"""Headless orbit viewer (port of ``trinerflet_tpu/utils/viewer.py``): a
turntable of the trained field written as a video, or as a PNG sequence
where no video writer is installed (``cli.write_video``)."""

from __future__ import annotations

import numpy as np
import torch

from ..data.synthetic import orbit_pose

__all__ = ["render_orbit"]


def render_orbit(trainer, state, out_path: str, num_frames: int = 60, radius: float = 2.0,
                 theta: float = 1.2, H: int = 400, W: int = 400, fovy_deg: float = 50.0,
                 use_ema: bool = True, fps: int = 25) -> str:
    """``num_frames`` views at ``theta`` and ``radius``, phi stepping once
    around (the EMA params with ``use_ema`` when the state has them),
    through ``trainer.render_image``. Returns the path written."""
    from ..cli import write_video

    fy = 0.5 * H / np.tan(0.5 * np.deg2rad(fovy_deg))
    intr = (fy, fy, W / 2.0, H / 2.0)
    params = state.ema_params if (use_ema and getattr(state, "ema_params", None) is not None) else state.params
    frames = []
    for i in range(num_frames):
        pose = orbit_pose(theta, 2 * np.pi * i / num_frames, radius)
        img, _ = trainer.render_image(params, state.occ, pose, intr, H, W)
        frames.append((img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
    return write_video(out_path, frames, fps=fps)
