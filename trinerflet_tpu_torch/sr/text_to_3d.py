"""Guidance-driven 3D generation with the wavelet triplane (port of
``trinerflet_tpu/sr/text_to_3d.py``).

Optimise the wavelet-triplane NeRF from scratch under diffusion guidance
over random orbit cameras, in rounds: every ``refresh_every`` steps a new
set of ``views_per_refresh`` cameras is drawn, each view is rendered at the
training budget and refined by the guidance's ``generate_sr`` into a cached
pseudo-GT, and every step fits a random 64^2 crop of a cached view through
the SR system's HR step (L2 and the wavelet L1).

The guidance is any of ``sr/guidance.py``'s: the weights-free oracle,
resize or conditioning denoisers, or a text-to-image UNet
(``guidance.kind: text2img``) for generation proper.

Differences from the JAX package, none of which changes a result:

* The state is the port's ``SRState``; the steps run eagerly (``SRSystem``).
* The refresh of view v at step s draws from a generator seeded with
  (seed + 3) * 1,000,003 + s + v (JAX folds s + v into a key of seed + 3).
* The cached pseudo-GT and the crops' rays live on the system's device.
* ``render_turntable`` returns the path ``cli.write_video`` wrote (the mp4,
  or the directory of its frames).

Reproduced on purpose: the HR step's weights set ``"sds": 0`` whatever
``lambda_sds`` says, and ``num_rays`` is unused (the crop is min(64, S)^2
rays), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike
from ..data.rays import rays_for_pixels
from ..data.synthetic import orbit_pose
from ..models.nerf import NeRFConfig
from ..ops.resize import resize
from ..render import renderer as R
from .config import C, ScheduledFloat
from .system import SRConfig, SRState, SRSystem

__all__ = ["TextTo3DConfig", "TextTo3DSystem", "sample_orbit_cameras"]


def sample_orbit_cameras(rng: np.random.Generator, n: int, radius_range=(1.6, 2.2),
                         theta_range=(np.pi / 3, 2 * np.pi / 3)) -> np.ndarray:
    """``n`` random orbit cameras (n, 4, 4): theta, phi, radius drawn in
    that order per camera."""
    poses = []
    for _ in range(n):
        theta = rng.uniform(*theta_range)
        phi = rng.uniform(0, 2 * np.pi)
        radius = rng.uniform(*radius_range)
        poses.append(orbit_pose(theta, phi, radius))
    return np.stack(poses)


@dataclasses.dataclass(frozen=True)
class TextTo3DConfig:
    total_steps: int = 4000
    views_per_refresh: int = 8       # cached multi-view pseudo-GT per round
    refresh_every: int = 400
    render_size: int = 128
    fovy_deg: float = 50.0
    lr: float = 1e-2
    num_rays: int = 4096
    lambda_fit: ScheduledFloat = 1.0
    lambda_sds: ScheduledFloat = 0.0
    wavelet_regularization: ScheduledFloat = 0.1
    background_color: float = 0.0
    update_extra_interval: int = 16
    eval_chunk: int = 16384
    seed: int = 0


def _intrinsics(S: int, fovy_deg: float):
    fy = 0.5 * S / np.tan(0.5 * np.deg2rad(fovy_deg))
    return (fy, fy, S / 2.0, S / 2.0)


class TextTo3DSystem:
    """The round-based generation loop on the SR system's render, step and
    occupancy upkeep."""

    def __init__(self, nerf_cfg: NeRFConfig, render_cfg: R.RenderConfig, cfg: TextTo3DConfig,
                 guidance, workspace: Optional[str] = None, device: DeviceLike = None):
        self.cfg = cfg
        sr_cfg = SRConfig(
            total_steps=cfg.total_steps, sr_start_step=0, lr=cfg.lr, num_rays_lr=cfg.num_rays,
            background_color=cfg.background_color, wavelet_regularization=cfg.wavelet_regularization,
            update_extra_interval=cfg.update_extra_interval, eval_chunk=cfg.eval_chunk, seed=cfg.seed,
        )
        # the SR system needs a low-res snapshot (its grid upkeep reads it)
        nerf_cfg = dataclasses.replace(nerf_cfg, triplane=dataclasses.replace(
            nerf_cfg.triplane, low_res_scale=max(nerf_cfg.triplane.low_res_scale, 2)))
        self.inner = SRSystem(nerf_cfg, render_cfg, sr_cfg, guidance, workspace, device=device)
        self.guidance = guidance
        self.device = self.inner.device

    def init_state(self, generator: Optional[torch.Generator] = None) -> SRState:
        return self.inner.init_state(generator)

    def fit(self, state: SRState, log_every: int = 200, callback=None) -> SRState:
        cfg = self.cfg
        dev = self.device
        host_rng = np.random.default_rng(cfg.seed)
        S = cfg.render_size
        intr = _intrinsics(S, cfg.fovy_deg)
        intr_t = torch.tensor([float(np.float32(x)) for x in intr], dtype=torch.float32, device=dev)
        V = cfg.views_per_refresh

        poses = sample_orbit_cameras(host_rng, V)
        targets = torch.zeros((V, S, S, 3), device=dev)
        last_refresh = -(10**9)
        crop = min(64, S)
        dy, dx = torch.meshgrid(torch.arange(crop, device=dev), torch.arange(crop, device=dev),
                                indexing="ij")
        crop_pix = (dy * S + dx).reshape(-1)   # + x0 * S + y0: x0 is the row

        for it in range(cfg.total_steps):
            step = it
            if step % cfg.update_extra_interval == 0:
                state = self.inner._update_grid(state)

            if step - last_refresh >= cfg.refresh_every:
                # a new round of cameras, each view's pseudo-GT refreshed
                poses = sample_orbit_cameras(host_rng, V)
                for v in range(V):
                    render = self.inner.render_view(state.params, state.occ, poses[v], intr, S, S,
                                                    mode="full", deep=False)
                    hr = render.permute(2, 0, 1)[None]
                    lr_proxy = resize(hr, (1, 3, S // 4, S // 4))
                    gen = torch.Generator(device=dev).manual_seed((cfg.seed + 3) * 1_000_003 + step + v)
                    pseudo = self.guidance.generate_sr(lr_proxy, hr, step=step, generator=gen)
                    targets[v] = pseudo[0].permute(1, 2, 0)
                last_refresh = step
                poses_t = torch.from_numpy(poses).to(dev)

            # a random crop of a random cached view through the HR step
            v = int(host_rng.integers(0, V))
            x0 = int(host_rng.integers(0, S - crop + 1))
            y0 = int(host_rng.integers(0, S - crop + 1))
            pix = crop_pix + (x0 * S + y0)
            ro, rd = rays_for_pixels(poses_t, intr_t, S, torch.full_like(pix, v), pix)
            tgt = targets[v, x0 : x0 + crop, y0 : y0 + crop]
            lr_tgt = resize(tgt, (crop // 4, crop // 4, 3))
            weights = {
                "l2_hr": C(cfg.lambda_fit, step),
                "l1_hr": 0.0,
                "consistency": 0.0,
                "reg": C(cfg.wavelet_regularization, step),
                "percep": 0.0,
                "sds": 0.0,
            }
            state, aux = self.inner._hr_step(state, ro, rd, tgt, lr_tgt, weights)

            if log_every and (it % log_every == 0 or it == cfg.total_steps - 1):
                print(f"gen step {step:6d} loss {float(aux['loss']):.5f}")
            if callback:
                callback(state, aux)
        return state

    @torch.no_grad()
    def render_turntable(self, state: SRState, out_path: str, frames: int = 30) -> str:
        """``frames`` views around the orbit at theta 1.2, radius 2 (the
        test-time budget), written with ``cli.write_video``; returns the
        path it wrote."""
        from ..cli import write_video

        S = self.cfg.render_size
        intr = _intrinsics(S, self.cfg.fovy_deg)
        imgs = []
        for i in range(frames):
            pose = orbit_pose(1.2, 2 * np.pi * i / frames, 2.0)
            img = self.inner.render_view(state.params, state.occ, pose, intr, S, S)
            imgs.append((img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
        return write_video(out_path, imgs)
