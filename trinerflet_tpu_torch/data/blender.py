"""Blender / nerf-synthetic scenes (port of ``trinerflet_tpu/data/blender.py``):
``transforms_{split}.json``, poses converted with the instant-ngp axis
permutation ``nerf_matrix_to_ngp``, intrinsics from ``camera_angle_x`` (or
``fl_x`` / ``fl_y``), RGBA images in [0, 1]. Images are read by
``data/images.py`` (the host library's PNG decoder) instead of OpenCV. All
arrays are host numpy; the trainer moves them to the device once."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np

from .images import downscale_area, read_images

__all__ = ["SceneData", "load_blender", "nerf_matrix_to_ngp"]


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 0.33, offset=(0, 0, 0)) -> np.ndarray:
    """OpenGL / Blender cam2world -> the ngp convention."""
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


@dataclasses.dataclass
class SceneData:
    images: np.ndarray        # (V, H, W, C) float32 in [0, 1], C in {3, 4}
    poses: np.ndarray         # (V, 4, 4) cam2world, ngp convention
    intrinsics: Tuple[float, float, float, float]  # fx, fy, cx, cy
    H: int
    W: int

    @property
    def num_views(self) -> int:
        return len(self.images)


def load_blender(
    root: str,
    split: str = "train",
    downscale: int = 1,
    scale: float = 0.33,
    offset=(0, 0, 0),
    max_views: Optional[int] = None,
) -> SceneData:
    with open(os.path.join(root, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    frames = meta["frames"]
    if max_views:
        frames = frames[:max_views]

    paths, poses = [], []
    for fr in frames:
        fpath = os.path.join(root, fr["file_path"])
        if not os.path.splitext(fpath)[1]:
            fpath += ".png"
        paths.append(fpath)
        poses.append(nerf_matrix_to_ngp(np.array(fr["transform_matrix"], np.float32), scale, offset))
    images = np.stack([downscale_area(img, downscale) for img in read_images(paths)])
    poses = np.stack(poses)
    H, W = images.shape[1:3]
    if "fl_x" in meta:
        fx, fy = meta["fl_x"] / downscale, meta["fl_y"] / downscale
    else:
        fx = fy = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    cx = meta.get("cx", W / 2.0) if "cx" in meta else W / 2.0
    cy = meta.get("cy", H / 2.0) if "cy" in meta else H / 2.0
    return SceneData(images=images, poses=poses, intrinsics=(fx, fy, cx, cy), H=H, W=W)
