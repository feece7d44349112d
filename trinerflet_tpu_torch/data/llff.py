"""LLFF (forward-facing, COLMAP-derived) scenes (port of
``trinerflet_tpu/data/llff.py``): ``poses_bounds.npy``, image minification,
pose recentring, optional spherify, every-Nth holdout split, NDC rays and
the global normalisation that puts every (NDC) ray inside [-1, 1]^3. LLFF
scenes carry per-view ray grids instead of pinhole intrinsics; the trainer
samples them through its pregenerated-ray path. Images are read by
``data/images.py`` (PNG through the host library, JPEG through cv2 or PIL)
instead of OpenCV alone.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from .images import downscale_area, read_images

__all__ = ["LLFFScene", "load_llff_scene", "ndc_rays"]


@dataclasses.dataclass
class LLFFScene:
    images: Optional[np.ndarray]  # (V, H, W, 3) float32, None for render path
    rays_o: np.ndarray            # (V, H, W, 3) float32, normalized to [-1,1]
    rays_d: np.ndarray            # (V, H, W, 3)
    H: int
    W: int
    near: float = 0.0
    far: float = 1.0

    @property
    def num_views(self) -> int:
        return len(self.rays_o)


def _normalize(v):
    return v / (np.linalg.norm(v) + 1e-9)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def _poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([_viewmatrix(vec2, up, center), hwf], 1)


def _recenter_poses(poses):
    poses_ = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], (1, 4))
    c2w = _poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottoms = np.tile(np.reshape(bottom, (1, 1, 4)), (poses.shape[0], 1, 1))
    poses_h = np.concatenate([poses[:, :3, :4], bottoms], -2)
    poses_h = np.linalg.inv(c2w) @ poses_h
    poses_[:, :3, :4] = poses_h[:, :3, :4]
    return poses_


def _spherify_poses(poses, bds):
    p34_to_44 = lambda p: np.concatenate(
        [p, np.tile(np.reshape(np.eye(4)[-1, :], (1, 1, 4)), (p.shape[0], 1, 1))], 1
    )
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    def min_line_dist(rays_o, rays_d):
        A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
        b_i = -A_i @ rays_o
        return np.squeeze(
            -np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0)) @ b_i.mean(0)
        )

    pt_mindist = min_line_dist(rays_o, rays_d)
    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)
    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4],
         np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)], -1
    )
    return poses_reset, bds


def _load_images(root: str, factor: int, num: int) -> np.ndarray:
    img_dir = os.path.join(root, f"images_{factor}") if factor > 1 else os.path.join(root, "images")
    use_resize = not os.path.isdir(img_dir)
    if use_resize:
        img_dir = os.path.join(root, "images")
    files = sorted(
        f for f in os.listdir(img_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    if len(files) != num:
        raise ValueError(f"{img_dir} holds {len(files)} images, poses_bounds.npy {num} poses")
    imgs = read_images([os.path.join(img_dir, f) for f in files], color=True)
    if use_resize and factor > 1:
        imgs = [downscale_area(img, factor) for img in imgs]
    return np.stack(imgs)


def _camera_rays(H, W, focal, c2w):
    """LLFF/NeRF convention: x right, y up (flipped j), z backward."""
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    dirs = np.stack(
        [(i - 0.5 * W) / focal, -(j - 0.5 * H) / focal, -np.ones_like(i)], -1
    )
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).copy()
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o: np.ndarray, rays_d: np.ndarray):
    """Standard NeRF NDC ray warp (shift to near plane, project)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return (
        np.stack([o0, o1, o2], -1).astype(np.float32),
        np.stack([d0, d1, d2], -1).astype(np.float32),
    )


def load_llff_scene(
    root: str,
    split: str = "train",
    downscale: int = 8,
    llff_hold: int = 8,
    spherify: bool = False,
    ndc: bool = True,
    bd_factor: float = 0.75,
) -> LLFFScene:
    """Load an LLFF scene into per-view ray grids + images.

    Matches load_llff_data (load_llff.py:238) + NeRFDatasetLLFF: recenter,
    scale by 1/(bd_factor * min_bound), every-``llff_hold``-th view held out
    for val/test, NDC conversion, then divide all rays by the global max
    |coordinate| so the scene sits in [-1, 1]^3.
    """
    pb = np.load(os.path.join(root, "poses_bounds.npy"))  # (V, 17)
    poses = pb[:, :-2].reshape(-1, 3, 5)
    bds = pb[:, -2:]
    # poses_bounds stores [down, right, backwards] -> convert to [right, up, backwards]
    poses = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], axis=2
    )
    images = _load_images(root, downscale, len(poses))
    H, W = images.shape[1:3]
    focal = poses[0, 2, 4] / downscale
    poses[:, 0, 4] = H
    poses[:, 1, 4] = W
    poses[:, 2, 4] = focal

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc
    poses = _recenter_poses(poses)
    if spherify:
        poses, bds = _spherify_poses(poses, bds)

    i_test = np.arange(len(poses))[::llff_hold] if llff_hold > 0 else np.array([], int)
    i_train = np.array([i for i in range(len(poses)) if i not in set(i_test.tolist())])
    sel = i_train if split == "train" else i_test

    rays_o, rays_d = [], []
    for i in range(len(poses)):
        o, d = _camera_rays(H, W, focal, poses[i, :3, :4])
        if ndc:
            o, d = ndc_rays(H, W, focal, 1.0, o, d)
        rays_o.append(o)
        rays_d.append(d)
    rays_o = np.stack(rays_o)
    rays_d = np.stack(rays_d)
    # normalize so every train ray endpoint lies in [-1, 1]^3 (provider.py:473-510)
    train_o, train_d = rays_o[i_train], rays_d[i_train]
    limit = max(
        np.abs(train_o).max(), np.abs(train_o + train_d).max()
    ) if ndc else 1.0
    rays_o = rays_o / limit
    rays_d = rays_d / limit

    return LLFFScene(
        images=images[sel],
        rays_o=rays_o[sel],
        rays_d=rays_d[sel],
        H=H,
        W=W,
    )
