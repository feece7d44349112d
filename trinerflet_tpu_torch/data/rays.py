"""Ray generation (port of ``trinerflet_tpu/data/rays.py``): pixel centers at
+0.5, pinhole directions ((i - cx)/fx, (j - cy)/fy, 1) normalized and rotated
by the cam2world rotation; origins are the camera centers. Training batches
are drawn on the device: uniform (view, pixel) pairs with replacement."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["rays_full_image", "rays_for_pixels", "sample_ray_batch"]


def rays_full_image(pose: np.ndarray, intrinsics, H: int, W: int) -> Tuple[np.ndarray, np.ndarray]:
    """All rays of one view, row-major, as numpy float32 (H*W, 3) x2 -- the
    same host-side arithmetic as the JAX package, so both render the same
    rays bit for bit."""
    fx, fy, cx, cy = intrinsics
    i, j = np.meshgrid(np.arange(W, dtype=np.float32) + 0.5,
                       np.arange(H, dtype=np.float32) + 0.5, indexing="xy")
    dirs = np.stack([(i - cx) / fx, (j - cy) / fy, np.ones_like(i)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays_d = dirs.reshape(-1, 3) @ pose[:3, :3].T
    rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def rays_for_pixels(poses: torch.Tensor, intrinsics, W: int, img_idx: torch.Tensor,
                    pix_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays for selected (view, flat pixel j*W + i) pairs: (B, 3) x2."""
    fx, fy, cx, cy = intrinsics
    i = (pix_idx % W).float() + 0.5
    j = torch.div(pix_idx, W, rounding_mode="floor").float() + 0.5
    dirs = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rows = poses.reshape(-1, 16)[img_idx]
    rot = rows[:, :12].reshape(-1, 3, 4)[:, :, :3]
    rays_d = (rot * dirs[:, None, :]).sum(-1)
    return rows[:, 3:12:4], rays_d


def _take_pixels(images: torch.Tensor, img_idx: torch.Tensor, pix_idx: torch.Tensor) -> torch.Tensor:
    """(B, C) pixel rows of (V, H, W, C) images at (view, flat pixel) pairs."""
    V, H, W = images.shape[:3]
    return images.reshape(V * H * W, -1)[img_idx * (H * W) + pix_idx]


def sample_ray_batch(images: torch.Tensor, poses: torch.Tensor, intrinsics, num_rays: int,
                     generator: Optional[torch.Generator] = None,
                     img_idx: Optional[torch.Tensor] = None,
                     pix_idx: Optional[torch.Tensor] = None):
    """A training batch: (rays_o, rays_d, pixels) of ``num_rays`` uniformly
    drawn (view, pixel) pairs. The indices are drawn with ``generator`` on
    its device, or passed in (``img_idx``, ``pix_idx``; tests inject them)."""
    V, H, W = images.shape[:3]
    dev = images.device
    if img_idx is None:
        gdev = generator.device if generator is not None else dev
        img_idx = torch.randint(0, V, (num_rays,), generator=generator, device=gdev)
        pix_idx = torch.randint(0, H * W, (num_rays,), generator=generator, device=gdev)
    img_idx, pix_idx = img_idx.to(dev).long(), pix_idx.to(dev).long()
    rays_o, rays_d = rays_for_pixels(poses, intrinsics, W, img_idx, pix_idx)
    return rays_o, rays_d, _take_pixels(images, img_idx, pix_idx)
