"""Ray generation (port of ``trinerflet_tpu/data/rays.py``): pixel centers at
+0.5, pinhole directions ((i - cx)/fx, (j - cy)/fy, 1) normalized and rotated
by the cam2world rotation; origins are the camera centers. Training batches
are drawn on the device: uniform (view, pixel) pairs with replacement, pairs
weighted by a coarse error map, or rows of pregenerated ray grids. Every
draw can be passed in instead (tests inject them)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["rays_full_image", "rays_for_pixels", "sample_ray_batch",
           "sample_ray_batch_error_map", "sample_ray_batch_pregen", "rand_poses"]


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
    """Rays for selected (view, flat pixel j*W + i) pairs: (B, 3) x2.

    The JAX train step traces the intrinsics, so ``(i - cx) / fx`` is a
    true division there; here it divides by float32 tensors on the pixels'
    device, since torch on the card would multiply by the reciprocal of a
    Python float."""
    fx, fy, cx, cy = torch.as_tensor(intrinsics, dtype=torch.float32, device=pix_idx.device).unbind()
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
        img_idx = _randint(V, num_rays, generator, dev)
        pix_idx = _randint(H * W, num_rays, generator, dev)
    img_idx, pix_idx = img_idx.to(dev).long(), pix_idx.to(dev).long()
    rays_o, rays_d = rays_for_pixels(poses, intrinsics, W, img_idx, pix_idx)
    return rays_o, rays_d, _take_pixels(images, img_idx, pix_idx)


def _randint(high: int, n: int, generator: Optional[torch.Generator], dev) -> torch.Tensor:
    gdev = generator.device if generator is not None else dev
    return torch.randint(0, high, (n,), generator=generator, device=gdev).to(dev)


def _rand(n: int, generator: Optional[torch.Generator], dev) -> torch.Tensor:
    gdev = generator.device if generator is not None else dev
    return torch.rand((n,), generator=generator, device=gdev).to(dev)


def sample_ray_batch_error_map(images: torch.Tensor, poses: torch.Tensor, intrinsics,
                               num_rays: int, error_map: torch.Tensor,
                               generator: Optional[torch.Generator] = None,
                               img_idx: Optional[torch.Tensor] = None,
                               u: Optional[torch.Tensor] = None,
                               jx: Optional[torch.Tensor] = None,
                               jy: Optional[torch.Tensor] = None):
    """Error-weighted ray sampling: a view uniformly, then a cell of its
    G x G error map (``error_map`` (V, G*G) nonnegative weights, G from its
    shape) by inverse CDF, then a jittered full-resolution pixel inside the
    cell. The inverse CDF is the JAX package's fixed-trip binary search over
    the flat per-view CDF, and the jitter its float32 arithmetic, so the same
    uniforms (``u``, ``jx``, ``jy`` in [0, 1), ``img_idx``) give the same
    pixels. Returns (rays_o, rays_d, pixels, (img_idx, cell))."""
    V, H, W = images.shape[:3]
    dev = images.device
    G = int(round(math.isqrt(error_map.shape[1])))
    if G * G != error_map.shape[1]:
        raise ValueError(f"error_map must be (V, G*G), got {tuple(error_map.shape)}")
    img_idx = _randint(V, num_rays, generator, dev) if img_idx is None else img_idx.to(dev)
    img_idx = img_idx.long()
    u = _rand(num_rays, generator, dev) if u is None else u.to(dev, torch.float32)
    jx = _rand(num_rays, generator, dev) if jx is None else jx.to(dev, torch.float32)
    jy = _rand(num_rays, generator, dev) if jy is None else jy.to(dev, torch.float32)
    cdf = torch.cumsum(error_map.float(), dim=1)
    u = u * cdf[:, -1][img_idx]
    flat_cdf = cdf.reshape(-1)
    base = img_idx * (G * G)
    lo = torch.zeros((num_rays,), dtype=torch.long, device=dev)
    hi = torch.full((num_rays,), G * G, dtype=torch.long, device=dev)
    for _ in range(max(1, (G * G - 1).bit_length())):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go_right = flat_cdf[base + torch.clamp_max(mid, G * G - 1)] < u
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    cell = torch.clamp_max(lo, G * G - 1)
    cx = torch.div(cell, G, rounding_mode="floor")
    cy = cell % G
    sx = torch.tensor(H / G, dtype=torch.float32, device=dev)
    sy = torch.tensor(W / G, dtype=torch.float32, device=dev)
    ix = torch.clamp((cx.float() * sx + jx * sx).int(), 0, H - 1).long()
    iy = torch.clamp((cy.float() * sy + jy * sy).int(), 0, W - 1).long()
    pix_idx = ix * W + iy
    rays_o, rays_d = rays_for_pixels(poses, intrinsics, W, img_idx, pix_idx)
    return rays_o, rays_d, _take_pixels(images, img_idx, pix_idx), (img_idx, cell)


def sample_ray_batch_pregen(images: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                            num_rays: int, generator: Optional[torch.Generator] = None,
                            img_idx: Optional[torch.Tensor] = None,
                            pix_idx: Optional[torch.Tensor] = None):
    """A batch from precomputed per-view ray grids (``rays_o``, ``rays_d``
    (V, H, W, 3), e.g. NDC rays): uniform (view, pixel) pairs, drawn with
    ``generator`` or passed in. Returns (rays_o, rays_d, pixels)."""
    V, H, W = images.shape[:3]
    dev = images.device
    if img_idx is None:
        img_idx = _randint(V, num_rays, generator, dev)
        pix_idx = _randint(H * W, num_rays, generator, dev)
    img_idx, pix_idx = img_idx.to(dev).long(), pix_idx.to(dev).long()
    return tuple(_take_pixels(a, img_idx, pix_idx) for a in (rays_o, rays_d, images))


def rand_poses(rng: np.random.Generator, size: int, radius: float = 1.0,
               theta_range=(np.pi / 3, 2 * np.pi / 3), phi_range=(0, 2 * np.pi)) -> np.ndarray:
    """Random orbit-camera poses looking at the origin, (size, 4, 4) float32
    numpy: spherical centers, forward = -normalize(center), up = (0, -1, 0)
    before orthogonalization (host-side, as the JAX package)."""
    thetas = rng.uniform(theta_range[0], theta_range[1], size)
    phis = rng.uniform(phi_range[0], phi_range[1], size)
    centers = radius * np.stack([np.sin(thetas) * np.sin(phis), np.cos(thetas),
                                 np.sin(thetas) * np.cos(phis)], axis=-1)

    def _norm(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-10)

    fwd = -_norm(centers)
    up = np.broadcast_to(np.array([0.0, -1.0, 0.0]), fwd.shape)
    right = _norm(np.cross(fwd, up))
    up = _norm(np.cross(right, fwd))
    poses = np.tile(np.eye(4, dtype=np.float32), (size, 1, 1))
    poses[:, :3, :3] = np.stack([right, up, fwd], axis=-1)
    poses[:, :3, 3] = centers
    return poses
