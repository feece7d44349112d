"""The analytic synthetic scene (port of ``trinerflet_tpu/data/synthetic.py``,
numpy backend): soft coloured spheres rendered by a brute-force numpy
marcher, orbit poses looking at the origin and the intrinsics law
fx = fy = 0.9 W, c = (W/2, H/2). An end-to-end fit target that needs no
download."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .blender import SceneData
from .rays import rays_full_image

__all__ = ["field", "make_synthetic_scene", "orbit_pose", "synthetic_intrinsics"]

# analytic scene: (center, radius, rgb, density)
_SPHERES = [
    ((-0.25, 0.0, 0.05), 0.28, (0.9, 0.25, 0.2), 40.0),
    ((0.28, 0.05, -0.05), 0.22, (0.2, 0.4, 0.9), 40.0),
    ((0.0, -0.3, 0.1), 0.18, (0.3, 0.85, 0.3), 40.0),
]


def field(pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic (sigma, rgb) at (..., 3) points."""
    sigma = np.zeros(pts.shape[:-1], np.float32)
    rgb = np.zeros(pts.shape[:-1] + (3,), np.float32)
    for (c, r, col, dens) in _SPHERES:
        d = np.linalg.norm(pts - np.asarray(c, np.float32), axis=-1)
        s = dens * (1.0 / (1.0 + np.exp(np.clip((d - r) / 0.01, -60, 60))))
        sigma = sigma + s
        rgb = rgb + s[..., None] * np.asarray(col, np.float32)
    rgb = rgb / np.maximum(sigma[..., None], 1e-8)
    return sigma, rgb


def _render_view(pose, intrinsics, H, W, num_steps=192, near=0.8, far=3.2) -> np.ndarray:
    """(H, W, 4) RGBA ground truth: uniform quadrature of the field."""
    rays_o, rays_d = rays_full_image(pose, intrinsics, H, W)
    t = np.linspace(near, far, num_steps, dtype=np.float32)
    dt = t[1] - t[0]
    img = np.zeros((H * W, 3), np.float32)
    acc = np.zeros((H * W,), np.float32)
    T = np.ones((H * W,), np.float32)
    for k in range(num_steps):
        sigma, rgb = field(rays_o + rays_d * t[k])
        alpha = 1.0 - np.exp(-sigma * dt)
        w = alpha * T
        img += w[:, None] * rgb
        acc += w
        T *= 1.0 - alpha
    return np.concatenate([img, acc[:, None]], axis=-1).reshape(H, W, 4)


def make_synthetic_scene(num_views: int = 20, H: int = 100, W: int = 100, radius: float = 2.0,
                         seed: int = 0, num_steps: int = 192) -> SceneData:
    """``num_views`` orbit views (golden-angle azimuths with a seeded jitter,
    polar angles avoiding the poles) of the spheres scene."""
    rng = np.random.default_rng(seed)
    intr = synthetic_intrinsics(H, W)
    poses = []
    for v in range(num_views):
        theta = np.arccos(1 - 1.6 * (v + 0.5) / num_views)
        phi = (v * 2.399963) % (2 * np.pi) + rng.uniform(0, 0.1)
        poses.append(orbit_pose(theta, phi, radius))
    images = [_render_view(p, intr, H, W, num_steps) for p in poses]
    return SceneData(images=np.stack(images), poses=np.stack(poses), intrinsics=intr, H=H, W=W)


def orbit_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """cam2world (4, 4) float32; the camera looks along +z of its rotation,
    toward the origin."""
    cx = radius * np.sin(theta) * np.cos(phi)
    cy = radius * np.cos(theta)
    cz = radius * np.sin(theta) * np.sin(phi)
    center = np.array([cx, cy, cz], np.float32)
    forward = -center / np.linalg.norm(center)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(up, forward)
    right /= np.linalg.norm(right) + 1e-9
    up2 = np.cross(forward, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0] = right
    pose[:3, 1] = up2
    pose[:3, 2] = forward
    pose[:3, 3] = center
    return pose


def synthetic_intrinsics(H: int, W: int) -> Tuple[float, float, float, float]:
    """(fx, fy, cx, cy) of the synthetic scene's cameras."""
    fx = fy = 0.9 * W
    return (fx, fy, W / 2.0, H / 2.0)
