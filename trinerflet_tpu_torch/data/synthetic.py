"""The analytic synthetic scene (port of ``trinerflet_tpu/data/synthetic.py``,
the spheres variant): soft coloured spheres rendered by a brute-force
numpy marcher, orbit poses looking at the origin and the intrinsics law
fx = fy = 0.9 W, c = (W/2, H/2); and ``write_synthetic_scene``, which
writes it to disk in the Blender format. An end-to-end fit target that
needs no download."""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

from .blender import SceneData
from .images import write_png
from .rays import rays_full_image

__all__ = ["field", "make_synthetic_scene", "orbit_pose", "synthetic_intrinsics",
           "write_synthetic_scene"]

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
    polar angles avoiding the poles) of the spheres scene. The views render
    on up to a thread per core (numpy's loops release the GIL), each as the
    JAX package renders it, so the images are its images bit for bit."""
    rng = np.random.default_rng(seed)
    intr = synthetic_intrinsics(H, W)
    poses = []
    for v in range(num_views):
        theta = np.arccos(1 - 1.6 * (v + 0.5) / num_views)
        phi = (v * 2.399963) % (2 * np.pi) + rng.uniform(0, 0.1)
        poses.append(orbit_pose(theta, phi, radius))
    with ThreadPoolExecutor(max(1, min(num_views, os.cpu_count() or 1))) as pool:
        images = list(pool.map(lambda p: _render_view(p, intr, H, W, num_steps), poses))
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


def _ngp_to_blender(pose: np.ndarray) -> np.ndarray:
    """Inverse of nerf_matrix_to_ngp with scale=1, offset=0."""
    b = np.eye(4, dtype=np.float32)
    b[1] = [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3]]
    b[2] = [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3]]
    b[0] = [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3]]
    return b


def write_synthetic_scene(root: str, num_views: int = 20, num_test_views: int = 4, H: int = 100,
                          W: int = 100, seed: int = 0) -> str:
    """Write the spheres scene to ``root`` in the Blender transforms format
    (loadable by ``load_blender(root, scale=1.0)``): train views from
    ``seed``, val and test views from ``seed + 1``, RGBA PNGs through
    ``write_png``."""
    os.makedirs(root, exist_ok=True)
    splits = [("train", num_views, seed), ("val", num_test_views, seed + 1),
              ("test", num_test_views, seed + 1)]
    cam_angle_x = 2 * np.arctan(0.5 * W / (0.9 * W))
    for split, n, s in splits:
        scene = make_synthetic_scene(n, H, W, seed=s)
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for v in range(n):
            write_png(os.path.join(root, f"{split}/r_{v}.png"),
                      (np.clip(scene.images[v], 0, 1) * 255).astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{v}",
                           "transform_matrix": _ngp_to_blender(scene.poses[v]).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": float(cam_angle_x), "frames": frames}, f)
    return root
