"""The analytic synthetic scenes (port of ``trinerflet_tpu/data/synthetic.py``):
``spheres`` (soft coloured spheres), ``hf`` (checker textures, thin rods, a
striped sphere) and ``srtex`` (band-limited textures on large shells, the SR
benchmark's scene), rendered by a brute-force marcher; orbit poses looking
at the origin and the intrinsics law fx = fy = 0.9 W, c = (W/2, H/2); and
``write_synthetic_scene``, which writes a scene to disk in the Blender
format. An end-to-end fit target that needs no download.

The fields take an array module ``xp`` as the JAX package's do: ``NP``
(numpy, the JAX package's host images bit for bit) or ``TorchXP(device)``,
which evaluates them with torch on a device (``backend="torch"``; the JAX
package's ``backend="jax"`` renders on its accelerator and is read the same
way here)."""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .blender import SceneData
from .images import write_png
from .rays import rays_full_image

__all__ = ["field", "field_hf", "field_srtex", "make_synthetic_scene", "orbit_pose",
           "synthetic_intrinsics", "write_synthetic_scene", "NP", "TorchXP"]

# analytic scene: (center, radius, rgb, density)
_SPHERES = [
    ((-0.25, 0.0, 0.05), 0.28, (0.9, 0.25, 0.2), 40.0),
    ((0.28, 0.05, -0.05), 0.22, (0.2, 0.4, 0.9), 40.0),
    ((0.0, -0.3, 0.1), 0.18, (0.3, 0.85, 0.3), 40.0),
]


class _NumpyXP:
    """The array module of the host fields: numpy."""

    zeros, exp, sin, abs, floor, round = (staticmethod(f) for f in
                                          (np.zeros, np.exp, np.sin, np.abs, np.floor, np.round))
    clip, maximum, hypot, concatenate = (staticmethod(f) for f in
                                         (np.clip, np.maximum, np.hypot, np.concatenate))

    @staticmethod
    def norm(x):
        return np.linalg.norm(x, axis=-1)

    @staticmethod
    def amax(x):
        return np.max(x, axis=-1)

    @staticmethod
    def astype(x, dtype):
        return x.astype(dtype)

    @staticmethod
    def const(a):
        return a


class TorchXP:
    """The array module of the fields on a torch device; numpy constants
    become tensors there (float64 ones stay float64, as numpy promotes)."""

    _DT = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
           np.dtype(np.int32): torch.int32}

    def __init__(self, device):
        self.device = torch.device(device)

    def zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=self._DT[np.dtype(dtype)], device=self.device)

    def const(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    def astype(self, x, dtype):
        return x.to(self._DT[np.dtype(dtype)])

    exp, sin, abs, floor, round = (staticmethod(f) for f in
                                   (torch.exp, torch.sin, torch.abs, torch.floor, torch.round))
    clip, maximum, hypot = staticmethod(torch.clamp), staticmethod(torch.maximum), staticmethod(torch.hypot)

    @staticmethod
    def concatenate(xs, axis):
        return torch.cat(xs, dim=axis)

    @staticmethod
    def norm(x):
        return torch.linalg.norm(x, dim=-1)

    @staticmethod
    def amax(x):
        return torch.amax(x, dim=-1)


NP = _NumpyXP()


def field(pts, xp=NP) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic (sigma, rgb) at (..., 3) points: soft coloured spheres."""
    sigma = xp.zeros(pts.shape[:-1], np.float32)
    rgb = xp.zeros(pts.shape[:-1] + (3,), np.float32)
    for (c, r, col, dens) in _SPHERES:
        d = xp.norm(pts - xp.const(np.asarray(c, np.float32)))
        s = dens * (1.0 / (1.0 + xp.exp(xp.clip((d - r) / 0.01, -60, 60))))
        sigma = sigma + s
        rgb = rgb + s[..., None] * xp.const(np.asarray(col, np.float32))
    rgb = rgb / xp.maximum(sigma[..., None], xp.const(np.float32(1e-8)))
    return sigma, rgb


def _smoothstep_inside(signed_dist, density: float, width: float, xp=NP):
    """Density ``density`` inside (signed_dist < 0), sharp sigmoid edge."""
    return density / (1.0 + xp.exp(xp.clip(signed_dist / width, -60, 60)))


def field_hf(pts, xp=NP) -> Tuple[np.ndarray, np.ndarray]:
    """High-frequency analytic (sigma, rgb): a striped sphere, a 5 x 5
    lattice of thin vertical rods and a checker-textured cube (sharp
    texture edges, thin geometry, occlusion)."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    sigma = xp.zeros(pts.shape[:-1], np.float32)
    rgb = xp.zeros(pts.shape[:-1] + (3,), np.float32)

    def add(s, col):
        nonlocal sigma, rgb
        sigma = sigma + s
        rgb = rgb + s[..., None] * xp.astype(col, np.float32)

    d = xp.norm(pts - xp.const(np.array([-0.05, -0.12, 0.0], np.float32))) - 0.34
    s = _smoothstep_inside(d, 70.0, 0.005, xp)
    stripe = xp.astype(xp.sin(x * 46.0) > 0, np.float32)[..., None]
    col = (stripe * xp.const(np.array([0.95, 0.8, 0.12]))
           + (1 - stripe) * xp.const(np.array([0.12, 0.22, 0.78])))
    add(s, col)

    pitch = 0.3
    xm = xp.clip(xp.round(x / pitch), -2, 2) * pitch
    zm = xp.clip(xp.round(z / pitch), -2, 2) * pitch
    d_rod = xp.hypot(x - xm, z - zm) - 0.016
    in_y = xp.maximum(xp.abs(y) - 0.55, xp.const(np.float32(0.0)))
    d_rod = xp.maximum(d_rod, in_y)
    s = _smoothstep_inside(d_rod, 90.0, 0.004, xp)
    ix = xp.astype(xm / pitch + 2, np.int32)
    iz = xp.astype(zm / pitch + 2, np.int32)
    hue = xp.astype((ix * 5 + iz) % 6, np.float32)[..., None] / 6.0
    col = xp.concatenate(
        [0.25 + 0.7 * xp.abs(xp.sin(np.pi * (hue + o))) for o in (0.0, 1 / 3, 2 / 3)],
        axis=-1,
    ).reshape(hue.shape[:-1] + (3,))
    add(s, col)

    q = xp.abs(pts - xp.const(np.array([0.48, 0.28, -0.42], np.float32))) - 0.17
    d_box = xp.amax(q)
    s = _smoothstep_inside(d_box, 80.0, 0.005, xp)
    cells = xp.astype(xp.floor(pts * 9.0), np.int32)
    checker = xp.astype((cells[..., 0] + cells[..., 1] + cells[..., 2]) % 2, np.float32)[..., None]
    col = (checker * xp.const(np.array([0.92, 0.92, 0.9]))
           + (1 - checker) * xp.const(np.array([0.65, 0.15, 0.12])))
    add(s, col)

    rgb = rgb / xp.maximum(sigma[..., None], xp.const(np.float32(1e-8)))
    return sigma, rgb


def field_srtex(pts, xp=NP) -> Tuple[np.ndarray, np.ndarray]:
    """The SR texture benchmark: four large thin-shell spheres carrying
    band-limited sinusoidal textures of ~0.03 world-unit period, ~5.3 px a
    period in 400^2 renders from radius 2 and ~1.3 px at 100^2, below the
    LR Nyquist rate, so bilinear x4 upsampling of the LR views cannot
    recover it and a multiview x4 SR model can."""
    sigma = xp.zeros(pts.shape[:-1], np.float32)
    rgb = xp.zeros(pts.shape[:-1] + (3,), np.float32)
    k = 212.0  # 2 pi / 0.0296 world units

    def add_sphere(center, r, m, col_a, col_b):
        nonlocal sigma, rgb
        d = xp.norm(pts - xp.const(np.asarray(center, np.float32))) - r
        s = _smoothstep_inside(d, 100.0, 0.006, xp)
        col = (m[..., None] * xp.const(np.asarray(col_a, np.float32))
               + (1.0 - m[..., None]) * xp.const(np.asarray(col_b, np.float32)))
        sigma = sigma + s
        rgb = rgb + s[..., None] * col

    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    m1 = 0.5 + 0.5 * xp.sin(k * x) * xp.sin(k * y)
    add_sphere((-0.30, 0.0, 0.05), 0.44, m1, (0.92, 0.86, 0.18), (0.12, 0.20, 0.75))
    m2 = 0.5 + 0.5 * xp.sin(k * y) * xp.sin(k * z)
    add_sphere((0.36, 0.05, -0.14), 0.36, m2, (0.85, 0.20, 0.15), (0.15, 0.80, 0.50))
    r3 = xp.norm(pts - xp.const(np.array([0.0, -0.40, 0.16], np.float32)))
    m3 = 0.5 + 0.5 * xp.sin(k * r3)
    add_sphere((0.0, -0.40, 0.16), 0.31, m3, (0.90, 0.55, 0.10), (0.20, 0.25, 0.35))
    m4 = 0.5 + 0.5 * xp.sin(k * x) * xp.sin(k * z)
    add_sphere((0.05, 0.44, 0.34), 0.28, m4, (0.25, 0.85, 0.85), (0.55, 0.15, 0.60))

    rgb = rgb / xp.maximum(sigma[..., None], xp.const(np.float32(1e-8)))
    return sigma, rgb


_FIELDS = {"spheres": field, "hf": field_hf, "srtex": field_srtex}


def _render_view(pose, intrinsics, H, W, num_steps=192, near=0.8, far=3.2,
                 field_fn=field) -> np.ndarray:
    """(H, W, 4) RGBA ground truth: uniform quadrature of the field."""
    rays_o, rays_d = rays_full_image(pose, intrinsics, H, W)
    t = np.linspace(near, far, num_steps, dtype=np.float32)
    dt = t[1] - t[0]
    img = np.zeros((H * W, 3), np.float32)
    acc = np.zeros((H * W,), np.float32)
    T = np.ones((H * W,), np.float32)
    for k in range(num_steps):
        sigma, rgb = field_fn(rays_o + rays_d * t[k])
        alpha = 1.0 - np.exp(-sigma * dt)
        w = alpha * T
        img += w[:, None] * rgb
        acc += w
        T *= 1.0 - alpha
    return np.concatenate([img, acc[:, None]], axis=-1).reshape(H, W, 4)


def _render_views_device(poses, intrinsics, H, W, num_steps, field_fn, device,
                         near=0.8, far=3.2, chunk=1 << 18):
    """The same quadrature with the field evaluated by torch on ``device``
    (the JAX package's ``backend="jax"``), in chunks of pixels; float32
    throughout. Returns (H, W, 4) numpy images."""
    xp = TorchXP(device)
    t = np.linspace(near, far, num_steps, dtype=np.float32)
    dt = float(t[1] - t[0])
    out = []
    for pose in poses:
        ro_all, rd_all = (torch.from_numpy(a).to(device) for a in rays_full_image(pose, intrinsics, H, W))
        rgba = []
        for s in range(0, H * W, chunk):
            ro, rd = ro_all[s : s + chunk], rd_all[s : s + chunk]
            n = ro.shape[0]
            img = torch.zeros((n, 3), device=device)
            acc = torch.zeros((n,), device=device)
            T = torch.ones((n,), device=device)
            for tk in t:
                sigma, rgb = field_fn(ro + rd * float(tk), xp=xp)
                alpha = 1.0 - torch.exp(-sigma * dt)
                w = alpha * T
                img += w[:, None] * rgb
                acc += w
                T *= 1.0 - alpha
            rgba.append(torch.cat([img, acc[:, None]], dim=-1))
        out.append(torch.cat(rgba).reshape(H, W, 4).float().cpu().numpy())
    return out


def make_synthetic_scene(num_views: int = 20, H: int = 100, W: int = 100, radius: float = 2.0,
                         seed: int = 0, num_steps: int = 192, variant: str = "spheres",
                         backend: str = "numpy", device: DeviceLike = None) -> SceneData:
    """``num_views`` orbit views (golden-angle azimuths with a seeded jitter,
    polar angles avoiding the poles) of the ``variant`` scene ("spheres",
    "hf" or "srtex"; the last two march at least 384 steps to resolve their
    detail). With ``backend="numpy"`` the views render on up to a thread
    per core (numpy's loops release the GIL), each as the JAX package
    renders it, so the images are its images bit for bit; ``"torch"`` (or
    the JAX package's ``"jax"``) renders on ``device`` (``cuda`` by
    default)."""
    field_fn = _FIELDS[variant]
    if variant in ("hf", "srtex"):
        num_steps = max(num_steps, 384)
    rng = np.random.default_rng(seed)
    intr = synthetic_intrinsics(H, W)
    poses = []
    for v in range(num_views):
        theta = np.arccos(1 - 1.6 * (v + 0.5) / num_views)
        phi = (v * 2.399963) % (2 * np.pi) + rng.uniform(0, 0.1)
        poses.append(orbit_pose(theta, phi, radius))
    if backend in ("torch", "jax"):
        images = _render_views_device(poses, intr, H, W, num_steps, field_fn, resolve_device(device))
    elif backend == "numpy":
        with ThreadPoolExecutor(max(1, min(num_views, os.cpu_count() or 1))) as pool:
            images = list(pool.map(lambda p: _render_view(p, intr, H, W, num_steps, field_fn=field_fn),
                                   poses))
    else:
        raise ValueError(f"unknown backend {backend!r} (numpy, torch)")
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
                          W: int = 100, seed: int = 0, variant: str = "spheres", backend: str = "numpy",
                          device: DeviceLike = None) -> str:
    """Write the ``variant`` scene to ``root`` in the Blender transforms format
    (loadable by ``load_blender(root, scale=1.0)``): train views from
    ``seed``, val and test views from ``seed + 1``, RGBA PNGs through
    ``write_png``. ``backend`` and ``device`` are ``make_synthetic_scene``'s
    (numpy, the JAX package's images bit for bit, by default)."""
    os.makedirs(root, exist_ok=True)
    splits = [("train", num_views, seed), ("val", num_test_views, seed + 1),
              ("test", num_test_views, seed + 1)]
    cam_angle_x = 2 * np.arctan(0.5 * W / (0.9 * W))
    for split, n, s in splits:
        scene = make_synthetic_scene(n, H, W, seed=s, variant=variant, backend=backend, device=device)
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
