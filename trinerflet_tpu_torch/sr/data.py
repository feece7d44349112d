"""Paired LR / HR multiview data for NeRF super-resolution (port of
``trinerflet_tpu/sr/data.py``).

* ``load_sr_blender``: one Blender scene loaded at two scales (the HR / LR
  ratio checked), alpha-composited onto the background colour;
  ``view_ray_grid`` gives a view's (H, W, 3) ray grids and
  ``shuffled_ray_stream`` the globally shuffled LR rays of all views in
  chunks, re-permuted each epoch (numpy's generator: the JAX package's
  stream, draw for draw).
* ``load_sr_llff``: the LLFF variant with NDC ray grids.
* ``make_synthetic_sr_scene``: an analytic scene rendered at HR, its LR
  views box-filtered from it (or re-rendered), from identical cameras.
* ``save_sr_scene_npz`` / ``load_sr_scene_npz``: the scene cache, the same
  file in both packages.

Everything here is host numpy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Iterator, Optional, Tuple

import numpy as np

from .._device import DeviceLike
from ..data.blender import SceneData, load_blender
from ..data.rays import rays_full_image
from ..data.synthetic import make_synthetic_scene

__all__ = [
    "SRSceneData", "composite_bg", "load_sr_blender", "load_sr_llff", "load_sr_scene_npz",
    "make_synthetic_sr_scene", "save_sr_scene_npz", "shuffled_ray_stream", "view_ray_grid",
]


@dataclasses.dataclass
class SRSceneData:
    lr: Any  # SceneData (pinhole) or LLFFScene (precomputed NDC ray grids)
    hr: Any

    def __post_init__(self):
        assert self.hr.H % self.lr.H == 0 and self.hr.W % self.lr.W == 0
        assert self.hr.H // self.lr.H == self.hr.W // self.lr.W
        assert self.lr.num_views == self.hr.num_views

    @property
    def scale(self) -> int:
        return self.hr.H // self.lr.H

    @property
    def num_views(self) -> int:
        return self.lr.num_views

    @property
    def pregen_rays(self) -> bool:
        return getattr(self.lr, "rays_o", None) is not None


def view_ray_grid(scene, v: int) -> Tuple[np.ndarray, np.ndarray]:
    """(rays_o, rays_d) grid (H, W, 3) for one view — precomputed (LLFF) or
    generated from the pinhole camera."""
    if getattr(scene, "rays_o", None) is not None:
        return scene.rays_o[v], scene.rays_d[v]
    ro, rd = rays_full_image(np.asarray(scene.poses[v]), scene.intrinsics,
                             scene.H, scene.W)
    return ro.reshape(scene.H, scene.W, 3), rd.reshape(scene.H, scene.W, 3)


def shuffled_ray_stream(
    scene, chunk: int, seed: int = 0, background_color: float = 0.0
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Infinite generator over globally shuffled rays of all views, consumed
    in ``chunk``-sized pieces and re-permuted each epoch (the reference's
    ``low_res_shuffled`` stream).

    Yields (rays_o, rays_d, rgb), each (chunk, 3) float32.
    """
    V = scene.num_views
    grids = [view_ray_grid(scene, v) for v in range(V)]
    ro = np.stack([g[0] for g in grids]).reshape(-1, 3).astype(np.float32)
    rd = np.stack([g[1] for g in grids]).reshape(-1, 3).astype(np.float32)
    rgb = composite_bg(np.asarray(scene.images), background_color).reshape(-1, 3)
    n = len(ro)
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(n)
        for s in range(0, n - chunk + 1, chunk):
            sel = perm[s : s + chunk]
            yield ro[sel], rd[sel], rgb[sel]


def composite_bg(images: np.ndarray, bg: float) -> np.ndarray:
    if images.shape[-1] == 4:
        rgb = images[..., :3] * images[..., 3:] + bg * (1 - images[..., 3:])
        return rgb.astype(np.float32)
    return images


def load_sr_blender(
    root: str,
    split: str = "train",
    hr_downscale: int = 1,
    scale_ratio: int = 4,
    background_color: float = 0.0,
    data_scale: float = 0.33,
) -> SRSceneData:
    """Load one Blender scene at HR and LR (= HR downscaled by scale_ratio)."""
    hr = load_blender(root, split, downscale=hr_downscale, scale=data_scale)
    lr = load_blender(root, split, downscale=hr_downscale * scale_ratio, scale=data_scale)
    hr.images = composite_bg(hr.images, background_color)
    lr.images = composite_bg(lr.images, background_color)
    return SRSceneData(lr=lr, hr=hr)


def load_sr_llff(
    root: str,
    split: str = "train",
    hr_downscale: int = 4,
    scale_ratio: int = 4,
    llff_hold: int = 8,
    ndc: bool = True,
    spherify: bool = False,
) -> SRSceneData:
    """LLFF SR pairs with NDC ray grids (e.g. the 378x504 -> 1512x2016
    recipe). Both resolutions share cameras, so the LR grid is aligned with
    every ``scale_ratio``-th HR ray."""
    from ..data.llff import load_llff_scene

    hr = load_llff_scene(root, split, downscale=hr_downscale,
                         llff_hold=llff_hold, ndc=ndc, spherify=spherify)
    lr = load_llff_scene(root, split, downscale=hr_downscale * scale_ratio,
                         llff_hold=llff_hold, ndc=ndc, spherify=spherify)
    return SRSceneData(lr=lr, hr=hr)


def make_synthetic_sr_scene(
    num_views: int = 8, lr_size: int = 32, scale: int = 4, seed: int = 0,
    background_color: float = 0.0, variant: str = "spheres",
    backend: str = "numpy", lr_from: str = "downsample", device: DeviceLike = None,
) -> SRSceneData:
    """A paired synthetic scene: the ``variant`` field rendered at
    ``lr_size * scale``, paired with LR views from identical cameras.
    ``lr_from="downsample"`` box-filters the HR renders (the reference's
    data semantics: its LR split is the HR images loaded at a coarser
    downscale); ``"render"`` re-renders at LR with one ray per pixel
    (point-sampled, so detail below an LR pixel aliases differently in each
    view). ``backend="torch"`` (or the JAX package's ``"jax"``) renders the
    ground truth on ``device``, ``"numpy"`` on the host's threads."""
    hr = make_synthetic_scene(num_views, lr_size * scale, lr_size * scale,
                              seed=seed, variant=variant, backend=backend, device=device)
    if lr_from == "downsample":
        V, Hh, Wh, C = hr.images.shape
        lr_imgs = hr.images.reshape(
            V, lr_size, scale, lr_size, scale, C).mean((2, 4)).astype(np.float32)
        lr = SceneData(images=lr_imgs, poses=hr.poses.copy(),
                       intrinsics=hr.intrinsics, H=lr_size, W=lr_size)
    else:
        lr = make_synthetic_scene(num_views, lr_size, lr_size, seed=seed,
                                  variant=variant, backend=backend, device=device)
        lr.poses = hr.poses.copy()
    fx_l = hr.intrinsics[0] / scale
    lr.intrinsics = (fx_l, fx_l, lr_size / 2.0, lr_size / 2.0)
    hr.images = composite_bg(hr.images, background_color)
    lr.images = composite_bg(lr.images, background_color)
    return SRSceneData(lr=lr, hr=hr)


def save_sr_scene_npz(scene: SRSceneData, path: str) -> None:
    """Cache a pinhole SR scene pair (rendering the ground truth is the slow
    part; a resumed run reloads it)."""
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        lr_images=scene.lr.images, hr_images=scene.hr.images,
        poses=scene.hr.poses,
        lr_intrinsics=np.asarray(scene.lr.intrinsics, np.float64),
        hr_intrinsics=np.asarray(scene.hr.intrinsics, np.float64),
    )
    os.replace(tmp, path)


def load_sr_scene_npz(path: str) -> SRSceneData:
    d = np.load(path)
    lr_im, hr_im, poses = d["lr_images"], d["hr_images"], d["poses"]
    lr = SceneData(images=lr_im, poses=poses.copy(),
                   intrinsics=tuple(d["lr_intrinsics"].tolist()),
                   H=lr_im.shape[1], W=lr_im.shape[2])
    hr = SceneData(images=hr_im, poses=poses,
                   intrinsics=tuple(d["hr_intrinsics"].tolist()),
                   H=hr_im.shape[1], W=hr_im.shape[2])
    return SRSceneData(lr=lr, hr=hr)
