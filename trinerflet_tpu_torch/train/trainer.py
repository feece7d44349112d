"""Serving half of the trainer (port of ``trinerflet_tpu/train/trainer.py``):
the eval render config and chunking, and full-frame rendering from a trained
state. The optimiser, the train step and the retunes come with slice 2.

Unlike the JAX package, which rebuilds the planes inside every jitted chunk,
``render_rays`` / ``render_image`` build them once per call (the values are
identical), and the last chunk is not padded (rays are independent).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._device import SLICE_LATER, DeviceLike, not_ported, resolve_device
from ..data.rays import rays_full_image
from ..models.nerf import NeRFConfig, NeRFField, init_nerf_params
from ..render import renderer as R

__all__ = ["TrainConfig", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-2
    iters: int = 5000
    warmup_steps: int = 0
    warmup_factor: float = 1e-3
    sched_base: float = 0.1
    sched_exp: float = 2.5
    num_rays: int = 4096
    ema_decay: float = 0.95
    wavelet_regularization: float = 0.1
    weighted_regularization: bool = False
    background_color: float = 0.0
    train_rand_bg: bool = False
    criterion: str = "mse"
    huber_delta: float = 0.1
    alpha_bce: float = 0.0
    z_variance_reg: float = -1.0
    mlp_weight_decay: float = -1.0
    update_extra_interval: int = 16
    renderer: str = "occgrid"
    proposal_samples: int = 64
    proposal_final: int = 32
    lambda_interlevel: float = 1.0
    error_map: bool = False
    eval_chunk: int = 16384
    budget_autotune: bool = True
    budget_trunc_tol: float = 3e-3
    seed: int = 0


class Trainer:
    def __init__(self, nerf_cfg: NeRFConfig, render_cfg: R.RenderConfig,
                 train_cfg: TrainConfig, device: DeviceLike = None):
        if train_cfg.renderer != "occgrid":
            raise not_ported(f"the {train_cfg.renderer!r} renderer", SLICE_LATER)
        self.device = resolve_device(device)
        self.nerf_cfg = nerf_cfg
        self.render_cfg = render_cfg
        self.cfg = train_cfg
        self.field = NeRFField(nerf_cfg)
        # deep test-time rendering: wider per-ray budget, smaller ray chunks
        self.eval_render_cfg = render_cfg.for_eval()
        ratio = max(1, self.eval_render_cfg.samples_per_ray_budget
                    // max(render_cfg.samples_per_ray_budget, 1))
        self.eval_chunk = max(1024, train_cfg.eval_chunk // ratio)

    # ------------------------------------------------------------------ state

    def init_params(self, generator: Optional[torch.Generator] = None) -> Dict:
        """Seeded random parameters (``TrainConfig.seed`` by default)."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        return init_nerf_params(self.nerf_cfg, generator, self.device)

    def init_occupancy(self, density_grid=None) -> R.OccupancyState:
        return R.init_occupancy(self.render_cfg, self.device, density_grid)

    @torch.no_grad()
    def update_grid(self, params: Dict, occ: R.OccupancyState,
                    jitter: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> R.OccupancyState:
        """One full density-grid refresh. The sweep needs planes no finer than
        twice the grid resolution."""
        self._check_device(params, occ)
        planes = self.field.build_planes(params, max_resolution=2 * self.render_cfg.grid_size)

        def density_fn(pts):
            return self.field.density(params, planes, pts)[0]

        return R.update_density_grid(occ, density_fn, self.render_cfg, jitter=jitter,
                                     generator=generator)

    def _check_device(self, params: Dict, occ: R.OccupancyState) -> None:
        """Params and state must live on the trainer's device: a state carried
        onto another device would otherwise run there until the first mixed op."""
        for name, t in (("params", params["encoder"]["base"]), ("occupancy", occ.occ)):
            if t.device.type != self.device.type:
                raise ValueError(f"{name} are on {t.device}, the trainer on {self.device}; "
                                 f"move them or build the trainer with device={t.device.type!r}")

    # -------------------------------------------------------------- rendering

    def _render_chunk_impl(self, params, planes, occ: R.OccupancyState, rays_o, rays_d, bg_color):
        def field_fn(xyzs, dirs):
            return self.field(params, planes, xyzs, dirs)

        return R.render_occgrid(
            field_fn, rays_o, rays_d, occ.occ, self.eval_render_cfg, bg_color=bg_color,
            occ_coarse=occ.occ_coarse, occ_bbox=occ.bbox)

    def render_rays(self, params, occ, rays_o, rays_d, H, W, bg_color=None):
        """Full-frame render of precomputed rays in eval chunks."""
        if bg_color is None:
            bg_color = self.cfg.background_color
        return self._render_chunked(params, occ, rays_o, rays_d, H, W, bg_color)

    def render_image(self, params, occ, pose, intrinsics, H, W,
                     bg_color=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-frame render of one view in eval chunks.
        Returns (image (H, W, 3), depth (H, W)) on the trainer's device."""
        if bg_color is None:
            bg_color = self.cfg.background_color
        rays_o, rays_d = rays_full_image(np.asarray(pose), intrinsics, H, W)
        return self._render_chunked(params, occ, rays_o, rays_d, H, W, bg_color)

    @torch.no_grad()
    def _render_chunked(self, params, occ, rays_o, rays_d, H, W, bg_color):
        self._check_device(params, occ)
        rays_o = torch.as_tensor(rays_o, dtype=torch.float32, device=self.device).reshape(-1, 3)
        rays_d = torch.as_tensor(rays_d, dtype=torch.float32, device=self.device).reshape(-1, 3)
        planes = self.field.build_planes(params)
        imgs, deps = [], []
        for s in range(0, H * W, self.eval_chunk):
            out = self._render_chunk_impl(params, planes, occ, rays_o[s : s + self.eval_chunk],
                                          rays_d[s : s + self.eval_chunk], bg_color)
            imgs.append(out["image"])
            deps.append(out["depth"])
        return torch.cat(imgs).reshape(H, W, 3), torch.cat(deps).reshape(H, W)
