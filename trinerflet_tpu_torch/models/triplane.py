"""Multiscale wavelet triplane encoder (port of ``trinerflet_tpu/models/triplane.py``).

Parameters are a plain dict of tensors: ``base`` (3, C, b, b) plus
``wavelets.level_i`` (3, C, 3, s_i, s_i), as in the JAX package. The
full-resolution planes are rebuilt by the inverse pyramid (``_idwt_ladder``,
one IDWT level per step: kernel K4 on CUDA) and returned channel-last
(3, H, W, C) for sampling (kernel K2 on CUDA).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from .._device import SLICE_LATER, DeviceLike, not_ported, resolve_device
from ..ops import wavelets as W
from ..ops.grid_sample import project_to_planes, sample_points

__all__ = ["TriplaneConfig", "get_levels", "init_triplane_params", "build_planes",
           "project_to_planes", "sample_triplane", "wavelet_l1", "grow_params"]


def get_levels(scale: int) -> int:
    """scale -> number of doublings."""
    lv = int(round(math.log2(scale)))
    if 2**lv != scale:
        raise ValueError(f"scale must be a power of two, got {scale}")
    return lv


@dataclasses.dataclass(frozen=True)
class TriplaneConfig:
    channels: int = 16
    resolution: int = 512
    wavelet_scale: int = 8
    wavelet_type: str = "bior6.8"
    lbound: float = 1.0
    init_sigma: float = 0.1
    wavelet_base_resolution: int = 0
    current_scale: int = 1
    upscale_ratio_bound: float = -1.0
    upscale_levels: int = 2
    low_res_scale: int = 1
    high_res_scale: int = 1
    fast_sampler: bool = True
    quad_max_resolution: int = 2048
    learned_rotation: bool = False
    lbound_auto_scale: bool = False

    @property
    def levels(self) -> int:
        return get_levels(self.wavelet_scale)

    @property
    def feature_dim(self) -> int:
        return 3 * self.channels

    @property
    def base_resolution(self) -> int:
        return W.wavelet_pyramid_shapes(self.resolution, self.levels, self.wavelet_type,
                                        self.wavelet_base_resolution)[0]

    @property
    def yh_sizes(self) -> Tuple[int, ...]:
        return tuple(W.wavelet_pyramid_shapes(self.resolution, self.levels, self.wavelet_type,
                                              self.wavelet_base_resolution)[1])

    @property
    def num_learnable_levels(self) -> int:
        return self.levels - get_levels(self.current_scale)

    @property
    def upscale_enabled(self) -> bool:
        return 0.0 < self.upscale_ratio_bound < 1.0

    def check_ported(self) -> None:
        """Raise for the variants this slice does not port."""
        if self.upscale_enabled:
            raise not_ported("upscale (zoom-in) planes", SLICE_LATER)
        if self.low_res_scale > 1 or self.high_res_scale > 1:
            raise not_ported("SR snapshot planes (low_res/high_res)", "the SR slice")
        if self.learned_rotation or self.lbound_auto_scale:
            raise not_ported("learned rotation / lbound zoom", SLICE_LATER)


def init_triplane_params(cfg: TriplaneConfig, generator: Optional[torch.Generator] = None,
                         device: DeviceLike = None) -> Dict:
    """Base plane ~ N(0, init_sigma); learnable detail levels zero; on
    ``device`` (``cuda`` by default)."""
    cfg.check_ported()
    device = resolve_device(device)
    b = cfg.base_resolution
    base = torch.randn((3, cfg.channels, b, b), generator=generator, dtype=torch.float32)
    wl = {f"level_{i}": torch.zeros((3, cfg.channels, 3, s, s), dtype=torch.float32)
          for i, s in enumerate(cfg.yh_sizes[: cfg.num_learnable_levels])}
    params = {"base": cfg.init_sigma * base, "wavelets": wl}
    return _to(params, device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _idwt_ladder(x: torch.Tensor, yh_list: List[Optional[torch.Tensor]],
                 yh_sizes: Tuple[int, ...], cfg: TriplaneConfig) -> torch.Tensor:
    """The inverse pyramid: per level yl = 2*x, yh = learned coefficients or
    zeros (frozen levels), both padded by the wavelet pad when the lowpass
    has reached ``wavelet_base_resolution``, then one IDWT level."""
    pad = W.idwt_pad(cfg.wavelet_type)
    for i, s in enumerate(yh_sizes):
        yl = 2.0 * x
        yh = yh_list[i]
        if yh is None:
            yh = torch.zeros((3, cfg.channels, 3, s, s), dtype=x.dtype, device=x.device)
        if yl.shape[-1] >= cfg.wavelet_base_resolution and pad > 0:
            yl = torch.nn.functional.pad(yl, (pad, pad, pad, pad))
            yh = torch.nn.functional.pad(yh, (pad, pad, pad, pad))
        x = W.idwt2d(yl, yh, cfg.wavelet_type)
    return x


def build_planes(params: Dict, cfg: TriplaneConfig, max_resolution: int = -1) -> Dict[str, torch.Tensor]:
    """{"full": (3, H, W, C)} channel-last planes from the wavelet parameters.
    ``max_resolution`` stops the ladder at the first level reaching it (the
    density-grid refresh needs only 2x the grid resolution)."""
    cfg.check_ported()
    yh_sizes = cfg.yh_sizes
    n_learn = cfg.num_learnable_levels
    yh_list = [params["wavelets"][f"level_{i}"] if i < n_learn else None
               for i in range(cfg.levels)]
    sizes_after = list(yh_sizes[1:]) + [cfg.resolution]
    n_levels = cfg.levels
    if max_resolution > 0:
        n_levels = next((i + 1 for i, s in enumerate(sizes_after) if s >= max_resolution),
                        cfg.levels)
    x = _idwt_ladder(params["base"], yh_list[:n_levels], yh_sizes[:n_levels], cfg)
    return {"full": x.permute(0, 2, 3, 1).contiguous()}


def sample_triplane(planes: Dict[str, torch.Tensor], coords: torch.Tensor, cfg: TriplaneConfig,
                    lbound: Optional[float] = None) -> torch.Tensor:
    """Features of (N, 3) points in [-lbound, lbound]^3 -> (N, 3C) float32,
    from the full-resolution planes."""
    cfg.check_ported()
    lb = cfg.lbound if lbound is None else lbound
    return sample_points(planes["full"], coords, lb).reshape(coords.shape[0], -1)


def _abs_mean(v: torch.Tensor) -> torch.Tensor:
    """mean |v| with the JAX package's gradient of |x| at 0, which is +1
    (``jnp.abs``), where torch's ``abs`` gives 0: zero-initialised levels
    must move at the first step as they do in JAX."""
    return torch.where(v >= 0, v, -v).mean()


def wavelet_l1(params: Dict, cfg: TriplaneConfig, weighted: bool = False) -> torch.Tensor:
    """Wavelet sparsity regularizer with element-count weighting: sum over
    the learnable levels of mean|coefs| * (numel / total), divided by the
    number of levels; in weighted mode finest-first 1/4^i weights instead."""
    cfg.check_ported()
    levels = [params["wavelets"][f"level_{i}"] for i in range(cfg.num_learnable_levels)]
    if not levels:
        return torch.zeros((), dtype=torch.float32, device=params["base"].device)
    total = sum(v.numel() for v in levels)
    if weighted:
        return sum((1.0 / 4**i) * _abs_mean(v) * (v.numel() / total)
                   for i, v in enumerate(reversed(levels)))
    return sum(_abs_mean(v) * (v.numel() / total) for v in levels) / len(levels)


def grow_params(old_params: Dict, old_cfg: TriplaneConfig, new_cfg: TriplaneConfig,
                generator: Optional[torch.Generator] = None, device: DeviceLike = None) -> Dict:
    """Cross-stage parameter surgery: a freshly initialised pyramid for
    ``new_cfg`` that takes over the base plane and every wavelet level whose
    shape matches from ``old_params``."""
    new_params = init_triplane_params(new_cfg, generator, device)
    if old_params["base"].shape == new_params["base"].shape:
        new_params["base"] = old_params["base"].to(new_params["base"].device)
    for k, v in old_params["wavelets"].items():
        if k in new_params["wavelets"] and new_params["wavelets"][k].shape == v.shape:
            new_params["wavelets"][k] = v.to(new_params["base"].device)
    return new_params
