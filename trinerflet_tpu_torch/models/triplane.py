"""Multiscale wavelet triplane encoder (port of ``trinerflet_tpu/models/triplane.py``).

Parameters are a plain dict of tensors, as in the JAX package: ``base``
(3, C, b, b) plus ``wavelets.level_i`` (3, C, 3, s_i, s_i); with the
zoom-in planes (``upscale_ratio_bound`` in (0, 1)) ``upscale.level_i``; with
the learned variants the quaternion ``rotation`` (4,) and the scalar
``lbound_scale``. The full-resolution planes are rebuilt by the inverse
pyramid (``_idwt_ladder``, one IDWT level per step: kernel K4 on CUDA), the
zoom-in planes by one more level on a centre crop each, and returned
channel-last (3, H, W, C) for sampling (kernel K2 on CUDA; K2x for the
coordinate gradient of the learned rotation and zoom).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..ops import wavelets as W
from ..ops.grid_sample import project_to_planes, sample_points, sample_points_reduced
from ..ops.raymarch import _inv

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

    def snapshot_resolutions(self) -> Dict[str, int]:
        """The SR snapshot planes ("double resolution mode"): ``low_res`` at
        resolution / low_res_scale and ``high_res`` at resolution /
        high_res_scale, each when its scale is above 1."""
        out = {}
        if self.low_res_scale > 1:
            out["low_res"] = self.resolution // self.low_res_scale
        if self.high_res_scale > 1:
            out["high_res"] = self.resolution // self.high_res_scale
        return out


def _upscale_geometry(cfg: TriplaneConfig) -> Tuple[List[int], List[int], List[float]]:
    """Nested crop geometry: per zoom level, the centre crop of side
    round(res * ratio_bound) (its corner, its size) refined by one more IDWT
    level, and the level's bound ratio_bound^(level+1)."""
    res = cfg.resolution
    sizes, corners, bounds = [], [], []
    for level in range(cfg.upscale_levels):
        base = round(res * cfg.upscale_ratio_bound)
        if res % base:
            raise ValueError(f"upscale_ratio_bound {cfg.upscale_ratio_bound} must evenly divide "
                             f"the plane ({res} by {base})")
        corners.append(round(res / 2 - base / 2))
        sizes.append(base)
        bounds.append(cfg.upscale_ratio_bound ** (level + 1))
        res = 2 * base
    return sizes, corners, bounds


def init_triplane_params(cfg: TriplaneConfig, generator: Optional[torch.Generator] = None,
                         device: DeviceLike = None) -> Dict:
    """Base plane ~ N(0, init_sigma); learnable detail levels zero; on
    ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    b = cfg.base_resolution
    base = torch.randn((3, cfg.channels, b, b), generator=generator, dtype=torch.float32)
    wl = {f"level_{i}": torch.zeros((3, cfg.channels, 3, s, s), dtype=torch.float32)
          for i, s in enumerate(cfg.yh_sizes[: cfg.num_learnable_levels])}
    params = {"base": cfg.init_sigma * base, "wavelets": wl}
    if cfg.upscale_enabled:
        params["upscale"] = {f"level_{i}": torch.zeros((3, cfg.channels, 3, s, s), dtype=torch.float32)
                             for i, s in enumerate(_upscale_geometry(cfg)[0])}
    if cfg.learned_rotation:
        params["rotation"] = torch.tensor([1.0, 0.0, 0.0, 0.0])  # the identity quaternion
    if cfg.lbound_auto_scale:
        params["lbound_scale"] = torch.ones(())
    return _to(params, device)


def _quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """The rotation of the quaternion (w, x, y, z), normalised first."""
    q = q / torch.sqrt((q * q).sum())
    w, x, y, z = q.unbind()
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)]),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)]),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]),
    ])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _idwt_ladder(x: torch.Tensor, yh_list: List[Optional[torch.Tensor]],
                 yh_sizes: Tuple[int, ...], cfg: TriplaneConfig,
                 snapshots: Tuple[int, ...] = ()) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """The inverse pyramid: per level yl = 2*x, yh = learned coefficients or
    zeros (frozen levels), both padded by the wavelet pad when the lowpass
    has reached ``wavelet_base_resolution``, then one IDWT level. Also
    returns the intermediate planes whose side is in ``snapshots``, by side."""
    pad = W.idwt_pad(cfg.wavelet_type)
    snaps: Dict[int, torch.Tensor] = {}
    for i, s in enumerate(yh_sizes):
        if x.shape[-1] in snapshots:
            snaps[x.shape[-1]] = x
        yl = 2.0 * x
        yh = yh_list[i]
        if yh is None:
            # the width of ``x``: a model rank's channel shard builds its own
            yh = torch.zeros((3, x.shape[1], 3, s, s), dtype=x.dtype, device=x.device)
        if yl.shape[-1] >= cfg.wavelet_base_resolution and pad > 0:
            yl = torch.nn.functional.pad(yl, (pad, pad, pad, pad))
            yh = torch.nn.functional.pad(yh, (pad, pad, pad, pad))
        x = W.idwt2d(yl, yh, cfg.wavelet_type)
    if x.shape[-1] in snapshots:
        snaps[x.shape[-1]] = x
    return x, snaps


def _levels_to(cfg: TriplaneConfig, resolution: int) -> int:
    """IDWT levels the ladder runs before its plane's side reaches
    ``resolution`` (all of them when it never does)."""
    sizes_after = list(cfg.yh_sizes[1:]) + [cfg.resolution]
    return next((i + 1 for i, s in enumerate(sizes_after) if s >= resolution), cfg.levels)


def build_planes(params: Dict, cfg: TriplaneConfig, max_resolution: int = -1,
                 modes: Optional[Tuple[str, ...]] = None) -> Dict[str, torch.Tensor]:
    """Channel-last (3, H, W, C) planes from the wavelet parameters:
    ``full``; the SR snapshots ``low_res`` / ``high_res`` (the ladder's
    intermediate plane at resolution / scale; ``high_res`` is ``full`` when
    that side is not one of the ladder's); with the zoom-in planes
    ``upscale_{level}``, each one IDWT level on the centre crop of the plane
    before it, with that level's learned coefficients.

    ``max_resolution`` stops the ladder at the first level reaching it and
    builds no zoom-in plane (the density-grid refresh needs only 2x the grid
    resolution); ``full`` is then the plane where it stopped, and a snapshot
    finer than that is left out.

    ``modes`` names the planes the caller reads (``full``, ``low_res``,
    ``high_res``): the ladder then runs only as far as the finest of them and
    only those are returned, each with the same bits as a whole build gives
    (JAX drops the unread levels when it compiles; an eager build would run
    them). Zoom-in planes come with ``full``."""
    yh_sizes = cfg.yh_sizes
    n_learn = cfg.num_learnable_levels
    yh_list = [params["wavelets"][f"level_{i}"] if i < n_learn else None
               for i in range(cfg.levels)]
    snap_res = cfg.snapshot_resolutions()
    truncated = max_resolution > 0
    if modes is not None:
        sides = set(yh_sizes) | {cfg.resolution}
        top = max(snap_res[m] if m != "full" and snap_res[m] in sides else cfg.resolution
                  for m in modes)
        max_resolution = min(max_resolution, top) if truncated else top
    n_levels = _levels_to(cfg, max_resolution) if max_resolution > 0 else cfg.levels
    x, snaps = _idwt_ladder(params["base"], yh_list[:n_levels], yh_sizes[:n_levels], cfg,
                            tuple(snap_res.values()))
    out = {"full": x.permute(0, 2, 3, 1).contiguous()}
    for name, r in snap_res.items():
        if r in snaps:
            out[name] = out["full"] if snaps[r] is x else snaps[r].permute(0, 2, 3, 1).contiguous()
        elif name == "high_res":
            out[name] = out["full"]
    if cfg.upscale_enabled and not truncated and (modes is None or "full" in modes):
        sizes, corners, _ = _upscale_geometry(cfg)
        for level, (c, s) in enumerate(zip(corners, sizes)):
            x, _ = _idwt_ladder(x[:, :, c : c + s, c : c + s],
                                [params["upscale"][f"level_{level}"]], (s,), cfg)
            out[f"upscale_{level}"] = x.permute(0, 2, 3, 1).contiguous()
    if modes is not None:
        out = {k: v for k, v in out.items() if k in modes or k.startswith("upscale_")}
    return out


def sample_triplane(planes: Dict[str, torch.Tensor], coords: torch.Tensor, cfg: TriplaneConfig,
                    lbound: Optional[float] = None, resolution_mode: str = "full",
                    enc_params: Optional[Dict] = None, grad_reduce=None) -> torch.Tensor:
    """Features of (N, 3) points in [-lbound, lbound]^3 -> (N, 3C) float32
    (C the planes' width: a model rank's channel shard gives its 3 C/M
    features, plane-major).

    ``enc_params`` supplies the learned rotation (the points become ``coords
    @ R(q)^T``) and the lbound zoom (``lb = lbound * lbound_scale``) when the
    configuration learns them; both are differentiated through the points
    (K2x). With the zoom-in planes, every point is sampled on ``full`` and on
    every zoom level, and its inf-norm picks one (``torch.where``): level l
    takes the points with ratio_bound^(l+2) lb < |p|_inf <= ratio_bound^(l+1)
    lb (the last level everything inside its bound), sampled at that bound.
    Without zoom-in planes in ``planes`` (the density refresh's, the SR
    snapshots') every point reads ``planes[resolution_mode]``.
    ``grad_reduce`` (a data rank's mean over its group) takes each plane
    gradient in float32 before it is rounded (``sample_points_reduced``)."""
    lb = cfg.lbound if lbound is None else lbound
    N = coords.shape[0]
    if enc_params is not None:
        if cfg.learned_rotation and "rotation" in enc_params:
            coords = coords @ _quat_to_matrix(enc_params["rotation"]).T
        if cfg.lbound_auto_scale and "lbound_scale" in enc_params:
            lb = lb * enc_params["lbound_scale"]

    def sample(plane_stack, xyz, bound):
        if grad_reduce is None:
            return sample_points(plane_stack, xyz, bound)
        return sample_points_reduced(plane_stack, xyz, bound, grad_reduce)

    def flat_sample(plane_stack, bound):
        if torch.is_tensor(bound):  # a learned zoom: divide here, autograd carries dL/dlb
            return sample(plane_stack, coords / bound, 1.0).reshape(N, -1)
        return sample(plane_stack, coords, bound).reshape(N, -1)

    if not cfg.upscale_enabled or "upscale_0" not in planes:
        return flat_sample(planes[resolution_mode], lb)
    _, _, ratio_bounds = _upscale_geometry(cfg)
    coords_max = coords.detach().abs().amax(dim=-1)
    out = flat_sample(planes["full"], lb)
    taken = torch.zeros((N,), dtype=torch.bool, device=coords.device)
    for level in range(cfg.upscale_levels):
        lb_up = ratio_bounds[level] * lb
        in_level = coords_max <= lb_up
        if level < cfg.upscale_levels - 1:
            in_level = in_level & (coords_max > ratio_bounds[level + 1] * lb)
        vals = flat_sample(planes[f"upscale_{level}"], lb_up)
        out = torch.where((in_level & ~taken)[:, None], vals, out)
        taken = taken | in_level
    return out


def _abs_mean(v: torch.Tensor) -> torch.Tensor:
    """mean |v| with the JAX package's gradient of |x| at 0, which is +1
    (``jnp.abs``), where torch's ``abs`` gives 0: zero-initialised levels
    must move at the first step as they do in JAX."""
    return torch.where(v >= 0, v, -v).mean()


def wavelet_l1(params: Dict, cfg: TriplaneConfig, weighted: bool = False) -> torch.Tensor:
    """Wavelet sparsity regularizer with element-count weighting: sum over
    the learnable levels of mean|coefs| * (numel / total), divided by the
    number of levels; in weighted mode finest-first 1/4^i weights instead;
    plus, with the zoom-in planes, mean|coefs| * 1/4^(l+1) * (numel /
    total) for each zoom level l."""
    levels = [params["wavelets"][f"level_{i}"] for i in range(cfg.num_learnable_levels)]
    if not levels:
        return torch.zeros((), dtype=torch.float32, device=params["base"].device)
    total = sum(v.numel() for v in levels)
    if weighted:
        reg = sum((1.0 / 4**i) * _abs_mean(v) * (v.numel() / total)
                  for i, v in enumerate(reversed(levels)))
    else:
        reg = sum(_abs_mean(v) * (v.numel() / total) for v in levels) * _inv(len(levels))
    if cfg.upscale_enabled and "upscale" in params:
        ups = [params["upscale"][f"level_{i}"] for i in range(cfg.upscale_levels)]
        reg = reg + sum(_abs_mean(v) * (1.0 / 4 ** (i + 1)) * (v.numel() / total)
                        for i, v in enumerate(ups))
    return reg


def grow_params(old_params: Dict, old_cfg: TriplaneConfig, new_cfg: TriplaneConfig,
                generator: Optional[torch.Generator] = None, device: DeviceLike = None) -> Dict:
    """Cross-stage parameter surgery: a freshly initialised pyramid for
    ``new_cfg`` that takes over from ``old_params`` the base plane, every
    wavelet and zoom-in level whose shape matches, and the learned rotation
    and lbound zoom where both stages have them."""
    new_params = init_triplane_params(new_cfg, generator, device)
    dev = new_params["base"].device
    if old_params["base"].shape == new_params["base"].shape:
        new_params["base"] = old_params["base"].to(dev)
    for group in ("wavelets", "upscale"):
        if group not in old_params or group not in new_params:
            continue
        for k, v in old_params[group].items():
            if k in new_params[group] and new_params[group][k].shape == v.shape:
                new_params[group][k] = v.to(dev)
    for k in ("rotation", "lbound_scale"):
        if k in old_params and k in new_params:
            new_params[k] = old_params[k].to(dev)
    return new_params
