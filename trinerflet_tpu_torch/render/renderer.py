"""Occupancy-grid renderer (port of ``trinerflet_tpu/render/renderer.py``).

``render_occgrid`` runs the hierarchical march (K1), then the field (K2
inside it) and a compositor on one of two layouts: the per-ray (N, B) layout
with the dense compositor (K3), or -- ``compaction="global"`` with
``global_slots_per_ray`` S > 0, which the budget tuner engages -- the
shared buffer of N*S slots that K5 packs, with the compact compositor
(K3c). It is differentiable in the field's parameters (K2, K3 and K3c
backward).
``OccupancyState`` / ``update_density_grid`` keep the occupancy state: the
field is queried at jittered cell centres (all cells, or a rotating block
for training's partial refresh), then ``occupancy_upkeep`` merges, thresholds,
dilates and bounds the grid -- kernel K6 (``kernels/csrc/occupancy.cu``) on
CUDA tensors, its plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from .._device import SLICE_LATER, DeviceLike, not_ported, resolve_device
from ..kernels import _build
from ..ops import raymarch as RM

__all__ = ["RenderConfig", "OccupancyState", "init_occupancy", "update_density_grid",
           "occupancy_upkeep", "occupancy_upkeep_plain", "tuned_num_coarse",
           "mark_untrained_grid", "render_occgrid"]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    bound: float = 1.0
    grid_size: int = 128
    density_thresh: float = 10.0
    min_near: float = 0.2
    max_steps: int = 1024
    occ_thresh_scale: float = 1.0
    num_steps: int = 512
    upsample_steps: int = 0
    dt_gamma: float = 0.0
    t_thresh: float = 1e-4
    density_scale: float = 1.0
    bg_radius: float = -1.0
    samples_per_ray_budget: int = 24
    eval_samples_per_ray: int = 0
    candidates_override: int = 0
    compaction: str = "per_ray"
    global_slots_per_ray: int = 0
    march: str = "hierarchical"
    fine_per_coarse: int = 12
    coarse_budget: int = 8
    num_coarse_override: int = 0
    occ_test_stride: int = 0
    coarse_test_stride: int = 0
    occ_mask_dense: bool = False

    def resolved_occ_test_stride(self) -> int:
        """0 = auto: floor(cell / (2 dt)), capped at F (training's default)."""
        if self.occ_test_stride != 0:
            return max(1, self.occ_test_stride)
        cell = 2.0 * min(1.0, self.bound) / self.grid_size
        dt = 2.0 * math.sqrt(3.0) / self.max_steps
        return max(1, min(self.fine_per_coarse, int(cell / (2.0 * dt))))

    def resolved_coarse_test_stride(self) -> int:
        """0 = auto: stride 1 (exact)."""
        if self.coarse_test_stride != 0:
            return max(1, self.coarse_test_stride)
        return 1

    @property
    def coarse_dilation_radius(self) -> int:
        """Dilation radius of occ_coarse so a coarse probe covers its whole
        group of segments (capped at 3)."""
        cell = 2.0 * min(1.0, self.bound) / self.grid_size
        dt = 2.0 * math.sqrt(3.0) / self.max_steps
        seg_cells = self.resolved_coarse_test_stride() * self.fine_per_coarse * dt / cell
        return max(1, min(3, math.ceil(seg_cells / 2.0)))

    @property
    def cascades(self) -> int:
        return 1 + max(0, math.ceil(math.log2(self.bound)))

    @property
    def num_candidates(self) -> int:
        if self.candidates_override > 0:
            return self.candidates_override
        return self.candidates_for(self.max_steps)

    def candidates_for(self, steps: int) -> int:
        """Candidate-enumeration length of the flat march for an occupied-
        sample cap: ``bound * steps`` at constant dt."""
        if self.dt_gamma > 0.0:
            raise not_ported("the dt_gamma > 0 candidate ladder", SLICE_LATER)
        return int(math.ceil(self.bound * steps))

    def for_eval(self) -> "RenderConfig":
        """Deep test-time variant: the exact dense layout and exact (stride-1)
        occupancy tests, widened to ``eval_samples_per_ray`` when set."""
        if self.eval_samples_per_ray <= 0 or (
                self.eval_samples_per_ray == self.samples_per_ray_budget):
            if (self.compaction == "global"
                    or self.resolved_occ_test_stride() != 1
                    or self.resolved_coarse_test_stride() != 1):
                return dataclasses.replace(self, compaction="per_ray", occ_test_stride=1,
                                           coarse_test_stride=1)
            return self
        e = self.eval_samples_per_ray
        return dataclasses.replace(
            self, samples_per_ray_budget=e, compaction="per_ray", occ_test_stride=1,
            coarse_test_stride=1,
            coarse_budget=max(self.coarse_budget, -(-e // self.fine_per_coarse) + 2))

    @property
    def aabb(self) -> Tuple[float, ...]:
        b = self.bound
        return (-b, -b, -b, b, b, b)


class OccupancyState(NamedTuple):
    density_grid: torch.Tensor   # (CAS, H^3) f32; -1 marks cells no camera sees
    occ: torch.Tensor            # (CAS, H, H, H) bool
    occ_coarse: torch.Tensor     # (CAS, H, H, H) bool, dilated occ
    mean_density: torch.Tensor   # () f32
    iter_density: torch.Tensor   # () int32
    bbox: torch.Tensor           # (6,) f32 world AABB of occupied cells (+1 voxel)


def init_occupancy(cfg: RenderConfig, device: DeviceLike = None,
                   density_grid=None) -> OccupancyState:
    """An empty state on ``device`` (``cuda`` by default), or one holding
    ``density_grid``."""
    H, C = cfg.grid_size, cfg.cascades
    device = resolve_device(device)
    grid = torch.zeros((C, H**3), dtype=torch.float32, device=device)
    if density_grid is not None:  # numpy (mark_untrained_grid) or a tensor
        grid = torch.as_tensor(density_grid, dtype=torch.float32, device=device).reshape(C, H**3)
    return OccupancyState(
        density_grid=grid,
        occ=torch.zeros((C, H, H, H), dtype=torch.bool, device=device),
        occ_coarse=torch.zeros((C, H, H, H), dtype=torch.bool, device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device),
        iter_density=torch.zeros((), dtype=torch.int32, device=device),
        bbox=torch.tensor(cfg.aabb, dtype=torch.float32, device=device),
    )


def _occupied_bbox(occ: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """World AABB of occupied cells over all cascades (+1 voxel margin); the
    scene box when nothing is occupied."""
    C, H = occ.shape[0], occ.shape[1]
    dev = occ.device
    inf = torch.tensor(float("inf"), device=dev)
    lo = torch.full((3,), float("inf"), device=dev)
    hi = torch.full((3,), float("-inf"), device=dev)
    idx = torch.arange(H, dtype=torch.float32, device=dev)
    for cas in range(C):
        bound = min(2**cas, cfg.bound)
        cell = 2.0 * bound / H
        world_lo = -bound + idx * cell
        for ax, red in enumerate([(1, 2), (0, 2), (0, 1)]):
            line = occ[cas].any(dim=red[1]).any(dim=red[0])
            mn = torch.where(line, world_lo, inf).min()
            mx = torch.where(line, world_lo + cell, -inf).max()
            lo[ax] = torch.minimum(lo[ax], mn - cell)
            hi[ax] = torch.maximum(hi[ax], mx + cell)
    full = torch.tensor(cfg.aabb, dtype=torch.float32, device=dev)
    empty = ~torch.isfinite(lo[0]) | ~torch.isfinite(hi[0])
    lo = torch.where(empty | (lo < full[:3]), full[:3], lo)
    hi = torch.where(empty | (hi > full[3:]), full[3:], hi)
    return torch.cat([lo, hi])


def _dilate3(occ: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """(2r+1)^3 max-pool (stride 1, same size) of a (CAS, H, H, H) bool grid,
    as r iterated 3^3 passes."""
    x = occ.float().unsqueeze(1)
    for _ in range(max(1, radius)):
        x = F.max_pool3d(x, kernel_size=3, stride=1, padding=1)
    return x.squeeze(1) > 0.5


def _grid_coords(H: int) -> np.ndarray:
    """All (x, y, z) cell coords, row-major x*H^2 + y*H + z order."""
    r = np.arange(H, dtype=np.int32)
    x, y, z = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([x.ravel(), y.ravel(), z.ravel()], axis=-1)


def mark_untrained_grid(poses: np.ndarray, intrinsics, cfg: RenderConfig) -> np.ndarray:
    """Cells no camera sees get density -1 forever. Host-side numpy, run once;
    returns the initial (CAS, H^3) density grid (0 where covered, -1 else)."""
    H, C = cfg.grid_size, cfg.cascades
    fx, fy, cx, cy = intrinsics
    coords = _grid_coords(H).astype(np.float32)
    world = 2 * coords / (H - 1) - 1
    grid = np.zeros((C, H**3), np.float32)
    for cas in range(C):
        bound = min(2**cas, cfg.bound)
        half = bound / H
        pts = world * (bound - half)
        covered = np.zeros(H**3, bool)
        for b in range(0, len(poses), 16):
            P = poses[b : b + 16]
            cam = pts[None] - P[:, None, :3, 3]
            cam = np.einsum("bnc,bcd->bnd", cam, P[:, :3, :3])
            mz = cam[..., 2] > 0
            mx = np.abs(cam[..., 0]) < cx / fx * cam[..., 2] + half * 2
            my = np.abs(cam[..., 1]) < cy / fy * cam[..., 2] + half * 2
            covered |= (mz & mx & my).any(axis=0)
        grid[cas, ~covered] = -1.0
    return grid


def _uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """U[0, 1) float32 on ``device``, drawn on the generator's own device."""
    if generator is None:
        return torch.rand(shape, dtype=torch.float32, device=device)
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=generator.device).to(device)


def update_density_grid(
    state: OccupancyState,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    cfg: RenderConfig,
    decay: float = 0.95,
    fraction: float = 1.0,
    jitter: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> OccupancyState:
    """Refresh the density grid: query the field at jittered cell centers,
    then ``occupancy_upkeep`` (EMA-max merge, cells at -1 stay; threshold at
    min(mean_density, density_thresh) * occ_thresh_scale; dilation; bbox).

    ``fraction < 1`` refreshes only a rotating contiguous block of
    ``S = int(H^3 * fraction)`` cells per cascade, starting at
    ``(iter_density * S) mod H^3`` (clamped to fit, as the JAX package's
    dynamic slice is): training's partial refresh.

    ``jitter`` (CAS, S, 3) gives the per-cell offsets in [-half, half)
    (tests inject them); otherwise they are drawn with ``generator``."""
    H, C = cfg.grid_size, cfg.cascades
    n = H**3
    dev = state.density_grid.device
    world = 2 * torch.as_tensor(_grid_coords(H), dtype=torch.float32, device=dev) / (H - 1) - 1
    S, off = n, 0
    if fraction < 1.0:
        S = max(1, int(n * fraction))
        off = min((int(state.iter_density) * S) % n, n - S)
        world = world[off : off + S]
    tmp = []
    for cas in range(C):
        bound = min(2**cas, cfg.bound)
        half = bound / H
        pts = world * (bound - half)
        if jitter is not None:
            pts = pts + jitter[cas].to(dev)
        else:
            pts = pts + (_uniform(pts.shape, generator, dev) * (2 * half) - half)
        tmp.append(density_fn(pts) * cfg.density_scale)
    new_grid, occ, occ_coarse, mean_density, bbox = occupancy_upkeep(
        state.density_grid, torch.stack(tmp), off, cfg, decay)
    return OccupancyState(
        density_grid=new_grid,
        occ=occ,
        occ_coarse=occ_coarse,
        mean_density=mean_density,
        iter_density=state.iter_density + 1,
        bbox=bbox,
    )


def occupancy_upkeep_plain(density_grid: torch.Tensor, tmp: torch.Tensor, offset: int,
                           cfg: RenderConfig, decay: float = 0.95):
    """Plain version of K6. density_grid (CAS, H^3) f32, tmp (CAS, S) f32
    queried densities of the cells [offset, offset + S) -> (new density_grid,
    occ (CAS, H, H, H) bool, occ_coarse (dilated occ), mean_density () f32,
    bbox (6,) f32)."""
    H, C = cfg.grid_size, cfg.cascades
    S = tmp.shape[1]
    old = density_grid[:, offset : offset + S]
    new_grid = density_grid.clone()
    new_grid[:, offset : offset + S] = torch.where(old >= 0, torch.maximum(old * decay, tmp), old)
    mean_density = torch.clamp_min(new_grid, 0).mean()
    thresh = torch.clamp_max(mean_density, cfg.density_thresh) * cfg.occ_thresh_scale
    occ = (new_grid > thresh).reshape(C, H, H, H)
    return (new_grid, occ, _dilate3(occ, cfg.coarse_dilation_radius), mean_density,
            _occupied_bbox(occ, cfg))


def occupancy_upkeep(density_grid: torch.Tensor, tmp: torch.Tensor, offset: int,
                     cfg: RenderConfig, decay: float = 0.95):
    """Kernel K6 on CUDA tensors, the plain version on CPU tensors."""
    if density_grid.is_cuda:
        return _occupancy_upkeep_cuda(density_grid, tmp, offset, cfg, decay)
    return occupancy_upkeep_plain(density_grid, tmp, offset, cfg, decay)


_K6_ARGS = {
    "occ_merge_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_longlong] * 3
    + [ctypes.c_float] + [ctypes.c_void_p] * 3,
    "occ_finalize_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                            ctypes.c_float, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3,
    "occ_threshold_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3,
    "occ_dilate_launch": [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    + [ctypes.c_float] + [ctypes.c_void_p] * 3,
}
_K6_THREADS = 256
_K6_MAX_CAS = 8


def _occupancy_upkeep_cuda(density_grid, tmp, offset, cfg, decay):
    H, C = cfg.grid_size, cfg.cascades
    n = H**3
    dev = density_grid.device
    if C > _K6_MAX_CAS or tuple(density_grid.shape) != (C, n) or density_grid.dtype != torch.float32:
        raise ValueError(f"occupancy kernel: density_grid must be ({C}, {n}) f32 with at most "
                         f"{_K6_MAX_CAS} cascades, got {tuple(density_grid.shape)} {density_grid.dtype}")
    S = tmp.shape[1]
    if (tmp.device != dev or tmp.dim() != 2 or tmp.shape[0] != C or not 0 <= offset <= n - S):
        raise ValueError(f"occupancy kernel: tmp must be ({C}, S) on {dev} with 0 <= offset <= "
                         f"{n} - S, got {tuple(tmp.shape)} on {tmp.device}, offset {offset}")
    old = density_grid.contiguous()
    tmp = tmp.float().contiguous()
    new_grid = torch.empty_like(old)
    n_blocks = -(-C * n // _K6_THREADS)
    partial = torch.empty((n_blocks,), device=dev, dtype=torch.float32)
    stats = torch.empty((2,), device=dev, dtype=torch.float32)
    minmax = torch.empty((C, 3, 2), device=dev, dtype=torch.int32)
    occ = torch.empty((C, H, H, H), device=dev, dtype=torch.bool)
    occ_coarse = torch.empty_like(occ)
    bbox = torch.empty((6,), device=dev, dtype=torch.float32)
    bounds = [min(2**c, cfg.bound) for c in range(C)]
    c_bounds = (ctypes.c_float * C)(*bounds)
    c_cells = (ctypes.c_float * C)(*[2.0 * b / H for b in bounds])
    s = _build.stream(dev)
    fn = lambda sym: _build.function("occupancy", sym, _K6_ARGS[sym])  # noqa: E731
    P = _build.ptr
    _build.check(fn("occ_merge_launch")(P(old), P(tmp), C, n, S, offset, float(decay),
                                        P(new_grid), P(partial), s), "occupancy merge")
    kernels.launches["occupancy"] += 1
    _build.check(fn("occ_finalize_launch")(P(partial), n_blocks, C * n, float(cfg.density_thresh),
                                           float(cfg.occ_thresh_scale), C, H, P(stats),
                                           P(minmax), s), "occupancy finalize")
    kernels.launches["occupancy"] += 1
    _build.check(fn("occ_threshold_launch")(P(new_grid), P(stats), C, H, P(occ), P(minmax), s),
                 "occupancy threshold")
    kernels.launches["occupancy"] += 1
    _build.check(fn("occ_dilate_launch")(P(occ), C, H, cfg.coarse_dilation_radius, P(minmax),
                                         c_bounds, c_cells, float(cfg.bound), P(occ_coarse),
                                         P(bbox), s), "occupancy dilate")
    kernels.launches["occupancy"] += 1
    return new_grid, occ, occ_coarse, stats[0], bbox


def tuned_num_coarse(cfg: RenderConfig, bbox: np.ndarray) -> Optional[int]:
    """The march-span retune policy: ``num_coarse_override`` sized to the
    occupied-bbox diagonal (x1.1 margin, +2 segments, rounded up to 8, floor
    8, capped at the worst case). None when the current span is already
    within [0.75 * target, target]."""
    diag = float(np.linalg.norm(bbox[3:] - bbox[:3]))
    seg = 2.0 * math.sqrt(3.0) / cfg.max_steps * cfg.fine_per_coarse
    worst = int(math.ceil(cfg.bound * cfg.max_steps / cfg.fine_per_coarse))
    target = int(math.ceil(diag * 1.1 / seg)) + 2
    target = min(worst, max(8, (target + 7) // 8 * 8))
    cur = cfg.num_coarse_override or worst
    if target < int(cur * 0.75) or target > cur:
        return target
    return None


def _background(n: int, bg_color, device) -> torch.Tensor:
    """(n, 3) background: white by default, a scalar grey, or given colors.
    (The background sphere network is not ported; NeRFField rejects it.)"""
    if bg_color is None:
        bg_color = 1.0
    if isinstance(bg_color, (int, float)):
        return torch.full((n, 3), float(bg_color), dtype=torch.float32, device=device)
    return bg_color


def render_occgrid(
    field_fn: Callable,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    occ: torch.Tensor,
    cfg: RenderConfig,
    noise: Optional[torch.Tensor] = None,
    bg_color=None,
    occ_coarse: Optional[torch.Tensor] = None,
    occ_bbox: Optional[torch.Tensor] = None,
    with_stats: bool = True,
) -> Dict[str, torch.Tensor]:
    """March + field + composite on the hierarchical march: the per-ray
    layout, or the global one (``compaction="global"``, S =
    ``global_slots_per_ray`` > 0: the kept samples packed into N*S shared
    slots by K5, the field on that buffer -- padding slots included, at
    xyz = dir = 0 -- and the compact compositor; ``global_fill`` reports
    the buffer's use, ``num_samples`` the slots kept).

    ``field_fn(xyzs (M, 3), dirs (M, 3)) -> (sigma (M,), rgb (M, 3))``.
    ``noise`` (N,) in [0, 1) perturbs the ray starts (the JAX package's
    ``perturb``; tests inject it); None renders unperturbed, as serving does.
    Returns the JAX package's keys: image, depth, weights_sum, z_variance,
    num_samples, overflow_frac, samples_mean, trunc_T, span_trunc_T, and
    with ``with_stats`` the sorted p99s samples_p99, span_p99,
    needed_seg_p99 (the trainer reads them only on retune steps)."""
    if cfg.dt_gamma != 0.0:
        raise not_ported("rendering with dt_gamma > 0", SLICE_LATER)
    if cfg.march != "hierarchical" or occ_coarse is None:
        raise not_ported("the flat candidate march", SLICE_LATER)
    if cfg.compaction == "global" and cfg.global_slots_per_ray <= 0:
        raise not_ported("compaction='global' with global_slots_per_ray=0 (the flat march's "
                         "exact global compaction)", SLICE_LATER)
    if cfg.compaction not in ("per_ray", "global"):
        raise ValueError(f"unknown compaction {cfg.compaction!r}")
    N = rays_o.shape[0]
    dev = rays_o.device
    aabb = occ_bbox if occ_bbox is not None else torch.tensor(cfg.aabb, dtype=torch.float32, device=dev)
    nears, fars = RM.near_far_from_aabb(rays_o, rays_d, aabb, cfg.min_near)
    hit = nears < 1e30
    nears_c = torch.where(hit, nears, 0.0)
    fars_c = torch.where(hit, fars, 0.0)  # near >= far -> no candidates
    if noise is None:
        noise = torch.zeros((N,), dtype=torch.float32, device=dev)

    steps = cfg.max_steps
    B = cfg.samples_per_ray_budget
    Fc = cfg.fine_per_coarse
    num_coarse = cfg.num_coarse_override or int(math.ceil(cfg.bound * steps / Fc))
    t, dt_scalar, mask, stride, seg_lastocc = RM.march_hierarchical(
        rays_o, rays_d, nears_c, fars_c, occ, occ_coarse, noise,
        num_coarse=num_coarse, fine_per_coarse=Fc, coarse_budget=cfg.coarse_budget,
        budget=B, max_steps=steps, grid_size=cfg.grid_size, cascades=cfg.cascades,
        bound=cfg.bound, occ_test_stride=cfg.resolved_occ_test_stride(),
        coarse_test_stride=cfg.resolved_coarse_test_stride())
    dt = torch.where(mask, dt_scalar * stride[:, None], 0.0)
    t0 = nears_c + dt_scalar * noise
    num_samples = mask.sum()
    demand = mask.sum(-1).float() * stride
    overflow_frac = (demand > B).float().mean()
    capped = demand > B
    span_ray = torch.where(hit, fars_c - nears_c, 0.0)
    span_capped = span_ray > (num_coarse * Fc) * (2.0 * RM.SQRT3 / steps) * 0.995

    needed_seg = seg_lastocc
    global_fill = None
    if cfg.compaction == "global":
        slots = N * cfg.global_slots_per_ray
        comp = RM.compact_global_dense(rays_o, rays_d, t, dt, mask, t0, m_budget=slots,
                                       bound=cfg.bound)
        sigmas, rgbs = field_fn(comp.xyzs, comp.dirs)
        ws, depth_raw, image, z_var = RM.composite_compact(
            cfg.density_scale * sigmas, rgbs, comp, N, cfg.t_thresh)
        num_samples = comp.num_valid
        global_fill = comp.num_valid.float() / slots
    else:
        pts = (rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]).clamp(-cfg.bound, cfg.bound)
        dirs = rays_d[:, None, :].expand(pts.shape)
        sigmas, rgbs = field_fn(pts.reshape(-1, 3), dirs.reshape(-1, 3))
        sigmas = sigmas.reshape(N, B)
        rgbs = rgbs.reshape(N, B, 3)
        ts_rel = torch.where(mask, t + dt - t0[:, None], 0.0)
        ws, depth_raw, image, weights = RM.composite_dense(
            cfg.density_scale * sigmas, rgbs, dt, ts_rel, mask=mask, t_thresh=cfg.t_thresh)
        mean_z = depth_raw / torch.clamp_min(ws, 1e-8)
        z_var = (weights * (ts_rel - mean_z[:, None]) ** 2).sum(-1) / torch.clamp_min(ws, 1e-8)
        if with_stats:
            # saturation-aware demand span: a saturated ray needs only the
            # span up to its last contributing sample
            with torch.no_grad():
                t_sat = torch.where(weights > 0, ts_rel, 0.0).amax(dim=1)
                saturated = ws > 1.0 - 10.0 * cfg.t_thresh
                needed_seg = torch.where(saturated, torch.minimum(
                    t_sat / (dt_scalar * Fc) + 2.0, seg_lastocc), seg_lastocc)

    bg = _background(N, bg_color, dev)
    image = image + (1.0 - ws)[:, None] * bg
    span = torch.clamp_min(fars - nears, 1e-6)
    # ts are relative to the (perturbed) ray start, so depth_raw already is
    # "depth - near"
    depth = torch.clamp_min(depth_raw, 0.0) / span
    out = {"image": image, "depth": depth, "weights_sum": ws, "z_variance": z_var,
           "num_samples": num_samples}
    if with_stats:
        # all three p99s from one sort
        with torch.no_grad():
            stats3 = torch.sort(torch.stack([demand, span_ray, needed_seg]), dim=1).values
        qi = int(round(0.99 * (N - 1)))
        out["samples_p99"] = stats3[0, qi]
        out["span_p99"] = stats3[1, qi]
        out["needed_seg_p99"] = stats3[2, qi]
    out["overflow_frac"] = overflow_frac
    out["samples_mean"] = demand.mean()
    n_capped = capped.sum()
    out["trunc_T"] = torch.where(
        n_capped > 0,
        torch.where(capped, 1.0 - ws, 0.0).sum() / torch.clamp_min(n_capped, 1).float(),
        0.0)
    n_sc = span_capped.sum()
    out["span_trunc_T"] = torch.where(
        n_sc > 0,
        torch.where(span_capped, 1.0 - ws, 0.0).sum() / torch.clamp_min(n_sc, 1).float(),
        0.0)
    if global_fill is not None:
        out["global_fill"] = global_fill
    return out
