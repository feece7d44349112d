"""Volume renderers (port of ``trinerflet_tpu/render/renderer.py``).

``render_occgrid`` marches the occupancy grid, then runs the field (K2
inside it) and a compositor. The march is the hierarchical one (K1) at
constant dt with a dilated grid, or else the flat candidate march (K1f),
which also walks the ``dt_gamma`` ladder. Layouts: the per-ray (N, B)
layout with the dense compositor (K3), or the global one with the compact
compositor (K3c) -- on the hierarchical march the shared buffer of N*S
slots (``global_slots_per_ray`` S > 0, which the budget tuner engages)
that K5 packs from the (N, B) selection, on the flat march K5's exact
packing of every valid candidate into N*B slots. ``render_dense`` is the
pure-tensor renderer: uniform depths, optional importance upsampling, K3
with no mask. Both are differentiable in the field's parameters (K2, K3 and
K3c backward).
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
from .._device import DeviceLike, resolve_device
from ..kernels import _build
from ..ops import raymarch as RM
from ..ops.raymarch import _inv

__all__ = ["RenderConfig", "OccupancyState", "init_occupancy", "update_density_grid",
           "occupancy_upkeep", "occupancy_upkeep_plain", "occupancy_rebuild",
           "occupancy_rebuild_plain", "rebuild_threshold", "tuned_num_coarse",
           "mark_untrained_grid", "render_dense", "render_occgrid"]


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
        sample cap: ``bound * steps`` at constant dt; on the dt_gamma ladder
        its closed-form worst case (a ray entering at min_near and crossing
        the full diagonal)."""
        if self.dt_gamma <= 0.0:
            return int(math.ceil(self.bound * steps))
        dt_min, dt_max = RM._step_bounds(steps, self.grid_size, self.cascades)
        return RM.worst_case_ladder_steps(2.0 * self.bound * RM.SQRT3, self.min_near, dt_min,
                                          dt_max, self.dt_gamma)

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
    returns the initial (CAS, H^3) density grid (0 where covered, -1 else).

    The JAX package projects 16 cameras at a time through one einsum over a
    (16, H^3, 3) array; here each camera's coordinates are three
    multiply-adds over the cells, about 4x faster (21 s -> 4.7 s for 30
    cameras at 128^3 x 2 cascades on an 8-core host); the coverage is the
    JAX package's (tests/test_torch_culling.py)."""
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
        for P in poses:
            c = pts - P[:3, 3]
            x, y, z = (c[:, 0] * P[0, d] + c[:, 1] * P[1, d] + c[:, 2] * P[2, d] for d in range(3))
            covered |= (z > 0) & (np.abs(x) < cx / fx * z + half * 2) & (np.abs(y) < cy / fy * z + half * 2)
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


_K6_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2
            + [ctypes.c_float] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_float]
            + [ctypes.c_void_p] * 8)
_K6_MAX_CAS = 8
# (device, stream) -> K6's int32 scratch (the two launches' tickets, the
# per-cascade min / max indices)
_k6_scratch: dict = {}


def _k6_launch(density_grid, cfg, entry, argtypes, what, args):
    """The frame both K6 entries share: checks the grid, allocates occ,
    occ_coarse, the stats and the bbox, takes the stream's scratch and calls
    ``entry`` with ``args(outputs, geometry, scratch)`` and the stream.
    ``outputs`` are the four outputs' pointers, ``geometry`` the dilation
    radius, the per-cascade bounds and cell sizes and the bound. A failed
    launch drops the scratch (it may be left dirty) and raises. Returns
    (occ, occ_coarse, stats, bbox)."""
    H, C = cfg.grid_size, cfg.cascades
    dev = density_grid.device
    if C > _K6_MAX_CAS or tuple(density_grid.shape) != (C, H**3) or density_grid.dtype != torch.float32:
        raise ValueError(f"{what}: density_grid must be ({C}, {H**3}) f32 with at most "
                         f"{_K6_MAX_CAS} cascades, got {tuple(density_grid.shape)} {density_grid.dtype}")
    occ = torch.empty((C, H, H, H), device=dev, dtype=torch.bool)
    occ_coarse = torch.empty_like(occ)
    stats = torch.empty((2,), device=dev, dtype=torch.float32)
    bbox = torch.empty((6,), device=dev, dtype=torch.float32)
    bounds = [min(2**c, cfg.bound) for c in range(C)]
    geometry = (cfg.coarse_dilation_radius, (ctypes.c_float * C)(*bounds),
                (ctypes.c_float * C)(*[2.0 * b / H for b in bounds]), float(cfg.bound))
    words = _build.function("occupancy", "occ_scratch_words", [])
    key, scratch = _build.stream_scratch(_k6_scratch, dev, int(words()), torch.int32)
    P = _build.ptr
    fn = _build.function("occupancy", entry, argtypes)
    code = fn(*args((P(occ), P(occ_coarse), P(stats), P(bbox)), geometry, P(scratch)),
              _build.stream(dev))
    if code != 0:
        _k6_scratch.pop(key, None)
    _build.check(code, what)
    kernels.launches["occupancy"] += 2
    return occ, occ_coarse, stats, bbox


def _occupancy_upkeep_cuda(density_grid, tmp, offset, cfg, decay):
    """Two launches: merge and mean; threshold, dilation and bbox."""
    H, C = cfg.grid_size, cfg.cascades
    n = H**3
    dev = density_grid.device
    S = tmp.shape[1]
    if (tmp.device != dev or tmp.dim() != 2 or tmp.shape[0] != C or not 0 <= offset <= n - S):
        raise ValueError(f"occupancy_upkeep: tmp must be ({C}, S) on {dev} with 0 <= offset <= "
                         f"{n} - S, got {tuple(tmp.shape)} on {tmp.device}, offset {offset}")
    old = density_grid.contiguous()
    tmp = tmp.float().contiguous()
    new_grid = torch.empty_like(old)
    partial_words = _build.function("occupancy", "occ_partial_words",
                                    [ctypes.c_int, ctypes.c_longlong], restype=ctypes.c_longlong)
    partial = torch.empty((int(partial_words(C, n)),), device=dev, dtype=torch.float32)
    P = _build.ptr
    occ, occ_coarse, stats, bbox = _k6_launch(
        old, cfg, "occ_upkeep_launch", _K6_ARGS, "occupancy_upkeep",
        lambda out, geometry, scratch: (
            P(old), P(tmp), C, H, S, offset, float(decay), float(cfg.density_thresh),
            float(cfg.occ_thresh_scale), *geometry, P(new_grid), *out, P(partial), scratch))
    return new_grid, occ, occ_coarse, stats[0], bbox


def rebuild_threshold(mean_density: float, cfg: RenderConfig) -> float:
    """A checkpoint's occupancy threshold from its stored mean, as the JAX
    package's ``load_checkpoint`` computes it: min(mean, density_thresh) *
    occ_thresh_scale in float64, compared in float32."""
    return float(np.float32(min(float(mean_density), cfg.density_thresh) * cfg.occ_thresh_scale))


def occupancy_rebuild_plain(density_grid: torch.Tensor, mean_density: float, cfg: RenderConfig):
    """Plain version of K6's rebuild: a stored density_grid (CAS, H^3) f32
    and its stored mean -> (occ (CAS, H, H, H) bool, occ_coarse, bbox (6,)
    f32), thresholded at ``rebuild_threshold``."""
    H, C = cfg.grid_size, cfg.cascades
    occ = (density_grid > rebuild_threshold(mean_density, cfg)).reshape(C, H, H, H)
    return occ, _dilate3(occ, cfg.coarse_dilation_radius), _occupied_bbox(occ, cfg)


def occupancy_rebuild(density_grid: torch.Tensor, mean_density: float, cfg: RenderConfig):
    """Kernel K6's threshold, dilation and bbox on a CUDA grid (no merge: the
    threshold comes from the stored mean), the plain version on a CPU one."""
    if density_grid.is_cuda:
        return _occupancy_rebuild_cuda(density_grid, mean_density, cfg)
    return occupancy_rebuild_plain(density_grid, mean_density, cfg)


_K6_REBUILD_ARGS = ([ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_float] + [ctypes.c_void_p] * 6)


def _occupancy_rebuild_cuda(density_grid, mean_density, cfg):
    """Two launches: the reset; threshold, dilation and bbox."""
    H, C = cfg.grid_size, cfg.cascades
    grid = density_grid.contiguous()
    occ, occ_coarse, _, bbox = _k6_launch(
        grid, cfg, "occ_rebuild_launch", _K6_REBUILD_ARGS, "occupancy_rebuild",
        lambda out, geometry, scratch: (
            _build.ptr(grid), C, H, float(mean_density), rebuild_threshold(mean_density, cfg),
            *geometry, *out, scratch))
    return occ, occ_coarse, bbox


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


def _background(rays_o: torch.Tensor, rays_d: torch.Tensor, bg_color, bg_fn,
                cfg: RenderConfig) -> torch.Tensor:
    """(N, 3) background: with ``cfg.bg_radius > 0`` and a ``bg_fn(sph,
    dirs)`` (the field's background network) its colour where each ray
    leaves the sphere; else white by default, a scalar grey, or given
    colours."""
    if cfg.bg_radius > 0 and bg_fn is not None:
        return bg_fn(RM.sph_from_ray(rays_o, rays_d, cfg.bg_radius), rays_d)
    if bg_color is None:
        bg_color = 1.0
    if isinstance(bg_color, (int, float)):
        return torch.full((rays_o.shape[0], 3), float(bg_color), dtype=torch.float32,
                          device=rays_o.device)
    return bg_color


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """jnp.linspace in float32: start (1 - s) + stop s with s = i * f32(1 /
    (num - 1)) (jit's reciprocal), the last entry exactly stop."""
    s = np.arange(num, dtype=np.float32) * (np.float32(1.0) / np.float32(num - 1))
    out = np.float32(start) * (np.float32(1.0) - s) + np.float32(stop) * s
    out[-1] = np.float32(stop)
    return torch.from_numpy(out).to(device)


def _ray_weights(sigmas: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """alpha_i prod_{j<i} (1 - alpha_j + 1e-15), alpha = 1 - exp(-sigma
    delta): composite_dense's weights (K3 on CUDA)."""
    zeros = torch.zeros_like(sigmas)
    rgbs = torch.zeros(sigmas.shape + (3,), dtype=sigmas.dtype, device=sigmas.device)
    return RM.composite_dense(sigmas, rgbs, deltas, zeros)[3]


def render_dense(
    density_fn: Callable,     # pts (M, 3) -> (sigma (M,), geo (M, G))
    color_fn: Callable,       # (dirs (M, 3), geo) -> rgb (M, 3)
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    cfg: RenderConfig,
    bg_color=None,
    bg_fn: Optional[Callable] = None,
    perturb: bool = False,
    jitter: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    occ: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Pure-tensor volume rendering: T = ``num_steps`` uniform depths over
    each ray's [near, far] in the scene box and, with ``upsample_steps`` t >
    0, t more placed by inverse CDF (``sample_pdf``) from the weights of the
    uniform pass (its sigmas detached, K3 forward) and merged in depth order
    (a stable sort: a new depth equal to an old one lands after it). K3
    composites all T + t samples with no mask.

    With ``perturb`` the uniform depths move by (jitter - 0.5) (far - near)
    / T and the new ones are drawn at ``u``: ``jitter`` (N, T) and ``u``
    (N, t), U[0, 1), are drawn from ``generator`` in that order when absent;
    without it u is the midpoint linspace. ``occ`` with
    ``cfg.occ_mask_dense`` zeroes sigma where the occupancy cell is off (a
    diagnostic). ``bg_fn`` as in ``render_occgrid``. Returns image, depth
    (the weighted mean of the normalised depth), weights_sum and
    z_variance."""
    N = rays_o.shape[0]
    T = cfg.num_steps
    dev = rays_o.device
    aabb = torch.tensor(cfg.aabb, dtype=torch.float32, device=dev)
    nears, fars = RM.near_far_from_aabb(rays_o, rays_d, aabb, cfg.min_near)
    hit = nears < 1e30
    nears = torch.where(hit, nears, 0.0)[:, None]
    fars = torch.where(hit, fars, 1e-3)[:, None]
    z_vals = nears + (fars - nears) * _linspace(0.0, 1.0, T, dev)[None, :]
    sample_dist = (fars - nears) * _inv(T)  # jit's / T
    if perturb:
        if jitter is None:
            jitter = _uniform((N, T), generator, dev)
        z_vals = z_vals + (jitter.to(dev, torch.float32) - 0.5) * sample_dist

    def pts_of(z):
        return (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).clamp(-cfg.bound, cfg.bound)

    sigmas, geos = density_fn(pts_of(z_vals).reshape(-1, 3))
    sigmas = sigmas.reshape(N, T)
    if cfg.upsample_steps > 0:
        t = cfg.upsample_steps
        with torch.no_grad():
            deltas = torch.cat([torch.diff(z_vals, dim=-1), sample_dist], -1)
            weights = _ray_weights(cfg.density_scale * sigmas.detach(), deltas)
            z_mid = z_vals[:, :-1] + 0.5 * deltas[:, :-1]
            if perturb:
                u = (_uniform((N, t), generator, dev) if u is None else u).to(dev, torch.float32)
            else:
                u = _linspace(0.5 / t, 1 - 0.5 / t, t, dev).expand(N, t)
            new_z = RM.sample_pdf(z_mid, weights[:, 1:-1], t, u)
        new_sig, new_geo = density_fn(pts_of(new_z).reshape(-1, 3))
        z_vals, order = torch.sort(torch.cat([z_vals, new_z], -1), dim=-1, stable=True)
        sigmas = torch.cat([sigmas, new_sig.reshape(N, t)], -1).gather(1, order)
        G = geos.shape[-1]
        geos = torch.cat([geos.reshape(N, T, G), new_geo.reshape(N, t, G)], 1)
        geos = geos.gather(1, order[..., None].expand(N, T + t, G)).reshape(N * (T + t), G)
        T = T + t

    deltas = torch.cat([torch.diff(z_vals, dim=-1), sample_dist], -1)
    if cfg.occ_mask_dense and occ is not None:
        occ_ok = RM.occupancy_lookup(occ, pts_of(z_vals), sample_dist.expand(N, T),
                                     grid_size=cfg.grid_size, cascades=cfg.cascades, bound=cfg.bound)
        sigmas = torch.where(occ_ok, sigmas, 0.0)
    dirs = rays_d[:, None, :].expand(N, T, 3)
    rgbs = color_fn(dirs.reshape(-1, 3), geos).reshape(N, T, 3)
    ori_z = torch.clamp((z_vals - nears) / (fars - nears), 0, 1)
    ws, depth, image, weights = RM.composite_dense(cfg.density_scale * sigmas, rgbs, deltas, ori_z)
    image = image + (1.0 - ws)[:, None] * _background(rays_o, rays_d, bg_color, bg_fn, cfg)
    mean_z = depth / torch.clamp_min(ws, 1e-8)
    z_var = (weights * (ori_z - mean_z[:, None]) ** 2).sum(-1) / torch.clamp_min(ws, 1e-8)
    return {"image": image, "depth": depth, "weights_sum": ws, "z_variance": z_var}


def _residual_T(flagged: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Mean residual transmittance 1 - ws over the flagged rays (0 when none)."""
    n = flagged.sum()
    return torch.where(n > 0, torch.where(flagged, 1.0 - ws, 0.0).sum()
                       / torch.clamp_min(n, 1).float(), 0.0)


def _shard_slots(ray_gather, mask: torch.Tensor, slots: int):
    """A data shard's part of the global layout's buffer: the shards'
    valid counts are gathered (the host reads them) and this shard keeps the
    samples that fall inside the global batch's ``slots`` x shards buffer
    at its place in row order, as one process's buffer keeps them. Returns
    (slots kept here, the buffer's mask (all False when none is kept), the
    global buffer's kept count, its size)."""
    counts = [int(c) for c in ray_gather(mask.sum().reshape(1).float()).cpu().tolist()]
    cap = slots * len(counts)
    keep = max(0, min(counts[ray_gather.index], cap - sum(counts[:ray_gather.index])))
    return keep, (mask if keep else torch.zeros_like(mask)), min(sum(counts), cap), cap


def _composite_per_ray(field_fn, rays_o, rays_d, t, dt, mask, t0, cfg: RenderConfig):
    """The field on the (N, B) layout's points and the dense compositor at
    the early-exit threshold; ts accumulate relative to the ray start t0.
    Returns (ws, depth_raw, image, z_var, weights, ts_rel)."""
    N, B = t.shape
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]).clamp(-cfg.bound, cfg.bound)
    dirs = rays_d[:, None, :].expand(pts.shape)
    sigmas, rgbs = field_fn(pts.reshape(-1, 3), dirs.reshape(-1, 3))
    ts_rel = torch.where(mask, t + dt - t0[:, None], 0.0)
    ws, depth_raw, image, weights = RM.composite_dense(
        cfg.density_scale * sigmas.reshape(N, B), rgbs.reshape(N, B, 3), dt, ts_rel, mask=mask,
        t_thresh=cfg.t_thresh)
    mean_z = depth_raw / torch.clamp_min(ws, 1e-8)
    z_var = (weights * (ts_rel - mean_z[:, None]) ** 2).sum(-1) / torch.clamp_min(ws, 1e-8)
    return ws, depth_raw, image, z_var, weights, ts_rel


def _composite_global(field_fn, comp: RM.CompactSamples, N: int, cfg: RenderConfig):
    """The field on a packed buffer (padding slots included, at xyz = dir =
    0) and the compact compositor. Returns (ws, depth_raw, image, z_var)."""
    sigmas, rgbs = field_fn(comp.xyzs, comp.dirs)
    return RM.composite_compact(cfg.density_scale * sigmas, rgbs, comp, N, cfg.t_thresh)


def _render_hierarchical(field_fn, rays_o, rays_d, nears, fars, hit, occ, occ_coarse, noise,
                         cfg: RenderConfig, with_stats: bool, ray_gather=None):
    """K1, then the per-ray layout or the S-slot global buffer (K5 + K3c)."""
    N = rays_o.shape[0]
    steps = cfg.max_steps
    B = cfg.samples_per_ray_budget
    Fc = cfg.fine_per_coarse
    num_coarse = cfg.num_coarse_override or int(math.ceil(cfg.bound * steps / Fc))
    t, dt_scalar, mask, stride, seg_lastocc = RM.march_hierarchical(
        rays_o, rays_d, nears, fars, occ, occ_coarse, noise,
        num_coarse=num_coarse, fine_per_coarse=Fc, coarse_budget=cfg.coarse_budget,
        budget=B, max_steps=steps, grid_size=cfg.grid_size, cascades=cfg.cascades,
        bound=cfg.bound, occ_test_stride=cfg.resolved_occ_test_stride(),
        coarse_test_stride=cfg.resolved_coarse_test_stride())
    dt = torch.where(mask, dt_scalar * stride[:, None], 0.0)
    t0 = nears + dt_scalar * noise
    demand = mask.sum(-1).float() * stride
    capped = demand > B
    span_ray = torch.where(hit, fars - nears, 0.0)
    span_capped = span_ray > (num_coarse * Fc) * (2.0 * RM.SQRT3 / steps) * 0.995
    stats = {"num_samples": mask.sum()}
    needed_seg = seg_lastocc
    if cfg.compaction == "global":
        slots = N * cfg.global_slots_per_ray
        cmask = mask
        if ray_gather is not None:
            keep, cmask, kept, cap = _shard_slots(ray_gather, mask, slots)
            slots = max(keep, 1)
        comp = RM.compact_global_dense(rays_o, rays_d, t, dt, cmask, t0, m_budget=slots,
                                       bound=cfg.bound)
        ws, depth_raw, image, z_var = _composite_global(field_fn, comp, N, cfg)
        stats["num_samples"] = comp.num_valid
        stats["global_fill"] = comp.num_valid.float() / slots
        if ray_gather is not None:
            stats["num_samples"] = torch.tensor(kept, dtype=torch.int32, device=rays_o.device)
            stats["global_fill"] = torch.tensor(kept / cap, dtype=torch.float32, device=rays_o.device)
    else:
        ws, depth_raw, image, z_var, weights, ts_rel = _composite_per_ray(
            field_fn, rays_o, rays_d, t, dt, mask, t0, cfg)
        if with_stats:
            # saturation-aware demand span: a saturated ray needs only the
            # span up to its last contributing sample
            with torch.no_grad():
                t_sat = torch.where(weights > 0, ts_rel, 0.0).amax(dim=1)
                saturated = ws > 1.0 - 10.0 * cfg.t_thresh
                needed_seg = torch.where(saturated, torch.minimum(
                    t_sat / (dt_scalar * Fc) + 2.0, seg_lastocc), seg_lastocc)
    ws_rays = ws
    if ray_gather is not None:
        # the global batch's statistics: every data shard's rays, in order
        cols = ray_gather(torch.stack([demand, span_ray, needed_seg.float(), ws.detach(),
                                       mask.sum(-1).float()], 1))
        demand, span_ray, needed_seg, ws_rays, kept = cols.unbind(1)
        N = cols.shape[0]
        capped = demand > B
        span_capped = span_ray > (num_coarse * Fc) * (2.0 * RM.SQRT3 / steps) * 0.995
        if cfg.compaction != "global":
            stats["num_samples"] = kept.sum()
    if with_stats:
        # all three p99s from one sort
        with torch.no_grad():
            stats3 = torch.sort(torch.stack([demand, span_ray, needed_seg]), dim=1).values
        qi = int(round(0.99 * (N - 1)))
        stats["samples_p99"] = stats3[0, qi]
        stats["span_p99"] = stats3[1, qi]
        stats["needed_seg_p99"] = stats3[2, qi]
    stats["overflow_frac"] = capped.float().mean()
    stats["samples_mean"] = demand.mean()
    stats["trunc_T"] = _residual_T(capped, ws_rays)
    stats["span_trunc_T"] = _residual_T(span_capped, ws_rays)
    return ws, depth_raw, image, z_var, stats


def _render_flat(field_fn, rays_o, rays_d, nears, fars, occ, noise, cfg: RenderConfig,
                 with_stats: bool, ray_gather=None):
    """K1f on ``num_candidates`` candidates, then the per-ray layout, or the
    exact global compaction of every valid candidate into N*B slots (K5 +
    K3c; no statistics, as in the JAX package)."""
    N = rays_o.shape[0]
    B = cfg.samples_per_ray_budget
    kw = dict(num_steps=cfg.num_candidates, max_steps=cfg.max_steps, grid_size=cfg.grid_size,
              cascades=cfg.cascades, bound=cfg.bound, dt_gamma=cfg.dt_gamma)
    if cfg.compaction == "global":
        march = RM.march_flat_candidates(rays_o, rays_d, nears, fars, occ, noise, **kw)
        slots = N * B
        if ray_gather is not None:
            keep, valid_mask, kept, _ = _shard_slots(ray_gather, march.valid, slots)
            march, slots = march._replace(valid=valid_mask), max(keep, 1)
        comp = RM.compact_samples(rays_o, rays_d, march, m_budget=slots, bound=cfg.bound)
        ws, depth_raw, image, z_var = _composite_global(field_fn, comp, N, cfg)
        valid = comp.num_valid
        if ray_gather is not None:
            valid = torch.tensor(kept, dtype=torch.int32, device=rays_o.device)
        return ws, depth_raw, image, z_var, {"num_samples": valid}
    t, dt, mask, stride, t0 = RM.march_flat(rays_o, rays_d, nears, fars, occ, noise, budget=B,
                                            **kw)
    dt = torch.where(mask, dt * stride[:, None], 0.0)
    ws, depth_raw, image, z_var, _, _ = _composite_per_ray(field_fn, rays_o, rays_d, t, dt, mask,
                                                           t0, cfg)
    demand = mask.sum(-1).float() * stride
    stats = {"num_samples": mask.sum()}
    ws_rays = ws
    if ray_gather is not None:  # the global batch's statistics
        cols = ray_gather(torch.stack([demand, ws.detach(), mask.sum(-1).float()], 1))
        demand, ws_rays, kept = cols.unbind(1)
        stats["num_samples"] = kept.sum()
    capped = demand > B
    if with_stats:
        with torch.no_grad():
            stats["samples_p99"] = torch.quantile(demand, 0.99)
    stats["overflow_frac"] = capped.float().mean()
    stats["samples_mean"] = demand.mean()
    stats["trunc_T"] = _residual_T(capped, ws_rays)
    return ws, depth_raw, image, z_var, stats


def render_occgrid(
    field_fn: Callable,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    occ: torch.Tensor,
    cfg: RenderConfig,
    noise: Optional[torch.Tensor] = None,
    bg_color=None,
    bg_fn: Optional[Callable] = None,
    occ_coarse: Optional[torch.Tensor] = None,
    occ_bbox: Optional[torch.Tensor] = None,
    with_stats: bool = True,
    ray_gather: Optional[Callable] = None,
) -> Dict[str, torch.Tensor]:
    """March + field + composite. The hierarchical march runs when
    ``march="hierarchical"``, ``dt_gamma == 0``, ``occ_coarse`` is given and
    the layout is not the slot-less global one (the JAX package's
    predicate); else the flat march.

    ``field_fn(xyzs (M, 3), dirs (M, 3)) -> (sigma (M,), rgb (M, 3))``.
    ``noise`` (N,) in [0, 1) perturbs the ray starts (the JAX package's
    ``perturb``; tests inject it); None renders unperturbed, as serving does.
    ``bg_fn(sph (N, 2), dirs (N, 3)) -> rgb (N, 3)`` (e.g.
    ``NeRFField.background``) colours the background where the rays leave
    the sphere of ``cfg.bg_radius`` when that is > 0; else ``bg_color``.
    Returns image, depth, weights_sum, z_variance and num_samples, then the
    JAX package's statistics for the branch taken:
    * hierarchical: overflow_frac, samples_mean, trunc_T, span_trunc_T;
      with ``with_stats`` the sorted p99s samples_p99, span_p99,
      needed_seg_p99; on the S-slot global buffer global_fill (the buffer's
      use; num_samples is then the slots kept);
    * flat, per-ray: overflow_frac, samples_mean, trunc_T; with
      ``with_stats`` samples_p99 (linearly interpolated);
    * flat, exact global: none.
    ``ray_gather(t (N, k)) -> (N_total, k)`` (a data rank's gather over
    its group, in the global batch's order; ``ray_gather.index`` is this
    rank's place in it) makes every statistic the global batch's, and on
    the global layouts each rank keeps the samples that one process's
    buffer of the global batch keeps (``_shard_slots``)."""
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
    hierarchical = (cfg.march == "hierarchical" and cfg.dt_gamma == 0.0 and occ_coarse is not None
                    and (cfg.compaction != "global" or cfg.global_slots_per_ray > 0))
    if hierarchical:
        ws, depth_raw, image, z_var, stats = _render_hierarchical(
            field_fn, rays_o, rays_d, nears_c, fars_c, hit, occ, occ_coarse, noise, cfg, with_stats,
            ray_gather)
    else:
        ws, depth_raw, image, z_var, stats = _render_flat(
            field_fn, rays_o, rays_d, nears_c, fars_c, occ, noise, cfg, with_stats, ray_gather)
    image = image + (1.0 - ws)[:, None] * _background(rays_o, rays_d, bg_color, bg_fn, cfg)
    # ts are relative to the (perturbed) ray start, so depth_raw already is
    # "depth - near"
    depth = torch.clamp_min(depth_raw, 0.0) / torch.clamp_min(fars - nears, 1e-6)
    return {"image": image, "depth": depth, "weights_sum": ws, "z_variance": z_var, **stats}
