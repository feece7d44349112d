"""Occupancy-grid ray marching and volume compositing (port of
``trinerflet_tpu/ops/raymarch.py``, the serving path's part).

``march_hierarchical`` is the two-level occupancy march (with the training
path's strided probes); ``march_flat`` the flat candidate march on the
``dt_gamma`` ladder (``dt_ladder``), which either selects each ray's
samples itself (the per-ray layout) or returns every candidate
(``MarchResults``, for the exact global compaction); ``composite_dense``
the per-ray compositor, an autograd function whose backward is the analytic
reverse pass. ``compact_global_dense`` / ``compact_samples`` pack the kept
samples into a shared ray-major buffer (the global layout) and
``composite_compact`` composites that buffer, again with an analytic
backward. On CUDA tensors they launch kernels K1 (``kernels/csrc/march.cu``),
K1f (``kernels/csrc/march_flat.cu``), K3 forward and backward
(``kernels/csrc/composite.cu``), K5 and the compact compositor's forward and
backward (``kernels/csrc/compact.cu``); on CPU tensors they run the plain
versions below.

Arithmetic the marches reproduce bit for bit: the JAX package runs them
inside ``jax.jit``, where XLA contracts ``a*b + c`` into one fused
multiply-add and turns a division by a static constant into a
multiplication by its float32 reciprocal. The plain versions state those
rounding points explicitly (``_fma``, ``_inv``) and K1 and K1f use ``fmaf``
at the same places, so ``mask`` agrees bit for bit across the three (on the
ladder up to the last ulp of ``exp`` and ``log``, see ``dt_ladder``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..kernels import _build
from .activation import plain_exp

__all__ = [
    "SQRT3",
    "near_far_from_aabb",
    "sph_from_ray",
    "occupancy_index",
    "occupancy_lookup",
    "first_k_valid",
    "march_hierarchical",
    "march_hierarchical_plain",
    "dt_ladder",
    "worst_case_ladder_steps",
    "march_candidates_plain",
    "compact_per_ray",
    "march_flat",
    "march_flat_plain",
    "march_flat_candidates",
    "composite_dense",
    "composite_dense_plain",
    "composite_dense_backward_plain",
    "MarchResults",
    "CompactSamples",
    "PAD_RAY_ID",
    "compact_global_dense",
    "compact_global_dense_plain",
    "compact_samples",
    "composite_compact",
    "composite_compact_plain",
    "composite_compact_backward_plain",
    "sample_pdf",
]

SQRT3 = 1.7320508075688772


def _f32(x: float) -> float:
    """A Python float rounded to float32 (how a constant enters f32 math)."""
    return float(np.float32(x))


def _inv(n: float) -> float:
    """float32 reciprocal of a static divisor, as XLA folds ``x / n``."""
    return float(np.float32(1.0) / np.float32(n))


def _fma(a, b, c) -> torch.Tensor:
    """``a*b + c`` rounded once to float32 (a fused multiply-add): the f32
    product is exact in float64, so only the final sum rounds."""
    def d(x):
        return x.double() if torch.is_tensor(x) else _f32(x)
    return (d(a) * d(b) + d(c)).float()


# ---------------------------------------------------------------------------
# Ray <-> scene intersections
# ---------------------------------------------------------------------------

def near_far_from_aabb(
    rays_o: torch.Tensor, rays_d: torch.Tensor, aabb: torch.Tensor, min_near: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test against aabb (6,) = (xmin, ymin, zmin, xmax, ymax, zmax).
    Missing rays get near == far == 3.4e38."""
    eps = 1e-15
    rd = rays_d + torch.where(rays_d.abs() < eps, eps, 0.0)
    inv_d = 1.0 / rd
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    miss = tmin > tmax
    near = torch.clamp_min(tmin, min_near)
    return torch.where(miss, 3.4e38, near), torch.where(miss, 3.4e38, tmax)


def sph_from_ray(rays_o: torch.Tensor, rays_d: torch.Tensor, radius: float) -> torch.Tensor:
    """Where each ray leaves the background sphere of ``radius``, as
    (theta, phi) normalised to [-1, 1] (y up): (N, 2)."""
    a = (rays_d * rays_d).sum(-1)
    b = (rays_o * rays_d).sum(-1)
    c = (rays_o * rays_o).sum(-1) - radius * radius
    t = (-b + torch.sqrt(torch.clamp_min(b * b - a * c, 0.0))) / a
    p = rays_o + t[:, None] * rays_d
    x, y, z = p.unbind(-1)
    theta = torch.atan2(torch.sqrt(x * x + z * z), y)  # [0, pi)
    phi = torch.atan2(z, x)  # [-pi, pi)
    return torch.stack([2 * theta / math.pi - 1, phi / math.pi], dim=-1)


# ---------------------------------------------------------------------------
# Occupancy addressing
# ---------------------------------------------------------------------------

def _mip_level(pts: torch.Tensor, dts: torch.Tensor, grid_size: int, cascades: int) -> torch.Tensor:
    """max(frexp exponent of max|coord|, of dt*H/2), clamped to [0, CAS-1]."""
    mx = pts.abs().amax(dim=-1)
    e_pos = torch.frexp(torch.clamp_min(mx, 1e-30)).exponent
    e_dt = torch.frexp(torch.clamp_min(dts * grid_size * 0.5, 1e-30)).exponent
    return torch.maximum(e_pos, e_dt).clamp(0, cascades - 1).long()


def occupancy_index(pts: torch.Tensor, dts: torch.Tensor, *, grid_size: int, cascades: int,
                    bound: float) -> torch.Tensor:
    """The march's cell-addressing law: the flat index into a (CAS, H, H, H)
    grid of the cell holding each world point. int64 of pts' leading shape."""
    lvl = _mip_level(pts, dts, grid_size, cascades)
    mip_bound = torch.clamp_max(torch.exp2(lvl.float()), bound)
    q = 0.5 * (pts / mip_bound[..., None] + 1.0) * grid_size
    q = q.clamp(0.0, grid_size - 1).long()
    return ((lvl * grid_size + q[..., 0]) * grid_size + q[..., 1]) * grid_size + q[..., 2]


def occupancy_lookup(
    grid_bool: torch.Tensor, pts: torch.Tensor, dts: torch.Tensor, *,
    grid_size: int, cascades: int, bound: float,
) -> torch.Tensor:
    """Occupancy test of world points against a (CAS, H, H, H) bool grid.
    Returns bool of pts' leading shape."""
    flat = occupancy_index(pts, dts, grid_size=grid_size, cascades=cascades, bound=bound)
    return grid_bool.reshape(-1)[flat]


def first_k_valid(valid: torch.Tensor, budget: int, spread: bool = False,
                  payload: Optional[torch.Tensor] = None):
    """Per-row selection of ``budget`` True entries of ``valid`` (N, K).

    ``spread=False`` keeps the first ``budget``; ``spread=True`` with more
    than ``budget`` valid entries keeps the evenly spread ranks
    ``ceil(b * count / budget)``, b = 1..budget (the JAX package's law, kept
    on purpose: truncating to the first samples would confine a dense grid's
    supervision to a shell at the ray entry). Returns ``(idx (N, budget),
    mask (N, budget), stride (N,))`` where stride = count/budget for rays
    over budget, else 1 [, payload taken at idx].
    """
    N, K = valid.shape
    pos = torch.arange(K, device=valid.device).expand(N, K)
    keys = torch.where(valid, pos, K)
    sorted_pos, order = torch.sort(keys, dim=1, stable=True)
    count = valid.sum(dim=1, keepdim=True)
    b1 = torch.arange(1, budget + 1, device=valid.device).expand(N, budget)
    if spread:
        over = count > budget
        inv = _inv(budget)
        even = torch.ceil(b1.float() * count.float() * inv)
        tgt = torch.where(over, even.long(), b1)
        stride = torch.where(over[:, 0], count[:, 0].float() * inv, 1.0)
    else:
        tgt = b1
        stride = torch.ones((N,), dtype=torch.float32, device=valid.device)
    src = torch.clamp(tgt - 1, 0, K - 1)
    mask = b1 <= count
    idx = torch.clamp_max(sorted_pos.gather(1, src), K - 1)
    if payload is None:
        return idx, mask, stride
    return idx, mask, stride, payload.gather(1, order.gather(1, src))


# ---------------------------------------------------------------------------
# Hierarchical march (K1)
# ---------------------------------------------------------------------------

def march_hierarchical_plain(
    rays_o: torch.Tensor, rays_d: torch.Tensor, nears: torch.Tensor, fars: torch.Tensor,
    occ: torch.Tensor, occ_coarse: torch.Tensor, noise: torch.Tensor, *,
    num_coarse: int, fine_per_coarse: int, coarse_budget: int, budget: int,
    max_steps: int, grid_size: int = 128, cascades: int = 1, bound: float = 1.0,
    occ_test_stride: int = 1, coarse_test_stride: int = 1,
):
    """Plain version of K1. Level 1 tests ``num_coarse`` segment midpoints
    (segment = F*dt) against the dilated grid and spread-keeps
    ``coarse_budget`` occupied segments; level 2 tests their F candidates
    each against the fine grid and spread-keeps ``budget``.

    Strided tests (training): with ``coarse_test_stride`` cs > 1 one probe
    at the centre of each group of cs segments, ``t0 + seg*(cs*k + cs/2)``,
    stands for the group; with ``occ_test_stride`` s > 1 one probe per s
    fine candidates, ``t_seg0 + dt*(s*k + (s-1)/2)``. Each probe's result is
    repeated over its group (``repeat(occ_p, s)[:F]``, nearest probe).

    Returns (t (N, budget) f32, 0 where masked; dt () f32; mask (N, budget)
    bool; stride (N,) f32 = seg_stride * fine_stride; seg_lastocc (N,) f32,
    the 1-based index of the last occupied segment, 0 when none)."""
    dt_py = 2.0 * SQRT3 / max_steps
    seg_py = dt_py * fine_per_coarse
    dt = _f32(dt_py)
    half_seg = _f32(0.5 * seg_py)
    dev = rays_o.device
    t0 = _fma(dt, noise, nears)

    def lookup(grid, t):  # t (N, ...) -> occupancy of o + d*t, clipped to the bound
        sh = (-1,) + (1,) * (t.dim() - 1) + (3,)
        p = _fma(rays_d.reshape(sh), t[..., None], rays_o.reshape(sh)).clamp(-bound, bound)
        return occupancy_lookup(grid, p, torch.full_like(t, dt), grid_size=grid_size,
                                cascades=cascades, bound=bound)

    kc = torch.arange(num_coarse, dtype=torch.float32, device=dev)
    t_mid = _fma(seg_py, kc[None, :], t0[:, None]) + half_seg
    if coarse_test_stride > 1:
        cs = coarse_test_stride
        kp = torch.arange(-(-num_coarse // cs), dtype=torch.float32, device=dev)
        t_pm = _fma(seg_py, cs * kp[None, :] + 0.5 * cs, t0[:, None])  # exact group centres
        occ_c = lookup(occ_coarse, t_pm).repeat_interleave(cs, dim=-1)[:, :num_coarse]
    else:
        occ_c = lookup(occ_coarse, t_mid)
    valid_c = occ_c & ((t_mid - half_seg) < fars[:, None])
    seg_pos = torch.arange(1, num_coarse + 1, device=dev)
    seg_lastocc = torch.where(valid_c, seg_pos, 0).amax(dim=1).float()
    seg_idx, seg_mask, seg_stride = first_k_valid(valid_c, coarse_budget, spread=True)

    t_seg0 = _fma(seg_py, seg_idx.float(), t0[:, None])
    kf = torch.arange(fine_per_coarse, dtype=torch.float32, device=dev)
    t_f = _fma(dt, kf[None, None, :], t_seg0[..., None])
    if occ_test_stride > 1:
        s = occ_test_stride
        kp = torch.arange(-(-fine_per_coarse // s), dtype=torch.float32, device=dev)
        t_p = _fma(dt, s * kp[None, None, :] + 0.5 * (s - 1), t_seg0[..., None])
        occ_f = lookup(occ, t_p).repeat_interleave(s, dim=-1)[..., :fine_per_coarse]
    else:
        occ_f = lookup(occ, t_f)
    valid_f = occ_f & seg_mask[..., None] & (t_f < fars[:, None, None])
    N = rays_o.shape[0]
    valid_f = valid_f.reshape(N, coarse_budget * fine_per_coarse)
    t_f = t_f.reshape(N, coarse_budget * fine_per_coarse)
    _, mask, fine_stride, t = first_k_valid(valid_f, budget, spread=True, payload=t_f)
    t = torch.where(mask, t, 0.0)
    return (t, torch.full((), dt, dtype=torch.float32, device=dev), mask,
            seg_stride * fine_stride, seg_lastocc)


def march_hierarchical(
    rays_o, rays_d, nears, fars, occ, occ_coarse, noise, *,
    num_coarse: int, fine_per_coarse: int, coarse_budget: int, budget: int,
    max_steps: int, grid_size: int = 128, cascades: int = 1, bound: float = 1.0,
    occ_test_stride: int = 1, coarse_test_stride: int = 1,
):
    """Two-level occupancy march (constant dt): kernel K1 on CUDA tensors,
    the plain version on CPU tensors. Strides of 1 test every candidate
    (serving); training's strided probes are described in the plain
    version."""
    if occ_test_stride < 1 or coarse_test_stride < 1:
        raise ValueError("occupancy test strides must be >= 1 (resolve 0 = auto first)")
    kw = dict(num_coarse=num_coarse, fine_per_coarse=fine_per_coarse,
              coarse_budget=coarse_budget, budget=budget, max_steps=max_steps,
              grid_size=grid_size, cascades=cascades, bound=bound,
              occ_test_stride=occ_test_stride, coarse_test_stride=coarse_test_stride)
    if rays_o.is_cuda:
        return _march_cuda(rays_o, rays_d, nears, fars, occ, occ_coarse, noise, **kw)
    return march_hierarchical_plain(rays_o, rays_d, nears, fars, occ, occ_coarse, noise, **kw)


_MAX_COARSE_BUDGET = 32
_K1_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float] * 6
            + [ctypes.c_void_p] * 5)


def _march_cuda(rays_o, rays_d, nears, fars, occ, occ_coarse, noise, *,
                num_coarse, fine_per_coarse, coarse_budget, budget, max_steps,
                grid_size, cascades, bound, occ_test_stride, coarse_test_stride):
    N = rays_o.shape[0]
    dev = rays_o.device
    for name, t, shape in (("rays_o", rays_o, (N, 3)), ("rays_d", rays_d, (N, 3)),
                           ("nears", nears, (N,)), ("fars", fars, (N,)), ("noise", noise, (N,))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"march kernel: {name} must be {shape} float32 on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    grid_shape = (cascades, grid_size, grid_size, grid_size)
    for name, g in (("occ", occ), ("occ_coarse", occ_coarse)):
        if g.device != dev or g.dtype != torch.bool or tuple(g.shape) != grid_shape:
            raise ValueError(f"march kernel: {name} must be {grid_shape} bool on {dev}, "
                             f"got {tuple(g.shape)} {g.dtype}")
    if not 0 < coarse_budget <= _MAX_COARSE_BUDGET:
        raise ValueError(f"march kernel: coarse_budget must be in [1, {_MAX_COARSE_BUDGET}]")
    if cascades * grid_size**3 >= 2**31:
        raise ValueError(f"march kernel: a {grid_shape} grid exceeds its 32-bit cell index")
    ins = [x.contiguous() for x in (rays_o, rays_d, nears, fars, noise, occ, occ_coarse)]
    dt_py = 2.0 * SQRT3 / max_steps
    seg_py = dt_py * fine_per_coarse
    dt32 = np.float32(dt_py)
    e_dt = int(np.frexp(max(dt32 * np.float32(grid_size) * np.float32(0.5), np.float32(1e-30)))[1])
    t = torch.empty((N, budget), device=dev, dtype=torch.float32)
    mask = torch.empty((N, budget), device=dev, dtype=torch.bool)
    stride = torch.empty((N,), device=dev, dtype=torch.float32)
    lastocc = torch.empty((N,), device=dev, dtype=torch.float32)
    dt_out = torch.full((), float(dt32), dtype=torch.float32, device=dev)
    if N == 0:  # nothing to launch, nothing counted
        return t, dt_out, mask, stride, lastocc
    fn = _build.function("march", "march_hierarchical_launch", _K1_ARGS)
    code = fn(*[_build.ptr(x) for x in ins],
              N, num_coarse, fine_per_coarse, coarse_budget, budget, grid_size, cascades, e_dt,
              occ_test_stride, coarse_test_stride, float(bound), float(dt32), _f32(seg_py),
              _f32(0.5 * seg_py), _inv(coarse_budget), _inv(budget),
              _build.ptr(t), _build.ptr(mask), _build.ptr(stride), _build.ptr(lastocc),
              _build.stream(dev))
    _build.check(code, "march_hierarchical")
    kernels.launches["march"] += 1
    return t, dt_out, mask, stride, lastocc


# ---------------------------------------------------------------------------
# Flat candidate march on the dt_gamma ladder (K1f)
# ---------------------------------------------------------------------------

class MarchResults(NamedTuple):
    """The flat march's candidates (JAX ``MarchResults``)."""
    ts: torch.Tensor     # (N, Kc) f32 candidate distances; ts[:, 0] is the perturbed start
    dts: torch.Tensor    # (N, Kc) f32 step at each candidate
    valid: torch.Tensor  # (N, Kc) bool: occupied, short of far, among the first max_steps


def _plain_log(x: torch.Tensor) -> torch.Tensor:
    """log(x); on the CPU in float64 rounded back (``plain_exp``'s reason:
    torch's CPU float32 transcendentals call MKL's vector library)."""
    if x.is_cuda:
        return torch.log(x)
    return torch.log(x.double()).to(x.dtype)


def _step_bounds(max_steps: int, grid_size: int, cascades: int) -> Tuple[float, float]:
    """(dt_min, dt_max) = (2 sqrt3 / max_steps, 2 sqrt3 2^(C-1) / H)."""
    return 2.0 * SQRT3 / max_steps, 2.0 * SQRT3 * (2 ** (cascades - 1)) / grid_size


def dt_ladder(t0: torch.Tensor, num_steps: int, dt_min: float, dt_max: float,
              dt_gamma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed form of the growing-step ladder ``t_{k+1} = t_k + clamp(
    dt_gamma t_k, dt_min, dt_max)`` from t0 (N,): constant dt_min while
    t < A = dt_min/gamma, geometric t (1+gamma)^j while t < B = dt_max/gamma,
    constant dt_max after; k1 and j2 are each ray's phase boundaries.
    Returns (ts, dts), each (N, num_steps).

    Rounding points are jitted XLA's: s0 = t0 + k1 dt_min, t0 + k dt_min
    and t2 + (k - k1 - j2) dt_max are one fused multiply-add each; the
    divisions by dt_min and log1p(gamma) multiply by float32 reciprocals.
    exp and log are float32 library functions (``plain_exp``,
    ``_plain_log``; K1f calls expf/logf, torch's on the card), which XLA's
    CPU versions may round one ulp apart."""
    g = dt_gamma
    lg = math.log1p(g)
    k = torch.arange(num_steps, dtype=torch.float32, device=t0.device)[None, :]
    t0 = t0[:, None]
    k1 = torch.ceil(torch.clamp_min(_f32(dt_min / g) - t0, 0.0) * _inv(dt_min))
    s0 = _fma(k1, dt_min, t0)
    j2 = torch.ceil(torch.clamp_min(
        _plain_log(torch.clamp_min(s0, _f32(dt_max / g)) / s0), 0.0) * _inv(lg))
    t2 = s0 * plain_exp(j2 * _f32(lg))
    t_p1 = _fma(k, dt_min, t0)
    t_p2 = s0 * plain_exp(torch.clamp_min(k - k1, 0.0) * _f32(lg))
    t_p3 = _fma(k - k1 - j2, dt_max, t2)
    ts = torch.where(k < k1, t_p1, torch.where(k < k1 + j2, t_p2, t_p3))
    return ts, torch.clamp(ts * _f32(g), _f32(dt_min), _f32(dt_max))


def worst_case_ladder_steps(span: float, t0: float, dt_min: float, dt_max: float,
                            dt_gamma: float) -> int:
    """Host-side bound on the ladder steps that cross ``span`` from ``t0``
    (sizes the candidate enumeration): ``ceil(span / dt_min)`` at
    dt_gamma = 0, else each phase's count in closed form, plus 2."""
    if dt_gamma <= 0.0:
        return int(math.ceil(span / dt_min))
    far = t0 + span
    A = dt_min / dt_gamma
    B = dt_max / dt_gamma
    k1 = max(0, int(math.ceil((min(A, far) - t0) / dt_min)))
    s0 = t0 + k1 * dt_min
    j2 = 0
    if far > s0 and B > s0:
        j2 = int(math.ceil(math.log(min(B, far) / s0) / math.log1p(dt_gamma)))
    t2 = s0 * (1.0 + dt_gamma) ** j2
    k3 = max(0, int(math.ceil((far - t2) / dt_max)))
    return k1 + j2 + k3 + 2


def march_candidates_plain(
    rays_o: torch.Tensor, rays_d: torch.Tensor, nears: torch.Tensor, fars: torch.Tensor,
    occ: torch.Tensor, noise: torch.Tensor, *, num_steps: int, max_steps: int,
    grid_size: int = 128, cascades: int = 1, bound: float = 1.0, dt_gamma: float = 0.0,
) -> MarchResults:
    """Plain version of K1f's candidate mode (JAX ``march_candidates``): Kc
    = ``num_steps`` candidates from t0 = near + clamp(gamma near, dt_min,
    dt_max) noise, at constant dt_min (gamma 0) or on ``dt_ladder``; each
    point o + d t (clipped to the bound) tested in the cell of its own mip
    level (the step enters it); valid = occupied and t < far, among each
    ray's first ``max_steps`` such candidates."""
    dt_min, dt_max = _step_bounds(max_steps, grid_size, cascades)
    step = torch.clamp(nears * _f32(dt_gamma), _f32(dt_min), _f32(dt_max))
    t0 = _fma(step, noise, nears)
    if dt_gamma == 0.0:
        # jitted XLA tests the points and far at t0 + dt_min k fused (the
        # ts it returns are added unfused, up to one ulp apart)
        k = torch.arange(num_steps, dtype=torch.float32, device=rays_o.device)
        ts = _fma(dt_min, k[None, :], t0[:, None])
        dts = torch.full_like(ts, _f32(dt_min))
    else:
        ts, dts = dt_ladder(t0, num_steps, dt_min, dt_max, dt_gamma)
    p = _fma(rays_d[:, None, :], ts[..., None], rays_o[:, None, :]).clamp(-bound, bound)
    occupied = occupancy_lookup(occ, p, dts, grid_size=grid_size, cascades=cascades, bound=bound)
    valid = occupied & (ts < fars[:, None])
    if num_steps > max_steps:
        v = valid.int()
        valid = valid & (torch.cumsum(v, dim=1) - v < max_steps)
    return MarchResults(ts=ts, dts=dts, valid=valid)


def compact_per_ray(march: MarchResults, budget: int):
    """The per-ray layout's selection: (k_idx (N, B), mask (N, B), stride
    (N,)) of each ray's spread-kept valid candidates (``first_k_valid``)."""
    return first_k_valid(march.valid, budget, spread=True)


def march_flat_plain(rays_o, rays_d, nears, fars, occ, noise, *, num_steps: int,
                     max_steps: int, budget: int, grid_size: int = 128, cascades: int = 1,
                     bound: float = 1.0, dt_gamma: float = 0.0):
    """Plain version of K1f's per-ray mode: the candidates, then each ray's
    ``budget`` spread-kept samples. Returns (t (N, B) f32, dt (N, B) f32,
    both 0 where masked; mask (N, B) bool; stride (N,) f32; t0 (N,) f32 the
    perturbed start). (The JAX package takes the last candidate's t at a
    masked slot; the compositor zeroes masked slots either way.)"""
    march = march_candidates_plain(rays_o, rays_d, nears, fars, occ, noise, num_steps=num_steps,
                                   max_steps=max_steps, grid_size=grid_size, cascades=cascades,
                                   bound=bound, dt_gamma=dt_gamma)
    idx, mask, stride = compact_per_ray(march, budget)
    t = torch.where(mask, march.ts.gather(1, idx), 0.0)
    dt = torch.where(mask, march.dts.gather(1, idx), 0.0)
    return t, dt, mask, stride, march.ts[:, 0].contiguous()


def march_flat(rays_o, rays_d, nears, fars, occ, noise, *, num_steps: int, max_steps: int,
               budget: int, grid_size: int = 128, cascades: int = 1, bound: float = 1.0,
               dt_gamma: float = 0.0):
    """Flat march, per-ray layout: kernel K1f on CUDA tensors, the plain
    version on CPU tensors."""
    kw = dict(num_steps=num_steps, max_steps=max_steps, grid_size=grid_size,
              cascades=cascades, bound=bound, dt_gamma=dt_gamma)
    if rays_o.is_cuda:
        return _march_flat_cuda(rays_o, rays_d, nears, fars, occ, noise, budget=budget, **kw)
    return march_flat_plain(rays_o, rays_d, nears, fars, occ, noise, budget=budget, **kw)


def march_flat_candidates(rays_o, rays_d, nears, fars, occ, noise, *, num_steps: int,
                          max_steps: int, grid_size: int = 128, cascades: int = 1,
                          bound: float = 1.0, dt_gamma: float = 0.0) -> MarchResults:
    """Flat march, every candidate (for the exact global compaction): kernel
    K1f's candidate mode on CUDA tensors, the plain version on CPU tensors."""
    kw = dict(num_steps=num_steps, max_steps=max_steps, grid_size=grid_size,
              cascades=cascades, bound=bound, dt_gamma=dt_gamma)
    if rays_o.is_cuda:
        return _march_flat_cuda(rays_o, rays_d, nears, fars, occ, noise, budget=0, **kw)
    return march_candidates_plain(rays_o, rays_d, nears, fars, occ, noise, **kw)


_K1F_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float] * 10
             + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_void_p] * 6)


def _march_flat_cuda(rays_o, rays_d, nears, fars, occ, noise, *, num_steps, max_steps, budget,
                     grid_size, cascades, bound, dt_gamma):
    """K1f: ``budget`` > 0 launches the per-ray mode, 0 the candidate mode."""
    N = rays_o.shape[0]
    dev = rays_o.device
    for name, t, shape in (("rays_o", rays_o, (N, 3)), ("rays_d", rays_d, (N, 3)),
                           ("nears", nears, (N,)), ("fars", fars, (N,)), ("noise", noise, (N,))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"march_flat kernel: {name} must be {shape} float32 on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    grid_shape = (cascades, grid_size, grid_size, grid_size)
    if occ.device != dev or occ.dtype != torch.bool or tuple(occ.shape) != grid_shape:
        raise ValueError(f"march_flat kernel: occ must be {grid_shape} bool on {dev}, "
                         f"got {tuple(occ.shape)} {occ.dtype}")
    if num_steps < 1 or budget < 0 or dt_gamma < 0.0 or N * max(num_steps, budget) >= 2**31:
        raise ValueError(f"march_flat kernel: needs num_steps >= 1, budget >= 0, dt_gamma >= 0 "
                         f"and N * max(num_steps, budget) < 2^31, got {num_steps}, {budget}, "
                         f"{dt_gamma}, N = {N}")
    # the rays are read through their strides (a batch's rays are often a view)
    ins = [rays_o, rays_d] + [x.contiguous() for x in (nears, fars, noise, occ)]
    strides = (ctypes.c_longlong * 4)(*rays_o.stride(), *rays_d.stride())
    dt_min, dt_max = _step_bounds(max_steps, grid_size, cascades)
    g = dt_gamma if dt_gamma > 0.0 else 1.0  # the ladder's constants are unused at gamma 0
    lg = math.log1p(g)
    consts = (float(bound), _f32(dt_gamma), _f32(dt_min), _f32(dt_max), _f32(dt_min / g),
              _f32(dt_max / g), _inv(dt_min), _f32(lg), _inv(lg), _inv(max(budget, 1)))
    f32 = dict(device=dev, dtype=torch.float32)
    if budget > 0:
        outs = (torch.empty((N, budget), **f32), torch.empty((N, budget), **f32),
                torch.empty((N, budget), device=dev, dtype=torch.bool),
                torch.empty((N,), **f32), torch.empty((N,), **f32))
        symbol = "march_flat_launch"
    else:
        outs = MarchResults(ts=torch.empty((N, num_steps), **f32),
                            dts=torch.empty((N, num_steps), **f32),
                            valid=torch.empty((N, num_steps), device=dev, dtype=torch.bool))
        symbol = "march_candidates_launch"
    if N == 0:  # nothing to launch, nothing counted
        return outs
    fn = _build.function("march_flat", symbol, _K1F_ARGS)
    ptrs = [_build.ptr(x) for x in outs] + [ctypes.c_void_p(0)] * (5 - len(outs))
    code = fn(*[_build.ptr(x) for x in ins], N, num_steps, max_steps, budget, grid_size, cascades,
              *consts, strides, *ptrs, _build.stream(dev))
    _build.check(code, "march_flat")
    kernels.launches["march_flat"] += 1
    return outs


# ---------------------------------------------------------------------------
# Compositing (K3)
# ---------------------------------------------------------------------------

def composite_dense_plain(sigmas, rgbs, deltas, ts, mask=None, t_thresh: float = 0.0):
    """Plain version of K3: dense (N, T) exclusive-cumprod compositing.
    alpha = 1 - exp(-sigma*delta) (0 off-mask), T_i = prod_{j<i}(1 - alpha_j
    + 1e-15), w = alpha*T, zeroed where T < t_thresh.
    Returns (weights_sum (N,), depth (N,), image (N, 3), weights (N, T))."""
    sd = sigmas * deltas
    if mask is not None:
        sd = torch.where(mask, sd, 0.0)
    alphas = 1.0 - plain_exp(-sd)
    trans = torch.cumprod(1.0 - alphas + 1e-15, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    weights = alphas * trans
    if t_thresh > 0.0:
        weights = torch.where(trans >= t_thresh, weights, 0.0)
    return (weights.sum(-1), (weights * ts).sum(-1),
            (weights[..., None] * rgbs).sum(-2), weights)


def composite_dense_backward_plain(sigmas, rgbs, deltas, ts, mask, t_thresh,
                                   g_ws, g_depth, g_image, g_weights):
    """Plain version of the K3 backward: the analytic reverse pass for
    cotangents at all four outputs. With x_i = 1 - alpha_i + 1e-15,
    c_i = [T_i >= t_thresh] and a_i = g_ws + g_depth t_i + g_image . rgb_i +
    g_weights_i (the cotangent of w_i), the suffix sum
    R_{i-1} = a_i alpha_i c_i + x_i R_i (R_{T-1} = 0) gives
    dL/dalpha_i = T_i (a_i c_i - R_i) without dividing by x_i, and
    dsigma_i = delta_i exp(-sigma_i delta_i) dL/dalpha_i on the mask.
    Returns (dsigma (N, T), drgb (N, T, 3))."""
    sd = torch.where(mask, sigmas * deltas, 0.0)
    e = plain_exp(-sd)
    alphas = 1.0 - e
    x = 1.0 - alphas + 1e-15
    trans = torch.cumprod(x, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    keep = trans >= t_thresh
    a = (g_ws[:, None] + g_depth[:, None] * ts + (g_image[:, None, :] * rgbs).sum(-1)
         + g_weights)
    a = torch.where(keep, a, 0.0)
    b = a * alphas
    R = torch.zeros_like(g_ws)
    suffix = []
    for i in range(sigmas.shape[1] - 1, -1, -1):
        suffix.append(R)
        R = b[:, i] + x[:, i] * R
    suffix = torch.stack(suffix[::-1], dim=1)
    dsigma = torch.where(mask, deltas * e * (trans * (a - suffix)), 0.0)
    weights = torch.where(keep, alphas * trans, 0.0)
    return dsigma, weights[..., None] * g_image[:, None, :]


class _CompositeDense(torch.autograd.Function):
    """Gradients flow to sigmas and rgbs; deltas, ts and the mask are ray
    geometry (no parameter reaches them)."""

    @staticmethod
    def forward(ctx, sigmas, rgbs, deltas, ts, mask, t_thresh):
        if sigmas.is_cuda:
            out = _composite_cuda(sigmas, rgbs, deltas, ts, mask, t_thresh)
        else:
            out = composite_dense_plain(sigmas, rgbs, deltas, ts, mask, t_thresh)
        ctx.save_for_backward(sigmas, rgbs, deltas, ts, mask)
        ctx.t_thresh = t_thresh
        return out

    @staticmethod
    @kernels.first_order
    def backward(ctx, g_ws, g_depth, g_image, g_weights):
        sigmas, rgbs, deltas, ts, mask = ctx.saved_tensors
        args = (sigmas, rgbs, deltas, ts, mask, ctx.t_thresh, g_ws, g_depth, g_image, g_weights)
        if sigmas.is_cuda:
            dsig, drgb = _composite_backward_cuda(*args)
        else:
            dsig, drgb = composite_dense_backward_plain(*args)
        return dsig, drgb, None, None, None, None


def composite_dense(sigmas, rgbs, deltas, ts, mask=None, t_thresh: float = 0.0):
    """Per-ray compositor: kernel K3 on CUDA tensors, the plain version on
    CPU; differentiable in sigmas and rgbs (K3 backward / its plain version)."""
    if mask is None:
        mask = torch.ones(sigmas.shape, dtype=torch.bool, device=sigmas.device)
    return _CompositeDense.apply(sigmas, rgbs, deltas, ts, mask, float(t_thresh))


_K3_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float]
            + [ctypes.c_void_p] * 5)


def _check_composite(sigmas, rgbs, deltas, ts, mask):
    N, B = sigmas.shape
    dev = sigmas.device
    if 3 * (N * B + 32) >= 2**31:
        raise ValueError(f"composite kernel: N * T = {N * B} samples pass its 32-bit indices")
    for name, x, shape, dtype in (("sigmas", sigmas, (N, B), torch.float32),
                                  ("rgbs", rgbs, (N, B, 3), torch.float32),
                                  ("deltas", deltas, (N, B), torch.float32),
                                  ("ts", ts, (N, B), torch.float32),
                                  ("mask", mask, (N, B), torch.bool)):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"composite kernel: {name} must be {shape} {dtype} on {dev}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    return [x.contiguous() for x in (sigmas, rgbs, deltas, ts, mask)]


def _composite_cuda(sigmas, rgbs, deltas, ts, mask, t_thresh):
    N, B = sigmas.shape
    dev = sigmas.device
    ins = _check_composite(sigmas, rgbs, deltas, ts, mask)
    ws = torch.empty((N,), device=dev, dtype=torch.float32)
    depth = torch.empty((N,), device=dev, dtype=torch.float32)
    image = torch.empty((N, 3), device=dev, dtype=torch.float32)
    weights = torch.empty((N, B), device=dev, dtype=torch.float32)
    if N == 0:
        return ws, depth, image, weights
    fn = _build.function("composite", "composite_launch", _K3_ARGS)
    code = fn(*[_build.ptr(x) for x in ins], N, B, float(t_thresh),
              _build.ptr(ws), _build.ptr(depth), _build.ptr(image), _build.ptr(weights),
              _build.stream(dev))
    _build.check(code, "composite_dense")
    kernels.launches["composite"] += 1
    return ws, depth, image, weights


_K3_BWD_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_float]
                + [ctypes.c_void_p] * 3)


def _composite_backward_cuda(sigmas, rgbs, deltas, ts, mask, t_thresh,
                             g_ws, g_depth, g_image, g_weights):
    N, B = sigmas.shape
    dev = sigmas.device
    ins = _check_composite(sigmas, rgbs, deltas, ts, mask)
    grads = []
    for name, g, shape in (("g_ws", g_ws, (N,)), ("g_depth", g_depth, (N,)),
                           ("g_image", g_image, (N, 3)), ("g_weights", g_weights, (N, B))):
        if g.device != dev or tuple(g.shape) != shape:
            raise ValueError(f"composite backward kernel: {name} must be {shape} on {dev}, "
                             f"got {tuple(g.shape)} on {g.device}")
        grads.append(g.float().contiguous())
    dsigma = torch.empty((N, B), device=dev, dtype=torch.float32)
    drgb = torch.empty((N, B, 3), device=dev, dtype=torch.float32)
    if N == 0:
        return dsigma, drgb
    fn = _build.function("composite", "composite_backward_launch", _K3_BWD_ARGS)
    code = fn(*[_build.ptr(x) for x in ins + grads], N, B, float(t_thresh),
              _build.ptr(dsigma), _build.ptr(drgb), _build.stream(dev))
    _build.check(code, "composite_dense backward")
    kernels.launches["composite_bwd"] += 1
    return dsigma, drgb


# ---------------------------------------------------------------------------
# Importance sampling (glue: the JAX package computes it outside any kernel)
# ---------------------------------------------------------------------------

def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sampling of new depths from bin weights: bins (B, T),
    weights (B, T-1), u (B, n_samples) uniforms in [0, 1) (a linspace for
    the deterministic mode) -> (B, n_samples)."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1).contiguous()  # (B, T)
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)
    cdf_g0, cdf_g1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_g0, bins_g1 = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, 1.0, denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


# ---------------------------------------------------------------------------
# Global compaction (K5) and the compact compositor (K3c)
# ---------------------------------------------------------------------------

PAD_RAY_ID = 2**30  # ray_id of a padding slot


class CompactSamples(NamedTuple):
    xyzs: torch.Tensor       # (M, 3) f32 sample positions, clipped to the bound
    dirs: torch.Tensor       # (M, 3) f32
    ts: torch.Tensor         # (M,) f32 distance from the perturbed ray start, t + dt - t0
    dts: torch.Tensor        # (M,) f32 step (0 on padding)
    ray_id: torch.Tensor     # (M,) int32, PAD_RAY_ID on padding
    offsets: torch.Tensor    # (N,) int32 start of each ray's segment, clipped to M
    counts: torch.Tensor     # (N,) int32 kept samples per ray, clipped to the room left
    num_valid: torch.Tensor  # () int32 kept samples in the buffer, min(total, M)


def compact_global_dense_plain(rays_o, rays_d, t, dt, mask, t0, *, m_budget: int,
                               bound: float) -> CompactSamples:
    """Plain version of K5: the valid slots of the (N, B) layout, in row
    order, packed into an ``m_budget`` buffer; the tail past the buffer is
    dropped."""
    N, B = t.shape
    dev = t.device
    M = m_budget
    counts_full = mask.sum(dim=1, dtype=torch.int32)
    cum = torch.cumsum(counts_full, 0, dtype=torch.int64)
    total = cum[-1] if N else torch.zeros((), dtype=torch.int64, device=dev)
    offs = torch.clamp_max(cum - counts_full, M)
    src = mask.reshape(-1).nonzero().squeeze(1)[:M]
    n = torch.div(src, B, rounding_mode="floor")
    k = src.shape[0]
    o, d = rays_o[n], rays_d[n]
    tg, dtg = t.reshape(-1)[src], dt.reshape(-1)[src]

    def buf(x, shape, fill=0):
        out = torch.full((M,) + shape, fill, dtype=x.dtype, device=dev)
        out[:k] = x
        return out

    return CompactSamples(
        xyzs=buf((o + d * tg[:, None]).clamp(-bound, bound), (3,)),
        dirs=buf(d, (3,)),
        ts=buf(tg + dtg - t0[n], ()),
        dts=buf(dtg, ()),
        ray_id=buf(n.int(), (), PAD_RAY_ID),
        offsets=offs.int(),
        counts=torch.minimum(counts_full, torch.clamp_min(M - offs, 0)).int(),
        num_valid=torch.clamp_max(total, M).int(),
    )


def compact_global_dense(rays_o, rays_d, t, dt, mask, t0, *, m_budget: int,
                         bound: float) -> CompactSamples:
    """Global compaction of the per-ray (N, B) budget layout into a shared
    ``m_budget`` buffer (ray-major; overflow drops the tail): kernel K5 on
    CUDA tensors, the plain version on CPU tensors. ``t`` (N, B) absolute
    sample distances, ``dt`` (N, B) steps, ``mask`` (N, B) bool, ``t0`` (N,)
    the perturbed ray starts. ``num_valid`` stays on the device. Any mask is
    compacted in row order, which is the buffer both of the JAX package's
    paths (prefix masks and sorted keys) give."""
    if rays_o.is_cuda:
        return _compact_cuda(rays_o, rays_d, t, dt, mask, t0, m_budget, bound)
    return compact_global_dense_plain(rays_o, rays_d, t, dt, mask, t0, m_budget=m_budget,
                                      bound=bound)


def compact_samples(rays_o, rays_d, march: MarchResults, *, m_budget: int,
                    bound: float) -> CompactSamples:
    """The flat march's compaction: the same buffer over its candidates
    (ray start ``march.ts[:, 0]``), through the same kernel."""
    return compact_global_dense(rays_o, rays_d, march.ts, march.dts, march.valid,
                                march.ts[:, 0], m_budget=m_budget, bound=bound)


_K5_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_longlong] * 5
            + [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2)
# (device, stream) -> K5's int64 scratch (tile counter, tile status words)
_k5_scratch: dict = {}


def _compact_cuda(rays_o, rays_d, t, dt, mask, t0, m_budget, bound):
    N, B = t.shape
    dev = t.device
    M = int(m_budget)
    for name, x, shape, dtype in (("rays_o", rays_o, (N, 3), torch.float32),
                                  ("rays_d", rays_d, (N, 3), torch.float32),
                                  ("t", t, (N, B), torch.float32), ("dt", dt, (N, B), torch.float32),
                                  ("mask", mask, (N, B), torch.bool), ("t0", t0, (N,), torch.float32)):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"compact kernel: {name} must be {shape} {dtype} on {dev}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    if N * B >= 2**31 or M >= 2**31 or M < 1:
        raise ValueError(f"compact kernel: N*B ({N * B}) and m_budget ({M}) must be in [1, 2^31)")
    # rays and t0 are read through their strides (a batch's rays are often a
    # view), the (N, B) rows contiguous
    ins = [rays_o, rays_d] + [x.contiguous() for x in (t, dt, mask)] + [t0]
    strides = (*rays_o.stride(), *rays_d.stride(), t0.stride(0) if N else 1)
    i32 = dict(device=dev, dtype=torch.int32)
    out = CompactSamples(
        xyzs=torch.empty((M, 3), device=dev, dtype=torch.float32),
        dirs=torch.empty((M, 3), device=dev, dtype=torch.float32),
        ts=torch.empty((M,), device=dev, dtype=torch.float32),
        dts=torch.empty((M,), device=dev, dtype=torch.float32),
        ray_id=torch.empty((M,), **i32), offsets=torch.empty((N,), **i32),
        counts=torch.empty((N,), **i32), num_valid=torch.empty((), **i32))
    sizes = [ctypes.c_int, ctypes.c_int]
    words = _build.function("compact", "compact_scratch_words", sizes, restype=ctypes.c_longlong)
    chunk_words = _build.function("compact", "compact_chunk_words", sizes,
                                  restype=ctypes.c_longlong)
    key, scratch = _build.stream_scratch(_k5_scratch, dev, int(words(N, B)), torch.int64)
    # each mask chunk's bits and the valid candidates before it in its row
    chunks = torch.empty((2 * int(chunk_words(N, B)),), **i32)
    fn = _build.function("compact", "compact_launch", _K5_ARGS)
    code = fn(*[_build.ptr(x) for x in ins], N, B, M, float(bound), *strides,
              *[_build.ptr(x) for x in out], _build.ptr(scratch), scratch.numel(),
              _build.ptr(chunks), _build.stream(dev))
    if code != 0:  # a launch that failed may leave the scratch dirty
        _k5_scratch.pop(key, None)
    _build.check(code, "compact_global_dense")
    kernels.launches["compact"] += 2  # the tiles (count, scan), the copy and padding
    return out


def _segment_base(x64: torch.Tensor, offsets, counts, rid, N: int) -> torch.Tensor:
    """Per slot, the float64 exclusive prefix of x64 at its ray's first slot
    (0 for padding): the base of a per-ray exclusive sum."""
    M = x64.shape[0]
    excl = torch.cumsum(x64, 0) - x64
    base = torch.where(counts > 0, excl[offsets.long().clamp(0, M - 1)], 0.0)
    return torch.cat([base, base.new_zeros(1)])[rid]


def _compact_weights(sigmas, dts, ray_id, offsets, counts, N: int, t_thresh: float):
    """(w, T, e = exp(-sd), valid) of the compact layout; T from the per-ray
    exclusive sum of sd = sigma*dt taken in float64 and rounded to f32."""
    rid = torch.clamp_max(ray_id.long(), N)
    sd = sigmas * dts
    sd64 = sd.double()
    excl = torch.cumsum(sd64, 0) - sd64 - _segment_base(sd64, offsets, counts, rid, N)
    trans = plain_exp(-excl.float())
    e = plain_exp(-sd)
    valid = rid < N
    w = torch.where((trans >= t_thresh) & valid, (1.0 - e) * trans, 0.0)
    return w, trans, e, valid, rid


def composite_compact_plain(sigmas, rgbs, dts, ts, ray_id, offsets, counts, num_rays: int,
                            t_thresh: float = 1e-4):
    """Plain version of the K3c forward. Per ray, T_i = exp(-sum_{j<i} sd_j)
    over its own segment (sd = sigma*dt), alpha = 1 - exp(-sd) (no +1e-15),
    w = alpha*T where T >= t_thresh, 0 on padding. Returns the per-ray sums
    (weights_sum, depth = sum w ts, image = sum w rgb, z2 = sum w ts^2),
    taken in float64 and rounded to f32.

    The JAX package takes the exclusive sum as ONE global f32 cumsum minus
    each ray's base, which cancels badly once the buffer's running sum is
    large (0.025 in weights_sum at the bench's 32,768 rays); this is the
    per-ray sum that formula stands for."""
    N = num_rays
    w, _, _, _, rid = _compact_weights(sigmas, dts, ray_id, offsets, counts, N, t_thresh)

    def seg(x):
        x = x.double()
        out = x.new_zeros((N + 1,) + x.shape[1:]).index_add_(0, rid, x)
        return out[:N].float()

    return seg(w), seg(w * ts), seg(w[:, None] * rgbs), seg(w * ts * ts)


def composite_compact_backward_plain(sigmas, rgbs, dts, ts, ray_id, offsets, counts,
                                     num_rays: int, t_thresh: float, g_ws, g_depth, g_image, g_z2):
    """Plain version of the K3c backward, for cotangents at (weights_sum,
    depth, image, z2). With a_k = g_ws + g_depth ts_k + g_image . rgb_k +
    g_z2 ts_k^2 (the slot's ray's cotangents):
    d sd_i = alive_i a_i exp(-sd_i) T_i - sum_{k>i, same ray} a_k w_k,
    dsigma_i = dt_i d sd_i, drgb_i = w_i g_image; zero on padding.
    Returns (dsigma (M,), drgb (M, 3))."""
    N = num_rays
    w, trans, e, valid, rid = _compact_weights(sigmas, dts, ray_id, offsets, counts, N, t_thresh)
    alive = (trans >= t_thresh) & valid
    ri = rid.clamp_max(N - 1) if N else rid
    a = (g_ws[ri] + g_depth[ri] * ts + (g_image[ri] * rgbs).sum(-1) + g_z2[ri] * ts * ts)
    a = torch.where(valid, a, 0.0)
    b = (a * w).double()
    incl = torch.cumsum(b, 0)
    M = b.shape[0]
    end = (offsets.long() + counts.long()).clamp(0, M)
    seg_end = torch.cat([b.new_zeros(1), incl])[torch.cat([end, end.new_zeros(1)])[rid]]
    suffix = (seg_end - incl).float()
    dsd = torch.where(alive, a * e * trans, 0.0) - suffix
    dsigma = torch.where(valid, dts * dsd, 0.0)
    drgb = torch.where(valid[:, None], w[:, None] * g_image[ri], 0.0)
    return dsigma, drgb


class _CompositeCompact(torch.autograd.Function):
    """Gradients flow to sigmas and rgbs; the buffer's geometry (dts, ts) and
    layout (ray_id, offsets, counts) get none."""

    @staticmethod
    def forward(ctx, sigmas, rgbs, dts, ts, ray_id, offsets, counts, num_rays, t_thresh):
        args = (sigmas, rgbs, dts, ts, ray_id, offsets, counts, num_rays, t_thresh)
        out = _composite_compact_cuda(*args) if sigmas.is_cuda else composite_compact_plain(*args)
        ctx.save_for_backward(sigmas, rgbs, dts, ts, ray_id, offsets, counts)
        ctx.num_rays, ctx.t_thresh = num_rays, t_thresh
        return out

    @staticmethod
    @kernels.first_order
    def backward(ctx, g_ws, g_depth, g_image, g_z2):
        args = (*ctx.saved_tensors, ctx.num_rays, ctx.t_thresh, g_ws, g_depth, g_image, g_z2)
        if ctx.saved_tensors[0].is_cuda:
            dsig, drgb = _composite_compact_backward_cuda(*args)
        else:
            dsig, drgb = composite_compact_backward_plain(*args)
        return dsig, drgb, None, None, None, None, None, None, None


def composite_compact(sigmas, rgbs, samples: CompactSamples, num_rays: int,
                      T_thresh: float = 1e-4):
    """Alpha-composite a compacted buffer back into per-ray outputs: the K3c
    kernels on CUDA tensors, the plain versions on CPU; differentiable in
    sigmas (M,) and rgbs (M, 3). Returns (weights_sum, depth, image,
    z_variance) per ray, z_variance = max(E[t^2] - E[t]^2, 0) under the
    per-ray weights, formed here as the JAX package forms it."""
    ws, depth, image, z2 = _CompositeCompact.apply(
        sigmas, rgbs, samples.dts, samples.ts, samples.ray_id, samples.offsets,
        samples.counts, int(num_rays), float(T_thresh))
    mean_z = depth / torch.clamp_min(ws, 1e-8)
    z_var = torch.clamp_min(z2 / torch.clamp_min(ws, 1e-8) - mean_z**2, 0.0)
    return ws, depth, image, z_var


_K3C_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_void_p] * 5
_K3C_BWD_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [ctypes.c_float]
                 + [ctypes.c_void_p] * 3)


def _check_compact(sigmas, rgbs, dts, ts, ray_id, offsets, counts, N):
    M = sigmas.shape[0]
    dev = sigmas.device
    for name, x, shape, dtype in (("sigmas", sigmas, (M,), torch.float32),
                                  ("rgbs", rgbs, (M, 3), torch.float32),
                                  ("dts", dts, (M,), torch.float32), ("ts", ts, (M,), torch.float32),
                                  ("ray_id", ray_id, (M,), torch.int32),
                                  ("offsets", offsets, (N,), torch.int32),
                                  ("counts", counts, (N,), torch.int32)):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"composite_compact kernel: {name} must be {shape} {dtype} on {dev}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    return [x.contiguous() for x in (sigmas, rgbs, dts, ts, ray_id, offsets, counts)]


def _composite_compact_cuda(sigmas, rgbs, dts, ts, ray_id, offsets, counts, num_rays, t_thresh):
    N = num_rays
    dev = sigmas.device
    sig, rgb, dts, ts, _, offs, cnts = _check_compact(sigmas, rgbs, dts, ts, ray_id, offsets,
                                                      counts, N)
    outs = [torch.empty(s, device=dev, dtype=torch.float32) for s in ((N,), (N,), (N, 3), (N,))]
    if N == 0:
        return tuple(outs)
    fn = _build.function("compact", "composite_compact_launch", _K3C_ARGS)
    code = fn(*[_build.ptr(x) for x in (sig, rgb, dts, ts, offs, cnts)], N, sig.shape[0],
              float(t_thresh), *[_build.ptr(x) for x in outs], _build.stream(dev))
    _build.check(code, "composite_compact")
    kernels.launches["composite_compact"] += 1
    return tuple(outs)


def _composite_compact_backward_cuda(sigmas, rgbs, dts, ts, ray_id, offsets, counts, num_rays,
                                     t_thresh, g_ws, g_depth, g_image, g_z2):
    N, M = num_rays, sigmas.shape[0]
    dev = sigmas.device
    ins = _check_compact(sigmas, rgbs, dts, ts, ray_id, offsets, counts, N)
    grads = []
    for name, g, shape in (("g_ws", g_ws, (N,)), ("g_depth", g_depth, (N,)),
                           ("g_image", g_image, (N, 3)), ("g_z2", g_z2, (N,))):
        if g.device != dev or tuple(g.shape) != shape:
            raise ValueError(f"composite_compact backward kernel: {name} must be {shape} on "
                             f"{dev}, got {tuple(g.shape)} on {g.device}")
        grads.append(g.float().contiguous())
    dsigma = torch.empty((M,), device=dev, dtype=torch.float32)
    drgb = torch.empty((M, 3), device=dev, dtype=torch.float32)
    if max(N, M) == 0:
        return dsigma, drgb
    fn = _build.function("compact", "composite_compact_backward_launch", _K3C_BWD_ARGS)
    code = fn(*[_build.ptr(x) for x in ins + grads], N, M, float(t_thresh),
              _build.ptr(dsigma), _build.ptr(drgb), _build.stream(dev))
    _build.check(code, "composite_compact backward")
    kernels.launches["composite_compact_bwd"] += 1
    return dsigma, drgb
