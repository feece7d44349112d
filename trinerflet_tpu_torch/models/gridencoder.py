"""Multiresolution hash / tiled grid encoder (port of
``trinerflet_tpu/models/gridencoder.py``).

L levels with geometric resolution growth, dense ("tiled") storage while a
level fits its table, spatial hashing beyond ``2^log2_hashmap_size``,
trilinear interpolation, optional smoothstep. Parameters are the JAX
package's dict of per-level f32 tables ``level_{l}`` of shape
(``level_size(l)``, ``level_dim``).

``grid_encode`` is an autograd function differentiable in the tables and,
when the points require it, in the points: on CUDA tensors it launches
kernel K7 forward and backward (``kernels/csrc/gridencoder.cu``: a warp
on 32 consecutive points at one level; the backward merges a warp's
updates of one row pair and adds them with vector float32 atomics, and
replaces the JAX package's sort + one-hot scatter) and K7x for the
coordinate gradient (JAX's autodiff through the corner weights, which
analytic normals on a hash-grid field take); on CPU tensors it runs the
plain versions below (the backward an ``index_add_``). Its table gradient
alone is differentiable once: a second derivative through it raises on both
devices (``kernels.first_order``). When the points want a gradient under
grad mode, the backward is an autograd function (``_GridEncodeBackward``)
whose own backward is K7x² (a block per 128 points, their live points in
tiles of 32 with a warp a level, the table gradient merged across the warp
and added by vector float atomics; the same file) on CUDA tensors and
``grid_encode_backward_x_backward_plain`` on CPU tensors, so training
through an analytic normal differentiates the coordinate gradient once
more; a third derivative raises.

Rounding: the JAX package runs under jit, where XLA turns ``x / bound`` into
``x * f32(1 / bound)`` and fuses the ``+ 1`` into one fused multiply-add.
One ulp there moves ``floor(pos)`` at a cell edge and with it all eight
corners, so the plain version and K7 round exactly there as jit does
(``_fma`` with the float32 reciprocal) and every other operation alone.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import math
from typing import Dict, List, Optional

import numpy as np
import torch


from .. import kernels
from .._device import DeviceLike, resolve_device
from ..kernels import _build
from ..ops.grid_sample import _clip_grad
from ..ops.raymarch import _fma

__all__ = ["GridEncoderConfig", "init_grid_params", "grid_encode", "grid_encode_plain",
           "grid_encode_backward_plain", "grid_encode_backward_x_plain",
           "grid_encode_backward_x_backward_plain", "grid_encode_backward_error"]

_PRIMES = (1, 2654435761, 805459861)  # instant-ngp spatial hash primes
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class GridEncoderConfig:
    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: int = 2048
    gridtype: str = "hash"         # "hash" | "tiled" (tiled never hashes -> dense modulo)
    interpolation: str = "linear"  # "linear" | "smoothstep"

    @property
    def per_level_scale(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return math.exp(math.log(self.desired_resolution / self.base_resolution)
                        / (self.num_levels - 1))

    def level_resolution(self, level: int) -> int:
        """ceil of a float power, as the JAX package (the top level of
        16 -> 2048 over 16 levels may come out 2048 or 2049)."""
        return int(math.ceil(self.base_resolution * self.per_level_scale**level))

    def level_size(self, level: int) -> int:
        res = self.level_resolution(level) + 1
        return min(res**self.input_dim, 2**self.log2_hashmap_size)

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim


def init_grid_params(cfg: GridEncoderConfig, generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None, std: float = 1e-4) -> Dict[str, torch.Tensor]:
    """Per-level f32 tables drawn from std * U(-1, 1), on ``device`` (``cuda``
    by default)."""
    device = resolve_device(device)
    out = {}
    for l in range(cfg.num_levels):
        u = torch.rand((cfg.level_size(l), cfg.level_dim), generator=generator, dtype=torch.float32)
        out[f"level_{l}"] = (std * (2.0 * u - 1.0)).to(device)
    return out


def _hashed(cfg: GridEncoderConfig, res: int, size: int) -> bool:
    return (res + 1) ** cfg.input_dim > size and cfg.gridtype != "tiled"


def _index_plain(coords: torch.Tensor, res: int, size: int, cfg: GridEncoderConfig) -> torch.Tensor:
    """Integer grid coords (..., D) int64 -> table row (int64): dense
    ``sum_d c_d (res+1)^d`` while the dense level fits its table or the grid
    is tiled, else the XOR of ``c_d * prime_d``; uint32 wrap-around (the
    products stay below 2^43 in int64 and are masked), then mod size."""
    D = cfg.input_dim
    if not _hashed(cfg, res, size):
        idx = sum(coords[..., d] * (res + 1) ** d for d in range(D)) & _U32
        return idx % size
    h = torch.zeros(coords.shape[:-1], dtype=torch.int64, device=coords.device)
    for d in range(D):
        h = h ^ ((coords[..., d] * _PRIMES[d % 3]) & _U32)
    return h % size


def _inv_bound(bound: float) -> float:
    """float32 reciprocal of the bound, as XLA folds ``x / bound``."""
    return float(np.float32(1.0) / np.float32(bound))


def _unit_coord(x: torch.Tensor, bound: float) -> torch.Tensor:
    """(x / bound + 1) * 0.5 before the clip, rounded as jit rounds it."""
    return _fma(x, _inv_bound(bound), 1.0) * 0.5


def _cell_plain(x: torch.Tensor, cfg: GridEncoderConfig, bound: float, level: int):
    """The cell corner p0 (N, D) int64 and the linear fraction (N, D) of
    every point at one level."""
    pos = _unit_coord(x, bound).clamp(0.0, 1.0) * cfg.level_resolution(level)
    p0 = torch.floor(pos)
    return p0.long(), pos - p0


def _corner_rows_plain(p0: torch.Tensor, cfg: GridEncoderConfig, level: int, corner) -> torch.Tensor:
    res, size = cfg.level_resolution(level), cfg.level_size(level)
    return _index_plain((p0 + torch.tensor(corner, device=p0.device)).clamp(0, res), res, size, cfg)


def _corners_plain(x: torch.Tensor, cfg: GridEncoderConfig, bound: float, level: int):
    """The 2^D corner weights (K, N) and table rows (K, N) of every point at
    one level, corners in meshgrid(..., indexing="ij") order."""
    p0, frac = _cell_plain(x, cfg, bound, level)
    if cfg.interpolation == "smoothstep":
        frac = frac * frac * (3.0 - 2.0 * frac)
    ws, rows = [], []
    for corner in itertools.product((0, 1), repeat=cfg.input_dim):
        w = None
        for d, b in enumerate(corner):
            f = frac[:, d] if b else 1.0 - frac[:, d]
            w = f if w is None else w * f
        ws.append(w)
        rows.append(_corner_rows_plain(p0, cfg, level, corner))
    return torch.stack(ws), torch.stack(rows)


def grid_encode_plain(tables: List[torch.Tensor], x: torch.Tensor, cfg: GridEncoderConfig,
                      bound: float = 1.0) -> torch.Tensor:
    """Plain version of K7: x (N, D) in [-bound, bound] -> (N, L*C) f32,
    level-major, each level the corner rows summed in corner order."""
    outs = []
    for l, table in enumerate(tables):
        w, rows = _corners_plain(x, cfg, bound, l)
        acc = torch.zeros((x.shape[0], cfg.level_dim), dtype=torch.float32, device=x.device)
        for k in range(w.shape[0]):
            acc = acc + w[k][:, None] * table[rows[k]]
        outs.append(acc)
    return torch.cat(outs, dim=-1)


def grid_encode_backward_plain(g: torch.Tensor, x: torch.Tensor, cfg: GridEncoderConfig,
                               bound: float = 1.0) -> List[torch.Tensor]:
    """Plain version of the K7 backward: g (N, L*C) -> the L table
    gradients (size_l, C) f32, each corner row accumulating w * g
    (``index_add_``)."""
    C = cfg.level_dim
    g = g.float()
    grads = []
    for l in range(cfg.num_levels):
        acc = torch.zeros((cfg.level_size(l), C), dtype=torch.float32, device=g.device)
        w, rows = _corners_plain(x, cfg, bound, l)
        gl = g[:, l * C : (l + 1) * C]
        for k in range(w.shape[0]):
            acc.index_add_(0, rows[k], w[k][:, None] * gl)
        grads.append(acc)
    return grads


def _fraction_derivatives(lin: torch.Tensor, smooth: bool):
    """The interpolation fraction of the linear fraction ``lin`` and its
    first and second derivatives: smoothstep t^2 (3 - 2t), 6 t (1 - t),
    6 - 12 t; or t, 1, 0."""
    if smooth:
        return lin * lin * (3.0 - 2.0 * lin), 6.0 * lin * (1.0 - lin), 6.0 - 12.0 * lin
    return lin, torch.ones_like(lin), torch.zeros_like(lin)


def grid_encode_backward_x_plain(g: torch.Tensor, tables: List[torch.Tensor], x: torch.Tensor,
                                 cfg: GridEncoderConfig, bound: float = 1.0) -> torch.Tensor:
    """Plain version of K7x: g (N, L*C) -> dL/dx (N, D) f32, JAX's autodiff
    of ``grid_encode`` in the points. Per level, with f the linear fraction
    and w_k the product over d of f_d or 1 - f_d (smoothstep applied):

        dL/dpos_d = sum_k (g_l . row_k) dw_k/df_d  (x 6 f_d (1 - f_d) with smoothstep)

    summed over the levels times each level's resolution, then times the
    clip's gradient (``_clip_grad``: 0.5 where the coordinate is exactly 0
    or 1, 0 beyond), 0.5 and 1 / bound."""
    C, D = cfg.level_dim, cfg.input_dim
    g = g.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for l, table in enumerate(tables):
        p0, lin = _cell_plain(x, cfg, bound, l)
        frac, dfrac, _ = _fraction_derivatives(lin, cfg.interpolation == "smoothstep")
        gl = g[:, l * C : (l + 1) * C]
        dw = torch.zeros_like(acc)
        for corner in itertools.product((0, 1), repeat=D):
            s = (gl * table[_corner_rows_plain(p0, cfg, l, corner)].float()).sum(-1)
            fac = [frac[:, d] if b else 1.0 - frac[:, d] for d, b in enumerate(corner)]
            for d, b in enumerate(corner):
                prod = None
                for e in range(D):
                    if e != d:
                        prod = fac[e] if prod is None else prod * fac[e]
                dw[:, d] += (s if b else -s) * prod
        acc = acc + dw * dfrac * cfg.level_resolution(l)
    return acc * _clip_grad(_unit_coord(x, bound), 1.0) * 0.5 * _inv_bound(bound)


def grid_encode_backward_error(grads: List[torch.Tensor], g: torch.Tensor, x: torch.Tensor,
                               cfg: GridEncoderConfig, bound: float = 1.0) -> List[float]:
    """How far each level's table gradient in ``grads`` (the kernel's or the
    plain version's) lies from a float64 accumulation of the same float32
    terms w * g, as a fraction of the float-summation bound n (eps sum|term|
    + tiny) (n the terms added into an entry, eps the float32 machine
    epsilon, tiny its smallest normal number: a float atomic add flushes
    subnormal inputs and results to zero, PTX ``atom.add.f32``); a float32
    sum in any order stays within 1. The float atomics add in an
    unspecified order, so this, not a comparison of two float32 sums, is
    what a backward is held to."""
    C, eps, tiny = cfg.level_dim, torch.finfo(torch.float32).eps, torch.finfo(torch.float32).tiny
    g = g.float()
    out = []
    for l in range(cfg.num_levels):
        exact = torch.zeros((cfg.level_size(l), C), dtype=torch.float64, device=g.device)
        mag, count = torch.zeros_like(exact), torch.zeros_like(exact[:, :1])
        w, rows = _corners_plain(x, cfg, bound, l)
        gl = g[:, l * C : (l + 1) * C]
        ones = torch.ones((x.shape[0], 1), dtype=torch.float64, device=g.device)
        for k in range(w.shape[0]):
            term = w[k][:, None] * gl  # the float32 product each backward adds
            exact.index_add_(0, rows[k], term.double())
            mag.index_add_(0, rows[k], term.abs().double())
            count.index_add_(0, rows[k], ones)
        err = (grads[l].double() - exact).abs()
        bnd = count * (eps * mag + tiny)
        if bool((err[bnd == 0] != 0).any()):
            out.append(math.inf)  # an entry no term reaches must be exactly 0
            continue
        out.append(float((err / torch.where(bnd > 0, bnd, 1.0)).max()))
    return out


def grid_encode_backward_x_backward_plain(gg_x, gg_tables, x: torch.Tensor, g: torch.Tensor,
                                          tables: List[torch.Tensor], cfg: GridEncoderConfig,
                                          bound: float = 1.0, wants=(True, True, True)):
    """Plain version of K7x², the backward of K7x: K7x maps (x, g, tables)
    to dL/dx; given its cotangent ``gg_x`` (N, D), and ``gg_tables`` (the
    cotangents of the K7 backward's table gradients, a list or None), return
    (dL/dx (N, D) f32, dL/dg (N, L*C) f32, the L table gradients (size_l, C)
    f32), each None where ``wants`` (x, g, tables) says it is not asked for
    or nothing reaches it. Per level, with A_d = gg_d clip'(u_d) 0.5 /
    bound, the level's resolution r, f the fraction (smoothstep applied),
    f' and f'' its derivatives in the linear fraction, c_d = A_d f'_d r and
    omega_k = sum_d c_d dw_k/df_d:

        dL/dg_l    = sum_k omega_k T[idx_k]
        dL/dT[idx_k] += omega_k g_l
        dL/dx_e   += (sum_{d != e} c_d sum_k s_k d^2w_k/df_d df_e f'_e
                      + A_e r f''_e sum_k s_k dw_k/df_e) r clip'(u_e) 0.5 / bound

    with s_k = g_l . T[idx_k] (trilinear weights: d^2w_k/df_d^2 = 0).
    ``gg_tables`` adds the K7 forward on them to dL/dg and K7x on them, with
    cotangent g, to dL/dx."""
    want_x, want_g, want_t = wants
    C, D, L = cfg.level_dim, cfg.input_dim, cfg.num_levels
    N = x.shape[0]
    g = g.float()
    dx = dg = dT = None
    if gg_x is not None:
        v = _unit_coord(x, bound)
        q = _clip_grad(v, 1.0) * 0.5 * _inv_bound(bound)  # du/dx
        A = gg_x.float() * q
        dx = torch.zeros((N, D), dtype=torch.float32, device=x.device) if want_x else None
        dg = torch.zeros((N, L * C), dtype=torch.float32, device=x.device) if want_g else None
        dT = [torch.zeros_like(t, dtype=torch.float32) for t in tables] if want_t else None
        for l, table in enumerate(tables):
            res = cfg.level_resolution(l)
            p0, lin = _cell_plain(x, cfg, bound, l)
            frac, dfrac, ddfrac = _fraction_derivatives(lin, cfg.interpolation == "smoothstep")
            c = A * dfrac * res
            gl = g[:, l * C : (l + 1) * C]
            dw = torch.zeros((N, D), dtype=torch.float32, device=x.device)
            hx = torch.zeros((N, D), dtype=torch.float32, device=x.device)
            for corner in itertools.product((0, 1), repeat=D):
                rows = _corner_rows_plain(p0, cfg, l, corner)
                fac = [frac[:, d] if b else 1.0 - frac[:, d] for d, b in enumerate(corner)]
                sgn = [1.0 if b else -1.0 for b in corner]

                def prod_except(*skip):
                    out = torch.ones_like(lin[:, 0])
                    for e in range(D):
                        if e not in skip:
                            out = out * fac[e]
                    return out

                dwk = [sgn[d] * prod_except(d) for d in range(D)]
                omega = sum(c[:, d] * dwk[d] for d in range(D))
                row = table[rows].float()
                if want_g:
                    dg[:, l * C : (l + 1) * C] += omega[:, None] * row
                if want_t:
                    dT[l].index_add_(0, rows, omega[:, None] * gl)
                if want_x:
                    s = (gl * row).sum(-1)
                    for e in range(D):
                        dw[:, e] += s * dwk[e]
                        for d in range(D):
                            if d != e:
                                hx[:, e] += c[:, d] * s * (sgn[d] * sgn[e] * prod_except(d, e))
            if want_x:
                dx += (hx * dfrac + A * res * ddfrac * dw) * res * q
    if gg_tables is not None and any(t is not None for t in gg_tables):
        gg_tables = [torch.zeros_like(t, dtype=torch.float32) if u is None else u.float()
                     for t, u in zip(tables, gg_tables)]
        if want_g:
            f = grid_encode_plain(gg_tables, x, cfg, bound)
            dg = f if dg is None else dg + f
        if want_x:
            d = grid_encode_backward_x_plain(g, gg_tables, x, cfg, bound)
            dx = d if dx is None else dx + d
    return dx, dg, dT


class _GridEncodeBackward(torch.autograd.Function):
    """The K7 backward and K7x as a function of (x, g, tables), so that its
    results can be differentiated once more (K7x²): what
    ``_GridEncode.backward`` runs when the points want a gradient (under
    ``no_grad``, ``apply`` runs ``forward`` alone). Returns (dL/dx, *the table gradients), the tables' only with
    ``tables_grad``."""

    @staticmethod
    def forward(ctx, x, g, cfg, bound, tables_grad, *tables):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, g, *tables)
        ctx.cfg, ctx.bound, ctx.tables_grad = cfg, bound, tables_grad
        fn = _grid_encode_backward_x_cuda if x.is_cuda else grid_encode_backward_x_plain
        dx = fn(g, list(tables), x, cfg, bound)
        if not tables_grad:
            return dx
        fn = _grid_encode_backward_cuda if x.is_cuda else grid_encode_backward_plain
        return (dx, *fn(g, x, cfg, bound))

    @staticmethod
    @kernels.first_order
    def backward(ctx, gg_x, *gg_tables):
        x, g, *tables = ctx.saved_tensors
        wants = (kernels.wanted(ctx, 0), kernels.wanted(ctx, 1),
                 any(kernels.wanted(ctx, 5 + l, 2 + l) for l in range(len(tables))))
        fn = (_grid_encode_backward_x_backward_cuda if x.is_cuda
              else grid_encode_backward_x_backward_plain)
        dx, dg, dT = fn(gg_x, list(gg_tables) if ctx.tables_grad else None, x, g, list(tables), ctx.cfg,
                        ctx.bound, wants)
        return (dx, dg, None, None, None, *(dT or [None] * len(tables)))


class _GridEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg, bound, *tables):
        ctx.save_for_backward(x, *tables)
        ctx.cfg, ctx.bound = cfg, bound
        if x.is_cuda:
            return _grid_encode_cuda(list(tables), x, cfg, bound)
        return grid_encode_plain(list(tables), x, cfg, bound)

    @staticmethod
    def backward(ctx, g):
        x, *tables = ctx.saved_tensors
        if kernels.wanted(ctx, 0):
            # K7x (and the K7 backward) as an autograd function, differentiable once more (K7x²)
            tables_grad = any(kernels.wanted(ctx, 3 + l, 1 + l) for l in range(len(tables)))
            out = _GridEncodeBackward.apply(x, g, ctx.cfg, ctx.bound, tables_grad, *tables)
            dx, grads = (out[0], list(out[1:])) if tables_grad else (out, [None] * len(tables))
            return (dx, None, None, *grads)
        return _GridEncode.tables_backward(ctx, g)

    @staticmethod
    @kernels.first_order
    def tables_backward(ctx, g):
        x, *tables = ctx.saved_tensors
        grads = [None] * len(tables)
        if any(kernels.wanted(ctx, 3 + l, 1 + l) for l in range(len(tables))):
            fn = _grid_encode_backward_cuda if x.is_cuda else grid_encode_backward_plain
            grads = fn(g, x, ctx.cfg, ctx.bound)
        return (None, None, None, *grads)


def grid_encode(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: GridEncoderConfig,
                bound: float = 1.0) -> torch.Tensor:
    """x (N, D) in [-bound, bound] -> (N, L * C) multi-level interpolated
    features (f32); differentiable in the tables and, when ``x`` requires
    it, in the points (K7x)."""
    tables = [params[f"level_{l}"] for l in range(cfg.num_levels)]
    return _GridEncode.apply(x, cfg, float(bound), *tables)


# ---------------------------------------------------------------------------
# K7 wrapper
# ---------------------------------------------------------------------------

_K7_LEVEL_DIMS = (1, 2, 4, 8)
_K7_MAX_LEVELS = 32
_K7_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_K7_BWD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int] \
    + [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _k7_levels(cfg: GridEncoderConfig, x: torch.Tensor, what: str):
    """Check what K7 takes and return its per-level host arrays
    (resolutions, wraps, hash flags)."""
    L, C = cfg.num_levels, cfg.level_dim
    if cfg.input_dim != 3 or C not in _K7_LEVEL_DIMS or not 1 <= L <= _K7_MAX_LEVELS:
        raise ValueError(f"{what}: input_dim 3, level_dim in {_K7_LEVEL_DIMS} and 1..{_K7_MAX_LEVELS} "
                         f"levels, got {cfg.input_dim}, {C}, {L}")
    if cfg.interpolation not in ("linear", "smoothstep"):
        raise ValueError(f"{what}: unknown interpolation {cfg.interpolation!r}")
    if x.dim() != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"{what}: x must be (N, 3) f32, got {tuple(x.shape)} {x.dtype}")
    res, wrap, hashed = [], [], []
    for l in range(L):
        r, size = cfg.level_resolution(l), cfg.level_size(l)
        h = _hashed(cfg, r, size)
        pow2 = size & (size - 1) == 0
        if not pow2 and (h or (r + 1) ** 3 > size):
            raise ValueError(f"{what}: level {l} wraps a table of {size} rows, not a power of two")
        res.append(r)
        wrap.append(size - 1 if pow2 else _U32)
        hashed.append(int(h))
    return ((ctypes.c_uint32 * L)(*res), (ctypes.c_uint32 * L)(*wrap), (ctypes.c_int * L)(*hashed))


def _check_tables(tables: List[torch.Tensor], cfg: GridEncoderConfig, x: torch.Tensor,
                  what: str) -> None:
    C = cfg.level_dim
    if len(tables) != cfg.num_levels:
        raise ValueError(f"{what}: {cfg.num_levels} tables expected, got {len(tables)}")
    for l, t in enumerate(tables):
        shape = (cfg.level_size(l), C)
        if (t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % (4 * min(C, 4))):
            raise ValueError(f"{what}: level_{l} must be a contiguous {shape} f32 table on "
                             f"{x.device}, aligned to its row loads; got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")


def _grid_encode_cuda(tables: List[torch.Tensor], x: torch.Tensor, cfg: GridEncoderConfig,
                      bound: float) -> torch.Tensor:
    c_res, c_wrap, c_hashed = _k7_levels(cfg, x, "grid_encode kernel")
    L, C = cfg.num_levels, cfg.level_dim
    _check_tables(tables, cfg, x, "grid_encode kernel")
    x = x.contiguous()
    N = x.shape[0]
    out = torch.empty((N, L * C), device=x.device, dtype=torch.float32)
    if N == 0:
        return out
    ptrs = (ctypes.c_void_p * L)(*[t.data_ptr() for t in tables])
    fn = _build.function("gridencoder", "grid_encode_launch", _K7_ARGS)
    code = fn(_build.ptr(x), N, L, C, ptrs, c_res, c_wrap, c_hashed, _inv_bound(bound),
              int(cfg.interpolation == "smoothstep"), _build.ptr(out), _build.stream(x.device))
    _build.check(code, "grid_encode")
    kernels.launches["grid_encode"] += 1
    return out


def _k7_grad_tables(cfg: GridEncoderConfig, device) -> List[torch.Tensor]:
    """The zeroed (size_l, C) f32 gradient tables the K7 backward adds into:
    views of one buffer (one memset), each level padded to an even number
    of rows, so every table starts aligned to a row pair (8 C bytes) and a
    pair's second row exists (K7 adds a row pair as one vector atomic at
    C <= 2; the padding row receives zeros only)."""
    C = cfg.level_dim
    sizes = [cfg.level_size(l) for l in range(cfg.num_levels)]
    spans = [(s + s % 2) * C for s in sizes]
    flat = torch.zeros((sum(spans),), device=device, dtype=torch.float32)
    return [v[: s * C].view(s, C) for v, s in zip(torch.split(flat, spans), sizes)]


def _grid_encode_backward_cuda(g: torch.Tensor, x: torch.Tensor, cfg: GridEncoderConfig,
                               bound: float) -> List[torch.Tensor]:
    c_res, c_wrap, c_hashed = _k7_levels(cfg, x, "grid_encode backward kernel")
    L, C = cfg.num_levels, cfg.level_dim
    N = x.shape[0]
    if g.device != x.device or tuple(g.shape) != (N, L * C):
        raise ValueError(f"grid_encode backward kernel: g must be ({N}, {L * C}) on {x.device}, "
                         f"got {tuple(g.shape)} on {g.device}")
    g = g.float().contiguous()
    x = x.contiguous()
    grads = _k7_grad_tables(cfg, x.device)
    if N > 0:
        ptrs = (ctypes.c_void_p * L)(*[t.data_ptr() for t in grads])
        fn = _build.function("gridencoder", "grid_encode_backward_launch", _K7_BWD_ARGS)
        _build.check(fn(_build.ptr(x), _build.ptr(g), N, L, C, ptrs, c_res, c_wrap, c_hashed,
                        _inv_bound(bound), int(cfg.interpolation == "smoothstep"),
                        _build.stream(x.device)), "grid_encode backward")
        kernels.launches["grid_encode_bwd"] += 1
    return grads


_K7X_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int] \
    + [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _grid_encode_backward_x_cuda(g: torch.Tensor, tables: List[torch.Tensor], x: torch.Tensor,
                                 cfg: GridEncoderConfig, bound: float) -> torch.Tensor:
    """K7x: dL/dx (N, 3) f32, one thread per point over the levels."""
    what = "grid_encode backward (x) kernel"
    c_res, c_wrap, c_hashed = _k7_levels(cfg, x, what)
    L, C = cfg.num_levels, cfg.level_dim
    N = x.shape[0]
    _check_tables(tables, cfg, x, what)
    if g.device != x.device or tuple(g.shape) != (N, L * C):
        raise ValueError(f"{what}: g must be ({N}, {L * C}) on {x.device}, got {tuple(g.shape)} "
                         f"on {g.device}")
    g = g.float().contiguous()
    x = x.contiguous()
    dx = torch.empty((N, 3), device=x.device, dtype=torch.float32)
    if N > 0:
        ptrs = (ctypes.c_void_p * L)(*[t.data_ptr() for t in tables])
        fn = _build.function("gridencoder", "grid_encode_backward_x_launch", _K7X_ARGS)
        _build.check(fn(_build.ptr(x), _build.ptr(g), N, L, C, ptrs, c_res, c_wrap, c_hashed,
                        _inv_bound(bound), int(cfg.interpolation == "smoothstep"), _build.ptr(dx),
                        _build.stream(x.device)), what)
        kernels.launches["grid_encode_bwd_x"] += 1
    return dx


_K7XX_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 \
    + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 4


def _grid_encode_backward_x_backward_cuda(gg_x, gg_tables, x: torch.Tensor, g: torch.Tensor,
                                          tables: List[torch.Tensor], cfg: GridEncoderConfig, bound: float,
                                          wants=(True, True, True)):
    """K7x²: (dL/dx (N, 3) f32, dL/dg (N, L*C) f32, the L table gradients)
    as ``grid_encode_backward_x_backward_plain`` defines them. From ``gg_x``:
    one launch, the points gg reaches in tiles of 32 with a warp a level,
    the table gradient by float2 / float4 atomics into zeroed tables padded
    as the K7 backward's (``_k7_grad_tables``). ``gg_tables`` adds the K7
    forward and K7x on them."""
    what = "grid_encode backward (x) backward kernel"
    want_x, want_g, want_t = wants
    c_res, c_wrap, c_hashed = _k7_levels(cfg, x, what)
    L, C = cfg.num_levels, cfg.level_dim
    N = x.shape[0]
    _check_tables(tables, cfg, x, what)
    if g.device != x.device or tuple(g.shape) != (N, L * C):
        raise ValueError(f"{what}: g must be ({N}, {L * C}) on {x.device}, got {tuple(g.shape)} "
                         f"on {g.device}")
    g = g.float().contiguous()
    x = x.contiguous()
    dx = dg = dT = None
    if gg_x is not None and (want_x or want_g or want_t):
        if gg_x.device != x.device or tuple(gg_x.shape) != (N, 3):
            raise ValueError(f"{what}: gg_x must be ({N}, 3) on {x.device}, got {tuple(gg_x.shape)} "
                             f"on {gg_x.device}")
        gg_x = gg_x.float().contiguous()
        dx = torch.empty((N, 3), device=x.device, dtype=torch.float32) if want_x else None
        dg = torch.empty((N, L * C), device=x.device, dtype=torch.float32) if want_g else None
        dT = _k7_grad_tables(cfg, x.device) if want_t else None
        if N > 0:
            ptrs = (ctypes.c_void_p * L)(*[t.data_ptr() for t in tables])
            gptrs = None if dT is None else (ctypes.c_void_p * L)(*[t.data_ptr() for t in dT])
            opt = lambda t: None if t is None else _build.ptr(t)  # noqa: E731
            fn = _build.function("gridencoder", "grid_encode_backward_x_backward_launch", _K7XX_ARGS)
            _build.check(fn(_build.ptr(x), _build.ptr(g), _build.ptr(gg_x), N, L, C, ptrs, c_res, c_wrap,
                            c_hashed, _inv_bound(bound), int(cfg.interpolation == "smoothstep"), opt(dx),
                            opt(dg), gptrs, _build.stream(x.device)), what)
            kernels.launches["grid_encode_bwd_x_bwd"] += 1
    if gg_tables is not None and any(t is not None for t in gg_tables):
        gg_tables = [torch.zeros_like(t) if u is None else u.float().contiguous()
                     for t, u in zip(tables, gg_tables)]
        if want_g:
            f = _grid_encode_cuda(gg_tables, x, cfg, bound)
            dg = f if dg is None else dg + f
        if want_x:
            d = _grid_encode_backward_x_cuda(g, gg_tables, x, cfg, bound)
            dx = d if dx is None else dx + d
    return dx, dg, dT
