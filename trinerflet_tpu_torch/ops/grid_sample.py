"""Bilinear sampling of the three feature planes (port of
``trinerflet_tpu/ops/grid_sample.py``).

Semantics are torch ``F.grid_sample(bilinear, padding_mode='border',
align_corners=True)`` on channel-last ``(H, W, C)`` planes, with the JAX
package's corner law: the continuous coordinate is clamped into the plane,
then ``x0 = min(floor(x), W - 2)`` and the four corners are ``x0, x0 + 1``
by ``y0, y0 + 1``. The sum is the JAX quad sampler's: four corner rows times
the weights ``[(1-wx)(1-wy), wx(1-wy), (1-wx)wy, wx wy]``, in float32.

``sample_points`` is the field's entry: project world points onto the three
planes and sample each. It is an autograd function. Its backward is the
plane gradient ``sum_corners w_corner * g`` (float32 sums, cast to the
plane dtype), as the JAX package's quad and corner samplers
(``_quad_bwd`` / ``_corner_bwd``, whose blocked one-hot scatter,
``ops/scatter.py:scatter_add_outer``, it replaces); and, when the points
require a gradient (the learned rotation and lbound zoom), also the
coordinate gradient that JAX's autodiff of ``grid_sample_2d`` /
``sample_planes`` gives (see ``sample_points_backward_xyz_plain``). On CUDA
tensors it launches kernel K2 forward and backward, or K2x when the
coordinate gradient is asked for (``kernels/csrc/grid_sample.cu``: the
forward fuses the projection; the backward sums each tile of the plane in
shared memory after binning the rows by tile, six launches from one call,
each sum in an order fixed by the inputs; K2x enqueues the same passes for
its plane gradient, or none when the planes need none, as for an analytic
normal, and one launch for dL/dxyz); on CPU tensors it runs the
plain versions (the plane gradient an ``index_add_`` in float32). Its plane
gradient is differentiable once: a second derivative through it raises on
both devices (``kernels.first_order``). Its coordinate gradient is
differentiable twice, as training through an analytic normal needs: under
grad mode K2x is an autograd function (``_SamplePointsBackwardXyz``) whose
backward is K2x² on CUDA tensors (a lane-group pass per point for dL/dg
and dL/dxyz that also bins the rows gg reaches, then the K2 backward's
other five passes with the bilinear weights' derivatives in place of the
weights for dL/dplanes; the same file) and ``sample_points_backward_xyz_backward_plain`` on CPU
tensors. A third derivative raises.

Rounding: ``x / lbound`` is a true division on every device, as the JAX
package computes it op by op and as the kernels divide (``_divide``: torch
on the card would multiply by the reciprocal of a Python float, and a point
on a texel edge would take the neighbouring cell there).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..kernels import _build

__all__ = ["grid_sample_2d", "sample_planes", "project_to_planes", "sample_points",
           "sample_points_reduced", "sample_points_plain", "sample_points_backward_plain",
           "sample_points_backward_xyz_plain", "sample_points_backward_xyz_backward_plain"]


def _cell(H: int, W: int, xr: torch.Tensor, yr: torch.Tensor):
    """Flat index of the (x0, y0) corner (N,) and the four corner weights
    (N, 4, 1) in the order (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1),
    from the texel coordinates before the clamp."""
    x = torch.clamp(xr, 0.0, W - 1)
    y = torch.clamp(yr, 0.0, H - 1)
    x0 = torch.clamp(torch.floor(x), 0, W - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, H - 2).to(torch.int64)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    w = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy], dim=1)
    return y0 * W + x0, w


def _corners(H: int, W: int, coords: torch.Tensor):
    """``_cell`` at coords (N, 2) in [-1, 1] (``coords[:, 0]`` indexes W)."""
    return _cell(H, W, (coords[:, 0] + 1.0) * 0.5 * (W - 1), (coords[:, 1] + 1.0) * 0.5 * (H - 1))


def _gather_sum(plane: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    H, W, C = plane.shape
    flat = plane.reshape(H * W, C)
    rows = torch.stack([flat[idx], flat[idx + 1], flat[idx + W], flat[idx + W + 1]], dim=1)
    return (rows * w).sum(dim=1)


def grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """plane (H, W, C) with H, W >= 2, coords (N, 2) in [-1, 1]
    (``coords[:, 0]`` indexes W) -> (N, C) float32 (bf16 planes promote like
    the JAX package)."""
    H, W, C = plane.shape
    return _gather_sum(plane, *_corners(H, W, coords))


def sample_planes(planes: torch.Tensor, coords2d: torch.Tensor) -> torch.Tensor:
    """planes (P, H, W, C), coords2d (P, N, 2) -> (N, P, C)."""
    out = torch.stack([grid_sample_2d(planes[p], coords2d[p]) for p in range(planes.shape[0])])
    return out.transpose(0, 1)


# (u, v) axes of the three planes: plane 0 spans (x, z), 1 (x, y), 2 (y, z)
_PLANE_AXES = ((0, 2), (0, 1), (1, 2))


def _divide(x: torch.Tensor, lbound: float) -> torch.Tensor:
    """x / lbound, a true division on every device: the bound goes in as a
    float32 tensor on x's device (torch on the card multiplies by the
    reciprocal of a Python scalar, and on the CPU divides)."""
    return x / x.new_full((), lbound)


def project_to_planes(coords: torch.Tensor, lbound: float) -> torch.Tensor:
    """(N, 3) world coords -> (3, N, 2) per-plane coords: plane 0 spans
    (x, z), plane 1 (x, y), plane 2 (y, z), each divided by ``lbound``."""
    c = _divide(coords, lbound)
    return torch.stack([c[:, list(ax)] for ax in _PLANE_AXES], dim=0)


def _point_cells(planes_shape, xyz: torch.Tensor, lbound: float):
    """Per plane, the texel coordinates before the clamp (xr, yr) of every
    point: (xyz / lbound + 1) * 0.5 * (n - 1), each operation rounded alone
    and the division a true one, as the JAX package computes it op by op
    (its parity tests run the train step so)."""
    _, H, W, _ = planes_shape
    unit = (_divide(xyz, lbound) + 1.0) * 0.5
    return [(unit[:, a] * (W - 1), unit[:, b] * (H - 1)) for a, b in _PLANE_AXES]


def sample_points_plain(planes: torch.Tensor, xyz: torch.Tensor, lbound: float) -> torch.Tensor:
    """Plain version of K2: planes (3, H, W, C), xyz (M, 3) -> (M, 3, C) f32."""
    _, H, W, _ = planes.shape
    out = [_gather_sum(planes[p], *_cell(H, W, xr, yr))
           for p, (xr, yr) in enumerate(_point_cells(planes.shape, xyz, lbound))]
    return torch.stack(out, dim=1)


def sample_points_backward_plain(g: torch.Tensor, xyz: torch.Tensor, lbound: float,
                                 plane_shape, plane_dtype) -> torch.Tensor:
    """Plain version of the K2 backward: g (M, 3, C) -> the (3, H, W, C)
    plane gradient, each corner row accumulating w_corner * g in float32
    (``index_add_``), then cast to the plane dtype."""
    P, H, W, C = plane_shape
    acc = torch.zeros((P * H * W, C), dtype=torch.float32, device=g.device)
    g = g.float()
    for p, (xr, yr) in enumerate(_point_cells(plane_shape, xyz, lbound)):
        idx, w = _cell(H, W, xr, yr)
        idx = idx + p * H * W
        for k, off in enumerate((0, 1, W, W + 1)):
            acc.index_add_(0, idx + off, w[:, k] * g[:, p])
    return acc.reshape(P, H, W, C).to(plane_dtype)


def _clip_grad(v: torch.Tensor, hi: int) -> torch.Tensor:
    """The JAX package's gradient of ``clip(v, 0, hi)``: 1 inside, 0 outside
    and 0.5 at either bound (``jnp.clip`` is a max then a min, and JAX splits
    the gradient of a tie between its arguments), where torch's ``clamp``
    gives 1."""
    inside = torch.where((v > 0) & (v < hi), 1.0, 0.0)
    return torch.where((v == 0) | (v == hi), 0.5, inside)


def sample_points_backward_xyz_plain(g: torch.Tensor, planes: torch.Tensor, xyz: torch.Tensor,
                                     lbound: float, planes_grad: bool = True):
    """Plain version of K2x: g (M, 3, C), planes (3, H, W, C), xyz (M, 3) ->
    (the plane gradient as ``sample_points_backward_plain``, or None without
    ``planes_grad``; the coordinate gradient (M, 3) f32). Per plane, with
    x = (u + 1) (W - 1) / 2 before the clamp and the corner rows f00, f01
    (x + 1), f10 (y + 1), f11:

        dL/du = (sum_c g_c [(f01 - f00)(1 - wy) + (f11 - f10) wy]) clip'(x) (W - 1) / 2

    and dL/dv alike with x and y swapped, clip' as JAX's (``_clip_grad``),
    in JAX's order of the factors (each one after it exact). The planes'
    (u, v) sum into the point, plane 0 being (x, z), 1 (x, y) and 2 (y, z),
    and the point's gradient is that over ``lbound`` (``u = x / lbound``)."""
    P, H, W, C = planes.shape
    g = g.float()
    duv = []
    for p, (xr, yr) in enumerate(_point_cells(planes.shape, xyz, lbound)):
        x, y = torch.clamp(xr, 0.0, W - 1), torch.clamp(yr, 0.0, H - 1)
        x0, y0 = torch.clamp(torch.floor(x), 0, W - 2), torch.clamp(torch.floor(y), 0, H - 2)
        idx = (y0 * W + x0).long()
        wx, wy = (x - x0)[:, None], (y - y0)[:, None]
        flat = planes[p].reshape(H * W, C).float()
        f00, f01, f10, f11 = flat[idx], flat[idx + 1], flat[idx + W], flat[idx + W + 1]
        gp = g[:, p]
        dwx = (gp * ((f01 - f00) * (1 - wy) + (f11 - f10) * wy)).sum(-1)
        dwy = (gp * ((f10 - f00) * (1 - wx) + (f11 - f01) * wx)).sum(-1)
        duv.append((dwx * _clip_grad(xr, W - 1) * (W - 1) * 0.5,
                    dwy * _clip_grad(yr, H - 1) * (H - 1) * 0.5))
    (du0, dv0), (du1, dv1), (du2, dv2) = duv
    dxyz = _divide(torch.stack([du0 + du1, dv1 + du2, dv0 + dv2], dim=-1), lbound)
    if not planes_grad:
        return None, dxyz
    return sample_points_backward_plain(g, xyz, lbound, tuple(planes.shape), planes.dtype), dxyz


def sample_points_backward_xyz_backward_plain(gg_xyz, gg_planes, planes: torch.Tensor,
                                              xyz: torch.Tensor, g: torch.Tensor, lbound: float,
                                              wants=(True, True, True)):
    """Plain version of K2x², the backward of K2x: K2x maps (planes, xyz, g)
    to (the plane gradient, dL/dxyz); given their cotangents ``gg_planes``
    (3, H, W, C) and ``gg_xyz`` (M, 3), either None, return (dL/dplanes in
    the plane dtype, dL/dxyz (M, 3) f32, dL/dg (M, 3, C) f32), each None
    where ``wants`` (planes, xyz, g) says it is not asked for or nothing
    reaches it. Per plane, with a_u, a_v the plane's axes of
    ``gg_xyz / lbound``, s_u = clip'(x) (W - 1) / 2 and s_v alike, c_u =
    a_u s_u, c_v = a_v s_v and h = sum_c g_c (f00 - f01 - f10 + f11):

        dL/dg      = c_u [(f01 - f00)(1 - wy) + (f11 - f10) wy]
                   + c_v [(f10 - f00)(1 - wx) + (f11 - f01) wx]
        dL/df00   += -(c_u (1 - wy) + c_v (1 - wx)) g, f01: c_u (1 - wy) - c_v wx,
                     f10: c_v (1 - wx) - c_u wy, f11: c_u wy + c_v wx
        dL/du     += c_v h s_u,  dL/dv += c_u h s_v  (then over lbound)

    (the bilinear Hessian's cross term; clip'' is 0). ``gg_planes`` adds the
    K2 forward on it to dL/dg and K2x's dL/dxyz on it, with cotangent g, to
    dL/dxyz."""
    want_p, want_x, want_g = wants
    P, H, W, C = planes.shape
    M = xyz.shape[0]
    g = g.float()
    dplanes = dxyz = dg = None
    if gg_xyz is not None:
        a = _divide(gg_xyz.float(), lbound)
        acc = torch.zeros((P * H * W, C), dtype=torch.float32, device=g.device) if want_p else None
        dg = torch.zeros((M, P, C), dtype=torch.float32, device=g.device) if want_g else None
        duv = []
        for p, (xr, yr) in enumerate(_point_cells(planes.shape, xyz, lbound)):
            x, y = torch.clamp(xr, 0.0, W - 1), torch.clamp(yr, 0.0, H - 1)
            x0, y0 = torch.clamp(torch.floor(x), 0, W - 2), torch.clamp(torch.floor(y), 0, H - 2)
            idx = (y0 * W + x0).long()
            wx, wy = x - x0, y - y0
            su = _clip_grad(xr, W - 1) * (W - 1) * 0.5
            sv = _clip_grad(yr, H - 1) * (H - 1) * 0.5
            au, av = (a[:, ax] for ax in _PLANE_AXES[p])
            cu, cv = au * su, av * sv
            gp = g[:, p]
            if want_p:
                ws = (-(cu * (1 - wy) + cv * (1 - wx)), cu * (1 - wy) - cv * wx,
                      cv * (1 - wx) - cu * wy, cu * wy + cv * wx)
                for w, off in zip(ws, (0, 1, W, W + 1)):
                    acc.index_add_(0, idx + (p * H * W + off), w[:, None] * gp)
            if want_g or want_x:
                flat = planes[p].reshape(H * W, C).float()
                f00, f01, f10, f11 = flat[idx], flat[idx + 1], flat[idx + W], flat[idx + W + 1]
            if want_g:
                dg[:, p] = (cu[:, None] * ((f01 - f00) * (1 - wy[:, None]) + (f11 - f10) * wy[:, None])
                            + cv[:, None] * ((f10 - f00) * (1 - wx[:, None]) + (f11 - f01) * wx[:, None]))
            if want_x:
                h = (gp * (f00 - f01 - f10 + f11)).sum(-1)
                duv.append((cv * h * su, cu * h * sv))
        if want_p:
            dplanes = acc.reshape(P, H, W, C).to(planes.dtype)
        if want_x:
            (du0, dv0), (du1, dv1), (du2, dv2) = duv
            dxyz = _divide(torch.stack([du0 + du1, dv1 + du2, dv0 + dv2], dim=-1), lbound)
    if gg_planes is not None:
        gg_planes = gg_planes.to(planes.dtype)
        if want_g:
            f = sample_points_plain(gg_planes, xyz, lbound)
            dg = f if dg is None else dg + f
        if want_x:
            d = sample_points_backward_xyz_plain(g, gg_planes, xyz, lbound, planes_grad=False)[1]
            dxyz = d if dxyz is None else dxyz + d
    return dplanes, dxyz, dg


class _SamplePointsBackwardXyz(torch.autograd.Function):
    """K2x as a function of (planes, xyz, g), so that its results can be
    differentiated once more (K2x²): what ``_SamplePoints.backward`` runs
    when the points want a gradient (under ``no_grad``, ``apply`` runs
    ``forward`` alone). Returns (the plane
    gradient, dL/dxyz), or dL/dxyz alone without ``planes_grad``."""

    @staticmethod
    def forward(ctx, planes, xyz, g, lbound, planes_grad):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(planes, xyz, g)
        ctx.lbound, ctx.planes_grad = lbound, planes_grad
        fn = _sample_points_backward_xyz_cuda if xyz.is_cuda else sample_points_backward_xyz_plain
        pg, dxyz = fn(g, planes, xyz, lbound, planes_grad=planes_grad)
        return (pg, dxyz) if planes_grad else dxyz

    @staticmethod
    @kernels.first_order
    def backward(ctx, *grads):
        gg_planes, gg_xyz = grads if ctx.planes_grad else (None, grads[0])
        planes, xyz, g = ctx.saved_tensors
        wants = (kernels.wanted(ctx, 0), kernels.wanted(ctx, 1), kernels.wanted(ctx, 2))
        fn = (_sample_points_backward_xyz_backward_cuda if xyz.is_cuda
              else sample_points_backward_xyz_backward_plain)
        dplanes, dxyz, dg = fn(gg_xyz, gg_planes, planes, xyz, g, ctx.lbound, wants)
        return dplanes, dxyz, dg, None, None


class _SamplePoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, planes, xyz, lbound):
        # the planes are kept only for K2x (the corner rows of dL/dxyz)
        ctx.save_for_backward(xyz, planes if ctx.needs_input_grad[1] else None)
        ctx.lbound = lbound
        ctx.plane_shape, ctx.plane_dtype = tuple(planes.shape), planes.dtype
        if xyz.is_cuda:
            return _sample_points_cuda(planes, xyz, lbound)
        return sample_points_plain(planes, xyz, lbound)

    @staticmethod
    def backward(ctx, g):
        if kernels.wanted(ctx, 1):
            # K2x as an autograd function, differentiable once more (K2x²)
            xyz, planes = ctx.saved_tensors
            planes_grad = kernels.wanted(ctx, 0)
            out = _SamplePointsBackwardXyz.apply(planes, xyz, g, ctx.lbound, planes_grad)
            return (*(out if planes_grad else (None, out)), None)
        return _SamplePoints.planes_backward(ctx, g)

    @staticmethod
    @kernels.first_order
    def planes_backward(ctx, g):
        xyz, _ = ctx.saved_tensors
        args = (g, xyz, ctx.lbound, ctx.plane_shape, ctx.plane_dtype)
        if xyz.is_cuda:
            return _sample_points_backward_cuda(*args), None, None
        return sample_points_backward_plain(*args), None, None


def sample_points(planes: torch.Tensor, xyz: torch.Tensor, lbound: float) -> torch.Tensor:
    """Triplane features at world points: (M, 3, C) float32; differentiable
    in the planes and, when ``xyz`` requires it, in the points (K2x)."""
    return _SamplePoints.apply(planes, xyz, float(lbound))


class _SamplePointsReduced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, planes, xyz, lbound, reduce):
        ctx.save_for_backward(xyz, planes if ctx.needs_input_grad[1] else None)
        ctx.lbound, ctx.reduce = lbound, reduce
        ctx.plane_shape, ctx.plane_dtype = tuple(planes.shape), planes.dtype
        if xyz.is_cuda:
            return _sample_points_cuda(planes, xyz, lbound)
        return sample_points_plain(planes, xyz, lbound)

    @staticmethod
    @kernels.first_order
    def backward(ctx, g):
        xyz, planes = ctx.saved_tensors
        dxyz = None
        if ctx.needs_input_grad[1]:
            fn = _sample_points_backward_xyz_cuda if xyz.is_cuda else sample_points_backward_xyz_plain
            dxyz = fn(g, planes, xyz, ctx.lbound, planes_grad=False)[1]
        pg = None
        if ctx.needs_input_grad[0]:
            bwd = _sample_points_backward_cuda if xyz.is_cuda else sample_points_backward_plain
            pg = ctx.reduce(bwd(g, xyz, ctx.lbound, ctx.plane_shape, torch.float32))
            pg = pg.to(ctx.plane_dtype)
        return pg, dxyz, None, None


def sample_points_reduced(planes: torch.Tensor, xyz: torch.Tensor, lbound: float,
                          reduce) -> torch.Tensor:
    """``sample_points`` whose plane gradient is ``reduce``d in float32
    before it is rounded to the plane dtype: the K2 backward writes float32
    sums, ``reduce`` (e.g. a data-group mean) takes and returns them, and
    the cast follows, as the JAX package's per-shard scatter psums its
    float32 partials. The point gradient, when ``xyz`` requires one, is
    K2x's alone (no plane gradient pass)."""
    return _SamplePointsReduced.apply(planes, xyz, float(lbound), reduce)


# ---------------------------------------------------------------------------
# K2 wrapper
# ---------------------------------------------------------------------------

_K2_CHANNELS = (4, 8, 16, 32)
_K2_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p]


def _check_planes_points(planes: torch.Tensor, xyz: torch.Tensor, what: str) -> None:
    """What K2 and K2x take: (3, H, W, C) bf16 or f32 planes, contiguous and
    16-byte aligned, C in _K2_CHANNELS, H, W >= 2; (M, 3) f32 points on the
    planes' device."""
    if planes.device != xyz.device:
        raise ValueError(f"{what}: planes and points on different devices")
    if planes.dim() != 4 or planes.shape[0] != 3:
        raise ValueError(f"{what}: planes must be (3, H, W, C), got {tuple(planes.shape)}")
    if planes.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: planes must be bf16 or f32, got {planes.dtype}")
    if xyz.dim() != 2 or xyz.shape[1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"{what}: xyz must be (M, 3) f32, got {tuple(xyz.shape)} {xyz.dtype}")
    _check_sizes(tuple(planes.shape), xyz.shape[0], what)
    if not planes.is_contiguous() or planes.data_ptr() % 16:
        raise ValueError(f"{what}: planes must be contiguous channel-last "
                         "and 16-byte aligned (it reads rows with 16-byte loads)")


def _check_sizes(plane_shape, M: int, what: str) -> None:
    """C in _K2_CHANNELS, H, W >= 2, and every index K2 forms fits 32 bits:
    the plane elements 3 H W C, the output and cotangent elements 3 M C, and
    the backward's tile lists (up to 4 entries per (sample, plane) row)."""
    _, H, W, C = plane_shape
    if C not in _K2_CHANNELS or H < 2 or W < 2:
        raise ValueError(f"{what}: C in {_K2_CHANNELS} and H, W >= 2, got {tuple(plane_shape)}")
    if 3 * H * W * C >= 2**31 or 3 * M * max(C, 4) >= 2**31:
        raise ValueError(f"{what}: {tuple(plane_shape)} planes and {M} points exceed the kernels' "
                         "32-bit indices")


def _sample_points_cuda(planes: torch.Tensor, xyz: torch.Tensor, lbound: float) -> torch.Tensor:
    _check_planes_points(planes, xyz, "sample_points kernel")
    _, H, W, C = planes.shape
    xyz = xyz.contiguous()
    M = xyz.shape[0]
    out = torch.empty((M, 3, C), device=xyz.device, dtype=torch.float32)
    if M == 0:
        return out
    fn = _build.function("grid_sample", "sample_points_launch", _K2_ARGS)
    code = fn(_build.ptr(planes), _build.ptr(xyz), M, H, W, C,
              int(planes.dtype == torch.bfloat16), float(lbound),
              _build.ptr(out), _build.stream(xyz.device))
    _build.check(code, "sample_points")
    kernels.launches["grid_sample"] += 1
    return out


_K2_BWD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
_K2_WORKSPACE_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong)]
# kernels one K2 backward call launches: count, column scan, scan, scatter,
# accumulate, reduce
K2_BWD_LAUNCHES = 6


def _backward_scratch(M: int, H: int, W: int, C: int, device, what: str, symbol="sample_points_backward_workspace"):
    """The K2 backward's scratch from torch's caching allocator: the rows'
    keys, tile lists and count matrix (int32), and the float32 partial tiles
    of tiles split across blocks (``symbol``: the launcher that sizes them,
    K2x²'s adding its lists of reached rows)."""
    words, floats = ctypes.c_longlong(), ctypes.c_longlong()
    ws = _build.function("grid_sample", symbol, _K2_WORKSPACE_ARGS)
    _build.check(ws(M, H, W, C, ctypes.byref(words), ctypes.byref(floats)), what)
    return (torch.empty((words.value,), device=device, dtype=torch.int32),
            torch.empty((floats.value,), device=device, dtype=torch.float32))


def _sample_points_backward_cuda(g: torch.Tensor, xyz: torch.Tensor, lbound: float,
                                 plane_shape, plane_dtype) -> torch.Tensor:
    """The K2 backward: the plane gradient (3, H, W, C) in the plane dtype,
    its float32 sums kept in shared memory tile by tile, each in an order
    fixed by the inputs (``kernels/csrc/grid_sample.cu``)."""
    what = "sample_points backward kernel"
    P, H, W, C = plane_shape
    M = xyz.shape[0]
    if P != 3:
        raise ValueError(f"{what}: bad plane shape {plane_shape}")
    _check_sizes(plane_shape, M, what)
    if plane_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: planes must be bf16 or f32, got {plane_dtype}")
    if g.device != xyz.device or tuple(g.shape) != (M, 3, C):
        raise ValueError(f"{what}: g must be ({M}, 3, {C}) on {xyz.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    if M == 0:
        return torch.zeros(plane_shape, device=xyz.device, dtype=plane_dtype)
    g = g.float().contiguous()
    xyz = xyz.contiguous()
    iscratch, partials = _backward_scratch(M, H, W, C, xyz.device, what)
    out = torch.empty(plane_shape, device=xyz.device, dtype=plane_dtype)
    fn = _build.function("grid_sample", "sample_points_backward_launch", _K2_BWD_ARGS)
    _build.check(fn(_build.ptr(xyz), _build.ptr(g), M, H, W, C, int(plane_dtype == torch.bfloat16),
                    float(lbound), _build.ptr(out), _build.ptr(iscratch), _build.ptr(partials),
                    _build.stream(xyz.device)), "sample_points backward")
    kernels.launches["grid_sample_bwd"] += K2_BWD_LAUNCHES
    return out


_K2X_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _sample_points_backward_xyz_cuda(g: torch.Tensor, planes: torch.Tensor, xyz: torch.Tensor,
                                     lbound: float, planes_grad: bool = True):
    """K2x: the plane gradient (the K2 backward's passes, enqueued by the
    same call, so bit for bit ``_sample_points_backward_cuda``'s on the same
    cotangent and points; None without ``planes_grad``) and dL/dxyz (M, 3)
    f32, one more launch of a lane group per point."""
    what = "sample_points backward (xyz) kernel"
    _check_planes_points(planes, xyz, what)
    _, H, W, C = planes.shape
    M = xyz.shape[0]
    if g.device != xyz.device or tuple(g.shape) != (M, 3, C):
        raise ValueError(f"{what}: g must be ({M}, 3, {C}) on {xyz.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    dxyz = torch.empty((M, 3), device=xyz.device, dtype=torch.float32)
    if M == 0:
        pg = torch.zeros(planes.shape, device=xyz.device, dtype=planes.dtype) if planes_grad else None
        return pg, dxyz
    g = g.float().contiguous()
    xyz = xyz.contiguous()
    pg, iscratch, partials = None, None, None
    if planes_grad:
        iscratch, partials = _backward_scratch(M, H, W, C, xyz.device, what)
        pg = torch.empty(planes.shape, device=xyz.device, dtype=planes.dtype)
    fn = _build.function("grid_sample", "sample_points_backward_xyz_launch", _K2X_ARGS)
    opt = lambda t: None if t is None else _build.ptr(t)  # noqa: E731
    _build.check(fn(_build.ptr(planes), _build.ptr(xyz), _build.ptr(g), M, H, W, C,
                    int(planes.dtype == torch.bfloat16), float(lbound), opt(pg), opt(iscratch),
                    opt(partials), _build.ptr(dxyz), _build.stream(xyz.device)),
                 "sample_points backward (xyz)")
    kernels.launches["grid_sample_bwd_xyz"] += 1 + (K2_BWD_LAUNCHES if planes_grad else 0)
    return pg, dxyz


_K2XX_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 6


def _sample_points_backward_xyz_backward_cuda(gg_xyz, gg_planes, planes: torch.Tensor,
                                              xyz: torch.Tensor, g: torch.Tensor, lbound: float,
                                              wants=(True, True, True)):
    """K2x²: (dL/dplanes in the plane dtype, dL/dxyz (M, 3) f32, dL/dg (M, 3,
    C) f32) as ``sample_points_backward_xyz_backward_plain`` defines them.
    From ``gg_xyz``: a first pass of a lane group per point for dL/dg and
    dL/dxyz which, with dL/dplanes, also bins the rows gg reaches as the K2
    backward's count pass does, then that backward's five other passes with
    the bilinear weights' derivatives (K2_BWD_LAUNCHES launches; each sum in
    an order fixed by the inputs); without dL/dplanes the first pass alone.
    ``gg_planes`` adds the K2 forward and K2x's dL/dxyz pass on it."""
    what = "sample_points backward (xyz) backward kernel"
    want_p, want_x, want_g = wants
    _check_planes_points(planes, xyz, what)
    _, H, W, C = planes.shape
    M = xyz.shape[0]
    if g.device != xyz.device or tuple(g.shape) != (M, 3, C):
        raise ValueError(f"{what}: g must be ({M}, 3, {C}) on {xyz.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    dplanes = dxyz = dg = None
    g = g.float().contiguous()
    xyz = xyz.contiguous()
    if gg_xyz is not None and (want_p or want_x or want_g):
        if gg_xyz.device != xyz.device or tuple(gg_xyz.shape) != (M, 3):
            raise ValueError(f"{what}: gg_xyz must be ({M}, 3) on {xyz.device}, got "
                             f"{tuple(gg_xyz.shape)} on {gg_xyz.device}")
        gg_xyz = gg_xyz.float().contiguous()
        dg = torch.empty((M, 3, C), device=xyz.device, dtype=torch.float32) if want_g else None
        dxyz = torch.empty((M, 3), device=xyz.device, dtype=torch.float32) if want_x else None
        iscratch = partials = None
        if want_p:
            iscratch, partials = _backward_scratch(M, H, W, C, xyz.device, what,
                                                   "sample_points_backward_xyz_backward_workspace")
            dplanes = torch.empty(planes.shape, device=xyz.device, dtype=planes.dtype)
        if M == 0:
            dplanes = None if dplanes is None else dplanes.zero_()
        else:
            fn = _build.function("grid_sample", "sample_points_backward_xyz_backward_launch", _K2XX_ARGS)
            opt = lambda t: None if t is None else _build.ptr(t)  # noqa: E731
            _build.check(fn(_build.ptr(planes), _build.ptr(xyz), _build.ptr(g), _build.ptr(gg_xyz), M, H, W, C,
                            int(planes.dtype == torch.bfloat16), float(lbound), opt(dg), opt(dxyz),
                            opt(dplanes), opt(iscratch), opt(partials), _build.stream(xyz.device)), what)
            kernels.launches["grid_sample_bwd_xyz_bwd"] += K2_BWD_LAUNCHES if want_p else 1
    if gg_planes is not None:
        gg_planes = gg_planes.to(planes.dtype).contiguous()
        if want_g:
            f = _sample_points_cuda(gg_planes, xyz, lbound)
            dg = f if dg is None else dg + f
        if want_x:
            d = _sample_points_backward_xyz_cuda(g, gg_planes, xyz, lbound, planes_grad=False)[1]
            dxyz = d if dxyz is None else dxyz + d
    return dplanes, dxyz, dg
