"""threestudio-style named registries: geometry, material, background (port of
``trinerflet_tpu/models/registry.py``).

The default triple (implicit-volume, neural-radiance-material,
solid-color-background) is :class:`~trinerflet_tpu_torch.models.nerf.NeRFField`
itself. The other entries:

* geometry ``volume-grid``: a dense (R, R, R, 1 + F) voxel grid sampled
  trilinearly (``sample_volume_grid``: kernel K10 on CUDA tensors,
  ``kernels/csrc/volume_grid.cu``, its plain version on CPU tensors);
* geometry ``implicit-sdf``: SDF and feature heads on the spatial encoding,
  a sphere / ellipsoid bias, and the VolSDF Laplace density;
* materials ``no-material`` and ``diffuse-with-point-light-material``
  (albedo, textureless and diffuse shading; it needs normals);
* backgrounds ``neural-environment-map-background`` (SH, MLP, sigmoid),
  ``textured-background`` (``background_textured``: kernel K11,
  ``kernels/csrc/textured_bg.cu``) and ``solid-color-background``.

Parameters are the JAX package's dict tree. :class:`RegistryField` duck-types
the NeRFField interface (``build_planes`` / ``density`` / ``color`` /
``__call__``; ``background(params, d)`` keeps the JAX signature), so any
combination renders through ``render_occgrid`` and ``render_dense``.

Normals (``normal_type``): finite differences (forward, or the 6-point
central stencil) on the density or the SDF, a predicted normal (an MLP on
the encoding), or the analytic gradient, taken with ``torch.autograd.grad``
through the field's sampler: K2's coordinate gradient (K2x) on a triplane,
K7x on a hash or tiled grid, K10's on a voxel grid. The port's sampler
carries coordinate gradients whenever the points require one, so the JAX
package's gradient-exact twin field (``_exact_inner``, ``fast_sampler=False``)
has no counterpart here. Training through an analytic normal differentiates
those coordinate gradients once more: K2x², K7x² and K10² (their backwards'
kernels, the same files) on CUDA tensors, their plain versions on CPU
tensors.

Deviations from the JAX package, neither of which changes a result it
gives: the ``pred`` normal and the SDF heads on a non-triplane field read
that field's own encoding (the JAX package samples a triplane there and
fails); and no gradient reaches a direction through the textured
background (a ray direction needs none).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .._device import DeviceLike, resolve_device
from ..kernels import _build
from ..ops.activation import plain_exp, trunc_exp
from ..ops.encoders import sh_dim, sh_encode
from ..ops.grid_sample import _clip_grad
from ..ops.raymarch import _fma, _inv
from .nerf import NeRFConfig, NeRFField, _init_mlp, _mlp, init_nerf_params
from .triplane import sample_triplane

__all__ = [
    "GEOMETRY_REGISTRY", "MATERIAL_REGISTRY", "BACKGROUND_REGISTRY", "NORMAL_TYPES",
    "VolumeGridConfig", "SDFConfig", "init_volume_grid", "sample_volume_grid",
    "sample_volume_grid_plain", "sample_volume_grid_backward_plain",
    "sample_volume_grid_backward_x_backward_plain", "sample_volume_grid_backward_x_backward_error",
    "sample_volume_grid_backward_error", "shifted_sdf",
    "laplace_density", "material_no_material", "material_diffuse_point_light",
    "init_env_map_bg", "background_env_map", "init_textured_bg", "background_textured",
    "background_textured_plain", "background_textured_backward_plain", "background_solid",
    "RegistryField", "make_field",
]


def _clip_hi(n: int) -> float:
    """The upper bound ``n - 1 - 1e-6`` as ``jnp.clip`` rounds a Python float
    to float32: 63.0 exactly at n = 64, 30.999998 at 32, 14.999999 at 16."""
    return float(np.float32(n - 1 - 1e-6))


def _clip(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: a max then a min, a tie splitting its gradient in half
    (as ``torch.maximum`` / ``torch.minimum`` do; ``torch.clamp`` gives 1)."""
    return torch.minimum(torch.maximum(v, v.new_tensor(lo)), v.new_tensor(hi))


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """``jnp.linalg.norm`` over the last axis: sqrt of the sum of squares
    (its gradient at 0 is NaN, as JAX's)."""
    return torch.sqrt((v * v).sum(-1, keepdim=keepdim))


# ---------------------------------------------------------------- geometry

@dataclasses.dataclass(frozen=True)
class VolumeGridConfig:
    """Dense voxel-grid geometry (reference volume_grid.py): a learnable
    (R, R, R, 1 + F) grid; channel 0 is raw density, the rest are features."""
    resolution: int = 64
    feature_dim: int = 15
    init_scale: float = 0.1


def init_volume_grid(cfg: VolumeGridConfig, generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``{"grid": init_scale * N(0, 1)}`` of shape (R, R, R, 1 + F) f32, on
    ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    R, F = cfg.resolution, cfg.feature_dim
    grid = cfg.init_scale * torch.randn((R, R, R, 1 + F), generator=generator, dtype=torch.float32)
    return {"grid": grid.to(device)}


_CORNERS_3D = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def _voxel_cell(x: torch.Tensor, R: int, bound: float):
    """q before the clip (N, 3), the cell corner q0 (N, 3) int64 and the
    fraction f (N, 3), rounded as jit rounds ``(x / bound * 0.5 + 0.5) *
    (R - 1)``: XLA multiplies by the float32 reciprocal of the static bound,
    folds the 0.5 into it (exactly) and fuses the + 0.5 into one fused
    multiply-add; every other operation rounds alone."""
    qpre = _fma(x, _inv(bound) * 0.5, 0.5) * (R - 1)
    q = _clip(qpre, 0.0, _clip_hi(R))
    q0 = torch.floor(q)
    return qpre, q0.long(), q - q0


def _voxel_corner(q0: torch.Tensor, f: torch.Tensor, R: int, corner):
    """The grid row (N,) and the weight factors (wx, wy, wz) of one corner."""
    i = [torch.clamp(q0[:, d] + corner[d], max=R - 1) for d in range(3)]
    fac = [f[:, d] if corner[d] else 1 - f[:, d] for d in range(3)]
    return (i[0] * R + i[1]) * R + i[2], fac


def sample_volume_grid_plain(grid: torch.Tensor, x: torch.Tensor, R: int, bound: float) -> torch.Tensor:
    """Plain version of K10: grid (R^3, CH) f32 rows, x (N, 3) -> (N, CH)
    f32, the 8 corner rows times ((wx * wy) * wz) summed in JAX's order."""
    _, q0, f = _voxel_cell(x, R, bound)
    out = torch.zeros((x.shape[0], grid.shape[1]), dtype=torch.float32, device=x.device)
    for corner in _CORNERS_3D:
        rows, (wx, wy, wz) = _voxel_corner(q0, f, R, corner)
        out = out + grid[rows] * (wx * wy * wz)[:, None]
    return out


def sample_volume_grid_backward_plain(g: torch.Tensor, grid: torch.Tensor, x: torch.Tensor, R: int,
                                      bound: float, grid_grad: bool = True, x_grad: bool = True):
    """Plain version of the K10 backward: g (N, CH) -> (the grid gradient
    (R^3, CH) f32, each corner row accumulating w * g (``index_add_``); dL/dx
    (N, 3) f32), either None when not asked for. With s_k = g . row_k,

        dL/df_d = sum_k s_k (+-1) prod_{e != d} w_e,

    then JAX's chain: times the clip's gradient (``_clip_grad``: 0.5 where
    q sits exactly on 0 or on the float32 bound, 0 outside), (R - 1), 0.5
    and the float32 reciprocal of the bound (jit's ``/ bound``)."""
    qpre, q0, f = _voxel_cell(x, R, bound)
    g = g.float()
    ggrid = torch.zeros_like(grid, dtype=torch.float32) if grid_grad else None
    df = torch.zeros_like(x, dtype=torch.float32) if x_grad else None
    for corner in _CORNERS_3D:
        rows, (wx, wy, wz) = _voxel_corner(q0, f, R, corner)
        if grid_grad:
            ggrid.index_add_(0, rows, (wx * wy * wz)[:, None] * g)
        if x_grad:
            s = (g * grid[rows].float()).sum(-1)
            for d, w_other in enumerate((wy * wz, wx * wz, wx * wy)):
                df[:, d] += (s if corner[d] else -s) * w_other
    gx = None
    if x_grad:
        gx = df * _clip_grad(qpre, _clip_hi(R)) * (R - 1) * 0.5 * _inv(bound)
    return ggrid, gx


def sample_volume_grid_backward_x_backward_plain(gg_x, gg_grid, grid: torch.Tensor, x: torch.Tensor,
                                                 g: torch.Tensor, R: int, bound: float,
                                                 wants=(True, True, True)):
    """Plain version of K10², the backward of K10's coordinate gradient: that
    maps (grid, x, g) to dL/dx (and the grid gradient); given the cotangent
    ``gg_x`` (N, 3) of dL/dx and ``gg_grid`` (R^3, CH) of the grid gradient,
    either None, return (the grid gradient (R^3, CH) f32, dL/dx (N, 3) f32,
    dL/dg (N, CH) f32), each None where ``wants`` (grid, x, g) says it is not
    asked for or nothing reaches it. With q_d = clip'(q_d) (R - 1) 0.5 /
    bound (dq/dx), A_d = gg_d q_d and omega_k = sum_d A_d dw_k/df_d:

        dL/dg       = sum_k omega_k row_k
        dL/drow_k  += omega_k g
        dL/dx_e     = q_e sum_{d != e} A_d sum_k s_k d^2w_k/df_d df_e

    with s_k = g . row_k (trilinear: the Hessian's diagonal is 0).
    ``gg_grid`` adds the K10 forward on it to dL/dg and its coordinate
    gradient, with cotangent g, to dL/dx."""
    want_grid, want_x, want_g = wants
    N = x.shape[0]
    g = g.float()
    ggrid = dx = dg = None
    if gg_x is not None:
        q, A, corners = _k10xx_corners(gg_x, x, R, bound)
        ggrid = torch.zeros_like(grid, dtype=torch.float32) if want_grid else None
        dg = torch.zeros((N, grid.shape[1]), dtype=torch.float32, device=x.device) if want_g else None
        hx = torch.zeros_like(x, dtype=torch.float32)
        for rows, fac, sgn, omega in corners:
            row = grid[rows].float()
            if want_g:
                dg += omega[:, None] * row
            if want_grid:
                ggrid.index_add_(0, rows, omega[:, None] * g)
            if want_x:
                s = (g * row).sum(-1)
                for e in range(3):
                    for d in range(3):
                        if d != e:
                            hx[:, e] += A[:, d] * s * (sgn[d] * sgn[e] * fac[3 - d - e])
        dx = hx * q if want_x else None
    if gg_grid is not None:
        gg_grid = gg_grid.float()
        if want_g:
            s = sample_volume_grid_plain(gg_grid, x, R, bound)
            dg = s if dg is None else dg + s
        if want_x:
            d = sample_volume_grid_backward_plain(g, gg_grid, x, R, bound, grid_grad=False)[1]
            dx = d if dx is None else dx + d
    return ggrid, dx, dg


def _k10xx_corners(gg_x: torch.Tensor, x: torch.Tensor, R: int, bound: float):
    """K10²'s per-point factors: q (N, 3) = dq/dx, A = gg_x q, and for each
    corner k in order (its rows (N,), weight factors, signs, omega_k (N,)
    = sum_d A_d dw_k/df_d, rounded as the kernel rounds it)."""
    qpre, q0, f = _voxel_cell(x, R, bound)
    q = _clip_grad(qpre, _clip_hi(R)) * (R - 1) * 0.5 * _inv(bound)
    A = gg_x.float() * q
    corners = []
    for corner in _CORNERS_3D:
        rows, fac = _voxel_corner(q0, f, R, corner)
        sgn = [1.0 if b else -1.0 for b in corner]
        dwk = (sgn[0] * (fac[1] * fac[2]), sgn[1] * (fac[0] * fac[2]), sgn[2] * (fac[0] * fac[1]))
        corners.append((rows, fac, sgn, A[:, 0] * dwk[0] + A[:, 1] * dwk[1] + A[:, 2] * dwk[2]))
    return q, A, corners


def _scatter_error(ggrid: torch.Tensor, terms) -> float:
    """How far ``ggrid`` lies from a float64 sum of the float32 ``terms``
    ((rows (N,), term (N, CH)) pairs, each row of a term added into its
    grid row), as a fraction of the float-summation bound n (eps sum|term|
    + tiny), n the nonzero terms an entry adds, eps the float32 machine
    epsilon and tiny its smallest normal number (a float atomic flushes
    subnormals to zero); a float32 sum of those terms in any order and any
    grouping lies within 1, an entry no nonzero term reaches must be
    exactly 0 (else inf)."""
    eps, tiny = torch.finfo(torch.float32).eps, torch.finfo(torch.float32).tiny
    exact = torch.zeros(ggrid.shape, dtype=torch.float64, device=ggrid.device)
    mag, count = torch.zeros_like(exact), torch.zeros_like(exact)
    for rows, term in terms:
        rows, term = rows.to(ggrid.device), term.to(ggrid.device)
        exact.index_add_(0, rows, term.double())
        mag.index_add_(0, rows, term.abs().double())
        count.index_add_(0, rows, (term != 0).double())
    err = (ggrid.double() - exact).abs()
    bnd = count * (eps * mag + tiny)
    if bool((err[bnd == 0] != 0).any()):
        return math.inf
    return float((err / torch.where(bnd > 0, bnd, 1.0)).max()) if err.numel() else 0.0


@torch.no_grad()
def sample_volume_grid_backward_x_backward_error(ggrid: torch.Tensor, gg_x: torch.Tensor, x: torch.Tensor,
                                                 g: torch.Tensor, R: int, bound: float) -> float:
    """How far K10²'s grid gradient ``ggrid`` (R^3, CH) from ``gg_x`` (the
    kernel's or the plain version's) lies from a float64 sum of the same
    float32 terms omega_k g, as a fraction of the float-summation bound
    (``_scatter_error``): within 1 for a float32 sum in any order. The
    kernel's float atomics, and its sums of a run's terms in registers
    before them, add in another order than ``index_add_``, so this, not a
    comparison of two float32 sums, is what K10²'s grid gradient is held
    to."""
    g = g.float()
    _, _, corners = _k10xx_corners(gg_x, x, R, bound)
    return _scatter_error(ggrid, [(rows, omega[:, None] * g) for rows, _, _, omega in corners])


@torch.no_grad()
def sample_volume_grid_backward_error(ggrid: torch.Tensor, g: torch.Tensor, x: torch.Tensor, R: int,
                                      bound: float) -> float:
    """As ``sample_volume_grid_backward_x_backward_error`` for the K10
    backward's grid gradient: the terms w_k g."""
    _, q0, f = _voxel_cell(x, R, bound)
    g = g.float()
    terms = []
    for corner in _CORNERS_3D:
        rows, (wx, wy, wz) = _voxel_corner(q0, f, R, corner)
        terms.append((rows, (wx * wy * wz)[:, None] * g))
    return _scatter_error(ggrid, terms)


class _SampleVolumeGridBackward(torch.autograd.Function):
    """K10's backward as a function of (grid, x, g), so that its coordinate
    gradient can be differentiated once more (K10²): what
    ``_SampleVolumeGrid.backward`` runs when the points want a gradient
    (under ``no_grad``, ``apply`` runs ``forward`` alone). Returns (the grid gradient, dL/dx), or dL/dx alone without
    ``grid_grad``."""

    @staticmethod
    def forward(ctx, grid, x, g, R, bound, grid_grad):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(grid, x, g)
        ctx.R, ctx.bound, ctx.grid_grad = R, bound, grid_grad
        fn = _sample_volume_grid_backward_cuda if x.is_cuda else sample_volume_grid_backward_plain
        ggrid, gx = fn(g, grid, x, R, bound, grid_grad, True)
        return (ggrid, gx) if grid_grad else gx

    @staticmethod
    @kernels.first_order
    def backward(ctx, *grads):
        gg_grid, gg_x = grads if ctx.grid_grad else (None, grads[0])
        grid, x, g = ctx.saved_tensors
        wants = (kernels.wanted(ctx, 0), kernels.wanted(ctx, 1), kernels.wanted(ctx, 2))
        fn = (_sample_volume_grid_backward_x_backward_cuda if x.is_cuda
              else sample_volume_grid_backward_x_backward_plain)
        ggrid, dx, dg = fn(gg_x, gg_grid, grid, x, g, ctx.R, ctx.bound, wants)
        return ggrid, dx, dg, None, None, None


class _SampleVolumeGrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, x, R, bound):
        ctx.save_for_backward(grid, x)
        ctx.R, ctx.bound = R, bound
        if x.is_cuda:
            return _sample_volume_grid_cuda(grid, x, R, bound)
        return sample_volume_grid_plain(grid, x, R, bound)

    @staticmethod
    def backward(ctx, g):
        grid, x = ctx.saved_tensors
        if kernels.wanted(ctx, 1):
            # the coordinate gradient as an autograd function, differentiable once more (K10²)
            grid_grad = kernels.wanted(ctx, 0)
            out = _SampleVolumeGridBackward.apply(grid, x, g, ctx.R, ctx.bound, grid_grad)
            return (*(out if grid_grad else (None, out)), None, None)
        return _SampleVolumeGrid.grid_backward(ctx, g)

    @staticmethod
    @kernels.first_order
    def grid_backward(ctx, g):
        grid, x = ctx.saved_tensors
        fn = _sample_volume_grid_backward_cuda if x.is_cuda else sample_volume_grid_backward_plain
        ggrid, _ = fn(g, grid, x, ctx.R, ctx.bound, kernels.wanted(ctx, 0), False)
        return ggrid, None, None, None


def sample_volume_grid(params: Dict, x: torch.Tensor, cfg: VolumeGridConfig,
                       bound: float) -> torch.Tensor:
    """Trilinear sample at x in [-bound, bound]^3 -> (N, 1 + F) f32;
    differentiable in the grid and, when ``x`` requires it, in the points
    (K10's backward computes only what is asked for)."""
    R = cfg.resolution
    grid = params["grid"].reshape(R * R * R, -1)
    return _SampleVolumeGrid.apply(grid, x, R, float(bound))


# ---------------------------------------------------------------- SDF geometry

@dataclasses.dataclass(frozen=True)
class SDFConfig:
    """Implicit SDF geometry (reference implicit_sdf.py): an SDF head and a
    feature head on the shared encoding, a geometric bias (``sdf_bias``) so
    the zero level set starts as a sphere or ellipsoid, and ``beta`` of the
    VolSDF Laplace density sigma = (1/beta) Psi_beta(-sdf) through which the
    SDF renders with the density renderers."""
    sdf_bias: str = "sphere"       # 'sphere' | 'ellipsoid' | 'none'
    sdf_bias_params: Tuple[float, ...] = (0.5,)
    init_beta: float = 0.1


def shifted_sdf(raw: torch.Tensor, x: torch.Tensor, cfg: SDFConfig) -> torch.Tensor:
    """Apply the geometric bias (implicit_sdf.py get_shifted_sdf)."""
    if cfg.sdf_bias == "sphere":
        bias = _norm(x) - cfg.sdf_bias_params[0]
    elif cfg.sdf_bias == "ellipsoid":
        size = torch.tensor(cfg.sdf_bias_params, dtype=torch.float32, device=x.device)
        k = _norm(x / size)
        bias = k * (k - 1.0) / torch.maximum(_norm(x / (size * size)), x.new_tensor(1e-8))
    elif cfg.sdf_bias == "none":
        bias = 0.0
    else:
        raise ValueError(f"unknown sdf_bias {cfg.sdf_bias!r}")
    return raw + bias


def laplace_density(sdf: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """VolSDF density: sigma = (1/beta) Laplace_CDF(-sdf; 0, beta), with
    JAX's guards so that neither branch of the select makes a NaN gradient."""
    beta = torch.maximum(beta, beta.new_tensor(1e-4))
    s = -sdf / beta
    zero = s.new_tensor(0.0)
    cdf = torch.where(s <= 0, 0.5 * plain_exp(torch.minimum(s, zero)),
                      1.0 - 0.5 * plain_exp(-torch.maximum(s, zero)))
    return cdf / beta


# ---------------------------------------------------------------- materials

def material_no_material(params: Dict, d: torch.Tensor, geo_feat: torch.Tensor, dtype) -> torch.Tensor:
    """RGB directly from the first 3 feature channels (no_material.py):
    view-independent sigmoid colour; needs geo_feat_dim >= 3."""
    del params, d, dtype
    return torch.sigmoid(geo_feat[..., :3].float())


def material_diffuse_point_light(geo_feat: torch.Tensor, positions: torch.Tensor,
                                 shading_normal: torch.Tensor, light_positions,
                                 ambient_light_color=(0.1, 0.1, 0.1),
                                 diffuse_light_color=(0.9, 0.9, 0.9),
                                 shading: str = "diffuse") -> torch.Tensor:
    """Lambertian point-light shading (diffuse_with_point_light_material.py):
    albedo = sigmoid(feat[:3]); diffuse = max(0, n . normalize(light - x))
    * diffuse colour; 'albedo' | 'textureless' | 'diffuse'."""
    albedo = torch.sigmoid(geo_feat[..., :3].float())
    if shading == "albedo":
        return albedo
    dev = positions.device
    amb = torch.tensor(ambient_light_color, dtype=torch.float32, device=dev)
    dif = torch.tensor(diffuse_light_color, dtype=torch.float32, device=dev)
    lp = torch.as_tensor(light_positions, dtype=torch.float32, device=dev).expand(positions.shape)
    ldir = lp - positions
    ldir = ldir / torch.maximum(_norm(ldir, keepdim=True), ldir.new_tensor(1e-8))
    lambert = torch.maximum((shading_normal * ldir).sum(-1, keepdim=True), ldir.new_tensor(0.0))
    textureless = lambert * dif + amb
    if shading == "textureless":
        return textureless.expand(albedo.shape)
    if shading == "diffuse":
        return _clip(albedo, 0.0, 1.0) * textureless
    raise ValueError(f"unknown shading {shading!r}")


# -------------------------------------------------------------- backgrounds

def init_env_map_bg(cfg: NeRFConfig, generator: Optional[torch.Generator] = None,
                    device: DeviceLike = None) -> Dict:
    device = resolve_device(device)
    dims = [sh_dim(cfg.sh_degree)] + [cfg.hidden_dim_bg] * (cfg.num_layers_bg - 1) + [3]
    return {"env_net": {k: v.to(device) for k, v in _init_mlp(dims, generator).items()}}


def background_env_map(params: Dict, d: torch.Tensor, cfg: NeRFConfig, dtype) -> torch.Tensor:
    """Direction-conditioned MLP background
    (neural_environment_map_background.py: SH -> MLP -> sigmoid)."""
    sh = sh_encode(d, cfg.sh_degree).to(dtype)
    return torch.sigmoid(_mlp(params["env_net"], sh, dtype).float())


def init_textured_bg(generator: Optional[torch.Generator] = None, device: DeviceLike = None,
                     height: int = 64, width: int = 128) -> Dict:
    device = resolve_device(device)
    tex = 0.1 * torch.randn((height, width, 3), generator=generator, dtype=torch.float32)
    return {"bg_texture": tex.to(device)}


def _texel_taps(d: torch.Tensor, H: int, W: int):
    """The 4 taps' texture rows and weights, dv the outer loop: [(rows (N,),
    w (N,))]."""
    dn = d / _norm(d, keepdim=True)
    theta = torch.acos(_clip(dn[:, 1], -1.0, 1.0))
    phi = torch.atan2(dn[:, 0], dn[:, 2]) + math.pi
    v = _clip(theta / math.pi * (H - 1), 0.0, _clip_hi(H))
    u = _clip(phi / (2 * math.pi) * (W - 1), 0.0, _clip_hi(W))
    fv0, fu0 = torch.floor(v), torch.floor(u)
    v0, u0, fv, fu = fv0.long(), fu0.long(), v - fv0, u - fu0
    taps = []
    for dv in (0, 1):
        wv = fv if dv else 1 - fv
        for du in (0, 1):
            wu = fu if du else 1 - fu
            rows = torch.clamp(v0 + dv, max=H - 1) * W + torch.clamp(u0 + du, max=W - 1)
            taps.append((rows, wv * wu))
    return taps


def background_textured_plain(tex: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Plain version of K11: tex (H, W, 3) f32, d (N, 3) -> sigmoid RGB
    (N, 3) f32."""
    H, W = tex.shape[:2]
    flat = tex.reshape(H * W, 3)
    out = torch.zeros((d.shape[0], 3), dtype=torch.float32, device=d.device)
    for rows, w in _texel_taps(d, H, W):
        out = out + flat[rows] * w[:, None]
    return torch.sigmoid(out)


def background_textured_backward_plain(g: torch.Tensor, s: torch.Tensor, d: torch.Tensor, H: int,
                                       W: int) -> torch.Tensor:
    """Plain version of the K11 backward: g (N, 3), the forward's output s
    -> the texture gradient (H, W, 3) f32, each tap's row accumulating
    w * g s (1 - s) (``index_add_``)."""
    gs = g.float() * (s * (1 - s))
    acc = torch.zeros((H * W, 3), dtype=torch.float32, device=g.device)
    for rows, w in _texel_taps(d, H, W):
        acc.index_add_(0, rows, w[:, None] * gs)
    return acc.reshape(H, W, 3)


class _TexturedBackground(torch.autograd.Function):
    """Differentiable in the texture; the direction is a ray direction and
    gets none."""

    @staticmethod
    def forward(ctx, tex, d):
        out = _background_textured_cuda(tex, d) if d.is_cuda else background_textured_plain(tex, d)
        ctx.save_for_backward(d, out)
        ctx.hw = tuple(tex.shape[:2])
        return out

    @staticmethod
    @kernels.first_order
    def backward(ctx, g):
        d, s = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        fn = _background_textured_backward_cuda if d.is_cuda else background_textured_backward_plain
        return fn(g, s, d, *ctx.hw), None


def background_textured(params: Dict, d: torch.Tensor) -> torch.Tensor:
    """Equirectangular learnable texture (textured_background.py): direction
    -> (theta, phi) -> bilinear texel blend, sigmoid colour (N, 3) f32."""
    return _TexturedBackground.apply(params["bg_texture"], d)


def background_solid(params: Dict, d: torch.Tensor, color: float) -> torch.Tensor:
    del params
    return torch.full((d.shape[0], 3), color, dtype=torch.float32, device=d.device)


GEOMETRY_REGISTRY = ("implicit-volume", "volume-grid", "implicit-sdf")
MATERIAL_REGISTRY = ("neural-radiance-material", "no-material",
                     "diffuse-with-point-light-material")
BACKGROUND_REGISTRY = ("solid-color-background",
                       "neural-environment-map-background",
                       "textured-background")
NORMAL_TYPES = ("none", "finite_difference", "finite_difference_laplacian",
                "analytic", "pred")


# ------------------------------------------------------------------- field

def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach() if torch.is_tensor(tree) else tree


def _views(tree):
    if isinstance(tree, dict):
        return {k: _views(v) for k, v in tree.items()}
    return tree.view_as(tree) if torch.is_tensor(tree) else tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


class RegistryField:
    """NeRFField-compatible field assembled from registry names.

    Non-default geometry swaps the spatial encoding, non-default material and
    background swap the shading and background heads. Renderers see only the
    duck-typed interface, so any combination runs through ``render_occgrid``
    and ``render_dense``; ``background(params, d)`` goes in as
    ``bg_fn=lambda sph, d: field.background(params, d)``.
    """

    def __init__(self, cfg: NeRFConfig,
                 geometry: str = "implicit-volume",
                 material: str = "neural-radiance-material",
                 background: str = "solid-color-background",
                 grid_cfg: Optional[VolumeGridConfig] = None,
                 sdf_cfg: Optional[SDFConfig] = None,
                 background_color: float = 0.0,
                 normal_type: str = "none",
                 fd_normal_eps: float = 0.01,
                 light_position=(2.0, 2.0, 2.0),
                 ambient_light_color=(0.1, 0.1, 0.1),
                 diffuse_light_color=(0.9, 0.9, 0.9)):
        if geometry not in GEOMETRY_REGISTRY:
            raise ValueError(f"unknown geometry {geometry!r}; have {GEOMETRY_REGISTRY}")
        if material not in MATERIAL_REGISTRY:
            raise ValueError(f"unknown material {material!r}; have {MATERIAL_REGISTRY}")
        if background not in BACKGROUND_REGISTRY:
            raise ValueError(f"unknown background {background!r}; have {BACKGROUND_REGISTRY}")
        if normal_type not in NORMAL_TYPES:
            raise ValueError(f"unknown normal_type {normal_type!r}; have {NORMAL_TYPES}")
        self.cfg = cfg
        self.geometry = geometry
        self.material = material
        self.bg_kind = background
        self.background_color = background_color
        self.grid_cfg = grid_cfg or VolumeGridConfig(feature_dim=cfg.geo_feat_dim)
        self.sdf_cfg = sdf_cfg or SDFConfig()
        self._inner = NeRFField(cfg)
        self.dtype = self._inner.dtype
        # normals (reference implicit_volume.py:48-51, :141-186); the diffuse
        # material requires them
        self.requires_normal = material == "diffuse-with-point-light-material"
        if self.requires_normal and normal_type == "none":
            normal_type = "finite_difference"
        self.normal_type = normal_type
        self.fd_normal_eps = fd_normal_eps
        self.light_position = tuple(light_position)
        self.ambient_light_color = tuple(ambient_light_color)
        self.diffuse_light_color = tuple(diffuse_light_color)

    # -- params
    def init_params(self, generator: Optional[torch.Generator] = None,
                    device: DeviceLike = None) -> Dict:
        """The JAX package's tree, drawn from ``generator``, on ``device``
        (``cuda`` by default): NeRFField's, with ``encoder`` the voxel grid
        and no ``sigma_net`` on volume-grid; ``sdf_net``, ``feature_net`` and
        the 0-dim ``log_beta`` instead of ``sigma_net`` on implicit-sdf;
        ``env_net`` or ``bg_texture`` for those backgrounds; ``normal_net``
        for ``pred`` normals."""
        device = resolve_device(device)
        cfg = self.cfg
        params = init_nerf_params(cfg, generator, device)
        if self.geometry == "volume-grid":
            params["encoder"] = init_volume_grid(self.grid_cfg, generator, device)
            params.pop("sigma_net")  # channel 0 is raw density (volume_grid.py has no decoder)
        elif self.geometry == "implicit-sdf":
            params.pop("sigma_net")
            for name, out in (("sdf_net", 1), ("feature_net", cfg.geo_feat_dim)):
                net = _init_mlp([cfg.in_dim, cfg.hidden_dim, out], generator)
                params[name] = {k: v.to(device) for k, v in net.items()}
            params["log_beta"] = torch.tensor(math.log(self.sdf_cfg.init_beta),
                                              dtype=torch.float32, device=device)
        if self.bg_kind == "neural-environment-map-background":
            params.update(init_env_map_bg(cfg, generator, device))
        elif self.bg_kind == "textured-background":
            params.update(init_textured_bg(generator, device))
        if self.normal_type == "pred":
            enc_dim = 1 + self.grid_cfg.feature_dim if self.geometry == "volume-grid" else cfg.in_dim
            net = _init_mlp([enc_dim, cfg.hidden_dim, 3], generator)
            params["normal_net"] = {k: v.to(device) for k, v in net.items()}
        return params

    # -- NeRFField interface
    def build_planes(self, params: Dict, max_resolution: int = -1,
                     modes: Optional[Tuple[str, ...]] = None) -> Dict:
        if self.geometry == "volume-grid":
            return {}
        return self._inner.build_planes(params, max_resolution, modes)

    def density(self, params: Dict, planes: Dict, x: torch.Tensor,
                resolution_mode: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
        """x (N, 3) -> (sigma (N,) f32, geo_feat (N, G)); ``resolution_mode``
        picks the triplane's plane on the implicit volume (the other
        geometries ignore it, as in the JAX package)."""
        if self.geometry == "volume-grid":
            feats = sample_volume_grid(params["encoder"], x, self.grid_cfg, self.cfg.bound)
            sigma = trunc_exp(self._inner._density_blob(x, feats[..., 0]))
            return sigma, feats[..., 1:]
        if self.geometry == "implicit-sdf":
            enc = self._encode(params, planes, x).to(self.dtype)
            sdf = self.sdf(params, planes, x, enc=enc)
            feats = _mlp(params["feature_net"], enc, self.dtype)
            sigma = laplace_density(sdf, plain_exp(params["log_beta"]))
            return sigma, feats.float()
        return self._inner.density(params, planes, x, resolution_mode)

    def sdf(self, params: Dict, planes: Dict, x: torch.Tensor,
            enc: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Shifted signed distance (implicit_sdf.py forward_sdf +
        get_shifted_sdf). Only for geometry='implicit-sdf'."""
        if enc is None:
            enc = self._encode(params, planes, x).to(self.dtype)
        raw = _mlp(params["sdf_net"], enc, self.dtype)[..., 0]
        return shifted_sdf(raw.float(), x, self.sdf_cfg)

    def _encode(self, params: Dict, planes: Dict, x: torch.Tensor) -> torch.Tensor:
        """The raw spatial encoding (what the pred-normal and SDF heads read,
        implicit_volume.py:216)."""
        if self.geometry == "volume-grid":
            return sample_volume_grid(params["encoder"], x, self.grid_cfg, self.cfg.bound)
        if self._inner._enc_apply is not None:
            return self._inner._enc_apply(params["encoder"], x)
        return sample_triplane(planes, x, self.cfg.triplane, lbound=self.cfg.bound,
                               enc_params=params["encoder"])

    def _density_only(self, params: Dict, planes: Dict, x: torch.Tensor) -> torch.Tensor:
        if self.geometry == "volume-grid":
            feats = sample_volume_grid(params["encoder"], x, self.grid_cfg, self.cfg.bound)
            return trunc_exp(self._inner._density_blob(x, feats[..., 0]))
        return self.density(params, planes, x)[0]

    def normal(self, params: Dict, planes: Dict, x: torch.Tensor) -> torch.Tensor:
        """Unit shading normals per ``normal_type`` (implicit_volume.py:141-218):

        * ``finite_difference``: forward difference over +eps offsets of the
          clipped stencil, ``n = -normalize(d(x + eps e_i) - d(x))``;
        * ``finite_difference_laplacian``: the central 6-point stencil;
        * ``analytic``: ``-normalize(grad_x density)`` by
          ``torch.autograd.grad`` on a detached copy of x under
          ``torch.enable_grad()`` (so it also serves under ``no_grad``);
          with grad mode on and a parameter requiring a gradient (training
          through it) with ``create_graph=True`` on the live parameters, so
          a loss's gradient reaches every parameter through the samplers'
          second derivatives (K2x², K7x², K10²), as ``jax.grad`` inside
          ``jax.value_and_grad`` does;
        * ``pred``: an MLP head on the spatial encoding.

        For ``implicit-sdf`` the differenced scalar is the SDF with a
        positive sign (outward) instead of the density's negative."""
        b = self.cfg.bound
        if self.geometry == "implicit-sdf":
            def scalar(p, prm=params, pl=planes):
                return self.sdf(prm, pl, p)
            sign = 1.0
        else:
            def scalar(p, prm=params, pl=planes):
                return self._density_only(prm, pl, p)
            sign = -1.0
        if self.normal_type in ("finite_difference", "finite_difference_laplacian"):
            eps = self.fd_normal_eps
            if self.normal_type == "finite_difference_laplacian":
                offs = torch.tensor([[eps, 0, 0], [-eps, 0, 0], [0, eps, 0],
                                     [0, -eps, 0], [0, 0, eps], [0, 0, -eps]],
                                    dtype=torch.float32, device=x.device)
                pts = torch.clamp(x[:, None, :] + offs[None], -b, b)
                dd = scalar(pts.reshape(-1, 3)).reshape(-1, 6)
                g = sign * 0.5 * (dd[:, 0::2] - dd[:, 1::2]) * _inv(eps)  # jit's / eps
            else:
                offs = eps * torch.eye(3, dtype=torch.float32, device=x.device)
                pts = torch.clamp(x[:, None, :] + offs[None], -b, b)
                dd = scalar(pts.reshape(-1, 3))
                d0 = scalar(x)
                g = sign * (dd.reshape(-1, 3) - d0[:, None]) * _inv(eps)
        elif self.normal_type == "analytic":
            train = torch.is_grad_enabled() and any(t.requires_grad for tree in (params, planes)
                                                    for t in _leaves(tree))
            with torch.enable_grad():
                xr = x.detach().requires_grad_(True)
                # views, not leaves, go in, so the samplers' backwards see
                # (kernels.wanted) that the inner gradient reads no plane,
                # table or grid gradient and the loss's no point gradient
                xv = xr.view_as(xr)
                if train:  # differentiable in the parameters (K2x², K7x², K10² behind it)
                    s = scalar(xv, _views(params), _views(planes))
                    g = sign * torch.autograd.grad(s.sum(), xr, create_graph=True)[0]
                else:
                    g = sign * torch.autograd.grad(scalar(xv, _detached(params), _detached(planes)).sum(),
                                                   xr)[0]
        elif self.normal_type == "pred":
            enc = self._encode(params, planes, x).to(self.dtype)
            g = _mlp(params["normal_net"], enc, self.dtype).float()
        else:
            raise ValueError(f"normal_type {self.normal_type!r} cannot produce normals")
        return g / torch.maximum(_norm(g, keepdim=True), g.new_tensor(1e-8))

    def color(self, params: Dict, d: torch.Tensor, geo_feat: torch.Tensor,
              x: Optional[torch.Tensor] = None, planes: Optional[Dict] = None,
              shading: str = "diffuse") -> torch.Tensor:
        if self.material == "no-material":
            return material_no_material(params, d, geo_feat, self.dtype)
        if self.material == "diffuse-with-point-light-material":
            if x is None:
                raise ValueError(
                    "diffuse-with-point-light-material needs sample positions;"
                    " call the field (__call__) or pass x= explicitly")
            n = self.normal(params, planes or {}, x)
            return material_diffuse_point_light(
                geo_feat, x, n, self.light_position, self.ambient_light_color,
                self.diffuse_light_color, shading)
        return self._inner.color(params, d, geo_feat)

    def __call__(self, params: Dict, planes: Dict, x: torch.Tensor, d: torch.Tensor,
                 resolution_mode: str = "full"):
        sigma, geo = self.density(params, planes, x, resolution_mode)
        return sigma, self.color(params, d, geo, x=x, planes=planes)

    def background(self, params: Dict, d: torch.Tensor) -> torch.Tensor:
        if self.bg_kind == "neural-environment-map-background":
            return background_env_map(params, d, self.cfg, self.dtype)
        if self.bg_kind == "textured-background":
            return background_textured(params, d)
        return background_solid(params, d, self.background_color)


def make_field(cfg: NeRFConfig,
               geometry: str = "implicit-volume",
               material: str = "neural-radiance-material",
               background: str = "solid-color-background",
               **kw) -> Tuple[Callable[..., Dict], object]:
    """Registry names -> (init_fn(generator=None, device=None), field). The
    default triple returns :class:`NeRFField` itself."""
    if (geometry, material, background) == (
        "implicit-volume", "neural-radiance-material", "solid-color-background"
    ):
        return (lambda generator=None, device=None: init_nerf_params(cfg, generator, device)), NeRFField(cfg)
    field = RegistryField(cfg, geometry, material, background, **kw)
    return field.init_params, field


# ---------------------------------------------------------------------------
# K10 and K11 wrappers
# ---------------------------------------------------------------------------

_K10_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
_K10_BWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_float] + [ctypes.c_void_p] * 3


def _check_volume(grid: torch.Tensor, x: torch.Tensor, R: int, what: str) -> None:
    """What K10 takes: a contiguous (R^3, CH) f32 grid and (N, 3) f32 points
    on one device."""
    if grid.device != x.device:
        raise ValueError(f"{what}: grid and points on different devices")
    if grid.dim() != 2 or grid.shape[0] != R**3 or grid.dtype != torch.float32 or not grid.is_contiguous():
        raise ValueError(f"{what}: the grid must be contiguous ({R ** 3}, CH) f32 rows, got "
                         f"{tuple(grid.shape)} {grid.dtype}")
    if x.dim() != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"{what}: x must be (N, 3) f32, got {tuple(x.shape)} {x.dtype}")


def _sample_volume_grid_cuda(grid: torch.Tensor, x: torch.Tensor, R: int, bound: float) -> torch.Tensor:
    """K10 forward: a lane group per point, a lane per float4 slice of its
    row; the plain version's bits."""
    _check_volume(grid, x, R, "sample_volume_grid kernel")
    x = x.contiguous()
    N, CH = x.shape[0], grid.shape[1]
    out = torch.empty((N, CH), device=x.device, dtype=torch.float32)
    if N == 0:
        return out
    fn = _build.function("volume_grid", "volume_grid_launch", _K10_ARGS)
    _build.check(fn(_build.ptr(x), _build.ptr(grid), N, R, CH, _inv(bound), _clip_hi(R),
                    _build.ptr(out), _build.stream(x.device)), "sample_volume_grid")
    kernels.launches["volume_grid"] += 1
    return out


def _sample_volume_grid_backward_cuda(g: torch.Tensor, grid: torch.Tensor, x: torch.Tensor, R: int,
                                      bound: float, grid_grad: bool = True, x_grad: bool = True):
    """K10 backward: one launch, lane groups as in the forward; the grid
    gradient (float4 atomics where the rows allow, a run of points in one
    cell summed first) and dL/dx (N, 3), each only when asked for (the grid
    gradient alone reads no grid row; dL/dx alone adds nothing)."""
    what = "sample_volume_grid backward kernel"
    _check_volume(grid, x, R, what)
    N, CH = x.shape[0], grid.shape[1]
    if g.device != x.device or tuple(g.shape) != (N, CH):
        raise ValueError(f"{what}: g must be ({N}, {CH}) on {x.device}, got {tuple(g.shape)} "
                         f"on {g.device}")
    g = g.float().contiguous()
    x = x.contiguous()
    ggrid = torch.zeros_like(grid) if grid_grad else None
    gx = torch.empty((N, 3), device=x.device, dtype=torch.float32) if x_grad else None
    if N > 0 and (grid_grad or x_grad):
        fn = _build.function("volume_grid", "volume_grid_backward_launch", _K10_BWD_ARGS)
        _build.check(fn(_build.ptr(x), _build.ptr(g), _build.ptr(grid), N, R, CH, _inv(bound),
                        _clip_hi(R), _build.ptr(ggrid) if grid_grad else None,
                        _build.ptr(gx) if x_grad else None, _build.stream(x.device)), what)
        kernels.launches["volume_grid_bwd"] += 1
    return ggrid, gx


_K11_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
_K11_BWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_float] + [ctypes.c_void_p] * 2


def _check_directions(d: torch.Tensor, what: str) -> None:
    if d.dim() != 2 or d.shape[1] != 3 or d.dtype != torch.float32:
        raise ValueError(f"{what}: d must be (N, 3) f32, got {tuple(d.shape)} {d.dtype}")


def _background_textured_cuda(tex: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """K11 forward: one thread per ray."""
    what = "background_textured kernel"
    if tex.device != d.device or tex.dim() != 3 or tex.shape[2] != 3 or tex.dtype != torch.float32:
        raise ValueError(f"{what}: the texture must be (H, W, 3) f32 on {d.device}, got "
                         f"{tuple(tex.shape)} {tex.dtype} on {tex.device}")
    _check_directions(d, what)
    H, W = tex.shape[:2]
    tex, d = tex.contiguous(), d.contiguous()
    out = torch.empty((d.shape[0], 3), device=d.device, dtype=torch.float32)
    if d.shape[0] == 0:
        return out
    fn = _build.function("textured_bg", "textured_bg_launch", _K11_ARGS)
    _build.check(fn(_build.ptr(d), _build.ptr(tex), d.shape[0], H, W, _clip_hi(H), _clip_hi(W),
                    _build.ptr(out), _build.stream(d.device)), "background_textured")
    kernels.launches["textured_bg"] += 1
    return out


def _background_textured_backward_cuda(g: torch.Tensor, s: torch.Tensor, d: torch.Tensor, H: int,
                                       W: int) -> torch.Tensor:
    """K11 backward: the texture gradient (H, W, 3) f32, one cooperative
    launch that zeroes it and adds each warp's merged texel sums with
    vector atomics."""
    what = "background_textured backward kernel"
    _check_directions(d, what)
    N = d.shape[0]
    for name, t in (("g", g), ("s", s)):
        if t.device != d.device or tuple(t.shape) != (N, 3):
            raise ValueError(f"{what}: {name} must be ({N}, 3) on {d.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    g, s, d = g.float().contiguous(), s.float().contiguous(), d.contiguous()
    acc = torch.empty((H, W, 3), device=d.device, dtype=torch.float32)  # the kernel zeroes it
    fn = _build.function("textured_bg", "textured_bg_backward_launch", _K11_BWD_ARGS)
    _build.check(fn(_build.ptr(d), _build.ptr(g), _build.ptr(s), N, H, W, _clip_hi(H), _clip_hi(W),
                    _build.ptr(acc), _build.stream(d.device)), what)
    kernels.launches["textured_bg_bwd"] += 1
    return acc


_K10XX_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                       ctypes.c_float] + [ctypes.c_void_p] * 4


def _sample_volume_grid_backward_x_backward_cuda(gg_x, gg_grid, grid: torch.Tensor, x: torch.Tensor,
                                                 g: torch.Tensor, R: int, bound: float,
                                                 wants=(True, True, True)):
    """K10²: (the grid gradient (R^3, CH) f32, dL/dx (N, 3) f32, dL/dg (N,
    CH) f32) as ``sample_volume_grid_backward_x_backward_plain`` defines
    them. From ``gg_x``: one launch, a block per span of points, the points
    gg reaches compacted, each run of them in one cell adding its float4
    atomics into the grid gradient (zeroed here: the launch adds into it)
    once. ``gg_grid`` adds the K10 forward and K10's coordinate gradient
    on it."""
    what = "sample_volume_grid backward (x) backward kernel"
    want_grid, want_x, want_g = wants
    _check_volume(grid, x, R, what)
    N, CH = x.shape[0], grid.shape[1]
    if g.device != x.device or tuple(g.shape) != (N, CH):
        raise ValueError(f"{what}: g must be ({N}, {CH}) on {x.device}, got {tuple(g.shape)} "
                         f"on {g.device}")
    g = g.float().contiguous()
    x = x.contiguous()
    ggrid = dx = dg = None
    if gg_x is not None and (want_grid or want_x or want_g):
        if gg_x.device != x.device or tuple(gg_x.shape) != (N, 3):
            raise ValueError(f"{what}: gg_x must be ({N}, 3) on {x.device}, got {tuple(gg_x.shape)} "
                             f"on {gg_x.device}")
        gg_x = gg_x.float().contiguous()
        ggrid = torch.zeros_like(grid) if want_grid else None
        dx = torch.empty((N, 3), device=x.device, dtype=torch.float32) if want_x else None
        dg = torch.empty((N, CH), device=x.device, dtype=torch.float32) if want_g else None
        if N > 0:
            opt = lambda t: None if t is None else _build.ptr(t)  # noqa: E731
            fn = _build.function("volume_grid", "volume_grid_backward_x_backward_launch", _K10XX_ARGS)
            _build.check(fn(_build.ptr(x), _build.ptr(g), _build.ptr(gg_x), _build.ptr(grid), N, R, CH,
                            _inv(bound), _clip_hi(R), opt(ggrid), opt(dx), opt(dg), _build.stream(x.device)),
                         what)
            kernels.launches["volume_grid_bwd_x_bwd"] += 1
    if gg_grid is not None:
        gg_grid = gg_grid.float().contiguous()
        if want_g:
            f = _sample_volume_grid_cuda(gg_grid, x, R, bound)
            dg = f if dg is None else dg + f
        if want_x:
            d = _sample_volume_grid_backward_cuda(g, gg_grid, x, R, bound, False, True)[1]
            dx = d if dx is None else dx + d
    return ggrid, dx, dg
