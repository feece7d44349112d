"""Second derivatives of the samplers' coordinate gradients (K2x², K7x²,
K10²) and training through analytic normals: the PyTorch port against the
JAX package (CPU).

Op level: each plain version (``sample_points_backward_xyz_backward_plain``,
``grid_encode_backward_x_backward_plain`` under linear and smoothstep
interpolation, ``sample_volume_grid_backward_x_backward_plain``) against
``jax.vjp`` of the JAX function's first-order vjp in (planes or tables or
grid, points), differentiated in (planes or tables or grid, points,
cotangent), with and without a cotangent on the first-order parameter
gradient. Inputs come from a numpy seed at small shapes (planes 3 x 8 x 8 x
4, three hash levels, R = 8), float32, and include points exactly on the
clip borders (JAX splits a tie's gradient, 0.5, and its second derivative
is 0) and exactly on cell boundaries. K2 is held to op-by-op JAX (the port
rounds the texel coordinate as op-by-op JAX does); K7 and K10 to jitted JAX
(the port rounds their cell coordinate as jit does). Tolerance: 1e-5 of
max|JAX| per output (float32 sums in other orders).

Field level: ``tests/test_registry.py``'s ``test_trains_through_renderer``
loss (its CFG, 32 rays from (0, 0, -0.9) about +z, a fully occupied 16^3
grid, the flat march of 64 steps, MSE against numpy-made colours) on a
field under the diffuse point-light material with analytic normals: the
triplane, ``implicit-sdf``, ``volume-grid`` (R = 16) and
``encoding="hashgrid"``, float32 MLPs. The port's ``autograd.grad`` of the
loss against the jitted ``jax.value_and_grad``: the losses within 1e-5
relative, every parameter leaf's gradient within 1e-5 relative L2 of
JAX's (float32 sums in other orders through the renderer, the MLPs' double
backward and the samplers' second derivatives).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_registry import _fields, _flat
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.models import gridencoder as JG
from trinerflet_tpu.models import registry as JR
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.ops import grid_sample as JGS
from trinerflet_tpu.render import renderer as JRR
from trinerflet_tpu_torch.models import gridencoder as PG
from trinerflet_tpu_torch.models import registry as PR
from trinerflet_tpu_torch.ops import grid_sample as GS
from trinerflet_tpu_torch.render import renderer as PRR

OP_TOL = 1e-5  # of max|JAX|


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL * np.abs(want).max() + 1e-30, err_msg=what)


def _exact_points(coord, targets, want):
    """For each target, the nearest float32 x (within 64 ulps) whose
    coordinate ``coord(x)`` (the port's, rounded as the compared JAX function
    rounds it) is exactly ``want``: a cell boundary or a clip border."""
    out = []
    for t, w in zip(targets, want):
        up = down = np.float32(t)
        cands = [up]
        for _ in range(64):
            up, down = np.nextafter(up, np.float32(np.inf)), np.nextafter(down, np.float32(-np.inf))
            cands += [up, down]
        cands = np.array(cands, np.float32)
        hit = cands[coord(torch.from_numpy(cands)).numpy() == w]
        if hit.size:
            out.append(hit[0])
    return np.array(out, np.float32)


def _points(rng, n, coord, edges, lo, hi):
    """n random points in [lo, hi]^3, then points whose every coordinate sits
    exactly on a cell boundary or a clip border (``edges``: (target, exact
    coordinate) pairs), mixed with random ones."""
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    on = _exact_points(coord, *zip(*edges))
    assert on.size >= len(edges) // 2
    picks = rng.choice(on, (3 * on.size, 3))
    mixed = np.where(rng.uniform(size=picks.shape) < 0.5, picks, rng.uniform(lo, hi, picks.shape))
    return np.concatenate([x, picks, mixed.astype(np.float32)]).astype(np.float32)


# ---------------------------------------------------------------------------
# K2x²
# ---------------------------------------------------------------------------

K2_SHAPE, K2_LB = (3, 8, 8, 4), 1.0


def _jax_k2xx(planes, x, g, gg_planes, gg_x):
    def k2(p, xx):
        return JGS.sample_planes(p, JT.project_to_planes(xx, K2_LB))

    def k2x(p, xx, gg):
        return jax.vjp(k2, p, xx)[1](gg)

    return jax.vjp(k2x, planes, x, g)[1]((gg_planes, gg_x))


@pytest.mark.parametrize("with_gg_planes", [False, True], ids=["gg_x", "gg_x+gg_planes"])
def test_k2xx_plain_matches_jax(with_gg_planes):
    rng = np.random.default_rng(0)
    W = K2_SHAPE[2]
    coord = lambda v: (GS._divide(v, K2_LB) + 1.0) * 0.5 * (W - 1)  # noqa: E731
    edges = [(2 * k / (W - 1) - 1, float(k)) for k in range(W)]
    x = _points(rng, 96, coord, edges, -1.1, 1.1)
    planes = rng.standard_normal(K2_SHAPE).astype(np.float32)
    g = rng.standard_normal((len(x), 3, K2_SHAPE[3])).astype(np.float32)
    gg_x = rng.standard_normal((len(x), 3)).astype(np.float32)
    gg_p = rng.standard_normal(K2_SHAPE).astype(np.float32) if with_gg_planes else np.zeros(K2_SHAPE, np.float32)
    want = _jax_k2xx(*(jnp.asarray(a) for a in (planes, x, g, gg_p, gg_x)))
    got = GS.sample_points_backward_xyz_backward_plain(
        torch.from_numpy(gg_x), torch.from_numpy(gg_p) if with_gg_planes else None, torch.from_numpy(planes),
        torch.from_numpy(x), torch.from_numpy(g), K2_LB)
    for name, a, b in zip(("dL/dplanes", "dL/dxyz", "dL/dg"), got, want):
        _close(a, b, name)
    assert np.abs(np.asarray(want[1])).max() > 0


# ---------------------------------------------------------------------------
# K7x²
# ---------------------------------------------------------------------------

K7_CFG = dict(num_levels=3, level_dim=2, base_resolution=4, desired_resolution=16, log2_hashmap_size=8)
K7_BOUND = 1.0


@functools.lru_cache(maxsize=None)
def _jax_k7xx(interpolation):
    cfg = JG.GridEncoderConfig(**K7_CFG, interpolation=interpolation)

    def k7(tables, x, g):
        return jax.vjp(lambda t, xx: JG.grid_encode(t, xx, cfg, K7_BOUND), tables, x)[1](g)

    return jax.jit(lambda tables, x, g, gg_t, gg_x: jax.vjp(k7, tables, x, g)[1]((gg_t, gg_x)))


@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
@pytest.mark.parametrize("with_gg_tables", [False, True], ids=["gg_x", "gg_x+gg_tables"])
def test_k7xx_plain_matches_jax(interpolation, with_gg_tables):
    cfg = PG.GridEncoderConfig(**K7_CFG, interpolation=interpolation)
    rng = np.random.default_rng(1)
    res = [cfg.level_resolution(l) for l in range(cfg.num_levels)]
    coord = lambda v: PG._unit_coord(v, K7_BOUND).clamp(0.0, 1.0) * res[1]  # noqa: E731
    edges = [(2 * k / res[1] - 1, float(k)) for k in range(res[1] + 1)]
    x = _points(rng, 96, coord, edges, -1.1, 1.1)
    L, C = cfg.num_levels, cfg.level_dim
    tables = [rng.uniform(-0.5, 0.5, (cfg.level_size(l), C)).astype(np.float32) for l in range(L)]
    g = rng.standard_normal((len(x), L * C)).astype(np.float32)
    gg_x = rng.standard_normal((len(x), 3)).astype(np.float32)
    gg_t = [(rng.standard_normal(t.shape) if with_gg_tables else np.zeros(t.shape)).astype(np.float32)
            for t in tables]
    names = [f"level_{l}" for l in range(L)]
    (jdt, jdx, jdg) = _jax_k7xx(interpolation)(
        {n: jnp.asarray(t) for n, t in zip(names, tables)}, jnp.asarray(x), jnp.asarray(g),
        {n: jnp.asarray(t) for n, t in zip(names, gg_t)}, jnp.asarray(gg_x))
    dx, dg, dt = PG.grid_encode_backward_x_backward_plain(
        torch.from_numpy(gg_x), [torch.from_numpy(t) for t in gg_t] if with_gg_tables else None,
        torch.from_numpy(x), torch.from_numpy(g), [torch.from_numpy(t) for t in tables], cfg, K7_BOUND)
    _close(dx, jdx, "dL/dx")
    _close(dg, jdg, "dL/dg")
    for n, t in zip(names, dt):
        _close(t, jdt[n], f"dL/d{n}")
    assert np.abs(np.asarray(jdx)).max() > 0


# ---------------------------------------------------------------------------
# K10²
# ---------------------------------------------------------------------------

K10_R, K10_CH, K10_BOUND = 8, 4, 1.0


@functools.lru_cache(maxsize=None)
def _jax_k10xx():
    cfg = JR.VolumeGridConfig(resolution=K10_R, feature_dim=K10_CH - 1)

    def k10(grid, x, g):
        return jax.vjp(lambda gr, xx: JR.sample_volume_grid({"grid": gr}, xx, cfg, K10_BOUND), grid, x)[1](g)

    return jax.jit(lambda grid, x, g, gg_grid, gg_x: jax.vjp(k10, grid, x, g)[1]((gg_grid, gg_x)))


@pytest.mark.parametrize("with_gg_grid", [False, True], ids=["gg_x", "gg_x+gg_grid"])
def test_k10xx_plain_matches_jax(with_gg_grid):
    R, CH = K10_R, K10_CH
    rng = np.random.default_rng(2)
    coord = lambda v: PR._voxel_cell(v[:, None].expand(-1, 3), R, K10_BOUND)[0][:, 0]  # noqa: E731
    edges = [(2 * k / (R - 1) - 1, float(k)) for k in range(R)]
    x = _points(rng, 96, coord, edges, -1.1, 1.1)
    grid = rng.standard_normal((R, R, R, CH)).astype(np.float32)
    g = rng.standard_normal((len(x), CH)).astype(np.float32)
    gg_x = rng.standard_normal((len(x), 3)).astype(np.float32)
    gg_grid = (rng.standard_normal(grid.shape) if with_gg_grid else np.zeros(grid.shape)).astype(np.float32)
    jgrid, jdx, jdg = _jax_k10xx()(*(jnp.asarray(a) for a in (grid, x, g, gg_grid, gg_x)))
    ggrid, dx, dg = PR.sample_volume_grid_backward_x_backward_plain(
        torch.from_numpy(gg_x), torch.from_numpy(gg_grid.reshape(R**3, CH)) if with_gg_grid else None,
        torch.from_numpy(grid.reshape(R**3, CH)), torch.from_numpy(x), torch.from_numpy(g), R, K10_BOUND)
    _close(ggrid, np.asarray(jgrid).reshape(R**3, CH), "dL/dgrid")
    _close(dx, jdx, "dL/dx")
    _close(dg, jdg, "dL/dg")
    assert np.abs(np.asarray(jdx)).max() > 0


# ---------------------------------------------------------------------------
# Training through analytic normals
# ---------------------------------------------------------------------------

N_RAYS = 32
FIELD_TOL = 1e-5  # relative L2 of each parameter's gradient
FIELD_SETUPS = {  # name -> (geometry, encoding, field kwargs, a parameter whose gradient must not vanish)
    "triplane": ("implicit-volume", "triplane_wavelet", {}, "encoder.base"),
    "sdf": ("implicit-sdf", "triplane_wavelet", {"sdf_cfg": dict(sdf_bias="sphere", sdf_bias_params=(0.5,))},
            "sdf_net.w1"),
    "grid": ("volume-grid", "triplane_wavelet", {}, "encoder.grid"),
    "hashgrid": ("implicit-volume", "hashgrid", {}, "encoder.level_0"),
}


@functools.lru_cache(maxsize=None)
def _field_case(name):
    """Both fields (diffuse material, analytic normals), the JAX package's
    initial parameters and the port's copy, the rays and colours of
    tests/test_registry.py's test_trains_through_renderer, and the jitted
    JAX value and gradient there (one compile per field, shared by the
    module)."""
    geometry, encoding, kw, _ = FIELD_SETUPS[name]
    jf, pf, jp, pp = _fields(geometry, "diffuse-with-point-light-material", "solid-color-background", encoding,
                             seed=5, normal_type="analytic", **kw)
    rng = np.random.default_rng(6)
    o = np.tile(np.array([[0.0, 0.0, -0.9]], np.float32), (N_RAYS, 1))
    d = rng.standard_normal((N_RAYS, 3)) * 0.1 + np.array([0, 0, 1.0])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    gt = rng.uniform(0.3, 0.7, (N_RAYS, 3)).astype(np.float32)
    rcfg = JRR.RenderConfig(bound=1.0, grid_size=16, max_steps=64, samples_per_ray_budget=8, dt_gamma=0.0,
                            march="flat", num_steps=64)
    occ = jnp.ones((1, 16, 16, 16), bool)

    def loss_fn(p):
        planes = jf.build_planes(p)
        out = JRR.render_occgrid(lambda x, dd: jf(p, planes, x, dd), jnp.asarray(o), jnp.asarray(d), occ, rcfg)
        return jnp.mean((out["image"] - jnp.asarray(gt)) ** 2), out["num_samples"]

    (jl, jn), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    return pf, pp, o, d, gt, float(jl), int(jn), {k: np.asarray(v) for k, v in _flat(jg).items()}


def _requiring_grad(tree):
    """A copy of the parameter tree whose leaves require a gradient."""
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def _port_loss(pf, params, o, d, gt):
    planes = pf.build_planes(params)
    rcfg = PRR.RenderConfig(bound=1.0, grid_size=16, max_steps=64, samples_per_ray_budget=8, dt_gamma=0.0,
                            march="flat", num_steps=64)
    out = PRR.render_occgrid(lambda x, dd: pf(params, planes, x, dd), torch.from_numpy(o), torch.from_numpy(d),
                             torch.ones((1, 16, 16, 16), dtype=torch.bool), rcfg)
    return ((out["image"] - torch.from_numpy(gt)) ** 2).mean(), int(out["num_samples"])


@pytest.mark.parametrize("name", sorted(FIELD_SETUPS))
def test_training_through_analytic_normals_matches_jax(name):
    pf, pp, o, d, gt, jl, jn, jg = _field_case(name)
    params = _requiring_grad(pp)
    leaves = _flat(params)
    loss, n = _port_loss(pf, params, o, d, gt)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    assert n == jn > 0
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
    assert set(leaves) == set(jg)
    for k, g in zip(leaves, grads):
        want = jg[k]
        got = np.zeros_like(want) if g is None else g.numpy()
        assert got.shape == want.shape, k
        scale = np.linalg.norm(want)
        err = np.linalg.norm(got - want)
        assert err <= FIELD_TOL * scale or (scale == 0 and err == 0), (k, err, scale)
    key = FIELD_SETUPS[name][3]
    assert np.abs(jg[key]).max() > 0, key
