"""The model registry's functions in the PyTorch port against the JAX
package (CPU): ``trinerflet_tpu_torch/models/registry.py`` against
``trinerflet_tpu/models/registry.py`` (K10, K11, the SDF, the materials,
the backgrounds, ``make_field``, the parameter trees and ``carry``'s round
trip), and K7x's plain version against
``jax.grad`` of ``grid_encode``.

Every input is made with numpy from a seed and handed to both packages; the
port's parameters come from the JAX package's ``init_params`` through
``carry.params_from_jax``. The JAX functions run op by op (the JAX
package's own tests call them so), except ``grid_encode`` and
``sample_volume_grid``, which the port rounds as jit does (``x * f32(1 /
bound) + 1`` fused, resp. ``x * f32(1 / bound) * 0.5 + 0.5``; see
``tests/test_torch_gridencoder.py`` and ``tests/test_torch_rounding.py``),
so K7x and K10 are held to jitted JAX, the points an argument.

Tolerances, stated per comparison:
* K10 (``sample_volume_grid``): features and the grid gradient within 1e-6
  absolute (the grid gradient's float32 sums run in another order); the
  point gradient within 1e-5 of its largest entry (JAX sums the corners'
  terms in another order), and exactly JAX's clip factor at the border:
  0.5 where q sits exactly on 0 or on the float32 bound (at bound 1,
  x = -1 and, at R = 64 where float32(R - 1 - 1e-6) is 63.0, x = +1); 0
  beyond.
* K7x: within 2e-6 of the largest entry of the jitted ``jax.grad`` (the
  corners' and channels' sums in another order), border ties included.
* K11 (``background_textured``): colours within 1e-6 (acos, atan2 and the
  sigmoid round an ulp apart), except that a direction whose phi lies
  within 1e-5 of the seam (phi = 0 = 2 pi, where u jumps from W - 1 to 0
  and the texture does not wrap) may take either side's value, which is
  JAX's colour there or JAX's colour of the same direction with d_x
  negated; the texture gradient within 1e-6, with the seam's rays given no
  cotangent.
* SDF bias, Laplace density, materials, backgrounds: 1e-6 absolute on
  values and gradients (1e-6 relative on the density, which is ~1/beta).

``tests/test_torch_registry_field.py`` holds ``RegistryField`` (every
geometry, material, background and normal type) on this file's setup.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_gridencoder import CASES, _points as _grid_points, _tables
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.models import gridencoder as JG
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import registry as JR
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu_torch.carry import params_from_jax
from trinerflet_tpu_torch.models import gridencoder as PG
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.models import registry as PR
from trinerflet_tpu_torch.models import triplane as PT
from trinerflet_tpu_torch.ops.grid_sample import _clip_grad

SMALL = dict(bound=1.0, geo_feat_dim=7, sh_degree=2, hidden_dim=16, hidden_dim_color=16)
TRI = dict(channels=4, resolution=32, wavelet_scale=2)
HASH = dict(num_levels=4, level_dim=2, base_resolution=4, desired_resolution=32, log2_hashmap_size=10)
N_PTS = 64  # one point count throughout: eager JAX compiles each primitive once per shape


def _cfgs(encoding="triplane_wavelet"):
    if encoding == "triplane_wavelet":
        return (JN.NeRFConfig(triplane=JT.TriplaneConfig(**TRI), **SMALL),
                PN.NeRFConfig(triplane=PT.TriplaneConfig(**TRI), **SMALL))
    return (JN.NeRFConfig(encoding=encoding, grid=JG.GridEncoderConfig(**HASH), **SMALL),
            PN.NeRFConfig(encoding=encoding, grid=PG.GridEncoderConfig(**HASH), **SMALL))


def _np(t):
    return np.asarray(t.detach() if torch.is_tensor(t) else t, np.float32)


def _flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _fields(geometry="implicit-volume", material="no-material", background="solid-color-background",
            encoding="triplane_wavelet", seed=0, bump=True, **kw):
    """Both fields, the JAX package's initial params (a random base plane
    so the triplane carries a signal; with ``bump`` a density bump in the
    voxel grid, so its normals have a direction) and the port's carried
    copy."""
    cj, cp = _cfgs(encoding)
    jkw, pkw = dict(kw), dict(kw)
    if geometry == "volume-grid":
        jkw["grid_cfg"] = JR.VolumeGridConfig(resolution=16, feature_dim=SMALL["geo_feat_dim"])
        pkw["grid_cfg"] = PR.VolumeGridConfig(resolution=16, feature_dim=SMALL["geo_feat_dim"])
    if "sdf_cfg" in kw:
        jkw["sdf_cfg"], pkw["sdf_cfg"] = JR.SDFConfig(**kw["sdf_cfg"]), PR.SDFConfig(**kw["sdf_cfg"])
    jf = JR.RegistryField(cj, geometry, material, background, **jkw)
    pf = PR.RegistryField(cp, geometry, material, background, **pkw)
    jp = jf.init_params(jax.random.PRNGKey(seed))
    if "base" in jp["encoder"]:
        jp["encoder"]["base"] = 0.5 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                                        jp["encoder"]["base"].shape)
    if "grid" in jp["encoder"] and bump:
        R = jf.grid_cfg.resolution
        idx = np.stack(np.meshgrid(*[np.arange(R)] * 3, indexing="ij"), -1) / (R - 1) * 2 - 1
        g = np.array(jp["encoder"]["grid"])
        g[..., 0] += 3.0 * np.exp(-(idx**2).sum(-1) / 0.3)
        jp["encoder"]["grid"] = jnp.asarray(g)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jf, pf, jp, pp


def _rays(n, seed, extent=0.9):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return x, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# K10: the voxel-grid sampler
# ---------------------------------------------------------------------------

def _volume_inputs(R, bound, seed):
    """Random points; points on grid nodes and on cell edges (one axis off
    the node); points on +-bound in one axis; points outside the box."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-bound, bound, (200, 3))
    nodes = rng.integers(0, R, (40, 3))
    on_nodes = (nodes / (R - 1) - 0.5) * 2 * bound
    edges = on_nodes.copy()
    edges[:, 1] = rng.uniform(-bound, bound, 40)
    border = rng.uniform(-0.5 * bound, 0.5 * bound, (6, 3))
    for i, (ax, s) in enumerate([(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]):
        border[i, ax] = s * bound
    outside = rng.uniform(-bound, bound, (6, 3))
    outside[np.arange(6), np.arange(6) % 3] = np.array([1.2, -1.3, 1.1, -1.4, 1.5, -1.1]) * bound
    X = np.concatenate([x, on_nodes, edges, border, outside]).astype(np.float32)
    grid = rng.standard_normal((R, R, R, 5)).astype(np.float32)
    G = rng.standard_normal((len(X), 5)).astype(np.float32)
    return X, grid, G


@pytest.mark.parametrize("R", [16, 64])
def test_sample_volume_grid_and_gradients_match_jax(R):
    bound = 1.5
    X, grid, G = _volume_inputs(R, bound, R)
    jc = JR.VolumeGridConfig(resolution=R, feature_dim=4)
    pc = PR.VolumeGridConfig(resolution=R, feature_dim=4)
    jout = jax.jit(lambda p, x: JR.sample_volume_grid(p, x, jc, bound))({"grid": jnp.asarray(grid)},
                                                                        jnp.asarray(X))
    jg, jx = jax.jit(jax.grad(lambda p, x: (JR.sample_volume_grid(p, x, jc, bound) * G).sum(),
                              argnums=(0, 1)))({"grid": jnp.asarray(grid)}, jnp.asarray(X))
    gt, xt = torch.from_numpy(grid).requires_grad_(True), torch.from_numpy(X).requires_grad_(True)
    out = PR.sample_volume_grid({"grid": gt}, xt, pc, bound)
    gg, gx = torch.autograd.grad((out * torch.from_numpy(G)).sum(), [gt, xt])
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(gg), np.asarray(jg["grid"]), rtol=0, atol=1e-6)
    jx = np.asarray(jx)
    np.testing.assert_allclose(_np(gx), jx, rtol=0, atol=1e-5 * np.abs(jx).max())
    # the plain backward alone, each output on its own
    ggrid, none = PR.sample_volume_grid_backward_plain(torch.from_numpy(G), gt.detach().reshape(R**3, 5),
                                                       torch.from_numpy(X), R, bound, x_grad=False)
    assert none is None and torch.equal(ggrid.reshape(gg.shape), gg)


def test_volume_grid_clip_ties_follow_jax():
    """JAX's clip gives a tie half the gradient. At bound 1, q sits exactly on
    0 at x = -1, and at R = 64 exactly on the float32 bound 63.0 at x = +1
    (at R = 16 the bound rounds to 14.999999 and +1 lies outside). At bound
    1.5 jit's q at x = -1.5 lies 1e-8 below 0 (``x * f32(1/1.5) * 0.5 +
    0.5`` fused), so no tie there and no gradient, as in jitted JAX."""
    for R in (16, 64):
        xs = torch.tensor([-1.0, 1.0, 1.1, 0.3])
        qpre = (xs * 0.5 + 0.5) * (R - 1)
        cg = _clip_grad(qpre, PR._clip_hi(R)).tolist()
        assert cg == [0.5, 0.5 if R == 64 else 0.0, 0.0, 1.0], (R, cg)
        assert torch.equal(PR._voxel_cell(xs[:, None].expand(4, 3), R, 1.0)[0][:, 0], qpre)
    assert PR._clip_hi(64) == 63.0 and PR._clip_hi(32) == np.float32(30.999998)
    R = 16
    rng = np.random.default_rng(3)
    grid = rng.standard_normal((R, R, R, 2)).astype(np.float32)
    cfg_j, cfg_p = JR.VolumeGridConfig(R, 1), PR.VolumeGridConfig(R, 1)
    jgrad = jax.jit(jax.grad(lambda x, b: JR.sample_volume_grid({"grid": jnp.asarray(grid)}, x, cfg_j,
                                                                 b)[:, 0].sum()), static_argnums=1)
    for bound in (1.0, 1.5):
        # x = -bound: half the one-sided slope of the first cell in that axis
        # at bound 1, none at 1.5
        x = torch.tensor([[-bound, 0.2, -0.3], [-bound + 1e-3, 0.2, -0.3]], requires_grad=True)
        out = PR.sample_volume_grid({"grid": torch.from_numpy(grid)}, x, cfg_p, bound)
        (gx,) = torch.autograd.grad(out[:, 0].sum(), [x])
        half = 0.5 if bound == 1.0 else 0.0
        np.testing.assert_allclose(gx[0, 0].item(), half * gx[1, 0].item(), rtol=1e-4)
        jx = jgrad(jnp.asarray(x.detach().numpy()), bound)
        np.testing.assert_allclose(gx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# K7x: grid_encode's coordinate gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bound", [1.0, 1.5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k7x_plain_matches_jax_grad(case, bound):
    """Hash and tiled grids, linear and smoothstep, points on every level's
    cell edges and on the box's border (u = 0 or 1 at bound 1: JAX's 0.5
    tie)."""
    pc, jc = PG.GridEncoderConfig(**CASES[case]), JG.GridEncoderConfig(**CASES[case])
    tables = _tables(pc, 3)
    x = _grid_points(pc, bound, 200, 4)
    G = np.random.default_rng(5).standard_normal((len(x), pc.output_dim)).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda xx: (JG.grid_encode(
        {k: jnp.asarray(v) for k, v in tables.items()}, xx, jc, bound) * G).sum()))(jnp.asarray(x)))
    got = PG.grid_encode_backward_x_plain(torch.from_numpy(G), [torch.from_numpy(tables[f"level_{l}"])
                                          for l in range(pc.num_levels)], torch.from_numpy(x), pc, bound)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())
    if bound == 1.0:  # the box's corners sit on the clip's ties
        u = PG._unit_coord(torch.tensor([[-1.0, 1.0, 0.0]]), 1.0)
        assert _clip_grad(u, 1.0).tolist() == [[0.5, 0.5, 1.0]]


# ---------------------------------------------------------------------------
# K11: the textured background
# ---------------------------------------------------------------------------

def _directions(seed):
    """Random directions, directions exactly on the seam (d_x = +-0,
    d_z < 0), within a few ulps of it, the poles, and unnormalised ones."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((300, 3))
    seam = np.stack([np.zeros(20), rng.uniform(-0.9, 0.9, 20), -rng.uniform(0.2, 1.0, 20)], -1)
    seam[10:, 0] = -0.0
    near = seam.copy()
    near[:, 0] = rng.choice([-1, 1], 20) * rng.uniform(1e-8, 1e-6, 20)
    poles = np.array([[0, 1, 0], [0, -1, 0], [1e-7, 1, 0], [0, -1, 1e-7]], np.float64)
    return np.concatenate([d, seam, near, poles, 3.0 * d[:8]]).astype(np.float32)


def _jax_bg(tex, d):
    return np.asarray(JR.background_textured({"bg_texture": jnp.asarray(tex)}, jnp.asarray(d)))


def test_textured_background_and_gradient_match_jax():
    H, W = 12, 20
    rng = np.random.default_rng(7)
    tex = rng.standard_normal((H, W, 3)).astype(np.float32)
    d = _directions(8)
    phi = np.arctan2(d[:, 0].astype(np.float64), d[:, 2]) + np.pi
    near_seam = (np.minimum(phi, 2 * np.pi - phi) < 1e-5) & (d[:, 2] < 0)
    assert near_seam.sum() >= 40
    want = _jax_bg(tex, d)
    other = _jax_bg(tex, d * np.array([-1.0, 1.0, 1.0], np.float32))  # the seam's other side
    tt = torch.from_numpy(tex).requires_grad_(True)
    got = PR.background_textured({"bg_texture": tt}, torch.from_numpy(d))
    err = np.abs(_np(got) - want).max(-1)
    err_other = np.abs(_np(got) - other).max(-1)
    assert (err[~near_seam] <= 1e-6).all(), err[~near_seam].max()
    assert (np.minimum(err, err_other)[near_seam] <= 1e-6).all()
    G = rng.standard_normal((len(d), 3)).astype(np.float32)
    G[near_seam] = 0.0
    jg = jax.grad(lambda t: (JR.background_textured({"bg_texture": t}, jnp.asarray(d)) * G).sum())(
        jnp.asarray(tex))
    (gt,) = torch.autograd.grad((got * torch.from_numpy(G)).sum(), [tt])
    np.testing.assert_allclose(gt.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    # constant texture: every direction reads sigmoid(0.5), as the JAX test asks
    const = PR.background_textured({"bg_texture": torch.full((8, 16, 3), 0.5)}, torch.from_numpy(d))
    np.testing.assert_allclose(const.numpy(), 1 / (1 + np.exp(-0.5)), rtol=1e-6)


# ---------------------------------------------------------------------------
# SDF, materials, backgrounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias,params", [("sphere", (0.5,)), ("ellipsoid", (0.6, 0.4, 0.8)),
                                         ("none", (0.5,))])
def test_shifted_sdf_matches_jax(bias, params):
    x, _ = _rays(100, 9)
    x[0] = 0.0  # the ellipsoid's guarded norm; the sphere's norm has no gradient there in either
    raw = np.random.default_rng(10).standard_normal(100).astype(np.float32)
    jc, pc = JR.SDFConfig(sdf_bias=bias, sdf_bias_params=params), PR.SDFConfig(sdf_bias=bias,
                                                                               sdf_bias_params=params)
    want = np.asarray(JR.shifted_sdf(jnp.asarray(raw), jnp.asarray(x), jc))
    jx = np.asarray(jax.grad(lambda xx: JR.shifted_sdf(jnp.asarray(raw), xx, jc).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = PR.shifted_sdf(torch.from_numpy(raw), xt, pc)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6)
    if bias != "none":
        (gx,) = torch.autograd.grad(got.sum(), [xt])
        np.testing.assert_array_equal(np.isnan(gx.numpy()), np.isnan(jx))
        np.testing.assert_allclose(np.nan_to_num(gx.numpy()), np.nan_to_num(jx), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="sdf_bias"):
        PR.shifted_sdf(torch.from_numpy(raw), xt, PR.SDFConfig(sdf_bias="cube"))


def test_laplace_density_and_gradient_match_jax():
    """Both branches, the select's edge s = 0 and beta's guard at, below
    and above 1e-4 (a tie gives each side half the gradient)."""
    sdf = np.concatenate([np.linspace(-0.5, 0.5, 41), [0.0, -0.0, 1e-7, -1e-7]]).astype(np.float32)
    for beta in (0.1, 1e-4, 5e-5):
        jv, (jgs, jgb) = jax.value_and_grad(lambda s, b: JR.laplace_density(s, b).sum(), argnums=(0, 1))(
            jnp.asarray(sdf), jnp.float32(beta))
        st = torch.from_numpy(sdf).requires_grad_(True)
        bt = torch.tensor(beta, dtype=torch.float32, requires_grad=True)
        v = PR.laplace_density(st, bt)
        gs, gb = torch.autograd.grad(v.sum(), [st, bt])
        want = np.asarray(JR.laplace_density(jnp.asarray(sdf), jnp.float32(beta)))
        np.testing.assert_allclose(_np(v), want, rtol=1e-6, atol=0)
        np.testing.assert_allclose(gs.numpy(), np.asarray(jgs), rtol=1e-5, atol=1e-6 * np.abs(jgs).max())
        np.testing.assert_allclose(gb.item(), float(jgb), rtol=1e-5)


@pytest.mark.parametrize("shading", ["albedo", "textureless", "diffuse"])
def test_diffuse_point_light_material_matches_jax(shading):
    x, n = _rays(N_PTS, 11)
    feats = np.random.default_rng(12).standard_normal((N_PTS, 7)).astype(np.float32) * 3
    n[:5] = -n[:5]                     # facing away: lambert clips to 0
    light = np.array([2.0, 2.0, 2.0], np.float32)
    jf = lambda f, nn: JR.material_diffuse_point_light(f, jnp.asarray(x), nn, jnp.asarray(light),
                                                       shading=shading)
    want = np.asarray(jf(jnp.asarray(feats), jnp.asarray(n)))
    jgf, jgn = jax.grad(lambda f, nn: (jf(f, nn) ** 2).sum(), argnums=(0, 1))(jnp.asarray(feats),
                                                                               jnp.asarray(n))
    ft, nt = torch.from_numpy(feats).requires_grad_(True), torch.from_numpy(n).requires_grad_(True)
    got = PR.material_diffuse_point_light(ft, torch.from_numpy(x), nt, tuple(light), shading=shading)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6)
    gf, gn = torch.autograd.grad((got**2).sum(), [ft, nt], allow_unused=True)
    gf = torch.zeros_like(ft) if gf is None else gf  # textureless: no albedo, JAX's gradient is 0
    np.testing.assert_allclose(gf.numpy(), np.asarray(jgf), rtol=0, atol=1e-6)
    if shading != "albedo":
        np.testing.assert_allclose(gn.numpy(), np.asarray(jgn), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="shading"):
        PR.material_diffuse_point_light(ft, torch.from_numpy(x), nt, tuple(light), shading="toon")
    nm = PR.material_no_material({}, None, ft, None)
    np.testing.assert_allclose(_np(nm), np.asarray(JR.material_no_material({}, None, jnp.asarray(feats),
                                                                           None)), rtol=0, atol=1e-6)


def test_env_map_and_solid_backgrounds_match_jax():
    jf, pf, jp, pp = _fields(background="neural-environment-map-background")
    _, d = _rays(N_PTS, 13)
    want = np.asarray(jf.background(jp, jnp.asarray(d)))
    np.testing.assert_allclose(_np(pf.background(pp, torch.from_numpy(d))), want, rtol=0, atol=1e-6)
    assert np.abs(want[0] - want[1]).max() > 1e-6  # view dependent
    jf, pf, jp, pp = _fields(background_color=0.25)
    np.testing.assert_array_equal(_np(pf.background(pp, torch.from_numpy(d))),
                                  np.asarray(jf.background(jp, jnp.asarray(d))))


COMBO_TREES = [  # each geometry and each background, and the pred normal's head
    ("implicit-volume", "no-material", "textured-background", "none"),
    ("volume-grid", "no-material", "neural-environment-map-background", "none"),
    ("implicit-sdf", "no-material", "solid-color-background", "none"),
    ("implicit-volume", "diffuse-with-point-light-material", "solid-color-background", "pred"),
    ("volume-grid", "diffuse-with-point-light-material", "textured-background", "pred")]


@pytest.mark.parametrize("combo", COMBO_TREES, ids=["-".join(c) for c in COMBO_TREES])
def test_param_tree_and_carry_round_trip(combo):
    """The port's init_params has the JAX package's keys and shapes; the
    JAX tree carried by params_from_jax gives the same forward."""
    geometry, material, background, normal_type = combo
    jf, pf, jp, pp = _fields(geometry, material, background, normal_type=normal_type)
    mine = pf.init_params(torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in _flat(mine).items()} == {k: tuple(np.shape(v))
                                                                  for k, v in _flat(jp).items()}
    assert ("sigma_net" in mine) == (geometry == "implicit-volume")
    assert mine.get("log_beta", torch.zeros(())).dim() == 0
    x, d = _rays(N_PTS, 17)
    js, jrgb = jf(jp, jf.build_planes(jp), jnp.asarray(x), jnp.asarray(d))
    ps, prgb = pf(pp, pf.build_planes(pp), torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(_np(ps), np.asarray(js), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(prgb), np.asarray(jrgb), rtol=0, atol=1e-4)
    tree = jax.tree.map(np.asarray, jp)
    with pytest.raises(KeyError, match="not ported"):
        params_from_jax(dict(tree, mystery_net={"w0": np.zeros((2, 2), np.float32)}), "cpu")


def test_carry_still_refuses_unknown_trees():
    with pytest.raises(KeyError, match="sigma_net"):
        params_from_jax({"encoder": {"base": np.zeros(1), "wavelets": {}}, "color_net": {}}, "cpu")
    with pytest.raises(KeyError, match="grid tables"):
        params_from_jax({"encoder": {"grid": np.zeros(1), "level_0": np.zeros(1)}, "sigma_net": {},
                         "color_net": {}}, "cpu")


def test_make_field_default_names_and_errors():
    cj, cp = _cfgs()
    init, field = PR.make_field(cp)
    assert type(field) is PN.NeRFField
    p = init(torch.Generator().manual_seed(0), "cpu")
    jinit, _ = JR.make_field(cj)
    assert {k: tuple(v.shape) for k, v in _flat(p).items()} == {
        k: tuple(np.shape(v)) for k, v in _flat(jinit(jax.random.PRNGKey(0))).items()}
    init, field = PR.make_field(cp, geometry="volume-grid")
    assert isinstance(field, PR.RegistryField) and init == field.init_params
    assert PR.GEOMETRY_REGISTRY == JR.GEOMETRY_REGISTRY and PR.MATERIAL_REGISTRY == JR.MATERIAL_REGISTRY
    assert PR.BACKGROUND_REGISTRY == JR.BACKGROUND_REGISTRY and PR.NORMAL_TYPES == JR.NORMAL_TYPES
    for kw, what in [({"geometry": "nope"}, "geometry"), ({"material": "nope"}, "material"),
                     ({"background": "nope"}, "background"), ({"normal_type": "nope"}, "normal_type")]:
        with pytest.raises(ValueError, match=what):
            PR.RegistryField(cp, **kw)
        with pytest.raises(ValueError, match=what):
            JR.RegistryField(cj, **kw)
    f = PR.RegistryField(cp, material="diffuse-with-point-light-material")
    assert f.normal_type == "finite_difference"  # the diffuse material needs normals
    params = f.init_params(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="positions"):
        f.color(params, torch.zeros((4, 3)), torch.zeros((4, cp.geo_feat_dim)))
    # the SR snapshot planes pass through the registry's implicit volume as
    # through NeRFField (float32: rtol 1e-5 on sigma, atol 1e-5 on features)
    tj = JR.RegistryField(JN.NeRFConfig(triplane=JT.TriplaneConfig(**TRI, low_res_scale=2), **SMALL))
    tp = PR.RegistryField(PN.NeRFConfig(triplane=PT.TriplaneConfig(**TRI, low_res_scale=2), **SMALL))
    jp = jax.tree.map(lambda a: a + 0.05, tj.init_params(jax.random.PRNGKey(2)))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(3).uniform(-1, 1, (N_PTS, 3)).astype(np.float32)
    jplanes, pplanes = tj.build_planes(jp), tp.build_planes(pp, modes=("low_res",))
    assert set(pplanes) == {"low_res"} and tuple(pplanes["low_res"].shape) == (3, 16, 16, 4)
    js, jg = tj.density(jp, jplanes, jnp.asarray(x), resolution_mode="low_res")
    ps, pg = tp.density(pp, pplanes, torch.from_numpy(x), resolution_mode="low_res")
    np.testing.assert_allclose(_np(ps), np.asarray(js), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(pg), np.asarray(jg), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="cannot produce normals"):
        PR.RegistryField(cp).normal(params, {}, torch.zeros((4, 3)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if torch.cuda.is_available():
            raise RuntimeError("device='cpu'")  # a card is there: the default device exists
        f.init_params(torch.Generator().manual_seed(0))
