"""The triplane field's variants and the other encodings of this slice: the
PyTorch port against the JAX package (CPU).

What is compared: K2x's plain version (the sampler's coordinate gradient)
against ``jax.grad`` of JAX's ``sample_planes``; ``sample_triplane`` with
the learned rotation and lbound zoom; the zoom-in (upscale) planes, their
routing and their wavelet L1 terms; k-planes with both combines; SH degrees
5-8; ``sph_from_ray``, the background network and ``render_occgrid`` with
``bg_fn``; ``grow_params`` and ``carry`` for the new leaves. Every input is
made with numpy from a seed and handed to both packages.

Tolerances, stated per comparison:
* K2x's plain coordinate gradient: 1e-5 of the largest entry (JAX sums the
  four corner products per channel, the port the two differences: a few
  float32 roundings); at the clamp border the factor is JAX's 0.5, outside
  it 0, checked exactly. Plane gradients 1e-6 (index_add_ against JAX's
  scatter-add in float32).
* Features: 1e-5 absolute. The rotation is ``coords @ R(q)^T`` in both, but
  XLA's CPU dot and torch's matmul may round a rotated coordinate one ulp
  apart; the feature moves by the ulp times the plane's slope (about
  2^-23 x 64 x 3 per unit), well inside the bound.
* Gradients of the learned leaves: 1e-4 relative L2 per leaf. An ulp of a
  rotated coordinate that crosses a cell edge leaves the feature and the
  plane gradient continuous, but changes that point's coordinate
  gradient from one cell's slope to the next; over 3,000 points the
  quaternion's and lbound_scale's gradients stay within 1e-4.
* SH, ``sph_from_ray``: 1e-6 absolute (measured equal).
* Renders with ``bg_fn``: ``test_torch_render.py``'s float32 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_render import _Draws, _poses
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.models import encodings as JE
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.ops import encoders as JENC
from trinerflet_tpu.ops import grid_sample as JGS
from trinerflet_tpu.ops import raymarch as JRM
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu_torch.carry import occupancy_from_jax, params_from_jax, train_state_from_jax
from trinerflet_tpu_torch.data.rays import rays_full_image
from trinerflet_tpu_torch.data.synthetic import synthetic_intrinsics
from trinerflet_tpu_torch.models import encodings as PE
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.models import triplane as PT
from trinerflet_tpu_torch.ops import encoders as PENC
from trinerflet_tpu_torch.ops import grid_sample as PGS
from trinerflet_tpu_torch.ops import raymarch as PRM
from trinerflet_tpu_torch.render import renderer as PR

DIMS = dict(channels=8, resolution=64, wavelet_scale=4)
VARIANTS = dict(learned_rotation=True, lbound_auto_scale=True, upscale_ratio_bound=0.5,
                upscale_levels=2)
BOUND = 1.5


def _tree_j(t):
    return {k: _tree_j(v) for k, v in t.items()} if isinstance(t, dict) else jnp.asarray(t)


def _tree_np(t):
    if isinstance(t, dict):
        return {k: _tree_np(v) for k, v in t.items()}
    return np.asarray(t.detach() if torch.is_tensor(t) else t, np.float32)


def _flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _enc_params(cfg, seed, rotation=(0.96, 0.12, -0.2, 0.15), lbound_scale=1.1):
    """Random base, wavelet and zoom-in levels; a quaternion away from the
    identity and a zoom away from 1."""
    rng = np.random.default_rng(seed)
    b = cfg.base_resolution
    p = {"base": (0.5 * rng.standard_normal((3, cfg.channels, b, b))).astype(np.float32),
         "wavelets": {f"level_{i}": (0.1 * rng.standard_normal((3, cfg.channels, 3, s, s))).astype(np.float32)
                      for i, s in enumerate(cfg.yh_sizes)}}
    if cfg.upscale_enabled:
        sizes = PT._upscale_geometry(cfg)[0]
        p["upscale"] = {f"level_{i}": (0.1 * rng.standard_normal((3, cfg.channels, 3, s, s))).astype(np.float32)
                        for i, s in enumerate(sizes)}
    if cfg.learned_rotation:
        p["rotation"] = np.asarray(rotation, np.float32)
    if cfg.lbound_auto_scale:
        p["lbound_scale"] = np.asarray(lbound_scale, np.float32)
    return p


def _points(n, seed, extent=BOUND):
    """Points over the box and beyond it (the clamp), a quarter of them
    inside the zoom-in levels' bounds."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.15 * extent, 1.15 * extent, (n, 3))
    x[: n // 4] *= 0.3
    x[n // 4 : n // 2] *= 0.6
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# K2x: the sampler's coordinate gradient
# ---------------------------------------------------------------------------

def _k2x_inputs(lbound):
    rng = np.random.default_rng(1)
    H, W, C = 16, 16, 4
    planes = rng.standard_normal((3, H, W, C)).astype(np.float32)
    n = 600
    xyz = rng.uniform(-1.3, 1.3, (n, 3)) * lbound                   # inside and clamped outside
    xyz[:40, 0], xyz[40:80, 1], xyz[80:120, 2] = lbound, -lbound, lbound  # on the border: the 0.5 tie
    k = rng.integers(1, W - 1, (100, 3))
    xyz[120:220] = (2.0 * k / (W - 1) - 1.0) * lbound                # interior cell edges
    xyz = xyz.astype(np.float32)
    g = rng.standard_normal((n, 3, C)).astype(np.float32)
    g[500:] = 0.0                                                    # rows with no cotangent
    return planes, xyz, g


@pytest.mark.parametrize("lbound", [1.0, 1.5])
def test_k2x_plain_matches_jax_grad(lbound):
    planes, xyz, g = _k2x_inputs(lbound)

    def f(p, x):
        return (JGS.sample_planes(p, JT.project_to_planes(x, lbound)) * g).sum()

    jp, jx = jax.grad(f, argnums=(0, 1))(jnp.asarray(planes), jnp.asarray(xyz))
    jp, jx = np.asarray(jp), np.asarray(jx)
    pg, xg = PGS.sample_points_backward_xyz_plain(torch.from_numpy(g), torch.from_numpy(planes),
                                                   torch.from_numpy(xyz), lbound)
    assert pg.dtype == xg.dtype == torch.float32 and xg.shape == (600, 3)
    np.testing.assert_allclose(xg.numpy(), jx, rtol=0, atol=1e-5 * np.abs(jx).max())
    np.testing.assert_allclose(pg.numpy(), jp, rtol=0, atol=1e-6)
    assert np.all(xg.numpy()[500:] == 0) and np.all(jx[500:] == 0)
    # through autograd: sample_points with points that require a gradient
    pt = torch.from_numpy(planes).requires_grad_(True)
    xt = torch.from_numpy(xyz).requires_grad_(True)
    (PGS.sample_points(pt, xt, lbound) * torch.from_numpy(g)).sum().backward()
    assert torch.equal(xt.grad, xg) and torch.equal(pt.grad, pg)


def test_k2x_clamp_factor_is_jax_tie():
    """jnp.clip's gradient is 0.5 at either bound (torch.clamp's is 1) and 0
    outside; on a border point K2x's plain version gives half the inside
    slope, as JAX does."""
    W = 16
    v = torch.tensor([0.0, W - 1.0, -0.25, 3.5, W - 0.5])
    assert PGS._clip_grad(v, W - 1).tolist() == [0.5, 0.5, 0.0, 1.0, 0.0]
    jclip = jax.vmap(jax.grad(lambda x: jnp.clip(x, 0.0, W - 1.0)))(jnp.asarray(v.numpy()))
    assert np.asarray(jclip).tolist() == [0.5, 0.5, 0.0, 1.0, 0.0]
    planes = torch.from_numpy(np.random.default_rng(2).standard_normal((3, W, W, 4)).astype(np.float32))
    g = torch.ones((2, 3, 4))
    edge = torch.tensor([[1.0, 0.3, 0.2], [1.0 - 1e-3, 0.3, 0.2]])  # x on the border, and just inside
    _, xg = PGS.sample_points_backward_xyz_plain(g, planes, edge, 1.0)
    # plane 0 and 1 read x on u; the slope in the last cell is the same
    # on the border and just inside, so the border gradient is half of it
    np.testing.assert_allclose(xg[0, 0].item(), 0.5 * xg[1, 0].item(), rtol=1e-3)
    _, xg_out = PGS.sample_points_backward_xyz_plain(g[:1], planes, torch.tensor([[1.2, 0.3, 0.2]]), 1.0)
    assert xg_out[0, 0].item() == 0.0


def test_k2x_plane_gradient_keeps_float32_sums():
    """A known difference, not a port fault: on JAX's learned path the plane
    gradient is XLA's scatter-add in the plane dtype, which stagnates in
    bf16 (1,000 adds of 1.001 into one texel stop at 256); the port sums in
    float32 and casts once."""
    planes = np.zeros((3, 4, 4, 4), np.float32)
    xyz = np.full((1000, 3), -1.0, np.float32)  # every point on texel (0, 0) of each plane
    g = np.full((1000, 3, 4), 1.001, np.float32)

    def f(p):
        return (JGS.sample_planes(p, JT.project_to_planes(jnp.asarray(xyz), 1.0)).astype(jnp.float32)
                * g).sum()

    jg = np.asarray(jax.grad(f)(jnp.asarray(planes, jnp.bfloat16)).astype(jnp.float32))
    pg, _ = PGS.sample_points_backward_xyz_plain(torch.from_numpy(g), torch.from_numpy(planes).bfloat16(),
                                                 torch.from_numpy(xyz), 1.0)
    assert jg[0, 0, 0, 0] == 256.0
    assert pg.dtype == torch.bfloat16 and pg[0, 0, 0, 0].item() == float(torch.tensor(1001.0).bfloat16())


# ---------------------------------------------------------------------------
# sample_triplane: the learned rotation and lbound zoom, the zoom-in planes
# ---------------------------------------------------------------------------

def _triplane_case(upscale):
    """JAX's features of sample_triplane over build_planes, and the gradients
    of sum(features * G) in every parameter leaf, for one config."""
    kw = VARIANTS if upscale else dict(learned_rotation=True, lbound_auto_scale=True)
    cj, cp = JT.TriplaneConfig(**DIMS, **kw), PT.TriplaneConfig(**DIMS, **kw)
    enc = _enc_params(cp, 3)
    x = _points(3000, 4)
    G = np.random.default_rng(5).standard_normal((3000, cj.feature_dim)).astype(np.float32)

    def jloss(p):
        f = JT.sample_triplane(JT.build_planes(p, cj), jnp.asarray(x), cj, lbound=BOUND, enc_params=p)
        return (f * G).sum(), f

    (_, jf), jg = jax.value_and_grad(jloss, has_aux=True)(_tree_j(enc))
    return cj, cp, enc, x, G, np.asarray(jf), _flat(_tree_np(jg))


def _port_grads(cp, enc, x, G):
    tree = params_from_jax({"encoder": enc, "sigma_net": {}, "color_net": {}}, "cpu")["encoder"]
    leaves = _flat(tree)
    for t in leaves.values():
        t.requires_grad_(True)
    f = PT.sample_triplane(PT.build_planes(tree, cp), torch.from_numpy(x), cp, lbound=BOUND,
                           enc_params=tree)
    names = sorted(leaves)
    grads = torch.autograd.grad((f * torch.from_numpy(G)).sum(), [leaves[n] for n in names])
    return f.detach().numpy(), dict(zip(names, (g.numpy() for g in grads)))


@pytest.mark.parametrize("upscale", [False, True])
def test_sample_triplane_learned_transform_matches_jax(upscale):
    cj, cp, enc, x, G, jf, jg = _triplane_case(upscale)
    pf, pg = _port_grads(cp, enc, x, G)
    assert pf.shape == jf.shape == (3000, 3 * DIMS["channels"])
    np.testing.assert_allclose(pf, jf, rtol=0, atol=1e-5)
    assert set(pg) == set(jg) and {"rotation", "lbound_scale"} <= set(pg)
    assert not upscale or {"upscale.level_0", "upscale.level_1"} <= set(pg)
    for n in jg:
        assert np.linalg.norm(jg[n]) > 0, n
        assert _rel_l2(pg[n], jg[n]) <= 1e-4, (n, _rel_l2(pg[n], jg[n]))


def test_upscale_build_planes_and_routing_match_jax():
    """The zoom-in ladder (one IDWT level per crop), the refresh's truncated
    build (no zoom-in plane: every point reads ``full``), and the routing
    without the learned transform: every level takes points."""
    cj, cp = JT.TriplaneConfig(**DIMS, upscale_ratio_bound=0.5), PT.TriplaneConfig(**DIMS, upscale_ratio_bound=0.5)
    enc = _enc_params(cp, 6)
    jplanes = JT.build_planes(_tree_j(enc), cj)
    tree = params_from_jax({"encoder": enc, "sigma_net": {}, "color_net": {}}, "cpu")["encoder"]
    pplanes = PT.build_planes(tree, cp)
    assert set(pplanes) == set(jplanes) == {"full", "upscale_0", "upscale_1"}
    for k in jplanes:
        assert pplanes[k].shape == jplanes[k].shape == (3, 64, 64, DIMS["channels"])
        np.testing.assert_allclose(pplanes[k].numpy(), np.asarray(jplanes[k]), rtol=0, atol=1e-5)
    x = _points(2000, 7)
    jf = np.asarray(JT.sample_triplane(jplanes, jnp.asarray(x), cj, lbound=BOUND))
    pf = PT.sample_triplane(pplanes, torch.from_numpy(x), cp, lbound=BOUND).numpy()
    np.testing.assert_allclose(pf, jf, rtol=0, atol=1e-5)
    m = np.abs(x).max(-1)
    assert (m <= 0.25 * BOUND).sum() > 50 and ((m > 0.25 * BOUND) & (m <= 0.5 * BOUND)).sum() > 50
    jsmall = JT.build_planes(_tree_j(enc), cj, max_resolution=32)
    psmall = PT.build_planes(tree, cp, max_resolution=32)
    assert set(psmall) == set(jsmall) == {"full"} and psmall["full"].shape[1] == 32
    np.testing.assert_allclose(PT.sample_triplane(psmall, torch.from_numpy(x), cp, lbound=BOUND).numpy(),
                               np.asarray(JT.sample_triplane(jsmall, jnp.asarray(x), cj, lbound=BOUND)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_field_planes_and_density_with_variants_match_jax(dtype):
    """NeRFField.build_planes casts the zoom-in levels to bf16 with the base
    and wavelets (not the rotation or the zoom), and density passes the
    encoder's learned leaves: bf16 planes within 2^-6 of their largest
    value (K4's rounding note); sigma at test_torch_field.py's tolerances."""
    kw = dict(bound=BOUND, compute_dtype=dtype, plane_dtype=dtype)
    cj = JN.NeRFConfig(triplane=JT.TriplaneConfig(**DIMS, **VARIANTS), **kw)
    cp = PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS, **VARIANTS), **kw)
    rng = np.random.default_rng(8)
    params = {"encoder": _enc_params(cp.triplane, 9),
              "sigma_net": {"w0": (rng.uniform(-1, 1, (24, 64)) / np.sqrt(24)).astype(np.float32),
                            "w1": (rng.uniform(-1, 1, (64, 16)) / 8).astype(np.float32)},
              "color_net": {}}
    jfield, pfield = JN.NeRFField(cj), PN.NeRFField(cp)
    jplanes = jfield.build_planes(_tree_j(params))
    pp = params_from_jax(params, "cpu")
    pplanes = pfield.build_planes(pp)
    for k in jplanes:
        ref = np.asarray(jplanes[k].astype(jnp.float32))
        assert pplanes[k].dtype == getattr(torch, dtype)
        tol = 1e-5 if dtype == "float32" else 2.0**-6 * np.abs(ref).max()
        np.testing.assert_allclose(pplanes[k].float().numpy(), ref, rtol=0, atol=tol)
    x = _points(1500, 10)
    # the same planes in both: the comparison is of the routing and transform
    same = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(getattr(torch, dtype))
            for k, v in jplanes.items()}
    js = np.asarray(jfield.density(_tree_j(params), jplanes, jnp.asarray(x))[0])
    ps = pfield.density(pp, same, torch.from_numpy(x))[0].numpy()
    if dtype == "float32":
        np.testing.assert_allclose(ps, js, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(ps, js, rtol=0.05)
        assert np.mean(np.isclose(ps, js, rtol=1e-6)) >= 0.95


@pytest.mark.parametrize("weighted", [False, True])
def test_wavelet_l1_with_upscale_terms_matches_jax(weighted):
    cj, cp = JT.TriplaneConfig(**DIMS, **VARIANTS), PT.TriplaneConfig(**DIMS, **VARIANTS)
    enc = _enc_params(cp, 11)
    enc["upscale"]["level_1"][0, 0, 0, :2, :2] = 0.0  # |x| at 0: JAX's gradient is +1
    jv, jg = jax.value_and_grad(lambda p: JT.wavelet_l1(p, cj, weighted))(_tree_j(enc))
    tree = params_from_jax({"encoder": enc, "sigma_net": {}, "color_net": {}}, "cpu")["encoder"]
    leaves = _flat(tree)
    for t in leaves.values():
        t.requires_grad_(True)
    pv = PT.wavelet_l1(tree, cp, weighted)
    names = sorted(leaves)
    pgs = torch.autograd.grad(pv, [leaves[n] for n in names], allow_unused=True)
    np.testing.assert_allclose(float(pv.detach()), float(jv), rtol=1e-5)  # float32 means of ~1e5 entries summed in another order
    jgf = _flat(_tree_np(jg))
    for n, g in zip(names, pgs):
        ref = jgf[n]
        got = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12, err_msg=n)
    assert np.abs(jgf["upscale.level_0"]).max() > 0


# ---------------------------------------------------------------------------
# k-planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["k_planes", "multiscale_k_planes", "multiscale_k_planes_mul"])
def test_kplanes_encode_and_table_gradients_match_jax(name):
    jparams, japply, jdim = JE.get_encoder(name, jax.random.PRNGKey(0), bound=BOUND)
    pparams, papply, pdim = PE.get_encoder(name, torch.Generator().manual_seed(0), "cpu", bound=BOUND)
    assert pdim == jdim == PE.encoder_dim(name) == PN.NeRFConfig(encoding=name).in_dim
    assert {k: tuple(v.shape) for k, v in pparams.items()} == jax.tree.map(np.shape, jparams)
    tables = params_from_jax({"encoder": jax.tree.map(np.asarray, jparams), "sigma_net": {},
                              "color_net": {}}, "cpu")["encoder"]
    x = _points(800, 12)
    G = np.random.default_rng(13).standard_normal((800, jdim)).astype(np.float32)

    def jloss(p):
        f = japply(p, jnp.asarray(x))
        return (f * G).sum(), f

    (_, jf), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    for t in tables.values():
        t.requires_grad_(True)
    pf = papply(tables, torch.from_numpy(x))
    names = sorted(tables)
    pgs = torch.autograd.grad((pf * torch.from_numpy(G)).sum(), [tables[n] for n in names])
    np.testing.assert_allclose(pf.detach().numpy(), np.asarray(jf), rtol=1e-5, atol=1e-6)
    for n, g in zip(names, pgs):
        assert _rel_l2(g.numpy(), np.asarray(jg[n])) <= 1e-5, n
    mul = name.endswith("_mul")
    assert (np.abs(pparams["scale_0"].numpy() - 1.0).mean() < 0.2) == mul  # multiplicative planes start near 1


# ---------------------------------------------------------------------------
# SH degrees 5-8, sph_from_ray, the background network
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degree", [5, 6, 7, 8])
def test_sh_encode_high_degrees_match_jax(degree):
    d = np.random.default_rng(degree).standard_normal((500, 3)).astype(np.float32)
    d[:250] /= np.linalg.norm(d[:250], axis=1, keepdims=True)  # unit and not
    got = PENC.sh_encode(torch.from_numpy(d), degree).numpy()
    ref = np.asarray(JENC.sh_encode(jnp.asarray(d), degree))
    assert got.shape == ref.shape == (500, degree**2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * max(1.0, np.abs(ref).max()))


def test_sph_from_ray_and_background_net_match_jax():
    rng = np.random.default_rng(14)
    ro = rng.uniform(-1.0, 1.0, (400, 3)).astype(np.float32)
    rd = rng.standard_normal((400, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    sph_j = np.asarray(JRM.sph_from_ray(jnp.asarray(ro), jnp.asarray(rd), 3.0))
    sph_p = PRM.sph_from_ray(torch.from_numpy(ro), torch.from_numpy(rd), 3.0).numpy()
    np.testing.assert_allclose(sph_p, sph_j, rtol=0, atol=1e-6)
    assert np.abs(sph_p).max() <= 1.0
    for dtype in ("float32", "bfloat16"):
        cj = JN.NeRFConfig(bg_radius=3.0, sh_degree=8, compute_dtype=dtype)
        cp = PN.NeRFConfig(bg_radius=3.0, sh_degree=8, compute_dtype=dtype)
        bg = {"w0": (rng.uniform(-1, 1, (66, 64)) / 8).astype(np.float32),
              "w1": (rng.uniform(-1, 1, (64, 3)) / 8).astype(np.float32)}
        pp = params_from_jax({"encoder": {}, "sigma_net": {}, "color_net": {}, "bg_net": bg}, "cpu")
        got = PN.NeRFField(cp).background(pp, torch.from_numpy(sph_p), torch.from_numpy(rd)).numpy()
        ref = np.asarray(JN.NeRFField(cj).background({"bg_net": _tree_j(bg)}, jnp.asarray(sph_j),
                                                      jnp.asarray(rd)))
        tol = 1e-6 if dtype == "float32" else 0.02  # a bf16 layer rounding may flip (test_torch_field.py)
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    init = PN.init_nerf_params(cp, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in init["bg_net"].items()} == {k: v.shape for k, v in bg.items()}


def test_render_occgrid_with_bg_fn_matches_jax(monkeypatch):
    """The field's background network behind the render: where the rays
    leave the sphere of bg_radius its colour fills 1 - weights_sum. The
    density is a closed-form blob (the same expression in both packages),
    the occupancy the JAX package's refresh of it, carried over."""
    rkw = dict(bound=BOUND, grid_size=32, max_steps=128, samples_per_ray_budget=20, bg_radius=3.0)
    rj, rp = JR.RenderConfig(**rkw), PR.RenderConfig(**rkw)
    cj, cp = JN.NeRFConfig(bg_radius=3.0, bound=BOUND), PN.NeRFConfig(bg_radius=3.0, bound=BOUND)
    rng = np.random.default_rng(15)
    bg = {"w0": (rng.uniform(-1, 1, (18, 64)) / 4).astype(np.float32),
          "w1": (rng.uniform(-1, 1, (64, 3)) / 4).astype(np.float32)}
    jparams = {"bg_net": _tree_j(bg)}
    pparams = params_from_jax({"encoder": {}, "sigma_net": {}, "color_net": {}, "bg_net": bg}, "cpu")

    def field(lib, x, d):
        r2 = (x * x).sum(-1)
        return 40.0 * lib.exp(-4.0 * r2), 0.5 + 0.4 * lib.tanh(x + 0.3 * d)

    H, C = rj.grid_size, rj.cascades
    jitter = np.stack([rng.uniform(-1, 1, (H**3, 3)).astype(np.float32) * np.float32(min(2**c, BOUND) / H)
                       for c in range(C)])
    monkeypatch.setattr(jax.random, "uniform", _Draws(jitter))
    jstate = JR.update_density_grid(JR.init_occupancy(rj), lambda x: field(jnp, x, x)[0],
                                    jax.random.PRNGKey(0), rj)
    ro, rd = rays_full_image(_poses()[3], synthetic_intrinsics(20, 20), 20, 20)
    noise = rng.random(ro.shape[0]).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", _Draws([noise]))
    jf, pf = JN.NeRFField(cj), PN.NeRFField(cp)
    jout = jax.jit(lambda o, d, st: JR.render_occgrid(  # one compile: cheaper than eager here
        lambda x, d: field(jnp, x, d), o, d, st.occ, rj, rng=jax.random.PRNGKey(1),
        bg_fn=lambda s, d: jf.background(jparams, s, d), perturb=True, occ_coarse=st.occ_coarse,
        occ_bbox=st.bbox, occ_bricks=st.occ_bricks, occ_coarse_bricks=st.occ_coarse_bricks))(
        jnp.asarray(ro), jnp.asarray(rd), jstate)
    monkeypatch.undo()
    pstate = occupancy_from_jax(jstate, device="cpu")
    kw = dict(noise=torch.from_numpy(noise), occ_coarse=pstate.occ_coarse, occ_bbox=pstate.bbox)
    args = (lambda x, d: field(torch, x, d), torch.from_numpy(ro), torch.from_numpy(rd), pstate.occ, rp)
    pout = PR.render_occgrid(*args, bg_fn=lambda s, d: pf.background(pparams, s, d), **kw)
    ws = pout["weights_sum"].numpy()
    assert int(pout["num_samples"]) == int(jout["num_samples"]) > 0 and (ws < 0.5).any()
    np.testing.assert_allclose(pout["image"].numpy(), np.asarray(jout["image"]), rtol=0, atol=5e-5)
    plain = PR.render_occgrid(*args, bg_color=1.0, **kw)
    assert not np.allclose(plain["image"].numpy(), pout["image"].numpy(), atol=1e-3)


# ---------------------------------------------------------------------------
# grow_params and carry for the new leaves
# ---------------------------------------------------------------------------

def test_grow_params_carries_variant_leaves_as_jax():
    old_c = dict(channels=4, resolution=64, wavelet_scale=4, **VARIANTS)
    new_c = dict(channels=4, resolution=128, wavelet_scale=8, **VARIANTS)
    oc, nc = PT.TriplaneConfig(**old_c), PT.TriplaneConfig(**new_c)
    old = params_from_jax({"encoder": _enc_params(oc, 16), "sigma_net": {}, "color_net": {}},
                          "cpu")["encoder"]
    grown = PT.grow_params(old, oc, nc, torch.Generator().manual_seed(1), "cpu")
    jgrown = JT.grow_params(_tree_j(_tree_np(old)), JT.TriplaneConfig(**old_c), JT.TriplaneConfig(**new_c),
                            jax.random.PRNGKey(1))
    assert jax.tree.map(np.shape, jgrown) == jax.tree.map(lambda t: tuple(t.shape), grown)
    jf, pf = _flat(_tree_np(jgrown)), _flat(grown)
    for k in ("rotation", "lbound_scale"):
        assert torch.equal(pf[k], old[k]) and np.array_equal(jf[k], old[k].numpy())
    carried = [k for k in pf if k.startswith(("wavelets.", "upscale.")) and k in _flat(old)
               and _flat(old)[k].shape == pf[k].shape]
    assert carried  # the zoom-in levels keep their crop size across the stages
    for k in carried:
        assert torch.equal(pf[k], _flat(old)[k]) and np.array_equal(jf[k], pf[k].numpy()), k
    plain = PT.grow_params(old, oc, PT.TriplaneConfig(channels=4, resolution=128, wavelet_scale=8),
                           torch.Generator().manual_seed(1), "cpu")
    assert set(plain) == {"base", "wavelets"}


def test_carry_moves_every_variant_leaf():
    cp = PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS, **VARIANTS), bg_radius=2.0)
    enc = _enc_params(cp.triplane, 17)
    rng = np.random.default_rng(18)
    tree = {"encoder": enc, "sigma_net": {"w0": rng.standard_normal((24, 16)).astype(np.float32)},
            "color_net": {"w0": rng.standard_normal((31, 3)).astype(np.float32)},
            "bg_net": {"w0": rng.standard_normal((18, 3)).astype(np.float32)}}
    got = params_from_jax(tree, "cpu")
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(_flat(got)[k].numpy(), v, err_msg=k)
    assert got["encoder"]["lbound_scale"].shape == ()
    kp = {"encoder": {"scale_0": np.ones((3, 4, 8, 8), np.float32), "scale_1": np.ones((3, 4, 16, 16), np.float32)},
          "sigma_net": {}, "color_net": {}}
    assert set(params_from_jax(kp, "cpu")["encoder"]) == {"scale_0", "scale_1"}
    with pytest.raises(KeyError, match="not ported"):
        params_from_jax(dict(tree, encoder=dict(enc, skew=np.ones(3))), "cpu")
    with pytest.raises(KeyError, match="grid tables"):
        params_from_jax(dict(kp, encoder={"scale_1": np.ones(3)}), "cpu")

    class _Adam:  # the optax chain's first state, as train_state_from_jax reads it
        def __init__(self, t):
            self.count, self.mu, self.nu = np.asarray(3), t, t

    state = {"params": tree, "opt_state": (_Adam(tree),), "ema_params": tree, "ema_count": np.asarray(3),
             "occ": {k: np.asarray(v) for k, v in PR.init_occupancy(PR.RenderConfig(grid_size=8),
                                                                   "cpu")._asdict().items()},
             "step": np.asarray(3)}
    st = train_state_from_jax(state, device="cpu")
    assert st.params["encoder"]["rotation"].requires_grad and set(st.opt_state["mu"]) == set(tree)
    assert torch.equal(st.ema_params["encoder"]["upscale"]["level_1"],
                       torch.from_numpy(enc["upscale"]["level_1"]))
