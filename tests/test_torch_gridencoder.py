"""The multiresolution grid encoder (K7's plain version), the encoder factory
and the hash-grid field of the PyTorch port against the JAX package (CPU).

Tables and points are made with numpy and handed to both. The JAX package
runs grid_encode under jit, where ``x / bound`` becomes a fused
``x * f32(1/bound) + 1``; the port rounds there as jit does, so at cell
edges the corners are compared with the jitted JAX function.

Tolerances:
* table rows of every corner: EQUAL to the JAX package's ``_index``;
* features within 1e-6 absolute and relative, table gradients within 1e-5
  absolute (``tests/test_encodings.py``'s tolerance for the JAX package's
  own backward): the eight corners are summed in another order;
* the hash-grid field: ``test_torch_field.py``'s tolerances (float32 rtol
  1e-5 on sigma, atol 1e-6 on rgb; bf16 rtol 0.05 / atol 0.02 with 95% of
  values equal to float32 precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trinerflet_tpu.models import encodings as JE
from trinerflet_tpu.models import gridencoder as JG
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu_torch.carry import params_from_jax
from trinerflet_tpu_torch.models import encodings as PE
from trinerflet_tpu_torch.models import gridencoder as PG
from trinerflet_tpu_torch.models import nerf as PN

# (JAX and port kwargs): levels that straddle dense and hashed, tiled, smoothstep
CASES = {
    "hash": dict(num_levels=6, level_dim=2, base_resolution=4, desired_resolution=64,
                 log2_hashmap_size=12),
    "tiled": dict(num_levels=4, level_dim=4, base_resolution=8, desired_resolution=40,
                  log2_hashmap_size=13, gridtype="tiled"),
    "smoothstep": dict(num_levels=5, level_dim=2, base_resolution=6, desired_resolution=100,
                       log2_hashmap_size=11, interpolation="smoothstep"),
    "one_feature": dict(num_levels=3, level_dim=1, base_resolution=16, desired_resolution=48,
                        log2_hashmap_size=14),
}


def _tables(cfg, seed, std=0.5):
    rng = np.random.default_rng(seed)
    return {f"level_{l}": (std * rng.uniform(-1, 1, (cfg.level_size(l), cfg.level_dim))).astype(np.float32)
            for l in range(cfg.num_levels)}


def _points(cfg, bound, n_random, seed):
    """Random points, points on (and one or two ulps beside) the cell edges
    of every level, and the corners of the box at +-bound."""
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(-bound, bound, (n_random, 3)).astype(np.float32)]
    for l in range(cfg.num_levels):
        res = cfg.level_resolution(l)
        k = rng.integers(0, res + 1, (64, 3))
        x = ((2.0 * k / res - 1.0) * bound).astype(np.float32)
        for s in (0, -1, 1, 2):
            pts.append(np.clip(x + s * np.spacing(np.abs(x) + 1e-30, dtype=np.float32),
                               -bound, bound).astype(np.float32))
    pts.append(np.array([[-bound] * 3, [bound] * 3, [bound, -bound, 0.0]], np.float32))
    return np.concatenate(pts)


def _jax_corner_rows(cfg, bound):
    """The JAX package's table row of every corner, as grid_encode computes
    them (jitted): (L, 2^D, N) int32."""
    corners = np.stack(np.meshgrid(*([np.array([0, 1])] * 3), indexing="ij"), -1).reshape(-1, 3)

    @jax.jit
    def rows(x):
        u = jnp.clip((x / bound + 1.0) * 0.5, 0.0, 1.0)
        out = []
        for l in range(cfg.num_levels):
            res, size = cfg.level_resolution(l), cfg.level_size(l)
            p0 = jnp.floor(u * res).astype(jnp.int32)
            c = jnp.clip(p0[None] + jnp.asarray(corners, jnp.int32)[:, None, :], 0, res)
            out.append(JG._index(c, res, size, cfg))
        return jnp.stack(out)

    return rows


def test_config_arithmetic_matches_jax():
    for kw in list(CASES.values()) + [{}, dict(num_levels=8, desired_resolution=512,
                                               log2_hashmap_size=15)]:
        jc, pc = JG.GridEncoderConfig(**kw), PG.GridEncoderConfig(**kw)
        assert pc.per_level_scale == jc.per_level_scale and pc.output_dim == jc.output_dim
        for l in range(jc.num_levels):
            assert pc.level_resolution(l) == jc.level_resolution(l)
            assert pc.level_size(l) == jc.level_size(l)
    # the hash-grid field's default: levels 0-4 dense, 5-15 hashed at 2^19 rows
    pc = PG.GridEncoderConfig()
    sizes = [pc.level_size(l) for l in range(16)]
    assert sizes[0] == 17**3 and sizes[4] == 60**3 and set(sizes[5:]) == {2**19}
    assert sum(sizes) == 6_119_857


@pytest.mark.parametrize("case", sorted(CASES))
def test_index_equals_jax_on_every_corner(case):
    jc, pc = JG.GridEncoderConfig(**CASES[case]), PG.GridEncoderConfig(**CASES[case])
    rng = np.random.default_rng(3)
    for l in range(jc.num_levels):
        res, size = jc.level_resolution(l), jc.level_size(l)
        c = rng.integers(0, res + 1, (4000, 3)).astype(np.int32)
        c[:8] = np.stack(np.meshgrid(*([np.array([0, res])] * 3), indexing="ij"), -1).reshape(-1, 3)
        want = np.asarray(JG._index(jnp.asarray(c), res, size, jc))
        got = PG._index_plain(torch.from_numpy(c).long(), res, size, pc).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < size


@pytest.mark.parametrize("case,bound", [("hash", 1.0), ("hash", 1.5), ("tiled", 1.5),
                                        ("smoothstep", 1.5), ("one_feature", 0.7)])
def test_corner_rows_at_cell_edges_equal_jitted_jax(case, bound):
    jc, pc = JG.GridEncoderConfig(**CASES[case]), PG.GridEncoderConfig(**CASES[case])
    x = _points(jc, bound, 300, 4)
    want = np.asarray(_jax_corner_rows(jc, bound)(jnp.asarray(x)))
    for l in range(pc.num_levels):
        _, rows = PG._corners_plain(torch.from_numpy(x), pc, bound, l)
        np.testing.assert_array_equal(rows.numpy(), want[l], err_msg=f"level {l}")


@pytest.mark.parametrize("case,bound", [("hash", 1.0), ("hash", 1.5), ("tiled", 1.5),
                                        ("smoothstep", 1.5), ("one_feature", 0.7)])
def test_forward_and_table_gradients_match_jax(case, bound):
    jc, pc = JG.GridEncoderConfig(**CASES[case]), PG.GridEncoderConfig(**CASES[case])
    tables = _tables(jc, 5)
    x = _points(jc, bound, 257, 6)
    jp = {k: jnp.asarray(v) for k, v in tables.items()}
    jx = jnp.asarray(x)
    enc = jax.jit(lambda p, x: JG.grid_encode(p, x, jc, bound))  # x an argument, as in training
    want = np.asarray(enc(jp, jx))
    gwant = jax.grad(lambda p: jnp.sum(jnp.sin(3.0 * enc(p, jx))))(jp)

    pp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in tables.items()}
    out = PG.grid_encode(pp, torch.from_numpy(x), pc, bound)
    assert out.shape == (len(x), pc.output_dim) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    # eager JAX divides: its u may be one f32 ulp (2^-24) off, which moves
    # pos by res * 2^-24 per axis and a feature by at most 1.5 (smoothstep's
    # slope) x 2 max|table| per axis
    max_res = max(jc.level_resolution(l) for l in range(jc.num_levels))
    tol = 3 * 1.5 * 2 * 0.5 * max_res * 2.0**-24
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(JG.grid_encode(jp, jx, jc, bound)),
                               rtol=0, atol=tol)
    grads = torch.autograd.grad(torch.sin(3.0 * out).sum(), [pp[k] for k in sorted(pp)])
    for k, g in zip(sorted(pp), grads):
        assert np.abs(np.asarray(gwant[k])).sum() > 0, k
        np.testing.assert_allclose(g.numpy(), np.asarray(gwant[k]), rtol=0, atol=1e-5, err_msg=k)


def test_backward_plain_is_the_gather_adjoint():
    """<grid_encode(T), G> = <T, backward(G)> for random tables and cotangents."""
    pc = PG.GridEncoderConfig(**CASES["hash"])
    tables = [torch.from_numpy(v).double() for v in _tables(pc, 7).values()]
    x = torch.from_numpy(_points(pc, 1.5, 200, 8))
    g = torch.randn((len(x), pc.output_dim), generator=torch.Generator().manual_seed(0)).double()
    lhs = (PG.grid_encode_plain(tables, x, pc, 1.5).double() * g).sum()
    rhs = sum((t * gt.double()).sum() for t, gt in
              zip(tables, PG.grid_encode_backward_plain(g, x, pc, 1.5)))
    assert abs(lhs.item() - rhs.item()) <= 1e-5 * abs(lhs.item())


@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_k7_gradient_tables_are_zeroed_views_aligned_to_row_pairs(C):
    """The tables the K7 backward adds into (host-side layout, the same on
    every device): zeroed (size_l, C) f32 views of one buffer, each level
    padded to an even number of rows, so each starts on a row pair and a
    pair's second row exists (the proposal grid's level 0 has 17^3 rows)."""
    cfg = PG.GridEncoderConfig(num_levels=5, level_dim=C, base_resolution=16, desired_resolution=128,
                               log2_hashmap_size=17)
    grads = PG._k7_grad_tables(cfg, "cpu")
    sizes = [cfg.level_size(l) for l in range(cfg.num_levels)]
    assert sizes[0] % 2 == 1
    rows = np.cumsum([0] + [s + s % 2 for s in sizes])
    base = grads[0].data_ptr()
    for l, gr in enumerate(grads):
        assert gr.shape == (sizes[l], C) and gr.dtype == torch.float32 and gr.is_contiguous()
        assert bool((gr == 0).all())
        assert gr.data_ptr() - base == 4 * C * rows[l]
        assert gr.untyped_storage().data_ptr() == base
    assert grads[0].untyped_storage().nbytes() == 4 * C * rows[-1]


def test_coordinate_gradient_is_not_ported():
    """The coordinate gradient is ported now (K7x's plain version on the
    CPU): ``grid_encode`` of points that require a gradient gives dL/dx
    through the autograd function, equal to ``grid_encode_backward_x_plain``
    and to the jitted ``jax.grad`` within 1e-6 of its largest entry, and
    leaves the table gradient as it is without it (equal).
    ``tests/test_torch_registry.py`` holds every grid type against JAX."""
    pc, jc = PG.GridEncoderConfig(**CASES["hash"]), JG.GridEncoderConfig(**CASES["hash"])
    tables = _tables(pc, 3)
    x = _points(pc, 1.5, 100, 4)
    G = np.random.default_rng(5).standard_normal((len(x), pc.output_dim)).astype(np.float32)
    pp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in tables.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    gx, *gt = torch.autograd.grad((PG.grid_encode(pp, xt, pc, 1.5) * torch.from_numpy(G)).sum(),
                                  [xt] + [pp[k] for k in sorted(pp)])
    want = np.asarray(jax.jit(jax.grad(lambda xx: (JG.grid_encode(
        {k: jnp.asarray(v) for k, v in tables.items()}, xx, jc, 1.5) * G).sum()))(jnp.asarray(x)))
    np.testing.assert_allclose(gx.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    plain = PG.grid_encode_backward_x_plain(torch.from_numpy(G), [pp[f"level_{l}"].detach() for l in
                                            range(pc.num_levels)], torch.from_numpy(x), pc, 1.5)
    assert torch.equal(gx, plain)
    gt0 = torch.autograd.grad((PG.grid_encode(pp, torch.from_numpy(x), pc, 1.5) * torch.from_numpy(G)).sum(),
                              [pp[k] for k in sorted(pp)])
    assert all(torch.equal(a, b) for a, b in zip(gt, gt0))


@pytest.mark.parametrize("name,dim", [(None, 3), ("frequency", 27), ("sphere_harmonics", 16),
                                      ("hashgrid", 32), ("tiledgrid", 32)])
def test_get_encoder_widths_and_outputs_match_jax(name, dim):
    jparams, japply, jdim = JE.get_encoder(name, jax.random.PRNGKey(0))
    pparams, papply, pdim = PE.get_encoder(name, torch.Generator().manual_seed(0), "cpu")
    assert pdim == jdim == dim == PE.encoder_dim(name)
    assert jax.tree.map(np.shape, jparams) == {k: tuple(v.shape) for k, v in pparams.items()}
    x = np.random.default_rng(9).uniform(-0.9, 0.9, (50, 3)).astype(np.float32)
    if name in ("hashgrid", "tiledgrid"):
        pparams = params_from_jax({"encoder": jparams, "sigma_net": {}, "color_net": {}}, "cpu")["encoder"]
    got = papply(pparams, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(japply(jparams, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    assert got.shape == (50, dim)


def test_kplanes_and_unknown_encodings_raise():
    """The k-planes encodings are ported (parity in
    tests/test_torch_variants.py); an unknown name still raises."""
    assert PE.get_encoder("k_planes", device="cpu")[2] == 48
    assert PN.NeRFField(PN.NeRFConfig(encoding="multiscale_k_planes_mul")).cfg.in_dim == 48
    with pytest.raises(ValueError, match="unknown encoding"):
        PE.get_encoder("bogus", device="cpu")


def _field_params(cfg, seed):
    rng = np.random.default_rng(seed)

    def mlp(dims):
        return {f"w{i}": rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(np.float32) / np.sqrt(dims[i])
                for i in range(len(dims) - 1)}

    return {"encoder": _tables(cfg.grid, seed + 1, std=1.0),
            "sigma_net": mlp([cfg.grid.output_dim, 64, 16]), "color_net": mlp([16 + 15, 64, 64, 3])}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hashgrid_field_matches_jax(dtype):
    gkw = dict(num_levels=8, level_dim=2, base_resolution=16, desired_resolution=256,
               log2_hashmap_size=15)
    kw = dict(encoding="hashgrid", bound=1.5, compute_dtype=dtype, plane_dtype=dtype)
    cj = JN.NeRFConfig(grid=JG.GridEncoderConfig(**gkw), **kw)
    cp = PN.NeRFConfig(grid=PG.GridEncoderConfig(**gkw), **kw)
    assert cp.in_dim == cj.in_dim == 16
    p = _field_params(cj, 0)
    jf, pf = JN.NeRFField(cj), PN.NeRFField(cp)
    jparams = jax.tree.map(jnp.asarray, p)
    pparams = params_from_jax(p, device="cpu")
    assert pf.build_planes(pparams) == {} == jf.build_planes(jparams)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.5, 1.5, (2000, 3)).astype(np.float32)
    d = rng.standard_normal((2000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    js, jg = jf.density(jparams, {}, jnp.asarray(x))
    ps, pg = pf.density(pparams, {}, torch.from_numpy(x))
    jrgb = np.asarray(jf.color(jparams, jnp.asarray(d), jg))
    prgb = pf.color(pparams, torch.from_numpy(d), pg).numpy()
    js, ps = np.asarray(js), ps.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(ps, js, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(prgb, jrgb, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(ps, js, rtol=0.05)
        np.testing.assert_allclose(prgb, jrgb, rtol=0, atol=0.02)
        assert np.mean(np.isclose(ps, js, rtol=1e-6)) >= 0.95
        assert np.mean(np.isclose(prgb, jrgb, rtol=1e-6)) >= 0.95


def test_field_params_shapes_match_jax_for_every_encoding():
    for enc in ("hashgrid", "tiledgrid", "frequency", "sphere_harmonics", None):
        gcfg = dict(num_levels=4, base_resolution=8, desired_resolution=64, log2_hashmap_size=12)
        cj = JN.NeRFConfig(encoding=enc, grid=JG.GridEncoderConfig(**gcfg) if enc else None)
        cp = PN.NeRFConfig(encoding=enc, grid=PG.GridEncoderConfig(**gcfg) if enc else None)
        jshapes = jax.tree.map(np.shape, JN.init_nerf_params(jax.random.PRNGKey(0), cj))
        pp = PN.init_nerf_params(cp, torch.Generator().manual_seed(0), "cpu")
        pshapes = {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in pp.items()}
        assert pshapes == jshapes, enc
        assert cp.in_dim == cj.in_dim


def test_params_from_jax_carries_grid_tables_and_rejects_others():
    cj = JN.NeRFConfig(encoding="hashgrid", grid=JG.GridEncoderConfig(**CASES["hash"]))
    p = _field_params(cj, 2)
    got = params_from_jax(p, device="cpu")
    for k, v in p["encoder"].items():
        np.testing.assert_array_equal(got["encoder"][k].numpy(), v)
    with pytest.raises(KeyError, match="grid tables"):
        params_from_jax(dict(p, encoder=dict(p["encoder"], scale_0=np.ones(3))), device="cpu")
    with pytest.raises(KeyError, match="grid tables"):
        params_from_jax(dict(p, encoder={"level_1": np.ones((4, 2))}), device="cpu")
    got = params_from_jax(dict(p, bg_net={"w0": np.ones((2, 2))}), device="cpu")  # carried now
    assert got["bg_net"]["w0"].shape == (2, 2)
    with pytest.raises(KeyError, match="not ported"):
        params_from_jax(dict(p, env_map={"w0": np.ones((2, 2))}), device="cpu")
