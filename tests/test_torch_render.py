"""The serving slice as a whole: the PyTorch port against the JAX package (CPU).

Setup: the bench's shapes cut to CPU size -- a 64^2 x 8-channel bior6.8
wavelet triplane (2 IDWT levels, non-zero detail coefficients), bound 1.5, a
32^3 grid with 2 cascades, max_steps 128, 20 samples per ray. Parameters,
cameras, density-grid jitter and ray noise are made with numpy and handed to
both packages (the JAX package's ``jax.random.uniform`` is patched to return
them, so neither framework's RNG is compared).

Tolerances, stated per comparison:
* density grid: float32 rtol 1e-4 (planes and MLPs sum in another order);
  bf16 rtol 0.05 (a bf16 rounding moved by one ulp, through exp).
* occupancy bits: equal wherever the density is not within that tolerance
  of the threshold.
* renders from the carried state (same occupancy): the march is identical,
  so mask-derived outputs (num_samples, p99 of demand) are EQUAL (their
  mean to rtol 1e-6); image / depth / weights_sum float32 atol 5e-5; bf16 atol 0.03
  (a bf16 MLP rounding flip changes one sample's sigma by up to ~5%).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trinerflet_tpu.data.synthetic import orbit_pose as j_orbit_pose
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu.train import trainer as JTR
from trinerflet_tpu_torch.carry import occupancy_from_jax, params_from_jax
from trinerflet_tpu_torch.data.rays import rays_full_image
from trinerflet_tpu_torch.data.synthetic import orbit_pose, synthetic_intrinsics
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.models import triplane as PT
from trinerflet_tpu_torch.render import renderer as PR
from trinerflet_tpu_torch.train import trainer as PTR

DIMS = dict(channels=8, resolution=64, wavelet_scale=4)
RKW = dict(bound=1.5, grid_size=32, max_steps=128, samples_per_ray_budget=20)
TOL = {"float32": dict(grid=1e-4, img=5e-5), "bfloat16": dict(grid=0.05, img=0.03)}


def _cfgs(dtype):
    kw = dict(bound=1.5, compute_dtype=dtype, plane_dtype=dtype)
    return (JN.NeRFConfig(triplane=JT.TriplaneConfig(**DIMS), **kw),
            PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS), **kw),
            JR.RenderConfig(**RKW), PR.RenderConfig(**RKW))


def _params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tri = cfg.triplane
    b = tri.base_resolution

    def mlp(dims):
        return {f"w{i}": rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(np.float32) / np.sqrt(dims[i])
                for i in range(len(dims) - 1)}

    return {
        "encoder": {"base": (0.5 * rng.standard_normal((3, tri.channels, b, b))).astype(np.float32),
                    "wavelets": {f"level_{i}": (0.1 * rng.standard_normal((3, tri.channels, 3, s, s))).astype(np.float32)
                                 for i, s in enumerate(tri.yh_sizes)}},
        "sigma_net": mlp([tri.feature_dim, 64, 16]),
        "color_net": mlp([16 + 15, 64, 64, 3]),
    }


def _jax_tree(t):
    return {k: _jax_tree(v) for k, v in t.items()} if isinstance(t, dict) else jnp.asarray(t)


class _Draws:
    """Stands in for jax.random.uniform: hands out numpy arrays in order."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape)
        return jnp.asarray(a, dtype)


def _poses():
    return np.stack([orbit_pose(np.arccos(1 - 1.6 * (v + 0.5) / 8), v * 2.399963, 2.0)
                     for v in range(8)])


@functools.lru_cache(maxsize=None)
def _refresh_both(dtype):
    """One full density-grid refresh in both packages from the same params,
    camera culling and jitter. Returns everything the tests compare (cached:
    the tests only read it)."""
    cj, cp, rj, rp = _cfgs(dtype)
    params = _params(cj)
    intr = synthetic_intrinsics(64, 64)
    grid0 = PR.mark_untrained_grid(_poses(), intr, rp)
    np.testing.assert_array_equal(grid0, JR.mark_untrained_grid(_poses(), intr, rj))
    H, C = rp.grid_size, rp.cascades
    rng = np.random.default_rng(7)
    jitter = np.stack([rng.uniform(-1, 1, (H**3, 3)).astype(np.float32) * np.float32(min(2**c, 1.5) / H)
                       for c in range(C)])

    jf = JN.NeRFField(cj)
    jparams = _jax_tree(params)
    jplanes = jf.build_planes(jparams, max_resolution=2 * H)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _Draws(jitter))
        jstate = JR.update_density_grid(
            JR.init_occupancy(rj)._replace(density_grid=jnp.asarray(grid0)),
            lambda x: jf.density(jparams, jplanes, x)[0], jax.random.PRNGKey(0), rj)

    ptr = PTR.Trainer(cp, rp, PTR.TrainConfig(), device="cpu")
    pparams = params_from_jax(params, device="cpu")
    pstate = ptr.update_grid(pparams, ptr.init_occupancy(grid0), jitter=torch.from_numpy(jitter))
    return cj, cp, rj, rp, params, jparams, pparams, jstate, pstate


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_density_grid_matches_jax(dtype):
    *_, jstate, pstate = _refresh_both(dtype)
    tol = TOL[dtype]["grid"]
    jg = np.asarray(jstate.density_grid)
    np.testing.assert_array_equal(jg < 0, pstate.density_grid.numpy() < 0)
    np.testing.assert_allclose(pstate.density_grid.numpy(), jg, rtol=tol, atol=1e-6)
    np.testing.assert_allclose(float(pstate.mean_density), float(jstate.mean_density), rtol=tol)
    thresh = float(jstate.mean_density)
    occ_j = np.asarray(jstate.occ).reshape(jg.shape)
    occ_p = pstate.occ.numpy().reshape(jg.shape)
    near = np.abs(jg - thresh) <= 2 * tol * max(thresh, np.abs(jg).max() * 1e-3)
    assert 0.05 < occ_j.mean() < 0.95  # a non-trivial grid
    np.testing.assert_array_equal(occ_p[~near], occ_j[~near])
    np.testing.assert_array_equal(pstate.occ_coarse.numpy(),
                                  PR._dilate3(pstate.occ, PR.RenderConfig(**RKW).coarse_dilation_radius).numpy())
    if np.array_equal(occ_p, occ_j):
        np.testing.assert_array_equal(pstate.occ_coarse.numpy(), np.asarray(jstate.occ_coarse))
        np.testing.assert_allclose(pstate.bbox.numpy(), np.asarray(jstate.bbox), atol=1e-6)
    assert int(pstate.iter_density) == int(jstate.iter_density) == 1


@pytest.mark.parametrize("dtype,perturb", [("float32", True), ("bfloat16", False)])
def test_render_occgrid_matches_jax(dtype, perturb, monkeypatch):
    cj, cp, rj, rp, params, jparams, pparams, jstate, _ = _refresh_both(dtype)
    pstate = occupancy_from_jax(jstate, device="cpu")
    intr = synthetic_intrinsics(20, 20)
    ro, rd = rays_full_image(_poses()[3], intr, 20, 20)
    rng = np.random.default_rng(9)
    noise = rng.random(ro.shape[0]).astype(np.float32)

    jf, pf = JN.NeRFField(cj), PN.NeRFField(cp)
    jplanes, pplanes = jf.build_planes(jparams), pf.build_planes(pparams)
    monkeypatch.setattr(jax.random, "uniform", _Draws([noise]))
    jout = JR.render_occgrid(
        lambda x, d: jf(jparams, jplanes, x, d), jnp.asarray(ro), jnp.asarray(rd), jstate.occ, rj,
        rng=jax.random.PRNGKey(1) if perturb else None, bg_color=0.0, perturb=perturb,
        occ_coarse=jstate.occ_coarse, occ_bbox=jstate.bbox, occ_bricks=jstate.occ_bricks,
        occ_coarse_bricks=jstate.occ_coarse_bricks)
    monkeypatch.undo()
    pout = PR.render_occgrid(
        lambda x, d: pf(pparams, pplanes, x, d), torch.from_numpy(ro), torch.from_numpy(rd),
        pstate.occ, rp, noise=torch.from_numpy(noise) if perturb else None, bg_color=0.0,
        occ_coarse=pstate.occ_coarse, occ_bbox=pstate.bbox)

    assert set(pout) == set(jout)
    assert int(jout["num_samples"]) > 0.5 * ro.shape[0]
    for k in ("num_samples", "samples_p99", "overflow_frac", "span_p99"):
        np.testing.assert_array_equal(pout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    # a mean over rays: reduced in another order
    np.testing.assert_allclose(pout["samples_mean"].numpy(), np.asarray(jout["samples_mean"]), rtol=1e-6)
    tol = TOL[dtype]["img"]
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(pout[k].numpy(), np.asarray(jout[k]), rtol=0, atol=tol, err_msg=k)
    for k in ("z_variance", "trunc_T", "span_trunc_T", "needed_seg_p99"):
        np.testing.assert_allclose(pout[k].numpy(), np.asarray(jout[k]), rtol=0.05, atol=tol, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_render_image_matches_jax(dtype):
    cj, cp, rj, rp, params, jparams, pparams, jstate, _ = _refresh_both(dtype)
    H, W = 24, 20
    intr = synthetic_intrinsics(H, W)
    pose = _poses()[5]
    np.testing.assert_array_equal(pose, j_orbit_pose(np.arccos(1 - 1.6 * 5.5 / 8), 5 * 2.399963, 2.0))
    jtr = JTR.Trainer(cj, rj, JTR.TrainConfig(eval_chunk=1024))
    ptr = PTR.Trainer(cp, rp, PTR.TrainConfig(eval_chunk=1024), device="cpu")
    assert (ptr.eval_chunk, ptr.eval_render_cfg.samples_per_ray_budget) == \
        (jtr.eval_chunk, jtr.eval_render_cfg.samples_per_ray_budget)
    assert dataclasses.asdict(ptr.eval_render_cfg) == dataclasses.asdict(jtr.eval_render_cfg)
    assert ptr.eval_render_cfg.num_candidates == jtr.eval_render_cfg.num_candidates
    jimg, jdep = jtr.render_image(jparams, jstate, pose, intr, H, W)
    pimg, pdep = ptr.render_image(pparams, occupancy_from_jax(jstate, device="cpu"), pose, intr, H, W)
    assert pimg.shape == (H, W, 3) and pdep.shape == (H, W)
    assert np.isfinite(pimg.numpy()).all() and np.asarray(jimg).std() > 1e-3
    # the JAX renderer runs under jit here (fused multiply-adds in the field),
    # so float32 gets 1e-4 instead of the eager 5e-5
    tol = 1e-4 if dtype == "float32" else TOL[dtype]["img"]
    np.testing.assert_allclose(pimg.numpy(), np.asarray(jimg), rtol=0, atol=tol)
    np.testing.assert_allclose(pdep.numpy(), np.asarray(jdep), rtol=0, atol=tol)


@pytest.mark.parametrize("slots", [4, 20], ids=["overflow", "ample"])
def test_render_occgrid_global_layout_matches_jax(slots, monkeypatch):
    """The global layout (K5 + the compact compositor) with injected noise:
    a buffer of 4 slots per ray (it overflows: the tail is dropped) and of
    20 (every kept sample fits). Counts and buffer use are EQUAL; image,
    depth and weights_sum within the JAX compositor's own error (its global
    f32 cumsum, see tests/test_torch_compact.py): eps = 4 ulp of the
    buffer's cumsum of sigma*dt, plus 8 ulp of each output's sum over the
    rays, plus the per-ray layout's 5e-5 for the field."""
    cj, cp, rj, rp, params, jparams, pparams, jstate, _ = _refresh_both("float32")
    rj, rp = (dataclasses.replace(c, compaction="global", global_slots_per_ray=slots) for c in (rj, rp))
    pstate = occupancy_from_jax(jstate, device="cpu")
    ro, rd = rays_full_image(_poses()[3], synthetic_intrinsics(20, 20), 20, 20)
    noise = np.random.default_rng(9).random(ro.shape[0]).astype(np.float32)
    jf, pf = JN.NeRFField(cj), PN.NeRFField(cp)
    jplanes, pplanes = jf.build_planes(jparams), pf.build_planes(pparams)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _Draws([noise]))
        jout = JR.render_occgrid(
            lambda x, d: jf(jparams, jplanes, x, d), jnp.asarray(ro), jnp.asarray(rd), jstate.occ, rj,
            rng=jax.random.PRNGKey(1), bg_color=0.0, perturb=True, occ_coarse=jstate.occ_coarse,
            occ_bbox=jstate.bbox, occ_bricks=jstate.occ_bricks,
            occ_coarse_bricks=jstate.occ_coarse_bricks)
    seen = {}
    composite = PR.RM.composite_compact

    def spy(sigmas, rgbs, comp, n, thresh):
        seen["sd"], seen["ts"] = (sigmas * comp.dts).detach().numpy(), comp.ts.numpy()
        return composite(sigmas, rgbs, comp, n, thresh)

    monkeypatch.setattr(PR.RM, "composite_compact", spy)
    pout = PR.render_occgrid(
        lambda x, d: pf(pparams, pplanes, x, d), torch.from_numpy(ro), torch.from_numpy(rd),
        pstate.occ, rp, noise=torch.from_numpy(noise), bg_color=0.0, occ_coarse=pstate.occ_coarse,
        occ_bbox=pstate.bbox)
    assert set(pout) == set(jout) and "global_fill" in pout
    for k in ("num_samples", "global_fill", "samples_p99", "overflow_frac", "span_p99", "needed_seg_p99"):
        assert float(pout[k]) == float(jout[k]), k
    fill = float(pout["global_fill"])
    assert fill == 1.0 if slots == 4 else 0.5 < fill < 1.0
    eps = 4 * float(np.spacing(np.cumsum(seen["sd"], dtype=np.float32)[-1]))
    for k, scale in (("image", 1.0), ("depth", float(seen["ts"].max())), ("weights_sum", 1.0)):
        got, ref = pout[k].numpy(), np.asarray(jout[k])
        tol = eps * scale + 8 * float(np.spacing(np.float32(np.abs(ref).sum()))) + TOL["float32"]["img"]
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=k)


def test_unported_render_options_raise():
    """Every march, layout and renderer of the JAX package is ported (the
    flat march and dt_gamma > 0 in tests/test_torch_flat_march.py, the dense
    renderer in tests/test_torch_dense.py), and so are the background
    network (bg_radius > 0, tests/test_torch_variants.py) and a field with
    the SR snapshot planes: the trainer builds ``low_res`` beside ``full``
    and renders ``full``, as JAX's does (float32 atol 1e-4, the jitted JAX
    renderer's tolerance above). What still raises is a renderer name the
    JAX package does not define."""
    rp = PR.RenderConfig(**RKW)
    bg = PTR.Trainer(PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS), bg_radius=2.0), rp,
                     PTR.TrainConfig(), device="cpu")
    assert "bg_net" in bg.init_params()
    cj, cp, rj, _, _, jparams, pparams, jstate, _ = _refresh_both("float32")
    sj = dataclasses.replace(cj, triplane=dataclasses.replace(cj.triplane, low_res_scale=2))
    sp = dataclasses.replace(cp, triplane=dataclasses.replace(cp.triplane, low_res_scale=2))
    jtr = JTR.Trainer(sj, rj, JTR.TrainConfig(eval_chunk=1024))
    ptr = PTR.Trainer(sp, rp, PTR.TrainConfig(eval_chunk=1024), device="cpu")
    planes = ptr.field.build_planes(pparams)
    assert set(planes) == set(jtr.field.build_planes(jparams)) == {"full", "low_res"}
    assert tuple(planes["low_res"].shape) == (3, 32, 32, 8)
    H, W = 12, 10
    jimg, _ = jtr.render_image(jparams, jstate, _poses()[2], synthetic_intrinsics(H, W), H, W)
    pimg, _ = ptr.render_image(pparams, occupancy_from_jax(jstate, device="cpu"), _poses()[2],
                               synthetic_intrinsics(H, W), H, W)
    assert np.asarray(jimg).std() > 1e-3
    np.testing.assert_allclose(pimg.numpy(), np.asarray(jimg), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="unknown renderer"):
        PTR.Trainer(PN.NeRFConfig(), rp, PTR.TrainConfig(renderer="nerfacc"), device="cpu")
    for renderer in ("occgrid", "proposal", "dense"):
        assert PTR.Trainer(PN.NeRFConfig(), rp, PTR.TrainConfig(renderer=renderer),
                           device="cpu").cfg.renderer == renderer


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partial_update_density_grid_matches_jax(dtype):
    """Training's rotating quarter refresh after the first full one
    (iter_density = 1: the block [S, 2S) of every cascade)."""
    cj, cp, rj, rp, params, jparams, pparams, jstate, _ = _refresh_both(dtype)
    H, C = rp.grid_size, rp.cascades
    S = H**3 // 4
    rng = np.random.default_rng(8)
    jitter = np.stack([rng.uniform(-1, 1, (S, 3)).astype(np.float32) * np.float32(min(2**c, 1.5) / H)
                       for c in range(C)])
    jf = JN.NeRFField(cj)
    jplanes = jf.build_planes(jparams, max_resolution=2 * H)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _Draws(jitter))
        j2 = JR.update_density_grid(jstate, lambda x: jf.density(jparams, jplanes, x)[0],
                                    jax.random.PRNGKey(0), rj, fraction=0.25)
    ptr = PTR.Trainer(cp, rp, PTR.TrainConfig(), device="cpu")
    p2 = ptr.update_grid(pparams, occupancy_from_jax(jstate, device="cpu"),
                         jitter=torch.from_numpy(jitter), full=False)
    jg, pg = np.asarray(j2.density_grid), p2.density_grid.numpy()
    old = np.asarray(jstate.density_grid)
    outside = np.ones(H**3, bool)
    outside[S : 2 * S] = False
    np.testing.assert_array_equal(pg[:, outside], old[:, outside])  # only the block moved
    assert (pg[:, S : 2 * S] != old[:, S : 2 * S]).any()
    tol = TOL[dtype]["grid"]
    np.testing.assert_allclose(pg, jg, rtol=tol, atol=1e-6)
    np.testing.assert_allclose(float(p2.mean_density), float(j2.mean_density), rtol=tol)
    thresh = float(j2.mean_density)
    near = np.abs(jg - thresh) <= 2 * tol * max(thresh, np.abs(jg).max() * 1e-3)
    occ_j = np.asarray(j2.occ).reshape(jg.shape)
    np.testing.assert_array_equal(p2.occ.numpy().reshape(jg.shape)[~near], occ_j[~near])
    assert int(p2.iter_density) == int(j2.iter_density) == 2


def test_render_occgrid_train_config_matches_jax():
    """The training render: a fine test stride of 2 (what the bench's auto
    stride resolves to at 128^3 / max_steps 1024) and with_stats off."""
    cj, cp, rj, rp, params, jparams, pparams, jstate, _ = _refresh_both("float32")
    rj, rp = (dataclasses.replace(c, occ_test_stride=2) for c in (rj, rp))
    pstate = occupancy_from_jax(jstate, device="cpu")
    ro, rd = rays_full_image(_poses()[2], synthetic_intrinsics(16, 16), 16, 16)
    noise = np.random.default_rng(12).random(ro.shape[0]).astype(np.float32)
    jf, pf = JN.NeRFField(cj), PN.NeRFField(cp)
    jplanes = jf.build_planes(jparams)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _Draws([noise]))
        jout = JR.render_occgrid(
            lambda x, d: jf(jparams, jplanes, x, d), jnp.asarray(ro), jnp.asarray(rd), jstate.occ, rj,
            rng=jax.random.PRNGKey(1), bg_color=0.0, perturb=True, occ_coarse=jstate.occ_coarse,
            occ_bbox=jstate.bbox, occ_bricks=jstate.occ_bricks,
            occ_coarse_bricks=jstate.occ_coarse_bricks, with_stats=False)
    pplanes = pf.build_planes(pparams)
    pout = PR.render_occgrid(
        lambda x, d: pf(pparams, pplanes, x, d), torch.from_numpy(ro), torch.from_numpy(rd),
        pstate.occ, rp, noise=torch.from_numpy(noise), bg_color=0.0, occ_coarse=pstate.occ_coarse,
        occ_bbox=pstate.bbox, with_stats=False)
    assert set(pout) == set(jout) and "samples_p99" not in pout
    np.testing.assert_array_equal(pout["num_samples"].numpy(), np.asarray(jout["num_samples"]))
    np.testing.assert_allclose(pout["image"].numpy(), np.asarray(jout["image"]), rtol=0,
                               atol=TOL["float32"]["img"])


def test_rays_and_cameras_match_jax():
    from trinerflet_tpu.data import rays as JRY
    from trinerflet_tpu_torch.data.rays import rays_for_pixels

    poses = _poses()
    for v in range(3):
        np.testing.assert_array_equal(
            poses[v], j_orbit_pose(np.arccos(1 - 1.6 * (v + 0.5) / 8), v * 2.399963, 2.0))
    intr = synthetic_intrinsics(30, 40)
    assert intr == (36.0, 36.0, 20.0, 15.0)
    for a, b in zip(rays_full_image(poses[2], intr, 30, 40),
                    JRY.rays_full_image(poses[2], intr, 30, 40)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(11)
    img = rng.integers(0, 8, 500).astype(np.int32)
    pix = rng.integers(0, 30 * 40, 500).astype(np.int32)
    jo, jd = JRY.rays_for_pixels(jnp.asarray(poses), intr, 40, jnp.asarray(img), jnp.asarray(pix))
    po, pd = rays_for_pixels(torch.from_numpy(poses), intr, 40, torch.from_numpy(img).long(),
                             torch.from_numpy(pix).long())
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
