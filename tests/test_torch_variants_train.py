"""The triplane field's variants in training: the PyTorch port's trainer
against the JAX package's jitted step (CPU).

Setup: ``test_torch_train.py``'s BENCH_SMOKE shapes (a 64^2 x 16-channel
bior6.8 wavelet triplane with 2 IDWT levels, bound 1.5, a 32^3 grid with 2
cascades, max_steps 128, 20 samples per ray, 512 rays, wavelet L1 0.4,
``budget_autotune`` off) with the learned rotation, the lbound zoom and two
zoom-in levels at ratio 0.5 (``--triplane_rotation --lbound_auto_scale
--upscale_ratio_bound 0.5``) and the background network (``bg_radius`` 2
in the field and the render config; the trainer, as the JAX trainer, never
passes ``bg_fn``, so ``bg_net`` stays where it was initialised).
Parameters, density-grid jitter, (view, pixel) indices and ray noise are
made with numpy and handed to both packages. The JAX step is
``_train_step_impl`` under ``jax.jit``, its draws passed in as arguments
(``jax.random`` is patched while it traces).

The field keeps SH degree 4: at degree 8 (the recurrence) XLA's jitted step
differs from eager JAX itself in the base plane's gradient by more than the
port does (``scripts/torch_sh8_jit_gap.py`` measures both), so a jitted
trajectory there would compare XLA's fusion, not the port. Degree 8 is
held in ``test_torch_variants.py`` (the encoder and the background net).

Tolerances (``test_torch_train.py``'s): the march is identical, so sample
counts are EQUAL; losses rtol 1e-4 per step; parameters and EMA within
1e-5 except at most 0.01% of a group's entries, and within 2 lr x 3
everywhere. The quaternion and lbound_scale (4 and 1 entries) must be
within 1e-5 outright.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import DIMS, N_RAYS, RKW, TKW, _batch, _Draws, _leaves, _port_batch, _scene
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu.train import trainer as JTR
from trinerflet_tpu_torch.carry import train_state_from_jax
from trinerflet_tpu_torch.data import synthetic as PS
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.models import triplane as PT
from trinerflet_tpu_torch.render import renderer as PR
from trinerflet_tpu_torch.train import trainer as PTR

VARIANTS = dict(learned_rotation=True, lbound_auto_scale=True, upscale_ratio_bound=0.5,
                upscale_levels=2)
FIELD = dict(bound=1.5, compute_dtype="float32", plane_dtype="float32", bg_radius=2.0)
VRKW = dict(RKW, bg_radius=2.0)
STEPS = 3


@functools.lru_cache(maxsize=None)
def _setup():
    """Both trainers, the JAX state after one full refresh (injected jitter),
    numpy-made params as at initialisation (random base and MLPs, zero detail
    and zoom-in levels, the identity quaternion, zoom 1)."""
    cj = JN.NeRFConfig(triplane=JT.TriplaneConfig(**DIMS, **VARIANTS), **FIELD)
    cp = PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS, **VARIANTS), **FIELD)
    jtr = JTR.Trainer(cj, JR.RenderConfig(**VRKW), JTR.TrainConfig(**TKW))
    ptr = PTR.Trainer(cp, PR.RenderConfig(**VRKW), PTR.TrainConfig(**TKW), device="cpu")
    rng = np.random.default_rng(0)
    tri = cj.triplane
    b = tri.base_resolution

    def mlp(dims):
        return {f"w{i}": rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(np.float32) / np.sqrt(dims[i])
                for i in range(len(dims) - 1)}

    enc = {"base": (0.5 * rng.standard_normal((3, 16, b, b))).astype(np.float32),
           "wavelets": {f"level_{i}": np.zeros((3, 16, 3, s, s), np.float32)
                        for i, s in enumerate(tri.yh_sizes)}}
    if tri.upscale_enabled:
        enc["upscale"] = {f"level_{i}": np.zeros((3, 16, 3, s, s), np.float32)
                          for i, s in enumerate(PT._upscale_geometry(cp.triplane)[0])}
    if tri.learned_rotation:
        enc["rotation"] = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    if tri.lbound_auto_scale:
        enc["lbound_scale"] = np.array(1.0, np.float32)
    params = {"encoder": enc, "sigma_net": mlp([tri.feature_dim, 64, 16]),
              "color_net": mlp([cj.in_dim_dir + 15, 64, 64, 3]), "bg_net": mlp([cj.in_dim_dir + 2, 64, 3])}
    jinit = JN.init_nerf_params(jax.random.PRNGKey(0), cj)
    assert jax.tree.map(np.shape, jinit) == jax.tree.map(np.shape, params)
    scene = _scene()
    grid = JR.mark_untrained_grid(scene.poses, scene.intrinsics, jtr.render_cfg)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtr.init_state(density_grid=grid)._replace(
        params=jparams, opt_state=jtr.optimizer.init(jparams),
        ema_params=jax.tree.map(jnp.copy, jparams))
    H, C = RKW["grid_size"], jtr.render_cfg.cascades
    jitter = np.stack([rng.uniform(-1, 1, (H**3, 3)).astype(np.float32) * np.float32(min(2**c, 1.5) / H)
                       for c in range(C)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _Draws(jitter))
        jstate = jtr._update_grid_impl(jstate, full=True)
    return jtr, ptr, jstate, jtr.scene_to_device(scene)


def _jitted_step(jtr):
    """``_train_step_impl`` under jit, the batch's draws as arguments."""

    def step(state, data, img, pix, noise):
        ints, floats = [img, pix], [noise]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "randint",
                       lambda key, shape, minval, maxval, dtype=jnp.int32: ints.pop(0).astype(dtype))
            mp.setattr(jax.random, "uniform",
                       lambda key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0:
                       floats.pop(0).astype(dtype))
            return jtr._train_step_impl(state, data, with_stats=False)

    return jax.jit(step)


def test_variants_trajectory_matches_jax():
    """Adam (eps 1e-15) with the schedule and the EMA over three f32 steps on
    injected batches: the quaternion, the zoom and the zoom-in levels move
    at step 1 in both."""
    jtr, ptr, jstate, jdata = _setup()
    state = train_state_from_jax(jstate, device="cpu")
    data = ptr.scene_to_device(PS.make_synthetic_scene(num_views=2, H=64, W=64, num_steps=32))
    jstep = _jitted_step(jtr)
    losses_j, losses_p = [], []
    for step in range(STEPS):
        draws = _batch(20 + step, 2, 64 * 64)
        jstate, aux_j = jstep(jstate, jdata, *(jnp.asarray(a) for a in draws))
        state, aux_p = ptr.train_step(state, data, with_stats=False, batch=_port_batch(draws))
        assert int(aux_p["num_samples"]) == int(aux_j["num_samples"]) > N_RAYS
        losses_j.append(float(aux_j["loss"]))
        losses_p.append(float(aux_p["loss"]))
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-4)
    assert state.step == int(jstate.step) == STEPS and state.ema_count == int(jstate.ema_count)
    for tree_p, tree_j in ((state.params, jstate.params), (state.ema_params, jstate.ema_params)):
        lp, lj = _leaves(tree_p), _leaves(jax.tree.map(np.asarray, tree_j))
        assert lp.keys() == lj.keys()
        for n in lj:
            d = np.abs(lp[n] - lj[n])
            assert (d > 1e-5).mean() <= 1e-4 and d.max() <= 2 * TKW["lr"] * STEPS, (n, (d > 1e-5).sum())
        for n in ("encoder.rotation", "encoder.lbound_scale"):
            assert np.abs(lp[n] - lj[n]).max() <= 1e-5, n
    lp = _leaves(state.params)
    assert np.abs(lp["encoder.rotation"] - [1, 0, 0, 0]).max() > 1e-3 and lp["encoder.lbound_scale"] != 1.0
    assert (lp["encoder.upscale.level_0"] != 0).mean() > 0.9
    np.testing.assert_array_equal(lp["bg_net.w0"], _leaves(jax.tree.map(np.asarray, _setup()[2].params))["bg_net.w0"])


@pytest.mark.parametrize("encoding", ["triplane_wavelet", "multiscale_k_planes_mul"])
def test_variants_and_kplanes_fit_render_and_evaluate(encoding):
    """The entry points on the CPU: init_state, fit on the refresh cadence
    (the refresh samples ``full`` through the learned transform),
    render_image (the zoom-in planes routed) and evaluate."""
    kw = dict(FIELD, encoding=encoding, sh_degree=8)
    cp = PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS, **VARIANTS), **kw)
    tr = PTR.Trainer(cp, PR.RenderConfig(**VRKW),
                     PTR.TrainConfig(**dict(TKW, iters=3, wavelet_regularization=0.4 if
                                            encoding == "triplane_wavelet" else 0.0)), device="cpu")
    scene = PS.make_synthetic_scene(num_views=2, H=24, W=24, num_steps=16)
    state = tr.init_state(density_grid=PR.mark_untrained_grid(scene.poses, scene.intrinsics, tr.render_cfg))
    assert ("bg_net" in state.params) and (("rotation" in state.params["encoder"])
                                           == (encoding == "triplane_wavelet"))
    state = tr.fit(state, scene, log_every=0)
    assert state.step == 3 and int(state.occ.iter_density) == 1
    img, dep = tr.render_image(state.ema_params, state.occ, scene.poses[0], scene.intrinsics, 24, 24)
    assert img.shape == (24, 24, 3) and torch.isfinite(img).all() and torch.isfinite(dep).all()
    res = tr.evaluate(state, scene)
    assert np.isfinite(res["PSNR"]) and np.isfinite(res["SSIM"])
    leaves = _leaves(state.params)
    assert all(np.isfinite(v).all() for v in leaves.values())
    if encoding == "triplane_wavelet":
        assert np.abs(leaves["encoder.rotation"] - [1, 0, 0, 0]).max() > 1e-3
    else:
        assert {"encoder.scale_0", "encoder.scale_1", "encoder.scale_2"} <= set(leaves)
