"""The hash-grid field on the occupancy-grid renderer: the PyTorch port's
trainer against the JAX package (CPU).

Setup: ``test_torch_train.py``'s render and train shapes (a 32^3 grid with 2
cascades, max_steps 128, 20 samples per ray, 512 rays, ``budget_autotune``
off) with ``NeRFConfig(encoding="hashgrid")`` at bound 1.5: an 8-level
grid, 16 -> 256, 2^15 rows (levels 0-2 dense, 3-7 hashed), and no wavelet
regularisation (a grid field has no wavelets). Tables, MLPs, density-grid
jitter, (view, pixel) indices and ray noise are made with numpy and handed
to both packages. The JAX field's encoder runs under jit, as the JAX trainer
runs it, since the port rounds its cell coordinate as jit does.

Tolerances (``test_torch_train.py``'s): the march is identical, so sample
counts are EQUAL; one f32 step's loss rtol 1e-5 and per-group gradients
within 1e-4 relative L2; the 5-step trajectory's losses rtol 1e-4,
parameters and EMA within 1e-5 except at most 0.01% of a group's entries
and within 2 lr x 5 everywhere.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import (N_RAYS, RKW, TKW, _batch, _Draws, _IntDraws, _leaves,
                                    _port_batch, _rel_l2, _scene)
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.models import gridencoder as JG
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu.train import trainer as JTR
from trinerflet_tpu_torch import kernels
from trinerflet_tpu_torch.carry import train_state_from_jax
from trinerflet_tpu_torch.data import synthetic as PS
from trinerflet_tpu_torch.models import gridencoder as PG
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.render import renderer as PR
from trinerflet_tpu_torch.train import trainer as PTR

GKW = dict(num_levels=8, level_dim=2, base_resolution=16, desired_resolution=256,
           log2_hashmap_size=15)
HTKW = dict(TKW, wavelet_regularization=0.0)


@functools.lru_cache(maxsize=None)
def _setup():
    kw = dict(encoding="hashgrid", bound=1.5, compute_dtype="float32", plane_dtype="float32")
    cj = JN.NeRFConfig(grid=JG.GridEncoderConfig(**GKW), **kw)
    cp = PN.NeRFConfig(grid=PG.GridEncoderConfig(**GKW), **kw)
    jtr = JTR.Trainer(cj, JR.RenderConfig(**RKW), JTR.TrainConfig(**HTKW))
    gcfg = cj.grid
    jtr.field._enc_apply = jax.jit(lambda p, x: JG.grid_encode(p, x, gcfg, cj.bound))
    ptr = PTR.Trainer(cp, PR.RenderConfig(**RKW), PTR.TrainConfig(**HTKW), device="cpu")
    rng = np.random.default_rng(0)

    def mlp(dims):
        return {f"w{i}": rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(np.float32) / np.sqrt(dims[i])
                for i in range(len(dims) - 1)}

    params = {"encoder": {f"level_{l}": rng.uniform(-1, 1, (gcfg.level_size(l), 2)).astype(np.float32)
                          for l in range(gcfg.num_levels)},
              "sigma_net": mlp([gcfg.output_dim, 64, 16]), "color_net": mlp([16 + 15, 64, 64, 3])}
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
    return jtr, ptr, jstate, jtr.scene_to_device(scene), jitter


def _port_data():
    return _setup()[1].scene_to_device(PS.make_synthetic_scene(num_views=2, H=64, W=64, num_steps=32))


def test_hashgrid_refresh_matches_jax():
    """One full density refresh of the port from the JAX state before it, on
    the same jitter: the same occupied cells."""
    jtr, ptr, jstate, _, jitter = _setup()
    fresh = JR.mark_untrained_grid(_scene().poses, _scene().intrinsics, jtr.render_cfg)
    state = train_state_from_jax(jstate, device="cpu")
    occ0 = ptr.init_occupancy(fresh)
    occ = ptr.update_grid(state.params, occ0, jitter=torch.from_numpy(jitter))
    occ_j = np.asarray(jstate.occ.occ)
    assert 0.001 < occ_j.mean() < 0.9
    # a density within rounding of the threshold may fall either way
    assert (occ.occ.numpy() != occ_j).mean() <= 1e-4
    np.testing.assert_allclose(occ.density_grid.numpy(), np.asarray(jstate.occ.density_grid),
                               rtol=1e-5, atol=1e-6)


def test_hashgrid_loss_and_grads_match_jax():
    jtr, ptr, jstate, jdata, _ = _setup()
    draws = _batch(1, 2, 64 * 64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", _IntDraws(draws[:2]))
        mp.setattr(jax.random, "uniform", _Draws(draws[2:]))
        (loss_j, aux_j), grads_j = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
            jstate.params, jstate.occ, jax.random.PRNGKey(0), jdata, None, True)
    state = train_state_from_jax(jstate, device="cpu")
    loss_p, aux_p = ptr._loss_fn(state.params, state.occ, _port_data(), _port_batch(draws), True,
                                 state.rng)
    names = sorted(_leaves(state.params))
    leaves = dict(PTR._leaves(state.params))
    grads_p = torch.autograd.grad(loss_p, [leaves[n] for n in names])
    assert int(aux_p["num_samples"]) == int(aux_j["num_samples"]) > N_RAYS
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_j), rtol=1e-5)
    gj = _leaves(jax.tree.map(np.asarray, grads_j))
    for n, g in zip(names, grads_p):
        assert np.linalg.norm(gj[n]) > 0, n
        assert _rel_l2(g.numpy(), gj[n]) <= 1e-4, (n, _rel_l2(g.numpy(), gj[n]))


def test_hashgrid_five_step_trajectory_matches_jax():
    jtr, ptr, jstate, jdata, _ = _setup()
    state = train_state_from_jax(jstate, device="cpu")
    data = _port_data()
    losses_j, losses_p = [], []
    for step in range(5):
        draws = _batch(10 + step, 2, 64 * 64)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "randint", _IntDraws(draws[:2]))
            mp.setattr(jax.random, "uniform", _Draws(draws[2:]))
            jstate, aux_j = jtr._train_step_impl(jstate, jdata, with_stats=step == 4)
        state, aux_p = ptr.train_step(state, data, with_stats=step == 4, batch=_port_batch(draws))
        losses_j.append(float(aux_j["loss"]))
        losses_p.append(float(aux_p["loss"]))
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-4)
    assert state.step == int(jstate.step) == 5 and state.ema_count == int(jstate.ema_count) == 5
    for tree_p, tree_j in ((state.params, jstate.params), (state.ema_params, jstate.ema_params)):
        lp, lj = _leaves(tree_p), _leaves(jax.tree.map(np.asarray, tree_j))
        assert lp.keys() == lj.keys()
        for n in lj:
            d = np.abs(lp[n] - lj[n])
            assert (d > 1e-5).mean() <= 1e-4 and d.max() <= 2 * TKW["lr"] * 5, (n, (d > 1e-5).sum())


def test_hashgrid_fit_render_and_evaluate_run():
    """init_state, fit on the cadence (refreshes and the march's retune),
    render_image and evaluate on the CPU with the port's own init; the
    trainer refuses the wavelet regularisation a grid field cannot have."""
    _, ptr, _, _, _ = _setup()
    scene = PS.make_synthetic_scene(num_views=2, H=24, W=24, num_steps=16)
    tr = PTR.Trainer(ptr.nerf_cfg, ptr.render_cfg, PTR.TrainConfig(**dict(HTKW, iters=3)), device="cpu")
    state = tr.init_state(density_grid=PR.mark_untrained_grid(scene.poses, scene.intrinsics,
                                                              tr.render_cfg))
    assert sorted(state.params["encoder"]) == [f"level_{l}" for l in range(8)]
    n0 = dict(kernels.launches)
    state = tr.fit(state, scene, log_every=0)
    assert kernels.launches == n0  # CPU tensors: the plain versions, no kernel
    assert state.step == 3 and int(state.occ.iter_density) == 1
    assert all(np.isfinite(v).all() for v in _leaves(state.params).values())
    res = tr.evaluate(state, scene)
    assert np.isfinite(res["PSNR"]) and np.isfinite(res["SSIM"])
    with pytest.raises(ValueError, match="wavelet_regularization"):
        PTR.Trainer(ptr.nerf_cfg, ptr.render_cfg, PTR.TrainConfig(**TKW), device="cpu")
