"""The flat march in training: the PyTorch port's trainer against the JAX
package's on the occupancy-grid renderer at dt_gamma = 1/128 (the CLI's
default) and bound 4, with the march left at "hierarchical" as the CLI
leaves it, so render_occgrid takes the flat branch (CPU).

Setup: ``test_torch_train.py``'s BENCH_SMOKE model (a 64^2 x 16-channel
wavelet triplane, random base and MLPs, zero detail levels, float32) at
bound 4: a 32^3 grid with 3 cascades, max_steps 128, 20 samples per ray,
512 rays, wavelet L1 0.4, the tuner on (it acts only in the retune); the
synthetic scene at 2 views of 64^2 with the cameras at radius 2, inside the
box, as a forward-facing capture's are (rays start at min_near, in the
ladder's first phase). Parameters, the refresh jitter, the batch indices
and the ray noise are numpy-made and handed to both packages.

Tolerances: as ``test_torch_train.py`` (loss rtol 1e-5 for one step,
gradients 1e-4 relative L2; the 5-step losses rtol 1e-4, parameters and EMA
within 1e-5 except at most 0.01% of a group's entries), with the sample
counts equal: on the ladder the march's t may sit an ulp or two apart
(tests/test_torch_flat_march.py), which moves a sample by that much but
keeps the mask here. The retune reads each package's own aux and must
reach the same config.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import DIMS, TKW, _Draws, _IntDraws, _leaves, _rel_l2
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.data import synthetic as JS
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

N_RAYS = 512
BOUND = 4.0
FKW = dict(bound=BOUND, grid_size=32, density_thresh=10.0, max_steps=128, samples_per_ray_budget=20,
           dt_gamma=1.0 / 128)
FTKW = dict(TKW, budget_autotune=True)


def _scene_args():
    return dict(num_views=2, H=64, W=64, num_steps=32)


@functools.lru_cache(maxsize=None)
def _setup():
    kw = dict(bound=BOUND, compute_dtype="float32", plane_dtype="float32")
    cj = JN.NeRFConfig(triplane=JT.TriplaneConfig(**DIMS), **kw)
    cp = PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS), **kw)
    jtr = JTR.Trainer(cj, JR.RenderConfig(**FKW), JTR.TrainConfig(**FTKW))
    ptr = PTR.Trainer(cp, PR.RenderConfig(**FKW), PTR.TrainConfig(**FTKW), device="cpu")
    rng = np.random.default_rng(0)
    tri = cj.triplane
    b = tri.base_resolution

    def mlp(dims):
        return {f"w{i}": rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(np.float32) / np.sqrt(dims[i])
                for i in range(len(dims) - 1)}

    params = {"encoder": {"base": (0.5 * rng.standard_normal((3, 16, b, b))).astype(np.float32),
                          "wavelets": {f"level_{i}": np.zeros((3, 16, 3, s, s), np.float32)
                                       for i, s in enumerate(tri.yh_sizes)}},
              "sigma_net": mlp([tri.feature_dim, 64, 16]), "color_net": mlp([16 + 15, 64, 64, 3])}
    scene = JS.make_synthetic_scene(**_scene_args())
    grid = JR.mark_untrained_grid(scene.poses, scene.intrinsics, jtr.render_cfg)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtr.init_state(density_grid=grid)._replace(
        params=jparams, opt_state=jtr.optimizer.init(jparams),
        ema_params=jax.tree.map(jnp.copy, jparams))
    H, C = FKW["grid_size"], jtr.render_cfg.cascades
    jitter = np.stack([rng.uniform(-1, 1, (H**3, 3)).astype(np.float32) * np.float32(min(2**c, BOUND) / H)
                       for c in range(C)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _Draws(jitter))
        jstate = jtr._update_grid_impl(jstate, full=True)
    return jtr, ptr, jstate, jtr.scene_to_device(scene)


def _draws(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, N_RAYS).astype(np.int32), rng.integers(0, 64 * 64, N_RAYS).astype(np.int32),
            rng.random(N_RAYS).astype(np.float32))


def _port_batch(draws):
    img, pix, noise = (torch.from_numpy(a) for a in draws)
    return {"img_idx": img, "pix_idx": pix, "noise": noise}


def _port_data():
    return _setup()[1].scene_to_device(PS.make_synthetic_scene(**_scene_args()))


def test_flat_step_loss_and_grads_match_jax():
    jtr, ptr, jstate, jdata = _setup()
    assert ptr.render_cfg.cascades == 3 and ptr.render_cfg.num_candidates == jtr.render_cfg.num_candidates
    draws = _draws(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", _IntDraws(draws[:2]))
        mp.setattr(jax.random, "uniform", _Draws([draws[2]]))
        (loss_j, aux_j), grads_j = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
            jstate.params, jstate.occ, jax.random.PRNGKey(0), jdata, None, True)
    state = train_state_from_jax(jstate, device="cpu")
    loss_p, aux_p = ptr._loss_fn(state.params, state.occ, _port_data(), _port_batch(draws), True,
                                 state.rng)
    assert set(aux_p) == set(aux_j)
    assert "samples_p99" in aux_p and "span_p99" not in aux_p  # the flat branch's statistics
    assert int(aux_p["num_samples"]) == int(aux_j["num_samples"]) > N_RAYS
    names = sorted(_leaves(state.params))
    leaves = dict(PTR._leaves(state.params))
    grads_p = torch.autograd.grad(loss_p, [leaves[n] for n in names])
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_j), rtol=1e-5)
    gj = _leaves(jax.tree.map(np.asarray, grads_j))
    for n, g in zip(names, grads_p):
        assert np.linalg.norm(gj[n]) > 0, n
        assert _rel_l2(g.numpy(), gj[n]) <= 1e-4, (n, _rel_l2(g.numpy(), gj[n]))


def test_flat_five_step_trajectory_and_retune_match_jax():
    """Five f32 steps (statistics on the last), then one retune of each
    package on its own last aux at iter_density 6: the same config (the
    budget and layout levers read samples_p99 and num_samples; the span
    lever sizes num_coarse, which the flat march does not read). A second
    retune on the exact global layout's aux, which carries no statistics,
    changes nothing in either."""
    jtr0, ptr0, jstate, jdata = _setup()
    jtr = JTR.Trainer(jtr0.nerf_cfg, jtr0.render_cfg, jtr0.cfg)
    ptr = PTR.Trainer(ptr0.nerf_cfg, ptr0.render_cfg, ptr0.cfg, device="cpu")
    state = train_state_from_jax(jstate, device="cpu")
    data = _port_data()
    losses_j, losses_p = [], []
    for step in range(5):
        draws = _draws(10 + step)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "randint", _IntDraws(draws[:2]))
            mp.setattr(jax.random, "uniform", _Draws(draws[2:]))
            jstate, aux_j = jtr._train_step_impl(jstate, jdata, with_stats=step == 4)
        state, aux_p = ptr.train_step(state, data, with_stats=step == 4, batch=_port_batch(draws))
        losses_j.append(float(aux_j["loss"]))
        losses_p.append(float(aux_p["loss"]))
        assert int(aux_p["num_samples"]) == int(aux_j["num_samples"])
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-4)
    assert state.step == int(jstate.step) == 5 and state.ema_count == int(jstate.ema_count) == 5
    for tree_p, tree_j in ((state.params, jstate.params), (state.ema_params, jstate.ema_params)):
        lp, lj = _leaves(tree_p), _leaves(jax.tree.map(np.asarray, tree_j))
        for n in lj:
            d = np.abs(lp[n] - lj[n])
            assert (d > 1e-5).mean() <= 1e-4 and d.max() <= 2 * TKW["lr"] * 5, (n, (d > 1e-5).sum())

    state = state._replace(occ=state.occ._replace(iter_density=torch.tensor(6, dtype=torch.int32)))
    jstate = jstate._replace(occ=jstate.occ._replace(iter_density=jnp.asarray(6, jnp.int32)))
    assert float(aux_p["samples_p99"]) == float(aux_j["samples_p99"])
    jtr._maybe_retune_march(jstate, aux_j)
    ptr._maybe_retune_march(state, aux_p)
    assert dataclasses.asdict(ptr.render_cfg) == dataclasses.asdict(jtr.render_cfg)
    assert dataclasses.asdict(ptr.eval_render_cfg) == dataclasses.asdict(jtr.eval_render_cfg)
    assert (ptr._march_retunes, ptr._budget_retunes, ptr._global_retunes) == \
        (jtr._march_retunes, jtr._budget_retunes, jtr._global_retunes)
    assert ptr._budget_p99_ema == pytest.approx(jtr._budget_p99_ema, rel=1e-6)
    # the exact global layout, as the layout lever engages it
    jtr.render_cfg = dataclasses.replace(jtr.render_cfg, compaction="global")
    ptr.render_cfg = cfg = dataclasses.replace(ptr.render_cfg, compaction="global")
    draws = _draws(20)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", _IntDraws(draws[:2]))
        mp.setattr(jax.random, "uniform", _Draws(draws[2:]))
        jstate, aux_j = jtr._train_step_impl(jstate, jdata, with_stats=True)
    state, aux_p = ptr.train_step(state, data, with_stats=True, batch=_port_batch(draws))
    assert set(aux_p) == set(aux_j) and not {"samples_p99", "global_fill"} & set(aux_p)
    assert int(aux_p["num_samples"]) == int(aux_j["num_samples"])
    np.testing.assert_allclose(float(aux_p["loss"]), float(aux_j["loss"]), rtol=1e-4)
    jtr._maybe_retune_march(jstate, aux_j)
    ptr._maybe_retune_march(state, aux_p)
    assert ptr.render_cfg == cfg and dataclasses.asdict(jtr.render_cfg) == dataclasses.asdict(cfg)


def test_flat_fit_render_and_evaluate_run():
    """fit on the refresh cadence with the retune, render_image and evaluate
    on the flat march; march="flat" keeps the retune off."""
    _, ptr, _, _ = _setup()
    scene = PS.make_synthetic_scene(num_views=2, H=24, W=24, num_steps=16)
    for march in ("hierarchical", "flat"):
        rc = dataclasses.replace(ptr.render_cfg, march=march)
        tr = PTR.Trainer(ptr.nerf_cfg, rc, PTR.TrainConfig(**dict(FTKW, iters=3, eval_chunk=1024)),
                         device="cpu")
        state = tr.init_state(density_grid=PR.mark_untrained_grid(scene.poses, scene.intrinsics, rc))
        state = tr.fit(state, scene, log_every=0)
        assert state.step == 3 and int(state.occ.iter_density) == 1
        res = tr.evaluate(state, scene)
        assert np.isfinite(res["PSNR"]) and np.isfinite(res["SSIM"])
        state = state._replace(occ=state.occ._replace(iter_density=torch.tensor(6, dtype=torch.int32)))
        tr._maybe_retune_march(state, {"num_samples": torch.tensor(100.0),
                                       "samples_p99": torch.tensor(3.0),
                                       "overflow_frac": torch.tensor(0.0),
                                       "samples_mean": torch.tensor(1.0)})
        assert (tr.render_cfg == rc) == (march == "flat")
