"""The autotune slice of the trainer against the JAX package (CPU): the
retune's levers on the same statistics, the global layout's trajectory,
error-map sampling and its EMA, pregenerated-ray scenes, random
backgrounds, CLIP guidance steps, and ``fit`` with all of them.

Setup and tolerances as ``test_torch_train.py`` (whose shapes, state and
draw helpers these tests share): parameters, jitter, (view, pixel) indices,
uniforms and noise made with numpy and handed to both packages; one f32
loss within rtol 1e-5; trajectories as that file states.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import (DIMS, N_RAYS, RKW, TKW, _batch, _Draws, _IntDraws,
                                    _leaves, _port_batch, _scene, _setup)
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.data import rays as JRY
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu.train import trainer as JTR
from trinerflet_tpu_torch.carry import train_state_from_jax
from trinerflet_tpu_torch.data import rays as PRY
from trinerflet_tpu_torch.data import synthetic as PS
from trinerflet_tpu_torch.data.rays import rays_full_image
from trinerflet_tpu_torch.render import renderer as PR
from trinerflet_tpu_torch.train import trainer as PTR


RETUNE_AUX = [
    # span shrinks (span-p99 rule); the buffer engages at 6 slots (mean 3)
    dict(num_samples=3.0, samples_p99=30.0, overflow_frac=0.3, trunc_T=0.0, samples_mean=14.0,
         span_p99=0.5, span_trunc_T=0.0, needed_seg_p99=30.0),
    # truncated rays go transmissive: the span grows back; the buffer fills: x2
    dict(num_samples=5.2, global_fill=0.9, samples_p99=30.0, overflow_frac=0.3, trunc_T=0.0,
         samples_mean=14.0, span_p99=0.5, span_trunc_T=0.5, needed_seg_p99=30.0),
    # demand falls: B shrinks to 8; the buffer fills again at >= B: per-ray
    dict(num_samples=4.0, global_fill=0.95, samples_p99=4.0, overflow_frac=0.0, trunc_T=0.0,
         samples_mean=4.0, span_p99=0.5, span_trunc_T=0.0, needed_seg_p99=4.0),
    # capped rays transmissive and overflowing: B grows x2 (twice), then shrinks
    dict(num_samples=2.0, samples_p99=30.0, overflow_frac=0.5, trunc_T=0.5, samples_mean=14.0,
         span_p99=0.5, span_trunc_T=0.0, needed_seg_p99=4.0),
    dict(num_samples=2.0, samples_p99=30.0, overflow_frac=0.5, trunc_T=0.5, samples_mean=14.0,
         span_p99=0.5, span_trunc_T=0.0, needed_seg_p99=4.0),
    dict(num_samples=2.0, samples_p99=4.0, overflow_frac=0.0, trunc_T=0.0, samples_mean=3.0,
         span_p99=0.2, span_trunc_T=0.0, needed_seg_p99=2.0),
    dict(num_samples=2.0, samples_p99=4.0, overflow_frac=0.0, trunc_T=0.0, samples_mean=3.0,
         span_p99=0.2, span_trunc_T=0.0, needed_seg_p99=2.0),
]


def _shape_fields(cfg):
    return (cfg.samples_per_ray_budget, cfg.num_coarse_override, cfg.compaction,
            cfg.global_slots_per_ray)


def test_retune_levers_match_jax():
    """The whole retune on the same aux sequence in both trainers: after each
    call the train config's shapes and the eval config are EQUAL; the
    sequence drives every branch (span shrink and grow-back, budget shrink
    and grow, global engage, doubling and fall-back, the retune caps)."""
    kw = dict(TKW, budget_autotune=True)
    _, ptr0, _, _ = _setup("float32")
    jtr = JTR.Trainer(JN.NeRFConfig(triplane=JT.TriplaneConfig(**DIMS), bound=1.5),
                      JR.RenderConfig(**RKW), JTR.TrainConfig(**kw))
    ptr = PTR.Trainer(ptr0.nerf_cfg, PR.RenderConfig(**RKW), PTR.TrainConfig(**kw), device="cpu")
    bbox = np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)

    def states(iter_density):
        j = types.SimpleNamespace(occ=types.SimpleNamespace(iter_density=np.int32(iter_density),
                                                            bbox=jnp.asarray(bbox)))
        p = types.SimpleNamespace(occ=types.SimpleNamespace(
            iter_density=torch.tensor(iter_density, dtype=torch.int32), bbox=torch.from_numpy(bbox)))
        return j, p

    js, ps = states(5)  # the occupancy has not settled: nothing moves
    jtr._maybe_retune_march(js, {k: v * N_RAYS if k == "num_samples" else v
                                 for k, v in RETUNE_AUX[0].items()})
    ptr._maybe_retune_march(ps, {k: v * N_RAYS if k == "num_samples" else v
                                 for k, v in RETUNE_AUX[0].items()})
    assert _shape_fields(ptr.render_cfg) == _shape_fields(jtr.render_cfg) == (20, 0, "per_ray", 0)
    js, ps = states(6)
    seen = []
    for a in RETUNE_AUX + [None]:
        aux = None if a is None else {k: v * N_RAYS if k == "num_samples" else v for k, v in a.items()}
        jtr._maybe_retune_march(js, aux)
        ptr._maybe_retune_march(ps, aux)
        assert _shape_fields(ptr.render_cfg) == _shape_fields(jtr.render_cfg), a
        assert dataclasses.asdict(ptr.eval_render_cfg) == dataclasses.asdict(jtr.eval_render_cfg)
        seen.append(_shape_fields(ptr.render_cfg))
    budgets = [s[0] for s in seen]
    assert min(budgets) < 20 and any(b > a for a, b in zip(budgets, budgets[1:]))  # shrink, grow
    assert ("global", 6) in [s[2:] for s in seen] and ("global", 12) in [s[2:] for s in seen]
    assert seen[2][2] == "per_ray" and seen[-1][2] == "per_ray"  # fell back, never re-engaged
    assert 8 in [s[1] for s in seen] and seen[1][1] == 16  # span shrank, grew back
    assert (ptr._budget_retunes, ptr._global_retunes) == (jtr._budget_retunes, jtr._global_retunes)
    assert ptr._budget_retunes == 4  # capped
    assert ptr.eval_render_cfg.compaction == "per_ray"
    assert PTR.global_slots_for(3.0) == 6 and PTR.global_slots_for(0.5) == 4


def _global_trainers(slots):
    jtr0, ptr0, jstate, jdata = _setup("float32")
    jtr = JTR.Trainer(jtr0.nerf_cfg, dataclasses.replace(
        jtr0.render_cfg, compaction="global", global_slots_per_ray=slots), jtr0.cfg)
    ptr = PTR.Trainer(ptr0.nerf_cfg, dataclasses.replace(
        ptr0.render_cfg, compaction="global", global_slots_per_ray=slots), ptr0.cfg, device="cpu")
    return jtr, ptr, jstate, jdata


def test_five_step_trajectory_global_layout_matches_jax():
    """Five f32 steps on the global layout (4 slots per ray: the buffer
    fills and drops its tail) with injected batches: the same tolerances as
    the per-ray trajectory, loss within 1e-4; the buffer's kept counts and
    use EQUAL at every step. (At 8 slots the JAX compositor's global cumsum
    is twice as long, and its error, through Adam's first steps, moves 0.2%
    of the base coefficients by up to 6.5e-5: the reference's error, see
    tests/test_torch_compact.py.)"""
    jtr, ptr, jstate, jdata = _global_trainers(4)
    state = train_state_from_jax(jstate, device="cpu")
    data = ptr.scene_to_device(PS.make_synthetic_scene(num_views=2, H=64, W=64, num_steps=32))
    losses_j, losses_p = [], []
    for step in range(5):
        draws = _batch(20 + step, 2, 64 * 64)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "randint", _IntDraws(draws[:2]))
            mp.setattr(jax.random, "uniform", _Draws(draws[2:]))
            jstate, aux_j = jtr._train_step_impl(jstate, jdata, with_stats=step == 4)
        state, aux_p = ptr.train_step(state, data, with_stats=step == 4, batch=_port_batch(draws))
        assert int(aux_p["num_samples"]) == int(aux_j["num_samples"]) > N_RAYS
        assert float(aux_p["global_fill"]) == float(aux_j["global_fill"])
        losses_j.append(float(aux_j["loss"]))
        losses_p.append(float(aux_p["loss"]))
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-4)
    for tree_p, tree_j in ((state.params, jstate.params), (state.ema_params, jstate.ema_params)):
        lp, lj = _leaves(tree_p), _leaves(jax.tree.map(np.asarray, tree_j))
        for n in lj:
            d = np.abs(lp[n] - lj[n])
            assert (d > 1e-5).mean() <= 1e-4 and d.max() <= 2 * TKW["lr"] * 5, (n, (d > 1e-5).sum())


def test_error_map_sampler_matches_jax():
    """The same uniforms give the same cells, pixels and rays: a 40x40 map
    on 48x40 images (non-integer cell size 1.2), integer weights (so both
    CDFs are exact) with empty cells."""
    V, H, W = 3, 48, 40
    rng = np.random.default_rng(13)
    images = rng.random((V, H, W, 4)).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * V)
    poses[:, :3, 3] = rng.standard_normal((V, 3))
    intr = (40.0, 40.0, 20.0, 24.0)
    emap = rng.integers(0, 6, (V, 40 * 40)).astype(np.float32)
    img = rng.integers(0, V, N_RAYS).astype(np.int32)
    u, jx, jy = (rng.random(N_RAYS).astype(np.float32) for _ in range(3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", _IntDraws([img]))
        mp.setattr(jax.random, "uniform", _Draws([u, jx, jy]))
        jo, jd, jp, (ji, jc) = JRY.sample_ray_batch_error_map(
            jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(poses), intr, N_RAYS,
            jnp.asarray(emap))
    po, pd, pp, (pi, pc) = PRY.sample_ray_batch_error_map(
        torch.from_numpy(images), torch.from_numpy(poses), intr, N_RAYS, torch.from_numpy(emap),
        img_idx=torch.from_numpy(img), u=torch.from_numpy(u), jx=torch.from_numpy(jx),
        jy=torch.from_numpy(jy))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    assert (emap.reshape(-1)[img * 1600 + pc.numpy()] > 0).all()  # empty cells never drawn


def test_error_map_step_matches_jax():
    """One f32 loss with error-map sampling (the step's map: ones, as fit
    starts it, then twice as heavy on view 1) and the map's EMA update
    0.1 old + 0.9 err: loss rtol 1e-5, map atol 1e-6."""
    jtr0, ptr0, jstate, jdata = _setup("float32")
    kw = dict(TKW, error_map=True)
    jtr = JTR.Trainer(jtr0.nerf_cfg, jtr0.render_cfg, JTR.TrainConfig(**kw))
    ptr = PTR.Trainer(ptr0.nerf_cfg, ptr0.render_cfg, PTR.TrainConfig(**kw), device="cpu")
    emap = np.ones((2, 64 * 64), np.float32)
    emap[1] = 2.0
    rng = np.random.default_rng(14)
    img = rng.integers(0, 2, N_RAYS).astype(np.int32)
    u, jx, jy, noise = (rng.random(N_RAYS).astype(np.float32) for _ in range(4))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", _IntDraws([img]))
        mp.setattr(jax.random, "uniform", _Draws([u, jx, jy, noise]))
        loss_j, aux_j = jtr._loss_fn(jstate.params, jstate.occ, jax.random.PRNGKey(0), jdata,
                                     jnp.asarray(emap), True)
    state = train_state_from_jax(jstate, device="cpu")
    data = ptr.scene_to_device(PS.make_synthetic_scene(num_views=2, H=64, W=64, num_steps=32))
    batch = {k: torch.from_numpy(v) for k, v in
             dict(img_idx=img, u=u, jx=jx, jy=jy, noise=noise).items()}
    loss_p, aux_p = ptr._loss_fn(state.params, state.occ, data, batch, True, state.rng,
                                 torch.from_numpy(emap))
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_j), rtol=1e-5)
    new_j, new_p = np.asarray(aux_j["_new_error_map"]), aux_p["_new_error_map"].numpy()
    assert (new_j != emap).sum() > N_RAYS // 2
    np.testing.assert_allclose(new_p, new_j, rtol=0, atol=1e-6)


def test_pregenerated_ray_batches_match_jax():
    """A scene of pregenerated per-view ray grids (the LLFF/NDC path): one
    f32 loss and its sample count, with injected (view, pixel) draws."""
    jtr, ptr, jstate, _ = _setup("float32")
    sc = _scene()
    grids = [rays_full_image(p, sc.intrinsics, sc.H, sc.W) for p in sc.poses]
    scene = types.SimpleNamespace(
        images=sc.images, H=sc.H, W=sc.W, num_views=2,
        rays_o=np.stack([g[0].reshape(sc.H, sc.W, 3) for g in grids]),
        rays_d=np.stack([g[1].reshape(sc.H, sc.W, 3) for g in grids]))
    draws = _batch(30, 2, 64 * 64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", _IntDraws(draws[:2]))
        mp.setattr(jax.random, "uniform", _Draws(draws[2:]))
        loss_j, aux_j = jtr._loss_fn(jstate.params, jstate.occ, jax.random.PRNGKey(0),
                                     jtr.scene_to_device(scene), None, True)
    state = train_state_from_jax(jstate, device="cpu")
    data = ptr.scene_to_device(scene)
    assert set(data) == {"images", "rays_o", "rays_d"}
    loss_p, aux_p = ptr._loss_fn(state.params, state.occ, data, _port_batch(draws), True, state.rng)
    assert int(aux_p["num_samples"]) == int(aux_j["num_samples"]) > N_RAYS
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_j), rtol=1e-5)


def test_random_background_loss_matches_jax():
    """``train_rand_bg``: the (N, 3) background draw composites the RGBA
    ground truth and the render alike; loss rtol 1e-5."""
    jtr0, ptr0, jstate, jdata = _setup("float32")
    kw = dict(TKW, train_rand_bg=True)
    jtr = JTR.Trainer(jtr0.nerf_cfg, jtr0.render_cfg, JTR.TrainConfig(**kw))
    ptr = PTR.Trainer(ptr0.nerf_cfg, ptr0.render_cfg, PTR.TrainConfig(**kw), device="cpu")
    img, pix, noise = _batch(31, 2, 64 * 64)
    bg = np.random.default_rng(32).random((N_RAYS, 3)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", _IntDraws([img, pix]))
        mp.setattr(jax.random, "uniform", _Draws([bg, noise]))
        loss_j, _ = jtr._loss_fn(jstate.params, jstate.occ, jax.random.PRNGKey(0), jdata, None, True)
    state = train_state_from_jax(jstate, device="cpu")
    data = ptr.scene_to_device(_scene())
    batch = dict(_port_batch((img, pix, noise)), bg=torch.from_numpy(bg))
    loss_p, _ = ptr._loss_fn(state.params, state.occ, data, batch, True, state.rng)
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_j), rtol=1e-5)
    loss_0, _ = ptr0._loss_fn(state.params, state.occ, data, _port_batch((img, pix, noise)), True,
                              state.rng)
    assert abs(float(loss_0.detach()) - float(loss_p.detach())) > 1e-4  # the background mattered


def test_clip_step_matches_jax():
    """One CLIP guidance step with a tiny differentiable loss (the mean
    squared distance of the render to grey 0.3): the same random orbit pose
    (host numpy), the same rays and noise; loss rtol 1e-5, then parameters
    and EMA as in the 5-step trajectory."""
    jtr0, ptr0, jstate, _ = _setup("float32")
    jtr = JTR.Trainer(jtr0.nerf_cfg, jtr0.render_cfg, jtr0.cfg)
    ptr = PTR.Trainer(ptr0.nerf_cfg, ptr0.render_cfg, ptr0.cfg, device="cpu")
    jtr.set_clip_guidance(lambda img: jnp.mean((img - 0.3) ** 2), 1)
    ptr.set_clip_guidance(lambda img: ((img - 0.3) ** 2).mean(), 1)
    assert ptr.clip_hw == jtr.clip_hw == (22, 22) and ptr.clip_radius == jtr.clip_radius
    pose_j = JRY.rand_poses(np.random.default_rng(8), 3, radius=1.5)
    pose_p = PRY.rand_poses(np.random.default_rng(8), 3, radius=1.5)
    np.testing.assert_array_equal(pose_p, pose_j)
    H, W = ptr.clip_hw
    f = 0.5 * W / np.tan(0.5 * np.radians(53.0))
    ro, rd = rays_full_image(pose_p[1], (f, f, W / 2, H / 2), H, W)
    noise = np.random.default_rng(9).random(H * W).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _Draws([noise]))
        jstate2, loss_j = jtr._clip_step_impl(jstate, jnp.asarray(ro), jnp.asarray(rd))
    state = train_state_from_jax(jstate, device="cpu")
    state, loss_p = ptr._clip_step(state, torch.from_numpy(ro), torch.from_numpy(rd),
                                   torch.from_numpy(noise))
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-5)
    assert state.step == int(jstate2.step) and state.opt_state["count"] == 1
    for tree_p, tree_j in ((state.params, jstate2.params), (state.ema_params, jstate2.ema_params)):
        lp, lj = _leaves(tree_p), _leaves(jax.tree.map(np.asarray, tree_j))
        for n in lj:
            d = np.abs(lp[n] - lj[n])
            assert (d > 1e-5).mean() <= 1e-4 and d.max() <= 2 * TKW["lr"], (n, (d > 1e-5).sum())


@pytest.mark.parametrize("k", [1, 0])
def test_fit_with_budget_autotune_and_the_options(k):
    """fit with the autotuner on (refresh every 2 steps, so the retune reads
    statistics from step 11 on), error-map sampling, random backgrounds and
    CLIP guidance: k = 1, one CLIP step after every supervised one (it
    trains, the levers read their statistics, the error map moves, the steps
    add up); k = 0, CLIP steps only (no supervised step: the map stays at
    ones and the retune gets no statistics)."""
    _, ptr, _, _ = _setup("float32")
    scene = PS.make_synthetic_scene(num_views=2, H=32, W=32, num_steps=16)
    cfg = PTR.TrainConfig(**dict(TKW, iters=16, update_extra_interval=2, budget_autotune=True,
                                 error_map=True, train_rand_bg=True))
    tr = PTR.Trainer(ptr.nerf_cfg, ptr.render_cfg, cfg, device="cpu")
    tr.set_clip_guidance(lambda img: ((img - 0.5) ** 2).mean(), k)
    state = tr.init_state(density_grid=PR.mark_untrained_grid(scene.poses, scene.intrinsics, tr.render_cfg))
    seen = []
    state = tr.fit(state, scene, log_every=0, callback=lambda s, a: seen.append(float(a["loss"])))
    steps = 16 + 8 if k else 16
    assert state.step == steps and state.ema_count == steps and len(seen) == 16
    assert np.isfinite(seen).all()
    assert state.error_map.shape == (2, 32 * 32) and bool((state.error_map != 1).any()) == bool(k)
    assert (tr._budget_p99_ema is not None and tr._span_p99_ema is not None) == bool(k)
    assert all(np.isfinite(v).all() for v in _leaves(state.params).values())
