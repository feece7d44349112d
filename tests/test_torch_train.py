"""The training slice: the PyTorch port's trainer against the JAX package (CPU).

Setup: ``bench.py``'s BENCH_SMOKE shapes -- a 64^2 x 16-channel bior6.8
wavelet triplane (2 IDWT levels, detail levels zero as at initialisation),
bound 1.5, a 32^3 grid with 2 cascades, max_steps 128, 20 samples per ray,
512 rays per step, wavelet L1 0.4, ``budget_autotune=False`` -- on the
synthetic scene at 2 views of 64^2. Parameters, density-grid jitter, the
batch's (view, pixel) indices and the ray noise are made with numpy and
handed to both packages (``jax.random.uniform`` / ``randint`` are patched to
return them), so no RNG stream is compared.

Tolerances, stated per comparison:
* the march is identical, so sample counts are EQUAL;
* one float32 step's loss: rtol 1e-5 (the field sums in another order);
  its gradient per parameter group: relative L2 error 1e-4 (the bf16
  gradients of each op are held in ``test_torch_grads.py``);
* the 5-step float32 trajectory (Adam with eps 1e-15, the schedule, the
  EMA): loss rtol 1e-4 per step; parameters and EMA within 1e-5 except at
  most 0.01% of the entries of a group. Adam's first steps move every
  parameter by about lr whatever its gradient's size, so a gradient within
  rounding of zero may step the other way: such an entry differs by up to
  2 lr per step (measured: 1 of 147,456 coefficients, by 0.0046).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trinerflet_tpu.data import rays as JRY
from trinerflet_tpu.data import synthetic as JS
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu.train import trainer as JTR
from trinerflet_tpu_torch.carry import train_state_from_jax
from trinerflet_tpu_torch.data import rays as PRY
from trinerflet_tpu_torch.data import synthetic as PS
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.models import triplane as PT
from trinerflet_tpu_torch.render import renderer as PR
from trinerflet_tpu_torch.train import trainer as PTR

N_RAYS = 512


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread for the module (the files that import this
    fixture share it). The suite runs several workers at once, and torch's
    default of a thread per core oversubscribes the machine: a port-only
    ``fit`` that takes 20 s alone took 524 s among six workers; on one
    thread it takes 30 s alone. The arithmetic is elementwise or summed
    with the same tolerance either way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIMS = dict(channels=16, resolution=64, wavelet_scale=4)
RKW = dict(bound=1.5, grid_size=32, density_thresh=10.0, max_steps=128,
           samples_per_ray_budget=20, dt_gamma=0.0)
TKW = dict(lr=1e-2, iters=10000, num_rays=N_RAYS, wavelet_regularization=0.4,
           update_extra_interval=16, budget_autotune=False)


class _Draws:
    """Stands in for jax.random.uniform: hands out numpy arrays in order."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape)
        return jnp.asarray(a, dtype)


class _IntDraws(_Draws):
    """Stands in for jax.random.randint."""

    def __call__(self, key, shape, minval, maxval, dtype=jnp.int32):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape) and a.min() >= minval and a.max() < maxval
        return jnp.asarray(a, dtype)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach().cpu() if torch.is_tensor(v) else v, np.float32)
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch(seed, V, HW):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, N_RAYS).astype(np.int32), rng.integers(0, HW, N_RAYS).astype(np.int32),
            rng.random(N_RAYS).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _scene():
    return JS.make_synthetic_scene(num_views=2, H=64, W=64, num_steps=32)


@functools.lru_cache(maxsize=None)
def _setup(dtype):
    """Both trainers and a JAX state after one full refresh (injected jitter),
    with numpy-made params: random base and MLPs, zero detail levels."""
    kw = dict(bound=1.5, compute_dtype=dtype, plane_dtype=dtype)
    cj = JN.NeRFConfig(triplane=JT.TriplaneConfig(**DIMS), **kw)
    cp = PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS), **kw)
    jtr = JTR.Trainer(cj, JR.RenderConfig(**RKW), JTR.TrainConfig(**TKW))
    ptr = PTR.Trainer(cp, PR.RenderConfig(**RKW), PTR.TrainConfig(**TKW), device="cpu")
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


def _jax_loss_and_grads(jtr, jstate, jdata, draws):
    img, pix, noise = draws
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", _IntDraws([img, pix]))
        mp.setattr(jax.random, "uniform", _Draws([noise]))
        (loss, aux), grads = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
            jstate.params, jstate.occ, jax.random.PRNGKey(0), jdata, None, True)
    return loss, aux, grads


def _port_batch(draws):
    img, pix, noise = (torch.from_numpy(a) for a in draws)
    return {"img_idx": img, "pix_idx": pix, "noise": noise}


def test_synthetic_scene_and_ray_batch_match_jax():
    js = JS.make_synthetic_scene(num_views=3, H=16, W=12, num_steps=16, seed=3)
    ps = PS.make_synthetic_scene(num_views=3, H=16, W=12, num_steps=16, seed=3)
    np.testing.assert_array_equal(ps.poses, js.poses)
    np.testing.assert_array_equal(ps.images, js.images)
    assert ps.intrinsics == js.intrinsics and (ps.H, ps.W, ps.num_views) == (16, 12, 3)
    img, pix, _ = _batch(5, 3, 16 * 12)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", _IntDraws([img, pix]))
        jout = JRY.sample_ray_batch(jax.random.PRNGKey(0), jnp.asarray(js.images), jnp.asarray(js.poses),
                                    js.intrinsics, N_RAYS)
    pout = PRY.sample_ray_batch(torch.from_numpy(ps.images), torch.from_numpy(ps.poses), ps.intrinsics,
                                N_RAYS, img_idx=torch.from_numpy(img), pix_idx=torch.from_numpy(pix))
    for a, b in zip(pout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("warmup", [0, 50])
def test_lr_schedule_matches_jax(warmup):
    jc = JTR.TrainConfig(lr=1e-2, iters=1000, warmup_steps=warmup)
    pc = PTR.TrainConfig(lr=1e-2, iters=1000, warmup_steps=warmup)
    jf, pf = JTR.lr_schedule(jc), PTR.lr_schedule(pc)
    for s in (0, 1, 7, 49, 50, 51, 400, 999, 1000, 1200):
        np.testing.assert_allclose(pf(s), float(jf(s)), rtol=1e-6)


def test_train_step_loss_and_grads_match_jax():
    jtr, ptr, jstate, jdata = _setup("float32")
    draws = _batch(1, 2, 64 * 64)
    loss_j, aux_j, grads_j = _jax_loss_and_grads(jtr, jstate, jdata, draws)
    state = train_state_from_jax(jstate, device="cpu")
    data = ptr.scene_to_device(PS.make_synthetic_scene(num_views=2, H=64, W=64, num_steps=32))
    loss_p, aux_p = ptr._loss_fn(state.params, state.occ, data, _port_batch(draws), True, state.rng)
    names = sorted(_leaves(state.params))
    leaves = dict(PTR._leaves(state.params))
    grads_p = torch.autograd.grad(loss_p, [leaves[n] for n in names])
    assert int(aux_p["num_samples"]) == int(aux_j["num_samples"]) > N_RAYS
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(aux_p["wavelet_reg"].detach()), float(aux_j["wavelet_reg"]),
                               rtol=1e-6)
    gj = _leaves(jax.tree.map(np.asarray, grads_j))
    for n, g in zip(names, grads_p):
        assert np.linalg.norm(gj[n]) > 0, n
        assert _rel_l2(g.numpy(), gj[n]) <= 1e-4, (n, _rel_l2(g.numpy(), gj[n]))


def test_five_step_trajectory_matches_jax():
    """Adam (eps 1e-15) with the schedule and the EMA over five f32 steps on
    injected batches; the zero detail levels move at step 1 in both."""
    jtr, ptr, jstate, jdata = _setup("float32")
    state = train_state_from_jax(jstate, device="cpu")
    data = ptr.scene_to_device(PS.make_synthetic_scene(num_views=2, H=64, W=64, num_steps=32))
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
    assert state.opt_state["count"] == 5
    for tree_p, tree_j in ((state.params, jstate.params), (state.ema_params, jstate.ema_params)):
        lp, lj = _leaves(tree_p), _leaves(jax.tree.map(np.asarray, tree_j))
        for n in lj:
            d = np.abs(lp[n] - lj[n])
            assert (d > 1e-5).mean() <= 1e-4 and d.max() <= 2 * TKW["lr"] * 5, (n, (d > 1e-5).sum())
    level = _leaves(state.params)["encoder.wavelets.level_1"]
    assert (level != 0).mean() > 0.9  # the sign convention of |x| at 0 moved them


def test_fit_runs_the_cadence_and_rejects_slice3_options():
    """fit on the cadence. What earlier slices rejected trains now (each has
    its own tests: the slice-3 options below and in
    tests/test_torch_train_options.py, the dense renderer and the flat
    march in tests/test_torch_dense*.py and tests/test_torch_flat*.py): the
    dense renderer builds, and the flat march's exact global compaction
    (slots 0) takes a step with the JAX package's aux (no statistics)."""
    jtr, ptr, jstate, _ = _setup("float32")
    scene = PS.make_synthetic_scene(num_views=2, H=32, W=32, num_steps=16)
    tr = PTR.Trainer(ptr.nerf_cfg, ptr.render_cfg, PTR.TrainConfig(**dict(TKW, iters=3)), device="cpu")
    state = tr.init_state(density_grid=PR.mark_untrained_grid(scene.poses, scene.intrinsics, tr.render_cfg))
    state = tr.fit(state, scene, log_every=0)
    assert state.step == 3 and int(state.occ.iter_density) == 1 and state.ema_count == 3
    assert all(np.isfinite(v).all() for v in _leaves(state.params).values())
    dense = PTR.Trainer(ptr.nerf_cfg, ptr.render_cfg, PTR.TrainConfig(**dict(TKW, renderer="dense")),
                        device="cpu")
    assert dense.cfg.renderer == "dense"
    flat = PTR.Trainer(ptr.nerf_cfg, dataclasses.replace(ptr.render_cfg, compaction="global"),
                       PTR.TrainConfig(**TKW), device="cpu")
    state, aux = flat.train_step(state, tr.scene_to_device(scene))
    assert state.step == 4 and np.isfinite(float(aux["loss"])) and int(aux["num_samples"]) > 0
    assert not {"samples_p99", "overflow_frac", "global_fill", "span_p99"} & set(aux)


def test_march_retune_and_grow_params_match_jax():
    jtr, ptr, jstate, _ = _setup("float32")
    bbox = np.array([-0.6, -0.5, -0.55, 0.62, 0.5, 0.58], np.float32)
    for cfg in (dict(RKW), dict(RKW, num_coarse_override=16), dict(RKW, max_steps=1024)):
        assert PR.tuned_num_coarse(PR.RenderConfig(**cfg), bbox) == \
            JR.tuned_num_coarse(JR.RenderConfig(**cfg), bbox)
    state = train_state_from_jax(jstate, device="cpu")
    state = state._replace(occ=state.occ._replace(iter_density=torch.tensor(6, dtype=torch.int32)))
    jstate6 = jstate._replace(occ=jstate.occ._replace(iter_density=jnp.asarray(6, jnp.int32)))
    jtr._maybe_retune_march(jstate6, None)
    ptr._maybe_retune_march(state)
    assert ptr.render_cfg.num_coarse_override == jtr.render_cfg.num_coarse_override
    assert ptr.eval_render_cfg.num_coarse_override == jtr.eval_render_cfg.num_coarse_override

    old_c = dict(channels=4, resolution=64, wavelet_scale=4)
    new_c = dict(channels=4, resolution=128, wavelet_scale=8)
    old = PT.init_triplane_params(PT.TriplaneConfig(**old_c), torch.Generator().manual_seed(0), "cpu")
    grown = PT.grow_params(old, PT.TriplaneConfig(**old_c), PT.TriplaneConfig(**new_c),
                           torch.Generator().manual_seed(1), "cpu")
    jold = jax.tree.map(lambda t: jnp.asarray(t.numpy()), old)
    jgrown = JT.grow_params(jold, JT.TriplaneConfig(**old_c), JT.TriplaneConfig(**new_c),
                            jax.random.PRNGKey(1))
    assert jax.tree.map(np.shape, jgrown) == {"base": tuple(grown["base"].shape), "wavelets": {
        k: tuple(v.shape) for k, v in grown["wavelets"].items()}}
    for k, v in grown["wavelets"].items():  # levels that kept their shape carried over
        if k in old["wavelets"] and old["wavelets"][k].shape == v.shape:
            assert torch.equal(v, old["wavelets"][k])

