"""The dense renderer in training: the PyTorch port's trainer with
``renderer="dense"`` against the JAX package's (CPU): one step's loss and
gradients, a 5-step f32 trajectory, one CLIP guidance step (which renders
densely off the occgrid renderer in both packages), and fit / render /
evaluate.

Setup: ``test_torch_train.py``'s BENCH_SMOKE model (64^2 x 16-channel
wavelet triplane, random base and MLPs, zero detail levels, float32, bound
1.5) with 48 uniform + 24 importance samples per ray, 256 rays per step,
wavelet L1 0.4, on the synthetic scene at 2 views of 64^2. Parameters, the
batch's (view, pixel) indices, the depth jitter and the upsampling uniforms
are numpy-made and handed to both packages (``jax.random.randint`` /
``uniform`` are patched to return them in the JAX package's draw order:
indices, jitter, u).

Tolerances: one step's loss rtol 1e-5 and per-group gradients 1e-4
relative L2 (as test_torch_train.py); the 5-step trajectory's losses rtol
1e-4, parameters and EMA within 2 lr x 5 everywhere, and, as
test_torch_proposal.py states for the same reason (the inverse CDF carries
its knots' rounding to the new depths, so texel and wavelet gradients that
cancel to near 0 change sign more often and Adam moves such an entry by
~lr either way), at most 2% of a group's entries beyond 1e-5 (measured:
1.6% of the first wavelet level) and each group's total update within 5e-3
relative L2 (measured: 2.7e-3, the first wavelet level; the proposal
renderer's 32 final samples measured 1.4e-3, the dense renderer's 72 per ray
carry more such entries). The CLIP step, from one carried state: loss rtol
1e-5, its update as one step's (at most 2% of entries beyond 1e-5, 2e-3
relative L2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import DIMS, RKW, TKW, _Draws, _IntDraws, _leaves, _rel_l2, _scene
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.data import rays as JRY
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

N_RAYS, T_UNI, T_UP = 256, 48, 24
DRKW = dict(RKW, num_steps=T_UNI, upsample_steps=T_UP)
DTKW = dict(TKW, num_rays=N_RAYS, renderer="dense")


@functools.lru_cache(maxsize=None)
def _setup():
    kw = dict(bound=1.5, compute_dtype="float32", plane_dtype="float32")
    cj = JN.NeRFConfig(triplane=JT.TriplaneConfig(**DIMS), **kw)
    cp = PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS), **kw)
    jtr = JTR.Trainer(cj, JR.RenderConfig(**DRKW), JTR.TrainConfig(**DTKW))
    ptr = PTR.Trainer(cp, PR.RenderConfig(**DRKW), PTR.TrainConfig(**DTKW), device="cpu")
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
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtr.init_state()._replace(params=jparams, opt_state=jtr.optimizer.init(jparams),
                                       ema_params=jax.tree.map(jnp.copy, jparams))
    return jtr, ptr, jstate, jtr.scene_to_device(_scene())


def _draws(seed, n=N_RAYS):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, n).astype(np.int32), rng.integers(0, 64 * 64, n).astype(np.int32),
            rng.random((n, T_UNI)).astype(np.float32), rng.random((n, T_UP)).astype(np.float32))


def _port_batch(draws):
    img, pix, jit, u = (torch.from_numpy(a) for a in draws)
    return {"img_idx": img, "pix_idx": pix, "dense_jitter": jit, "dense_u": u}


def _port_data():
    return _setup()[1].scene_to_device(PS.make_synthetic_scene(num_views=2, H=64, W=64, num_steps=32))


def _check_update(tree_p, tree_j, start, rel):
    lp, lj = _leaves(tree_p), _leaves(jax.tree.map(np.asarray, tree_j))
    for n in lj:
        d = np.abs(lp[n] - lj[n])
        assert (d > 1e-5).mean() <= 2e-2 and d.max() <= 2 * TKW["lr"] * 5, (n, (d > 1e-5).mean())
        assert _rel_l2(lp[n] - start[n], lj[n] - start[n]) <= rel, (n, _rel_l2(lp[n] - start[n],
                                                                               lj[n] - start[n]))


def test_dense_loss_and_grads_match_jax():
    jtr, ptr, jstate, jdata = _setup()
    draws = _draws(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", _IntDraws(draws[:2]))
        mp.setattr(jax.random, "uniform", _Draws(draws[2:]))
        (loss_j, aux_j), grads_j = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
            jstate.params, jstate.occ, jax.random.PRNGKey(0), jdata, None, True)
    state = train_state_from_jax(jstate, device="cpu")
    loss_p, aux_p = ptr._loss_fn(state.params, state.occ, _port_data(), _port_batch(draws), True,
                                 state.rng)
    assert set(aux_p) == set(aux_j) == {"mse", "wavelet_reg"}  # the dense renderer has no statistics
    names = sorted(_leaves(state.params))
    leaves = dict(PTR._leaves(state.params))
    grads_p = torch.autograd.grad(loss_p, [leaves[n] for n in names])
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_j), rtol=1e-5)
    gj = _leaves(jax.tree.map(np.asarray, grads_j))
    for n, g in zip(names, grads_p):
        assert np.linalg.norm(gj[n]) > 0, n
        assert _rel_l2(g.numpy(), gj[n]) <= 1e-4, (n, _rel_l2(g.numpy(), gj[n]))


def test_dense_five_step_trajectory_and_clip_step_match_jax():
    jtr, ptr, jstate, jdata = _setup()
    state = train_state_from_jax(jstate, device="cpu")
    start = _leaves(jax.tree.map(np.asarray, jstate.params))
    data = _port_data()
    losses_j, losses_p = [], []
    for step in range(5):
        draws = _draws(10 + step)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "randint", _IntDraws(draws[:2]))
            mp.setattr(jax.random, "uniform", _Draws(draws[2:]))
            jstate, aux_j = jtr._train_step_impl(jstate, jdata, with_stats=True)
        state, aux_p = ptr.train_step(state, data, batch=_port_batch(draws))
        losses_j.append(float(aux_j["loss"]))
        losses_p.append(float(aux_p["loss"]))
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-4)
    assert state.step == int(jstate.step) == 5 and state.ema_count == int(jstate.ema_count) == 5
    for tree_p, tree_j in ((state.params, jstate.params), (state.ema_params, jstate.ema_params)):
        _check_update(tree_p, tree_j, start, rel=5e-3)

    # one CLIP step (a toy differentiable loss) on a random orbit pose
    jtr2 = JTR.Trainer(jtr.nerf_cfg, jtr.render_cfg, jtr.cfg)
    jtr2.set_clip_guidance(lambda img: jnp.mean((img - 0.3) ** 2), 1)
    ptr.set_clip_guidance(lambda img: ((img - 0.3) ** 2).mean(), 1)
    H, W = ptr.clip_hw
    assert (H, W) == jtr2.clip_hw == (16, 16)
    pose = PRY.rand_poses(np.random.default_rng(8), 1, radius=1.5)[0]
    np.testing.assert_array_equal(pose, JRY.rand_poses(np.random.default_rng(8), 1, radius=1.5)[0])
    f = 0.5 * W / np.tan(0.5 * np.radians(53.0))
    ro, rd = PRY.rays_full_image(pose, (f, f, W / 2, H / 2), H, W)
    _, _, jit, u = _draws(30, H * W)
    state = train_state_from_jax(jstate, device="cpu")
    before = _leaves(jax.tree.map(np.asarray, jstate.params))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _Draws([jit, u]))
        jstate, loss_j = jtr2._clip_step_impl(jstate, jnp.asarray(ro), jnp.asarray(rd))
    state, loss_p = ptr._clip_step(state, torch.from_numpy(ro), torch.from_numpy(rd),
                                   jitter=torch.from_numpy(jit), u=torch.from_numpy(u))
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-5)
    assert state.step == int(jstate.step) == 6
    _check_update(state.params, jstate.params, before, rel=2e-3)


def test_dense_fit_render_and_evaluate_run():
    """fit (no refresh, no retune), render_image and evaluate on the CPU,
    the draws from the state's generator; a CLIP-only fit (k = 0)."""
    _, ptr, _, _ = _setup()
    scene = PS.make_synthetic_scene(num_views=2, H=16, W=16, num_steps=16)
    tr = PTR.Trainer(ptr.nerf_cfg, ptr.render_cfg, PTR.TrainConfig(**dict(DTKW, iters=3, eval_chunk=1024)),
                     device="cpu")
    state = tr.fit(tr.init_state(), scene, log_every=0)
    assert state.step == 3 and int(state.occ.iter_density) == 0 and state.ema_count == 3
    assert all(np.isfinite(v).all() for v in _leaves(state.params).values())
    img, dep = tr.render_image(state.ema_params, state.occ, scene.poses[0], scene.intrinsics, 16, 16)
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all() and torch.isfinite(dep).all()
    res = tr.evaluate(state, scene)
    assert np.isfinite(res["PSNR"]) and np.isfinite(res["SSIM"]) and len(res["per_image"]) == 2
    tr.set_clip_guidance(lambda im: (im - 0.5).square().mean(), 0)
    seen = []
    state = tr.fit(state, scene, log_every=0, callback=lambda s, a: seen.append("clip_loss" in a))
    assert state.step == 6 and seen == [True] * 3
