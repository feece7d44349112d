"""The proposal renderer of the PyTorch port against the JAX package (CPU):
``sample_pdf``, ``render_proposal``'s outputs and ``interlevel_loss`` on
analytic fields, then the trainer's ``renderer="proposal"`` step and a
5-step trajectory on ``test_torch_train.py``'s model and scene.

Parameters, the batch's (view, pixel) indices, the ladder jitter and the
final-level uniforms are made with numpy and handed to both packages
(``jax.random.uniform`` / ``randint`` are patched to return them in the
JAX package's draw order: indices, jitter, uniforms).

Tolerances, stated per comparison:
* ``sample_pdf``: 1e-6 absolute, plus what a CDF knot's rounding (the
  cumsums sum in other orders) carries over a steep bin, as the test states;
* ``render_proposal`` on analytic fields: 1e-5 absolute on every output (exp
  and the cumsums round apart; a final sample that lands on a proposal bin
  edge moves by rounding only, since the inverse CDF is continuous);
  ``interlevel_loss``: rtol 1e-4 (its deficits are differences of nearly
  equal weights);
* the trainer: as ``test_torch_train.py`` -- one f32 step's loss rtol 1e-5
  and per-group gradients within 1e-4 relative L2; the 5-step trajectory's
  losses rtol 1e-4 and parameters and EMA within 2 lr x 5 everywhere. Per
  entry the proposal path is held looser than that file's 0.01% beyond
  1e-5: the proposal weights round apart by up to 9e-8 (exp, the cumprod
  and the cumsums sum in other orders), and the inverse CDF carries that
  over steep bins to the final sample positions (up to 1e-5 in t; 209 of
  4,096 beyond 1e-6 in one step, measured), where the occgrid march is bit
  for bit. Texel and wavelet gradients that cancel to near 0 then change
  sign more often, and Adam moves such an entry by ~lr either way. So at
  most 2% of a group's entries may differ by more than 1e-5 (measured:
  1.1% of the first wavelet level), and each group's total update must
  agree within 2e-3 relative L2 (measured: 1.4e-3 at most).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import DIMS, RKW, TKW, _Draws, _IntDraws, _leaves, _rel_l2, _scene
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.ops import raymarch as JRM
from trinerflet_tpu.render import proposal as JP
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu.train import trainer as JTR
from trinerflet_tpu_torch.carry import params_from_jax, train_state_from_jax
from trinerflet_tpu_torch.data import synthetic as PS
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.models import triplane as PT
from trinerflet_tpu_torch.ops import raymarch as PRM
from trinerflet_tpu_torch.render import proposal as PP
from trinerflet_tpu_torch.render import renderer as PR
from trinerflet_tpu_torch.train import trainer as PTR

N_RAYS, P, F = 256, 32, 16
PTKW = dict(TKW, num_rays=N_RAYS, renderer="proposal", proposal_samples=P, proposal_final=F)


def test_sample_pdf_matches_jax():
    rng = np.random.default_rng(0)
    B, T, S = 300, 33, 24
    bins = np.sort(rng.uniform(0.2, 3.0, (B, T)), axis=1).astype(np.float32)
    w = rng.uniform(0, 1, (B, T - 1)).astype(np.float32) ** 4
    w[:20] = 0.0  # empty rays: the 1e-5 floor makes them uniform
    w[20:40, 5:] = 0.0  # mass in the first bins only
    u = rng.uniform(0, 1, (B, S)).astype(np.float32)
    u[:, 0] = 0.0
    want = np.asarray(JRM.sample_pdf(jnp.asarray(bins), jnp.asarray(w), S, jnp.asarray(u)))
    got = PRM.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), S, torch.from_numpy(u)).numpy()
    # the two cumsums sum in other orders, so a CDF knot may differ by up to
    # T f32 ulps of 1; t = (u - cdf_0) / (cdf_1 - cdf_0) carries that over
    # the bin: |dt| <= 2 T 2^-24 / denom x bin width (plus 1e-6)
    pdf = (w + 1e-5) / (w + 1e-5).sum(-1, keepdims=True)
    cdf = np.concatenate([np.zeros((B, 1)), np.cumsum(pdf, -1, dtype=np.float64)], -1)
    inds = np.stack([np.searchsorted(c, uu, side="right") for c, uu in zip(cdf, u)])
    lo, hi = np.maximum(inds - 1, 0), np.minimum(inds, T - 1)
    denom = np.take_along_axis(cdf, hi, 1) - np.take_along_axis(cdf, lo, 1)
    denom = np.where(denom < 1e-5, 1.0, denom)
    width = np.take_along_axis(bins, hi, 1) - np.take_along_axis(bins, lo, 1)
    tol = 1e-6 + 2 * T * 2.0**-24 / denom * width
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    assert np.mean(np.abs(got - want) <= 1e-6) > 0.95
    assert (got >= bins[:, :1] - 1e-6).all() and (got <= bins[:, -1:] + 1e-6).all()


def test_linspace_matches_jax():
    """The training ladder (0 to 1 over a power-of-two P) is equal; other
    ladders and the serving midpoints are within one f32 ulp (jnp.linspace
    runs jitted, where XLA may fuse or fold its arithmetic)."""
    for num in (65, 33, 17):
        np.testing.assert_array_equal(PP._linspace(0.0, 1.0, num, "cpu").numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, num)))
    np.testing.assert_array_max_ulp(PP._linspace(0.0, 1.0, 49, "cpu").numpy(),
                                    np.asarray(jnp.linspace(0.0, 1.0, 49)), maxulp=1)
    for F in (32, 24, 16, 7):
        np.testing.assert_array_max_ulp(PP._linspace(0.5 / F, 1 - 0.5 / F, F, "cpu").numpy(),
                                        np.asarray(jnp.linspace(0.5 / F, 1 - 0.5 / F, F)), maxulp=1)


# ---------------------------------------------------------------------------
# render_proposal on analytic fields
# ---------------------------------------------------------------------------

def _sphere_fields(xp, exp, sin):
    def density_fn(pts):
        r2 = (pts * pts).sum(-1)
        return 30.0 * exp(-r2 / 0.2), pts

    def color_fn(d, geo):
        return 0.5 + 0.5 * sin(3.0 * geo + d)

    return density_fn, color_fn


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3)).astype(np.float32)
    o = (2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = (0.5 * rng.uniform(-1, 1, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8] = -d[:8]  # rays that miss the box
    return o, d.astype(np.float32)


def _prop_params(pcfg, seed):
    rng = np.random.default_rng(seed)
    dim = pcfg.grid.output_dim
    return {"grid": {f"level_{l}": (0.1 * rng.uniform(-1, 1, (pcfg.grid.level_size(l), 2))).astype(np.float32)
                     for l in range(pcfg.grid.num_levels)},
            "w": (rng.uniform(-1, 1, (dim, 1)) * dim**-0.5 + 0.3).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _render_pair(perturb):
    """The JAX and port outputs of one render_proposal call (numpy)."""
    cfg_j, cfg_p = JR.RenderConfig(bound=1.5), PR.RenderConfig(bound=1.5)
    pj = JP.ProposalConfig(num_proposal_samples=48, num_final_samples=24)
    pp = PP.ProposalConfig(num_proposal_samples=48, num_final_samples=24)
    params = _prop_params(pj, 1)
    o, d = _rays(200, 2)
    rng = np.random.default_rng(3)
    jitter = rng.uniform(0, 1, (200, 49)).astype(np.float32)
    u = rng.uniform(0, 1, (200, 24)).astype(np.float32)
    jd, jc = _sphere_fields(jnp, jnp.exp, jnp.sin)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _Draws([jitter, u]))
        jout = JP.render_proposal(jd, jc, jax.tree.map(jnp.asarray, params), jnp.asarray(o),
                                  jnp.asarray(d), cfg_j, pj, rng=jax.random.PRNGKey(0), bg_color=0.3,
                                  perturb=perturb)
        jil = float(JP.interlevel_loss(jout))
    td, tc = _sphere_fields(torch, torch.exp, torch.sin)
    tparams = {"grid": {k: torch.from_numpy(v) for k, v in params["grid"].items()},
               "w": torch.from_numpy(params["w"])}
    pout = PP.render_proposal(td, tc, tparams, torch.from_numpy(o), torch.from_numpy(d), cfg_p, pp,
                              bg_color=0.3, perturb=perturb, jitter=torch.from_numpy(jitter),
                              u=torch.from_numpy(u))
    pil = float(PP.interlevel_loss(pout))
    return ({k: np.asarray(v) for k, v in jout.items()}, jil,
            {k: v.detach().numpy() for k, v in pout.items()}, pil)


@pytest.mark.parametrize("perturb", [True, False])
def test_render_proposal_matches_jax(perturb):
    jout, _, pout, _ = _render_pair(perturb)
    assert jout.keys() == pout.keys()
    for k in jout:
        assert pout[k].shape == jout[k].shape, k
        np.testing.assert_allclose(pout[k], jout[k], rtol=0, atol=1e-5, err_msg=k)
    assert pout["weights_sum"].max() > 0.5 and pout["prop_weights"].sum(1).max() > 0.1


@pytest.mark.parametrize("perturb", [True, False])
def test_interlevel_loss_matches_jax(perturb):
    _, jil, _, pil = _render_pair(perturb)
    assert jil > 0
    np.testing.assert_allclose(pil, jil, rtol=1e-4)


def test_proposal_density_and_gradients_match_jax():
    pj, pp = JP.ProposalConfig(), PP.ProposalConfig()
    assert sum(pp.grid.level_size(l) for l in range(5)) == 392_832
    params = _prop_params(pj, 4)
    pts = np.random.default_rng(5).uniform(-1.5, 1.5, (700, 3)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)

    def jloss(p):
        return jnp.sum(jnp.log1p(JP.proposal_density(p, jnp.asarray(pts), pj, 1.5)))

    gj = jax.grad(jloss)(jp)
    tp = {"grid": {k: torch.from_numpy(v).requires_grad_(True) for k, v in params["grid"].items()},
          "w": torch.from_numpy(params["w"]).requires_grad_(True)}
    loss = torch.log1p(PP.proposal_density(tp, torch.from_numpy(pts), pp, 1.5)).sum()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jp)), rtol=1e-5)
    loss.backward()
    np.testing.assert_allclose(tp["w"].grad.numpy(), np.asarray(gj["w"]), rtol=1e-4, atol=1e-6)
    for k, v in tp["grid"].items():
        assert _rel_l2(v.grad.numpy(), np.asarray(gj["grid"][k])) <= 1e-5, k


def test_ray_weights_through_the_compositor_match_jax():
    rng = np.random.default_rng(6)
    sig = (50 * rng.uniform(0, 1, (64, 40)) ** 3).astype(np.float32)
    dt = (0.05 * rng.uniform(0, 1, (64, 40))).astype(np.float32)
    g = rng.standard_normal((64, 40)).astype(np.float32)
    want, vjp = jax.vjp(lambda s: JP._ray_weights(s, jnp.asarray(dt)), jnp.asarray(sig))
    ts = torch.from_numpy(sig).requires_grad_(True)
    got = PP._ray_weights(ts, torch.from_numpy(dt))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    (gs,) = torch.autograd.grad(got, ts, torch.from_numpy(g))
    assert _rel_l2(gs.numpy(), np.asarray(vjp(jnp.asarray(g))[0])) <= 1e-5


# ---------------------------------------------------------------------------
# The trainer on the proposal renderer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup():
    """Both trainers on the proposal renderer and a JAX state with
    numpy-made params: random base and MLPs, zero detail levels, the
    proposal grid at std 0.1 and its head."""
    kw = dict(bound=1.5, compute_dtype="float32", plane_dtype="float32")
    cj = JN.NeRFConfig(triplane=JT.TriplaneConfig(**DIMS), **kw)
    cp = PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS), **kw)
    jtr = JTR.Trainer(cj, JR.RenderConfig(**RKW), JTR.TrainConfig(**PTKW))
    ptr = PTR.Trainer(cp, PR.RenderConfig(**RKW), PTR.TrainConfig(**PTKW), device="cpu")
    rng = np.random.default_rng(0)
    tri = cj.triplane
    b = tri.base_resolution

    def mlp(dims):
        return {f"w{i}": rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(np.float32) / np.sqrt(dims[i])
                for i in range(len(dims) - 1)}

    params = {"encoder": {"base": (0.5 * rng.standard_normal((3, 16, b, b))).astype(np.float32),
                          "wavelets": {f"level_{i}": np.zeros((3, 16, 3, s, s), np.float32)
                                       for i, s in enumerate(tri.yh_sizes)}},
              "sigma_net": mlp([tri.feature_dim, 64, 16]), "color_net": mlp([16 + 15, 64, 64, 3]),
              "proposal": _prop_params(jtr.prop_cfg, 7)}
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtr.init_state()._replace(params=jparams, opt_state=jtr.optimizer.init(jparams),
                                       ema_params=jax.tree.map(jnp.copy, jparams))
    return jtr, ptr, jstate, jtr.scene_to_device(_scene())


def _draws(seed, V, HW):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, N_RAYS).astype(np.int32), rng.integers(0, HW, N_RAYS).astype(np.int32),
            rng.random((N_RAYS, P + 1)).astype(np.float32), rng.random((N_RAYS, F)).astype(np.float32))


def _port_batch(draws):
    img, pix, jit, u = (torch.from_numpy(a) for a in draws)
    return {"img_idx": img, "pix_idx": pix, "prop_jitter": jit, "prop_u": u}


def _port_data():
    return _setup()[1].scene_to_device(PS.make_synthetic_scene(num_views=2, H=64, W=64, num_steps=32))


def test_trainer_builds_the_proposal_state_and_carries_jax():
    jtr, ptr, jstate, _ = _setup()
    assert ptr.prop_cfg == PP.ProposalConfig(num_proposal_samples=P, num_final_samples=F)
    fresh = ptr.init_state()
    assert {k: tuple(v.shape) for k, v in PTR._leaves(fresh.params)} == \
        {k: v.shape for k, v in _leaves(jax.tree.map(np.asarray, jtr.init_state().params)).items()}
    state = train_state_from_jax(jstate, device="cpu")
    for tree_p, tree_j in ((state.params, jstate.params), (state.opt_state["mu"], jstate.opt_state[0].mu),
                           (state.ema_params, jstate.ema_params)):
        lp, lj = _leaves(tree_p), _leaves(jax.tree.map(np.asarray, tree_j))
        assert lp.keys() == lj.keys() and any(k.startswith("proposal.grid.") for k in lp)
        for k in lj:
            np.testing.assert_array_equal(lp[k], lj[k])
    with pytest.raises(KeyError, match="proposal"):
        params_from_jax(dict(jax.tree.map(np.asarray, jstate.params), proposal={"w": np.ones((10, 1))}),
                        device="cpu")


def test_proposal_loss_and_grads_match_jax():
    jtr, ptr, jstate, jdata = _setup()
    draws = _draws(1, 2, 64 * 64)
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
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(aux_p["interlevel"].detach()), float(aux_j["interlevel"]), rtol=1e-4)
    assert float(aux_j["interlevel"]) > 0
    gj = _leaves(jax.tree.map(np.asarray, grads_j))
    for n, g in zip(names, grads_p):
        assert np.linalg.norm(gj[n]) > 0, n
        assert _rel_l2(g.numpy(), gj[n]) <= 1e-4, (n, _rel_l2(g.numpy(), gj[n]))


def test_proposal_five_step_trajectory_matches_jax():
    jtr, ptr, jstate, jdata = _setup()
    state = train_state_from_jax(jstate, device="cpu")
    start = _leaves(jax.tree.map(np.asarray, jstate.params))
    data = _port_data()
    losses_j, losses_p = [], []
    for step in range(5):
        draws = _draws(10 + step, 2, 64 * 64)
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
        lp, lj = _leaves(tree_p), _leaves(jax.tree.map(np.asarray, tree_j))
        for n in lj:
            d = np.abs(lp[n] - lj[n])
            assert (d > 1e-5).mean() <= 2e-2 and d.max() <= 2 * TKW["lr"] * 5, (n, (d > 1e-5).sum())
            assert _rel_l2(lp[n] - start[n], lj[n] - start[n]) <= 2e-3, n
    moved = _leaves(state.params)["proposal.w"] - start["proposal.w"]
    assert np.abs(moved).max() > 0  # the interlevel loss trains the proposal head


def test_proposal_fit_render_and_evaluate_run():
    """fit (no refresh, no retune), render_image and evaluate on the CPU;
    the draws come from the state's generator. CLIP guidance renders through
    the dense renderer, as the JAX package's does off the occgrid
    renderer."""
    _, ptr, _, _ = _setup()
    scene = PS.make_synthetic_scene(num_views=2, H=24, W=24, num_steps=16)
    tr = PTR.Trainer(ptr.nerf_cfg, ptr.render_cfg, PTR.TrainConfig(**dict(PTKW, iters=3, eval_chunk=1024)),
                     device="cpu")
    state = tr.init_state()
    state = tr.fit(state, scene, log_every=0)
    assert state.step == 3 and int(state.occ.iter_density) == 0 and state.ema_count == 3
    assert all(np.isfinite(v).all() for v in _leaves(state.params).values())
    res = tr.evaluate(state, scene)
    assert np.isfinite(res["PSNR"]) and np.isfinite(res["SSIM"]) and len(res["per_image"]) == 2
    tr.set_clip_guidance(lambda img: (img - 0.5).square().mean(), 1)
    state, clip_l = tr.clip_guidance_step(state)
    assert state.step == 4 and np.isfinite(float(clip_l)) and tr.clip_hw == (16, 16)
