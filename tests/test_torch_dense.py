"""The dense renderer of the PyTorch port against the JAX package (CPU):
``render_dense`` with and without importance upsampling, perturbed (jitter
and u injected) and not, with the occupancy mask, and the gradients it sends
to the field's parameters.

The field is ``test_torch_render.py``'s: a 64^2 x 8-channel bior6.8 wavelet
triplane (non-zero detail levels) and the MLPs, float32, numpy-made
parameters; the rays come from an orbit camera, plus a few that miss the
box. The JAX package's ``jax.random.uniform`` is patched to return the
jitter and then u, its draw order.

Tolerances, stated per comparison:
* without upsampling the depths are the same float32 operations (the
  linspace as jit rounds it), so image / depth / weights_sum hold to atol
  2e-5 (the field and the cumprod sum in another order; exp rounds apart);
  z_variance rtol 1e-4;
* with upsampling the new depths come from ``sample_pdf``, whose CDF knots
  round apart (tests/test_torch_proposal.py); a new depth moves by rounding
  only (the inverse CDF is continuous), so the same tolerances hold;
* the parameter gradients of a weighted sum of the outputs: relative L2
  1e-4 per group (as tests/test_torch_train.py's one step).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_render import _cfgs, _jax_tree, _params, _poses
from tests.test_torch_train import _Draws, _leaves, _rel_l2
from trinerflet_tpu.data.rays import rays_full_image as j_rays_full_image
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu_torch.carry import params_from_jax
from trinerflet_tpu_torch.data.synthetic import synthetic_intrinsics
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.render import renderer as PR
from trinerflet_tpu_torch.train import trainer as PTR

T_UNI, T_UP = 48, 24


def _rays():
    ro, rd = j_rays_full_image(_poses()[2], synthetic_intrinsics(12, 12), 12, 12)
    ro, rd = ro.reshape(-1, 3).astype(np.float32), rd.reshape(-1, 3).astype(np.float32)
    ro[:4], rd[:4] = [-3.0, 2.0, 0.0], [1.0, 0.0, 0.0]  # rays that miss the box
    return ro, rd


def _occ(cfg, seed=3):
    return np.random.default_rng(seed).random((cfg.cascades,) + (cfg.grid_size,) * 3) < 0.5


def _loss_weights(n):
    rng = np.random.default_rng(11)
    return (rng.standard_normal((n, 3)).astype(np.float32), rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _pair(upsample, perturb, occ_mask):
    """Outputs and parameter gradients of one render_dense call in both
    packages (numpy)."""
    cj, cp, rj, rp = _cfgs("float32")
    kw = dict(num_steps=T_UNI, upsample_steps=T_UP if upsample else 0, occ_mask_dense=occ_mask)
    rj, rp = dataclasses.replace(rj, **kw), dataclasses.replace(rp, **kw)
    params = _params(cj)
    ro, rd = _rays()
    N = ro.shape[0]
    rng = np.random.default_rng(5)
    jitter = rng.random((N, T_UNI)).astype(np.float32)
    u = rng.random((N, T_UP)).astype(np.float32)
    occ = _occ(rp)
    gi, gd, gw = _loss_weights(N)

    jf = JN.NeRFField(cj)
    jparams = _jax_tree(params)

    def jloss(p):
        planes = jf.build_planes(p)
        out = JR.render_dense(lambda x: jf.density(p, planes, x), lambda d, g: jf.color(p, d, g),
                              jnp.asarray(ro), jnp.asarray(rd), rj, rng=jax.random.PRNGKey(0),
                              bg_color=0.3, perturb=perturb, occ=jnp.asarray(occ))
        loss = (out["image"] * gi).sum() + (out["depth"] * gd).sum() + (out["weights_sum"] * gw).sum()
        return loss, out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _Draws([jitter, u] if upsample else [jitter]))
        (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jparams)

    pf = PN.NeRFField(cp)
    pparams = params_from_jax(params, device="cpu")
    leaves = PTR._leaves(pparams)
    for _, t in leaves:
        t.requires_grad_(True)
    planes = pf.build_planes(pparams)
    pout = PR.render_dense(lambda x: pf.density(pparams, planes, x), lambda d, g: pf.color(pparams, d, g),
                           torch.from_numpy(ro), torch.from_numpy(rd), rp, bg_color=0.3, perturb=perturb,
                           jitter=torch.from_numpy(jitter), u=torch.from_numpy(u),
                           occ=torch.from_numpy(occ))
    loss = ((pout["image"] * torch.from_numpy(gi)).sum() + (pout["depth"] * torch.from_numpy(gd)).sum()
            + (pout["weights_sum"] * torch.from_numpy(gw)).sum())
    pgrad = torch.autograd.grad(loss, [t for _, t in leaves])
    return ({k: np.asarray(v) for k, v in jout.items()}, _leaves(jax.tree.map(np.asarray, jgrad)),
            {k: v.detach().numpy() for k, v in pout.items()},
            {n: g.numpy() for (n, _), g in zip(leaves, pgrad)})


CASES = [(False, True, False), (False, False, False), (True, True, False), (True, False, False),
         (True, True, True)]
IDS = ["uniform-perturbed", "uniform", "upsampled-perturbed", "upsampled", "upsampled-occ-mask"]


@pytest.mark.parametrize("upsample,perturb,occ_mask", CASES, ids=IDS)
def test_render_dense_matches_jax(upsample, perturb, occ_mask):
    jout, _, pout, _ = _pair(upsample, perturb, occ_mask)
    assert set(pout) == set(jout) == {"image", "depth", "weights_sum", "z_variance"}
    for k in ("image", "depth", "weights_sum"):
        assert pout[k].shape == jout[k].shape, k
        np.testing.assert_allclose(pout[k], jout[k], rtol=0, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(pout["z_variance"], jout["z_variance"], rtol=1e-4, atol=1e-7)
    assert pout["weights_sum"][4:].max() > 0.5


@pytest.mark.parametrize("upsample,perturb,occ_mask", CASES, ids=IDS)
def test_render_dense_field_gradients_match_jax(upsample, perturb, occ_mask):
    _, jgrad, _, pgrad = _pair(upsample, perturb, occ_mask)
    assert jgrad.keys() == pgrad.keys()
    for n in jgrad:
        assert np.linalg.norm(jgrad[n]) > 0, n
        assert _rel_l2(pgrad[n], jgrad[n]) <= 1e-4, (n, _rel_l2(pgrad[n], jgrad[n]))


def _merge_case(xp, RMod, render, to, monkeypatch):
    """render_dense on rays along +z from inside the box (a point's z is its
    depth exactly), with sample_pdf patched to return some of the uniform
    depths themselves: the merge meets ties. The uniform pass has sigma 2
    and colour 0.1, the new samples sigma 40 and colour 0.9, so the order of
    tied samples decides the composite."""
    calls = []

    def density_fn(x):
        calls.append(x)
        s = 2.0 if len(calls) == 1 else 40.0
        return xp.zeros(x.shape[:1]) + s, xp.zeros(x.shape) + (0.1 if len(calls) == 1 else 0.9)

    def sample_pdf(bins, weights, n, u):
        z = calls[0][:, 2].reshape(bins.shape[0], -1)
        return z[:, 1:2 * n:2]

    monkeypatch.setattr(RMod, "sample_pdf", sample_pdf)
    out = render(density_fn, lambda d, g: g, to(np.array([[0.0, 0.0, 0.0], [0.3, -0.2, 0.1]], np.float32)),
                 to(np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)))
    return {k: np.asarray(v) for k, v in out.items()}


def test_render_dense_merge_is_stable_and_draws_in_order(monkeypatch):
    """Ties in the depth merge resolve as the JAX package's stable argsort
    does (the uniform sample first); with perturb and no injected draws,
    the jitter and then u come from the generator."""
    _, _, rj, rp = _cfgs("float32")
    rj, rp = (dataclasses.replace(c, num_steps=8, upsample_steps=3) for c in (rj, rp))
    jout = _merge_case(jnp, JR.RM, lambda *a: JR.render_dense(*a, rj), jnp.asarray, monkeypatch)
    pout = _merge_case(torch, PR.RM, lambda *a: PR.render_dense(*a, rp), torch.from_numpy, monkeypatch)
    for k in jout:
        np.testing.assert_allclose(pout[k], jout[k], rtol=0, atol=1e-6, err_msg=k)

    monkeypatch.undo()
    rp = dataclasses.replace(rp, num_steps=8, upsample_steps=4)
    ro, rd = torch.tensor([[0.0, 0.0, -3.0]]), torch.tensor([[0.0, 0.0, 1.0]])
    seen = {1: [], 2: []}

    def density_fn(run):
        def fn(x):
            seen[run].append(x.clone())
            return torch.ones(x.shape[0]), x
        return fn

    PR.render_dense(density_fn(1), lambda d, g: g, ro, rd, rp, perturb=True,
                    generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    jit, u = torch.rand((1, 8), generator=g), torch.rand((1, 4), generator=g)
    PR.render_dense(density_fn(2), lambda d, g: g, ro, rd, rp, perturb=True, jitter=jit, u=u)
    assert len(seen[1]) == len(seen[2]) == 2
    for a, b in zip(seen[1], seen[2]):
        assert torch.equal(a, b)
