"""The SR system in the PyTorch port against the JAX package (CPU): a
trajectory through both phases, the HR step's SDS and perceptual terms,
the gradient masks and ``evaluate``.

Setup: an 8-channel 64^2 bior6.8 triplane with 2 IDWT levels and
``low_res_scale`` 2 (phase 1 samples the 32^2 snapshot), 32-wide MLPs, a
32^3 grid, the srtex scene at 3 views of 8^2 LR / 16^2 HR (the host render,
the same bits in both packages). Both systems start from the JAX
package's initial state (``carry.sr_state_from_jax``).

Every random draw is handed to both packages, from two numpy generators of
one seed consumed in the same order: the JAX package's
``jax.random.uniform`` / ``randint`` / ``normal`` are patched (and its
``jax.jit`` made the identity while the system runs, so a patched draw is
drawn at each call, not once at tracing), and the port's steps get the
same values injected (``batch``, ``jitter``).

Tolerances:
* per-step losses: rtol 1e-4 (the field sums in another order); the
  wavelet L1 term alone rtol 1e-3: after a step every coefficient is
  about lr in magnitude, and eager JAX on the CPU sums the 73,728 of a
  level in sequence in float32, which drifts by 4.2e-4 (measured; the
  port's value is within 1e-6 of the float64 mean of the same params);
* parameters after the trajectory: within 1e-5 except at most 0.1% of a
  group's entries, none beyond 2 lr per step (Adam's first steps move each
  entry by about lr whatever its gradient's size, so a gradient within
  rounding of zero may step the other way; tests/test_torch_train.py);
* the occupancy bits: equal;
* ``evaluate`` on one state: PSNR and SSIM within 1e-3 dB / 1e-5 (the
  renders agree within 1e-4).
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu.sr import data as JDATA
from trinerflet_tpu.sr import guidance as JG
from trinerflet_tpu.sr import system as JSYS
from trinerflet_tpu.utils import lpips as JL
from trinerflet_tpu_torch.carry import network_params_from_jax, sr_state_from_jax
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.models import triplane as PT
from trinerflet_tpu_torch.render import renderer as PR
from trinerflet_tpu_torch.sr import data as PDATA
from trinerflet_tpu_torch.sr import guidance as PG
from trinerflet_tpu_torch.sr import system as PSYS

TRI = dict(channels=8, resolution=64, wavelet_scale=4, low_res_scale=2)
NERF = dict(bound=1.0, hidden_dim=32, hidden_dim_color=32)
RND = dict(bound=1.0, grid_size=32, density_thresh=1.0, max_steps=128, samples_per_ray_budget=16)
SR = dict(total_steps=6, sr_start_step=3, hr_fit_refresh_every=2, num_rays_lr=64, crop_size_lr=4,
          update_extra_interval=100, eval_chunk=1024, wavelet_regularization=0.01,
          lambda_l1_hr=[3, 0.0, 1.0, 6])
SCENE = dict(num_views=3, lr_size=8, scale=2, variant="srtex", seed=3)


def _f32(lo, u, hi):
    return (lo + u * (hi - lo)).astype(np.float32)


class Draws:
    """Two numpy generators of one seed: ``j`` feeds the patched JAX draws,
    ``p`` the port's injected ones, in the same order."""

    def __init__(self, seed=0):
        self.j, self.p = np.random.default_rng(seed), np.random.default_rng(seed)

    # JAX side
    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(_f32(float(minval), self.j.random(tuple(shape)), float(maxval)), dtype)

    def randint(self, key, shape, minval, maxval, dtype=jnp.int32):
        return jnp.asarray(self.j.integers(int(minval), int(maxval), tuple(shape)), dtype)

    def normal(self, key, shape=(), dtype=jnp.float32):
        return jnp.asarray(self.j.standard_normal(tuple(shape)).astype(np.float32), dtype)

    def patch_jax(self, mp):
        """Call after the states are made: the JAX initialisers draw too."""
        mp.setattr(jax.random, "uniform", self.uniform)
        mp.setattr(jax.random, "randint", self.randint)
        mp.setattr(jax.random, "normal", self.normal)

    # port side: wrap a system's steps so they take the same draws
    def patch_port(self, mp, cls=PSYS.SRSystem):
        rng = self.p
        lr_step, hr_step, update_grid = cls._lr_step, cls._hr_step, cls._update_grid

        def _lr_step(sys_, state, data, weights, batch=None):
            V, H, W = data["images"].shape[:3]
            N = sys_.cfg.num_rays_lr
            img, pix = rng.integers(0, V, N), rng.integers(0, H * W, N)
            noise = _f32(0.0, rng.random(N), 1.0)
            return lr_step(sys_, state, data, weights, {"img_idx": torch.from_numpy(img),
                                                        "pix_idx": torch.from_numpy(pix),
                                                        "noise": torch.from_numpy(noise)})

        def _hr_step(sys_, state, rays_o, rays_d, pgt, lgt, weights, sds_t_bounds=None, batch=None):
            noise = _f32(0.0, rng.random(rays_o.shape[0]), 1.0)
            return hr_step(sys_, state, rays_o, rays_d, pgt, lgt, weights, sds_t_bounds,
                           {"noise": torch.from_numpy(noise)})

        def _update_grid(sys_, state, jitter=None):
            cfg = sys_.render_cfg
            H = cfg.grid_size
            halves = [min(2**c, cfg.bound) / H for c in range(cfg.cascades)]
            jit = np.stack([_f32(-h, rng.random((H**3, 3)), h) for h in halves])
            return update_grid(sys_, state, torch.from_numpy(jit))

        def _randn(shape, generator, device):  # the guidance's normals (NCHW)
            s = tuple(shape)
            a = rng.standard_normal((s[0], s[2], s[3], s[1])).astype(np.float32)
            return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

        def _randint(lo, hi, generator):
            return int(rng.integers(lo, hi, ()))

        mp.setattr(cls, "_lr_step", _lr_step)
        mp.setattr(cls, "_hr_step", _hr_step)
        mp.setattr(cls, "_update_grid", _update_grid)
        mp.setattr(PG, "_randn", _randn)
        mp.setattr(PG, "_randint", _randint)


def no_jit(mp):
    """The JAX system's ``jax.jit`` as the identity, so that a patched draw
    is drawn at every call (a jitted step would keep its first draws)."""
    mp.setattr(jax, "jit", lambda f, **kw: f)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.array(v.detach().cpu() if torch.is_tensor(v) else v, np.float32)  # a copy
    return out


def assert_params_close(pparams, jparams, lr, steps):
    lp, lj = _leaves(pparams), _leaves(jax.tree.map(np.asarray, jparams))
    assert set(lp) == set(lj)
    for n in lj:
        d = np.abs(lp[n] - lj[n])
        assert (d > 1e-5).mean() <= 1e-3 and d.max() <= 2 * lr * steps, (n, (d > 1e-5).sum(), d.max())


@functools.lru_cache(maxsize=None)
def scenes():
    return JDATA.make_synthetic_sr_scene(**SCENE), PDATA.make_synthetic_sr_scene(**SCENE)


def systems(sr=None, lpips=None, guidance="resize", **tri):
    sr = dict(SR, **(sr or {}))
    tj, tp = JT.TriplaneConfig(**dict(TRI, **tri)), PT.TriplaneConfig(**dict(TRI, **tri))
    cj, cp = JN.NeRFConfig(triplane=tj, **NERF), PN.NeRFConfig(triplane=tp, **NERF)
    rj, rp = JR.RenderConfig(**RND), PR.RenderConfig(**RND)
    if guidance == "resize":
        gj, gp = JG.make_resize_guidance(JG.GuidanceConfig()), PG.make_resize_guidance(PG.GuidanceConfig())
    else:  # an oracle target of the crop's size, for the SDS term
        target = np.full((1, 8, 8, 3), 0.4, np.float32)
        gc = dict(num_inference_steps=4, guidance_scale=1.0)
        gj = JG.make_oracle_guidance(JG.GuidanceConfig(**gc), jnp.asarray(target))
        gp = PG.make_oracle_guidance(PG.GuidanceConfig(**gc), torch.from_numpy(target).permute(0, 3, 1, 2))
    lj = lp = None
    if lpips:
        lj = JL.init_lpips_params(jax.random.PRNGKey(4), "alex")
        lp = network_params_from_jax(lj, "cpu")
    jsys = JSYS.SRSystem(cj, rj, JSYS.SRConfig(**sr), gj, lpips_params=lj, lpips_net="alex")
    psys = PSYS.SRSystem(cp, rp, PSYS.SRConfig(**sr), gp, lpips_params=lp, lpips_net="alex", device="cpu")
    return jsys, psys


def initial_states(jsys, scene_j):
    grid = JR.mark_untrained_grid(scene_j.lr.poses, scene_j.lr.intrinsics, jsys.render_cfg)
    jstate = jsys.init_state(jax.random.PRNGKey(5), density_grid=grid)
    return jstate, sr_state_from_jax(jstate, "cpu")


_JIT = jax.jit


@functools.lru_cache(maxsize=None)
def _trajectory(lpips=False, total_steps=6, sr_start_step=3):
    """Both systems' fit (6 steps: 3 LR, 3 HR with two pseudo-GT refreshes
    by default), the per-step aux, and the final states."""
    scene_j, scene_p = scenes()
    sr = dict(total_steps=total_steps, sr_start_step=sr_start_step)
    if lpips:
        sr["lambda_lr_consistency_perceptual"] = 0.1
    draws = Draws(11)
    with pytest.MonkeyPatch.context() as mp:
        no_jit(mp)
        # LPIPS draws nothing: JAX's own function, compiled as one graph
        # (op by op it compiles ~40 s of convolutions here)
        mp.setattr(JL, "lpips", _JIT(JL.lpips, static_argnames=("net", "normalize")))
        jsys, psys = systems(sr, lpips)
        jstate, pstate = initial_states(jsys, scene_j)
        draws.patch_jax(mp)
        draws.patch_port(mp)
        jaux, paux = [], []
        jstate = jsys.fit(jstate, scene_j, log_every=0,
                          callback=lambda s, a: jaux.append({k: float(v) for k, v in a.items()}))
        pstate = psys.fit(pstate, scene_p, log_every=0,
                          callback=lambda s, a: paux.append({k: float(v) for k, v in a.items()}))
    return jsys, psys, jstate, pstate, jaux, paux


def check_trajectory(lpips=False, total_steps=6, sr_start_step=3):
    jsys, psys, jstate, pstate, jaux, paux = _trajectory(lpips, total_steps, sr_start_step)
    n_hr = total_steps - sr_start_step
    assert len(jaux) == len(paux) == total_steps and pstate.step == int(jstate.step) == total_steps
    assert (["l2_hr" in a for a in paux] == ["l2_hr" in a for a in jaux]
            == [False] * sr_start_step + [True] * n_hr)
    assert ("consistency_perceptual" in paux[-1]) == lpips
    for s, (a, b) in enumerate(zip(paux, jaux)):
        assert set(a) == set(b), s
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3 if k == "reg" else 1e-4, atol=1e-7,
                                       err_msg=f"step {s} {k}")
    assert pstate.opt_state["count"] == int(jstate.opt_state[0].count) == total_steps
    assert_params_close(pstate.params, jstate.params, 1e-2, total_steps)
    np.testing.assert_array_equal(pstate.occ.occ.numpy(), np.asarray(jstate.occ.occ))
    assert psys._march_retunes == jsys._march_retunes == 0
    lvl = _leaves(pstate.params)["encoder.wavelets.level_1"]  # the 32^2 level
    assert (lvl != 0).mean() > 0.9


def test_two_phase_trajectory_matches_jax():
    """3 LR steps on the low_res snapshot, then 3 HR steps on crops against
    the resize guidance's pseudo-GT (refreshed at steps 3 and 5 by a whole
    HR view), with L1 ramping in, LR consistency and the wavelet L1."""
    check_trajectory()


def test_evaluate_matches_jax(tmp_path):
    """``evaluate`` of one state (JAX's after the trajectory, carried) in
    both packages: the per-frame and mean LR / HR / bilinear PSNR and HR
    SSIM, and the file they write."""
    jsys, psys, jstate, _, _, _ = _trajectory()
    scene_j, scene_p = scenes()
    jsys.workspace, psys.workspace = str(tmp_path / "j"), str(tmp_path / "p")
    os.makedirs(jsys.workspace)
    os.makedirs(psys.workspace)
    with pytest.MonkeyPatch.context() as mp:
        no_jit(mp)
        jsys._build_jits()
        jres = jsys.evaluate(jstate, scene_j)
    pres = psys.evaluate(sr_state_from_jax(jstate, "cpu"), scene_p)
    assert os.listdir(psys.workspace) == os.listdir(jsys.workspace) == ["final_results_6.json"]
    with open(os.path.join(psys.workspace, "final_results_6.json")) as f:
        assert json.load(f) == json.loads(json.dumps(pres))
    assert set(pres) == set(jres)
    for k in ("PSNR_lr", "PSNR_hr", "PSNR_bilinear", "SSIM_hr"):
        tol = 1e-5 if k == "SSIM_hr" else 1e-3
        np.testing.assert_allclose(pres[k], jres[k], rtol=0, atol=tol, err_msg=k)
    np.testing.assert_allclose(pres["PSNR_bilinear"], jres["PSNR_bilinear"], rtol=0, atol=1e-5)
    for a, b in zip(pres["per_frame"], jres["per_frame"]):
        assert a["view"] == b["view"] and set(a) == set(b)
        np.testing.assert_allclose(a["PSNR_hr"], b["PSNR_hr"], rtol=0, atol=1e-3)


def test_planes_only_and_min_res_masks():
    """``sr_planes_only`` with ``sr_min_res`` 32: the MLPs, the 16^2 base
    plane and the 16^2 wavelet level do not move over a fit from fresh Adam
    moments (their gradients are zeroed), the 32^2 level does; the same in
    JAX."""
    scene_j, scene_p = scenes()
    sr = dict(sr_planes_only=True, sr_min_res=32, total_steps=3, sr_start_step=0)
    draws = Draws(31)
    with pytest.MonkeyPatch.context() as mp:
        no_jit(mp)
        jsys, psys = systems(sr)
        jstate, pstate = initial_states(jsys, scene_j)
        draws.patch_jax(mp)
        draws.patch_port(mp)
        before = _leaves(pstate.params)
        jstate = jsys.fit(jstate, scene_j, log_every=0)
        pstate = psys.fit(pstate, scene_p, log_every=0)
    after, jafter = _leaves(pstate.params), _leaves(jax.tree.map(np.asarray, jstate.params))
    for n in before:
        frozen = n != "encoder.wavelets.level_1"  # base and level_0 are 16^2
        assert np.array_equal(after[n], before[n]) == frozen, n
        assert np.array_equal(jafter[n], before[n]) == frozen, n
    assert_params_close(pstate.params, jstate.params, 1e-2, 3)


def test_system_rejects_a_single_resolution_triplane():
    cfg = PN.NeRFConfig(triplane=PT.TriplaneConfig(**dict(TRI, low_res_scale=1)), **NERF)
    with pytest.raises(ValueError, match="low_res_scale"):
        PSYS.SRSystem(cfg, PR.RenderConfig(**RND), PSYS.SRConfig(**SR),
                      PG.make_resize_guidance(PG.GuidanceConfig()), device="cpu")
    jsys, psys = systems()
    assert dataclasses.asdict(psys.eval_render_cfg) == dataclasses.asdict(jsys.eval_render_cfg)
    assert psys.eval_chunk == jsys.eval_chunk
