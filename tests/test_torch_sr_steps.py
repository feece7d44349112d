"""The SR system's HR step in the PyTorch port against the JAX package
(CPU): a trajectory with the perceptual LR-consistency term (LPIPS, alex,
random weights of the real shapes carried from JAX), and one HR step with
the SDS term (the oracle denoiser). The setup, the draws handed to both
packages and the tolerances are tests/test_torch_sr_system.py's; Adam's
first moment after the SDS step (0.1 x the gradient) is held to rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sr_system import (Draws, _leaves, assert_params_close, check_trajectory,
                                        initial_states, no_jit, scenes, systems)
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)


def test_perceptual_trajectory_matches_jax():
    """2 HR steps from the start (both refresh a view's pseudo-GT) with
    LPIPS (alex) of the HR estimate pooled to LR against the LR ground
    truth, weight 0.1."""
    check_trajectory(lpips=True, total_steps=2, sr_start_step=0)


def test_hr_step_with_sds_matches_jax():
    """One HR step with the SDS term (oracle denoiser, the timestep bounds
    at step 0) after a grid refresh: loss, SDS and the updated parameters;
    SDS changes the encoder's gradient (Adam's first moment) against the
    same step without it."""
    scene_j, _ = scenes()
    crop = 8
    rng = np.random.default_rng(2)
    ro = np.tile(np.array([[0.0, 0.0, -2.0]], np.float32), (crop * crop, 1))
    rd = rng.normal(0, 0.15, (crop * crop, 3)).astype(np.float32) + np.array([0, 0, 1], np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    pgt = rng.random((crop, crop, 3)).astype(np.float32)
    lgt = rng.random((crop // 2, crop // 2, 3)).astype(np.float32)
    w = dict(l2_hr=1.0, l1_hr=0.5, consistency=1.0, reg=0.01, percep=0.0, sds=0.5)
    mu = {}
    for lam in (0.0, 0.5):
        draws = Draws(21)
        with pytest.MonkeyPatch.context() as mp:
            no_jit(mp)
            jsys, psys = systems(dict(lambda_sds=lam), guidance="oracle")
            jstate, pstate = initial_states(jsys, scene_j)
            draws.patch_jax(mp)
            draws.patch_port(mp)
            jstate, pstate = jsys._update_grid(jstate), psys._update_grid(pstate)
            bounds = jsys.guidance.step_bounds(0)
            jb = jnp.asarray(bounds, jnp.int32) if lam else None
            js, ja = jsys._hr_step_impl(jstate, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(pgt),
                                        jnp.asarray(lgt), {k: jnp.float32(v) for k, v in w.items()}, jb)
            ps, pa = psys._hr_step(pstate, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(pgt),
                                   torch.from_numpy(lgt), w, bounds if lam else None)
        assert ("sds" in pa) == ("sds" in ja) == bool(lam)
        for k in ja:
            np.testing.assert_allclose(float(pa[k]), float(ja[k]), rtol=1e-4, atol=1e-7, err_msg=k)
        assert_params_close(ps.params, js.params, 1e-2, 1)
        mu[lam] = _leaves(ps.opt_state["mu"])["encoder.base"]
        np.testing.assert_allclose(mu[lam], _leaves(jax.tree.map(np.asarray, js.opt_state[0].mu))["encoder.base"],
                                   rtol=1e-3, atol=1e-9)
    assert np.abs(mu[0.5]).max() > 0 and np.abs(mu[0.5] - mu[0.0]).max() > 0
