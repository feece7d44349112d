"""The flat candidate march of the PyTorch port against the JAX package
(CPU): the dt_gamma ladder and its host-side sizing, the candidate march
(JAX ``march_candidates``, jitted), the per-ray selection
(``compact_per_ray``) and ``render_occgrid``'s flat branch on both layouts.

Inputs (rays, occupancy, noise) are made with numpy from a seed; the JAX
package's ``jax.random.uniform`` is patched to return the noise.

Tolerances, stated per comparison:
* dt_gamma = 0: valid, dts and the selection bit for bit, as the
  hierarchical march: the plain version rounds where jitted XLA rounds
  where it tests the points. XLA's ts output rounds t0 + dt_min k in two
  steps where its point test fuses them (one multiply-add), so the returned
  ts agree within one ulp (the port returns the fused value it tests).
* dt_gamma > 0: the ladder's exp and log are float32 library functions, and
  XLA's CPU versions and the plain version's (float64, rounded once) round
  some arguments one ulp apart (measured: 7% of the geometric phase's
  exps). ts then differ by up to 2 ulps (measured) where the later phases
  carry it: held to 4 ulps, with at least 80% of entries equal; dts are
  clamp(ts gamma), held the same way. A candidate whose point sits within
  those ulps of a cell edge may flip: at most 1e-4 of the valid candidates
  (measured: none here; 1 of 83,170 at bound 8).
* the sizing integers (worst_case_ladder_steps, candidates_for) are equal.
* render_occgrid's flat branch on the same march: counts equal, the p99 of
  demand rtol 1e-6 (the JAX package runs first_k_valid eagerly there, so
  stride = count / B is a true division where the port multiplies by the
  float32 reciprocal, as jitted XLA does: one ulp), image / depth /
  weights_sum atol 1e-5 (exp and the cumprods round apart), z_variance and
  trunc_T rtol 1e-4; on the exact global layout the JAX compositor's own
  error is added (see the test).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import _Draws
from trinerflet_tpu.ops import raymarch as JRM
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu_torch import kernels
from trinerflet_tpu_torch.ops import raymarch as PRM
from trinerflet_tpu_torch.render import renderer as PR


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _close_in_ulps(got, want, max_ulps=4, min_equal=0.8):
    d = _ulps(np.ascontiguousarray(got, np.float32), np.ascontiguousarray(want, np.float32))
    assert d.max() <= max_ulps and (d == 0).mean() >= min_equal, (d.max(), (d == 0).mean())


# ---------------------------------------------------------------------------
# The ladder and its sizing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,max_steps,grid", [
    (1.0 / 128, 1024, 128),   # the CLI's default
    (1.0 / 256, 512, 64),
    (0.05, 256, 128),         # aggressive growth: the third phase comes fast
])
def test_dt_ladder_matches_jax(g, max_steps, grid):
    """tests/test_ops.py's cases, against the ladder as jitted XLA computes
    it (inside march_candidates), plus random starts across all phases."""
    dt_min = 2 * PRM.SQRT3 / max_steps
    dt_max = 2 * PRM.SQRT3 * 4 / grid
    t0 = np.concatenate([[0.05, 0.2, 1.7, 25.0, 200.0],
                         np.random.default_rng(0).uniform(0.05, 40.0, 300)]).astype(np.float32)
    fn = jax.jit(JRM.dt_ladder, static_argnums=(1, 2, 3, 4))
    jts, jdts = fn(jnp.asarray(t0), 300, dt_min, dt_max, g)
    pts, pdts = PRM.dt_ladder(torch.from_numpy(t0), 300, dt_min, dt_max, g)
    _close_in_ulps(pts.numpy(), np.asarray(jts))
    _close_in_ulps(pdts.numpy(), np.asarray(jdts))
    assert np.array_equal(pts[:, 0].numpy(), t0)
    A, B = dt_min / g, dt_max / g  # every phase is reached
    ts = pts.numpy()
    assert (ts < A).any() and ((ts >= A) & (ts < B)).any() and (ts > B).any()


def test_ladder_sizing_matches_jax():
    """worst_case_ladder_steps and RenderConfig.candidates_for return the
    JAX package's integers over a grid of (bound, gamma, max_steps)."""
    for bound in (1.0, 1.5, 2.0, 4.0, 8.0, 16.0):
        for g in (0.0, 1.0 / 512, 1.0 / 256, 1.0 / 128, 0.05):
            for steps in (64, 128, 512, 1024, 4096):
                for grid in (64, 128):
                    kw = dict(bound=bound, dt_gamma=g, max_steps=steps, grid_size=grid)
                    pc, jc = PR.RenderConfig(**kw), JR.RenderConfig(**kw)
                    assert pc.num_candidates == jc.num_candidates, kw
                    assert pc.candidates_for(steps // 2) == jc.candidates_for(steps // 2), kw
                    dt_min, dt_max = PRM._step_bounds(steps, grid, pc.cascades)
                    args = (2 * bound * PRM.SQRT3, 0.2, dt_min, dt_max, g)
                    assert PRM.worst_case_ladder_steps(*args) == JRM.worst_case_ladder_steps(*args)
    cfg = dict(grid_size=128, max_steps=1024, dt_gamma=1.0 / 128)
    assert PR.RenderConfig(bound=4.0, **cfg).num_candidates == 519
    assert PR.RenderConfig(bound=2.0, **cfg).num_candidates == 431
    assert PR.RenderConfig(bound=1.5, **dict(cfg, dt_gamma=0.0)).num_candidates == 1536
    assert PR.RenderConfig(bound=4.0, candidates_override=77, **cfg).num_candidates == 77


# ---------------------------------------------------------------------------
# The candidate march and the per-ray selection
# ---------------------------------------------------------------------------

def _scene(bound, grid, frac, n, seed):
    """Rays from cameras outside the box (at 1.5-3 bounds) and from inside
    it (near = min_near: the ladder's first phase), an occupancy grid of
    ``frac`` occupied cells, noise in [0, 1); near/far as render_occgrid
    forms them."""
    rng = np.random.default_rng(seed)
    C = 1 + max(0, math.ceil(math.log2(bound)))
    v = rng.standard_normal((n, 3))
    r = rng.uniform(1.5, 3.0, (n, 1)) * bound
    r[: n // 5] = rng.uniform(0.0, 0.5, (n // 5, 1)) * bound
    o = r * v / np.linalg.norm(v, axis=1, keepdims=True)
    d = 0.5 * bound * rng.uniform(-1, 1, (n, 3)) - o
    d[: n // 5] = rng.standard_normal((n // 5, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    occ = rng.random((C, grid, grid, grid)) < frac
    aabb = np.array([-bound] * 3 + [bound] * 3, np.float32)
    near, far = JRM.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.2)
    hit = near < 1e30
    near, far = np.array(jnp.where(hit, near, 0.0)), np.array(jnp.where(hit, far, 0.0))
    noise = rng.random(n).astype(np.float32)
    return C, (o, d, near, far, occ, noise)


MARCH_CASES = {  # bound, grid, gamma, max_steps, occupied fraction, candidates_override
    "uniform": (1.5, 32, 0.0, 128, 0.3, 0),
    "uniform_capped": (1.5, 32, 0.0, 64, 0.7, 160),  # Kc > max_steps: the cap binds
    "ladder_cli": (4.0, 64, 1.0 / 128, 1024, 0.2, 0),
    "ladder_steep": (2.0, 32, 0.05, 128, 0.3, 0),
    "ladder_capped": (2.0, 32, 1.0 / 64, 32, 0.8, 0),
}


def _march_both(case):
    bound, grid, g, steps, frac, override = MARCH_CASES[case]
    C, arrays = _scene(bound, grid, frac, 600, 1)
    Kc = JR.RenderConfig(bound=bound, grid_size=grid, max_steps=steps, dt_gamma=g,
                         candidates_override=override).num_candidates
    kw = dict(num_steps=Kc, max_steps=steps, grid_size=grid, cascades=C, bound=bound, dt_gamma=g)
    j = JRM.march_candidates(*map(jnp.asarray, arrays), **kw)
    p = PRM.march_candidates_plain(*map(torch.from_numpy, arrays), **kw)
    return kw, arrays, j, p


@pytest.mark.parametrize("case", sorted(MARCH_CASES))
def test_march_candidates_matches_jax(case):
    kw, _, j, p = _march_both(case)
    jv, pv = np.asarray(j.valid), p.valid.numpy()
    assert jv.sum() > 0
    if case.endswith("capped"):
        assert kw["num_steps"] > kw["max_steps"] and jv.sum(1).max() == kw["max_steps"]  # it binds
    if kw["dt_gamma"] == 0.0:
        _close_in_ulps(p.ts.numpy(), np.asarray(j.ts), max_ulps=1, min_equal=0.5)
        np.testing.assert_array_equal(p.dts.numpy(), np.asarray(j.dts))
        np.testing.assert_array_equal(pv, jv)
    else:
        _close_in_ulps(p.ts.numpy(), np.asarray(j.ts))
        _close_in_ulps(p.dts.numpy(), np.asarray(j.dts))
        assert (pv != jv).sum() <= 1e-4 * jv.sum(), (pv != jv).sum()


def _ranks_past_count(valid, B):
    """Rays over the budget B whose spread rank ceil(b * count * f32(1/B))
    (float32, as jit computes it) exceeds their count for some b <= B."""
    count = valid.sum(1).astype(np.float32)
    b = np.arange(1, B + 1, dtype=np.float32)
    tgt = np.ceil(b[None, :] * count[:, None] * np.float32(1.0 / B))
    return (count > B) & (tgt > count[:, None]).any(1)


@pytest.mark.parametrize("B", [7, 13, 20])
@pytest.mark.parametrize("case", ["uniform", "uniform_capped", "ladder_cli"])
def test_compact_per_ray_and_march_flat_match_jax(case, B):
    """compact_per_ray against the JAX package's under jit, on the same
    valid candidates; march_flat_plain's t and dt are the selected
    candidates' (the JAX package's take_along_axis), zero where masked.
    At B = 7 and 13 some rays' spread rank runs past their count (B 7:
    counts 11-15, 22-28; B 13: 14, 15, 26-31), and the slot takes the last
    candidate, masked true, as in the JAX package; at B = 20 none does."""
    kw, arrays, j, p = _march_both(case)
    past = _ranks_past_count(p.valid.numpy(), B)
    assert past.any() == (B != 20), past.sum()
    fn = jax.jit(JRM.compact_per_ray, static_argnums=1)
    ji, jm, js = fn(JRM.MarchResults(j.ts, j.dts, jnp.asarray(p.valid.numpy())), B)
    pi, pm, ps = PRM.compact_per_ray(p, B)
    jm = np.asarray(jm)
    np.testing.assert_array_equal(pm.numpy(), jm)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pi.numpy()[jm], np.asarray(ji)[jm])
    Kc = kw["num_steps"]
    assert (pi.numpy()[past][:, -1] == Kc - 1).all() and jm[past].all()
    assert (np.asarray(js) > 1).any()  # spread rays
    assert B < 20 or (jm.sum(1) < B).any()  # and short rays (every ray here keeps 7 or more)
    t, dt, mask, stride, t0 = PRM.march_flat(*map(torch.from_numpy, arrays), budget=B, **kw)
    np.testing.assert_array_equal(mask.numpy(), jm)
    np.testing.assert_array_equal(stride.numpy(), ps.numpy())
    for got, cand in ((t, p.ts), (dt, p.dts)):
        want = np.where(jm, np.take_along_axis(cand.numpy(), np.asarray(ji), 1), 0.0)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t0.numpy(), p.ts[:, 0].numpy())


def test_march_flat_wrappers_on_the_cpu_and_the_kernel_checks():
    """CPU tensors take the plain versions and count no launch; the kernel
    wrapper checks its inputs before it builds or launches anything."""
    kw, arrays, _, p = _march_both("uniform")
    n0 = kernels.launches["march_flat"]
    cand = PRM.march_flat_candidates(*map(torch.from_numpy, arrays), **kw)
    for a, b in zip(cand, p):
        assert torch.equal(a, b)
    assert kernels.launches["march_flat"] == n0
    o, d, near, far, occ, noise = map(torch.from_numpy, arrays)
    with pytest.raises(ValueError, match="rays_o must be"):
        PRM._march_flat_cuda(o.double(), d, near, far, occ, noise, budget=20, **kw)
    with pytest.raises(ValueError, match="occ must be"):
        PRM._march_flat_cuda(o, d, near, far, occ.float(), noise, budget=20, **kw)
    with pytest.raises(ValueError, match="num_steps >= 1"):
        PRM._march_flat_cuda(o, d, near, far, occ, noise, budget=-1, **kw)


# ---------------------------------------------------------------------------
# render_occgrid's flat branch
# ---------------------------------------------------------------------------

def _fields(exp, sin):
    def field_fn(x, d):
        r2 = (x * x).sum(-1)
        return 40.0 * exp(-r2 / 2.0) + 0.5, 0.5 + 0.5 * sin(2.0 * x + d)
    return field_fn


@pytest.mark.parametrize("layout,g,with_stats", [
    ("per_ray", 1.0 / 128, True), ("per_ray", 0.0, False), ("global", 1.0 / 128, True)])
def test_render_occgrid_flat_matches_jax(layout, g, with_stats, monkeypatch):
    """The flat branch with injected noise: taken for dt_gamma > 0 with the
    march left hierarchical (the CLI's case), and for march="flat" at
    dt_gamma = 0; the aux keys are the JAX package's for the branch. On the
    global layout the JAX compositor's own error is allowed as in
    tests/test_torch_render.py (its global f32 cumsum): 4 ulp of the
    buffer's cumsum of sigma dt (eps), plus 8 ulp of each output's sum; its
    z_variance, E[t^2] - E[t]^2, carries eps times 4 t_max^2 / weights_sum."""
    bound, grid = 4.0, 32
    C, (o, d, _, _, occ, noise) = _scene(bound, grid, 0.25, 400, 2)
    kw = dict(bound=bound, grid_size=grid, max_steps=256, dt_gamma=g, samples_per_ray_budget=20,
              compaction=layout, march="hierarchical" if g > 0 else "flat")
    rj, rp = JR.RenderConfig(**kw), PR.RenderConfig(**kw)
    occ_coarse = np.array(JR._dilate3(jnp.asarray(occ), 1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _Draws([noise]))
        jout = JR.render_occgrid(_fields(jnp.exp, jnp.sin), jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(occ), rj, rng=jax.random.PRNGKey(0), bg_color=0.2,
                                 perturb=True, occ_coarse=jnp.asarray(occ_coarse),
                                 with_stats=with_stats)
    seen = {}
    composite = PR.RM.composite_compact

    def spy(sigmas, rgbs, comp, n, thresh):
        seen["sd"], seen["ts"] = (sigmas * comp.dts).detach().numpy(), comp.ts.numpy()
        return composite(sigmas, rgbs, comp, n, thresh)

    monkeypatch.setattr(PR.RM, "composite_compact", spy)
    pout = PR.render_occgrid(_fields(torch.exp, torch.sin), torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(occ), rp, noise=torch.from_numpy(noise), bg_color=0.2,
                             occ_coarse=torch.from_numpy(occ_coarse), with_stats=with_stats)
    keys = {"image", "depth", "weights_sum", "z_variance", "num_samples"}
    if layout == "per_ray":
        keys |= {"overflow_frac", "samples_mean", "trunc_T"} | ({"samples_p99"} if with_stats else set())
    assert set(pout) == set(jout) == keys
    assert int(pout["num_samples"]) == int(jout["num_samples"]) > 2 * len(o)
    if layout == "per_ray":
        assert float(pout["overflow_frac"]) == float(jout["overflow_frac"]) > 0
        np.testing.assert_allclose(float(pout["samples_mean"]), float(jout["samples_mean"]), rtol=1e-6)
        if with_stats:
            np.testing.assert_allclose(float(pout["samples_p99"]), float(jout["samples_p99"]), rtol=1e-6)
        np.testing.assert_allclose(float(pout["trunc_T"]), float(jout["trunc_T"]), rtol=1e-4, atol=1e-7)
    eps = 4 * float(np.spacing(np.cumsum(seen["sd"], dtype=np.float32)[-1])) if seen else 0.0
    for k in ("image", "depth", "weights_sum"):
        ref = np.asarray(jout[k])
        tol = 1e-5 + (eps + 8 * float(np.spacing(np.float32(np.abs(ref).sum()))) if seen else 0.0)
        np.testing.assert_allclose(pout[k].numpy(), ref, rtol=0, atol=tol, err_msg=k)
    zt = 1e-6
    if seen:
        zt = zt + (eps + 1e-5) * 4 * float(seen["ts"].max()) ** 2 / np.maximum(pout["weights_sum"].numpy(), 1e-3)
    zj = np.asarray(jout["z_variance"])
    assert (np.abs(pout["z_variance"].numpy() - zj) <= 1e-4 * np.abs(zj) + zt).all()
    assert float(pout["weights_sum"].max()) > 0.5
