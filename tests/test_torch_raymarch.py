"""Parity of the PyTorch port's ray marching and compositing with the JAX
package (CPU).

The march is held bit for bit: ``mask``, ``stride``, ``seg_lastocc`` and the
kept ``t`` must be EQUAL to the JAX package's (which runs the march under
jit, where XLA fuses multiply-adds -- the port reproduces those rounding
points). Compositing is float32 with atol 1e-6: the same factors in the same
order, sums reduced in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trinerflet_tpu.ops import raymarch as JRM
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu_torch.ops import raymarch as PRM
from trinerflet_tpu_torch.render import renderer as PR

BOUND, GRID, CAS, STEPS = 1.5, 32, 2, 128


def _rays(seed, n):
    """Rays from cameras on a radius-2 sphere aimed near the origin."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3))
    o = 2.0 * v / np.linalg.norm(v, axis=1, keepdims=True)
    target = 0.6 * rng.uniform(-1, 1, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _grids(seed, frac):
    rng = np.random.default_rng(seed)
    occ = rng.random((CAS, GRID, GRID, GRID)) < frac
    occ_coarse = np.array(JR._dilate3(jnp.asarray(occ), 2))
    return occ, occ_coarse


def test_near_far_equal():
    o, d = _rays(0, 500)
    d[:7, 1] = 0.0  # axis-parallel rays exercise the eps guard
    aabb = np.array([-1.2, -1.0, -1.5, 1.3, 1.1, 1.4], np.float32)
    jn, jf = JRM.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.2)
    pn, pf = PRM.near_far_from_aabb(torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(aabb), 0.2)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))


def test_occupancy_lookup_equal():
    rng = np.random.default_rng(1)
    occ, _ = _grids(1, 0.3)
    pts = rng.uniform(-BOUND, BOUND, (4000, 3)).astype(np.float32)
    pts[:100] *= 0.3  # inner cascade
    dts = np.full((4000,), 2 * JRM.SQRT3 / STEPS, np.float32)
    ref = JRM.occupancy_lookup(jnp.asarray(occ), jnp.asarray(pts), jnp.asarray(dts),
                               grid_size=GRID, cascades=CAS, bound=BOUND)
    got = PRM.occupancy_lookup(torch.from_numpy(occ), torch.from_numpy(pts),
                               torch.from_numpy(dts), grid_size=GRID, cascades=CAS, bound=BOUND)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("budget,frac", [(8, 0.3), (20, 0.5), (20, 0.05)])
def test_first_k_valid_equal(budget, frac):
    rng = np.random.default_rng(budget)
    valid = rng.random((300, 96)) < frac
    valid[:5] = False
    payload = rng.standard_normal((300, 96)).astype(np.float32)
    # the JAX package calls it inside the jitted march: compare with that
    fn = jax.jit(JRM.first_k_valid, static_argnames=("budget", "spread"))
    ji, jm, js, jp = fn(jnp.asarray(valid), budget=budget, spread=True,
                        payload=jnp.asarray(payload))
    pi, pm, ps, pp = PRM.first_k_valid(torch.from_numpy(valid), budget, spread=True,
                                       payload=torch.from_numpy(payload))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    m = np.asarray(jm)
    np.testing.assert_array_equal(pi.numpy()[m], np.asarray(ji)[m])
    np.testing.assert_array_equal(pp.numpy()[m], np.asarray(jp)[m])


@pytest.mark.parametrize("frac,noise_on,fs,cs", [
    (0.25, True, 1, 1), (0.6, False, 1, 1), (0.03, True, 1, 1),
    (0.25, True, 2, 1), (0.6, True, 3, 1), (0.1, False, 2, 2), (0.25, True, 3, 3), (0.05, True, 5, 2)])
def test_march_hierarchical_equal(frac, noise_on, fs, cs):
    """Exact tests (stride 1) and training's strided probes: fine stride fs
    (one probe per fs candidates), coarse stride cs (one per cs segments)."""
    o, d = _rays(2, 700)
    occ, occ_coarse = _grids(3, frac)
    aabb = np.array([-BOUND] * 3 + [BOUND] * 3, np.float32)
    n, f = JRM.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.2)
    hit = n < 1e30
    n, f = np.array(jnp.where(hit, n, 0.0)), np.array(jnp.where(hit, f, 0.0))
    noise = (np.random.default_rng(4).random(700) if noise_on else np.zeros(700)).astype(np.float32)
    kw = dict(num_coarse=int(np.ceil(BOUND * STEPS / 12)), fine_per_coarse=12, coarse_budget=8,
              budget=20, max_steps=STEPS, grid_size=GRID, cascades=CAS, bound=BOUND,
              occ_test_stride=fs, coarse_test_stride=cs)
    jt, jdt, jm, js, jl = JRM.march_hierarchical(
        *map(jnp.asarray, (o, d, n, f, occ, occ_coarse, noise)), **kw)
    pt, pdt, pm, ps, pl = PRM.march_hierarchical(
        *map(torch.from_numpy, (o, d, n, f, occ, occ_coarse, noise)), **kw)
    assert np.asarray(jm).sum() > 0
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert float(pdt) == float(jdt)


def test_march_rejects_unported_options():
    """The march takes every stride >= 1, and the renderer every march and
    layout of the JAX package (the flat march, its exact global compaction
    and dt_gamma > 0 are held in tests/test_torch_flat_march.py); what is
    rejected is a stride below 1 and an unknown layout."""
    z = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="strides must be >= 1"):
        PRM.march_hierarchical(z, z, z[:, 0], z[:, 0], None, None, z[:, 0], num_coarse=4,
                               fine_per_coarse=12, coarse_budget=8, budget=20, max_steps=128,
                               occ_test_stride=0)
    cfg = PR.RenderConfig(bound=BOUND, grid_size=GRID, compaction="shared")
    with pytest.raises(ValueError, match="unknown compaction"):
        PR.render_occgrid(None, z, z, None, cfg, occ_coarse=z)


@pytest.mark.parametrize("T", [20, 64, 576])  # the per-ray B, the proposal P, the dense 512 + 64
@pytest.mark.parametrize("t_thresh", [0.0, 1e-4])
def test_composite_dense_matches_jax(t_thresh, T):
    rng = np.random.default_rng(5)
    N = 400
    sig = (rng.random((N, T)) * 60).astype(np.float32)
    rgb = rng.random((N, T, 3)).astype(np.float32)
    dl = (rng.random((N, T)) * 0.05).astype(np.float32)
    ts = np.cumsum(dl, 1).astype(np.float32)
    mask = rng.random((N, T)) < 0.8
    ref = JRM.composite_dense(*map(jnp.asarray, (sig, rgb, dl, ts, mask)), t_thresh=t_thresh)
    got = PRM.composite_dense(*map(torch.from_numpy, (sig, rgb, dl, ts, mask)), t_thresh=t_thresh)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)


def test_dilate_and_bbox_match_jax():
    occ, _ = _grids(6, 0.002)
    for r in (1, 2, 3):
        np.testing.assert_array_equal(PR._dilate3(torch.from_numpy(occ), r).numpy(),
                                      np.asarray(JR._dilate3(jnp.asarray(occ), r)))
    cfg_j = JR.RenderConfig(bound=BOUND, grid_size=GRID)
    cfg_p = PR.RenderConfig(bound=BOUND, grid_size=GRID)
    for g in (occ, np.zeros_like(occ)):
        np.testing.assert_allclose(PR._occupied_bbox(torch.from_numpy(g), cfg_p).numpy(),
                                   np.asarray(JR._occupied_bbox(jnp.asarray(g), cfg_j)),
                                   rtol=0, atol=1e-6)
