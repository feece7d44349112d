"""The global sample layout: K5's plain version (``compact_global_dense``,
``compact_samples``) and the compact compositor's (``composite_compact``
forward and backward) against the JAX package and a float64 reference (CPU).

Inputs are made with numpy and handed to both packages.

Tolerances, stated per comparison:
* compaction: EQUAL on every field, bit for bit (the same selections, the
  same two f32 roundings of ``o + d*t`` and of ``t + dt - t0``), dtype
  included.
* ``composite_compact`` against a float64 per-ray reference: 1e-6 absolute,
  at the bench's size (32,768 rays, 12 slots per ray) as at a small one. The
  port takes each ray's exclusive sum of sigma*dt as such (in float64,
  rounded to f32); what is left is f32 rounding of exp and of the products.
* against the JAX package only where the JAX formula is accurate: it takes
  the exclusive sum as ONE global f32 cumsum minus each ray's base, so its
  exponent carries a few ulp of the cumsum's end c_end (0.025 off in
  weights_sum at the bench size; ROADMAP Queue 3). The test buffer keeps
  c_end below 1e3 and derives the tolerance from it: with eps = 4 ulp(c_end)
  the bound on an exponent's error, a ray's weight sum is off by at most
  eps (the weights sum to <= 1), depth by eps * max t, and so on; JAX's
  segment sums (differences of a global f32 cumsum too) add 8 ulp of the
  buffer-wide sum of each output. Gradients (``jax.vjp`` through the same
  cumsums): 2 eps max|a| + 8 ulp(sum |a w|), times max dt, where a is the
  per-slot cotangent. No slot's transmittance lies within 1e-3 (in log) of
  the t_thresh cut, so no ``alive`` flag can flip (asserted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trinerflet_tpu.ops import raymarch as JRM
from trinerflet_tpu_torch.ops import raymarch as PRM

T_THRESH = 1e-4


def _dense_layout(seed, N, B, prefix, fill=0.6):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((N, 3)).astype(np.float32)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    if prefix:
        cnt = rng.integers(0, B + 1, N)
        mask = np.arange(B)[None] < cnt[:, None]
    else:
        mask = rng.random((N, B)) < fill
    t = np.where(mask, rng.uniform(0.5, 3.0, (N, B)), 0).astype(np.float32)
    dt = np.where(mask, rng.uniform(0.003, 0.006, (N, B)), 0).astype(np.float32)
    t0 = rng.uniform(0.2, 0.5, N).astype(np.float32)
    return o, d, t, dt, mask, t0


def _assert_equal_samples(p, j):
    assert p._fields == tuple(j._fields)
    for f in j._fields:
        a, b = getattr(p, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix_path", "sort_path"])
@pytest.mark.parametrize("case", ["exact", "ample", "overflow", "empty"])
def test_compact_global_dense_matches_jax(case, prefix):
    """Both JAX paths: the prefix-mask path on row-prefix masks (what the
    hierarchical march yields), the sort path on arbitrary masks."""
    N, B = 97, 12
    o, d, t, dt, mask, t0 = _dense_layout(1, N, B, prefix)
    if case == "empty":
        mask[:] = False
    total = int(mask.sum())
    M = {"exact": total, "ample": N * B, "overflow": total - 37, "empty": 5 * N}[case]
    kw = dict(m_budget=M, bound=1.5)
    j = JRM.compact_global_dense(*map(jnp.asarray, (o, d, t, dt, mask, t0)), **kw,
                                 prefix_mask=prefix)
    p = PRM.compact_global_dense(*map(torch.from_numpy, (o, d, t, dt, mask, t0)), **kw)
    _assert_equal_samples(p, j)
    assert int(p.num_valid) == min(total, M)
    if case == "overflow":  # a ray cut at the end of the buffer, later rays empty
        assert (p.counts.numpy() < mask.sum(1)).sum() >= 2 and (p.ray_id.numpy() < N).all()
    if case == "ample":
        assert (p.ray_id.numpy()[total:] == PRM.PAD_RAY_ID).all()


@pytest.mark.parametrize("ample", [True, False])
def test_compact_samples_matches_jax(ample):
    """The flat march's compaction on a numpy-built MarchResults (arbitrary
    valid mask, step sizes on every candidate)."""
    rng = np.random.default_rng(2)
    N, K = 64, 40
    ts = np.sort(rng.uniform(0.3, 3.0, (N, K)), axis=1).astype(np.float32)
    dts = rng.uniform(0.002, 0.01, (N, K)).astype(np.float32)
    valid = rng.random((N, K)) < 0.3
    o = rng.standard_normal((N, 3)).astype(np.float32)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    M = N * K if ample else int(valid.sum()) // 2
    jm = JRM.MarchResults(ts=jnp.asarray(ts), dts=jnp.asarray(dts), valid=jnp.asarray(valid))
    pm = PRM.MarchResults(ts=torch.from_numpy(ts), dts=torch.from_numpy(dts),
                          valid=torch.from_numpy(valid))
    j = JRM.compact_samples(jnp.asarray(o), jnp.asarray(d), jm, m_budget=M, bound=1.0)
    p = PRM.compact_samples(torch.from_numpy(o), torch.from_numpy(d), pm, m_budget=M, bound=1.0)
    _assert_equal_samples(p, j)


def _compact_buffer(seed, N, S, sig_range=(40.0, 400.0)):
    """A compacted buffer with 1..S samples per ray (ample room), sigma in
    sig_range and dt in [0.003, 0.006] (the bench's step at bound 1.5)."""
    o, d, t, dt, mask, t0 = _dense_layout(seed, N, S, prefix=True)
    rng = np.random.default_rng(seed + 100)
    mask[:, 0] = True  # every ray has a sample: weights_sum well away from 0
    t[:, 0] = rng.uniform(0.5, 3.0, N)
    dt[:, 0] = rng.uniform(0.003, 0.006, N)
    comp = PRM.compact_global_dense_plain(*map(torch.from_numpy, (o, d, t, dt, mask, t0)),
                                          m_budget=N * S + 7, bound=1.5)
    M = comp.ts.shape[0]
    sig = rng.uniform(*sig_range, M).astype(np.float32)
    rgb = rng.random((M, 3)).astype(np.float32)
    return comp, sig, rgb


def _float64_reference(comp, sig, rgb, cts):
    """Per ray in float64, as a dense (N, S) layout: outputs (ws, depth,
    image, z2), the exponent S_i of every slot, and dsigma, drgb for
    cotangents cts at (ws, depth, image, z2)."""
    off, cnt = comp.offsets.numpy().astype(np.int64), comp.counts.numpy().astype(np.int64)
    N, S = off.shape[0], int(cnt.max())
    j = np.arange(S)
    idx = np.minimum(off[:, None] + j, len(sig) - 1)
    live = j[None] < cnt[:, None]
    g = lambda x: np.where(live.reshape(live.shape + (1,) * (x.ndim - 1)), x[idx], 0.0)  # noqa: E731
    sd = g(sig.astype(np.float64)) * g(comp.dts.numpy().astype(np.float64))
    ts = g(comp.ts.numpy().astype(np.float64))
    rgb_d = g(rgb.astype(np.float64))
    expo = np.cumsum(sd, 1) - sd
    T = np.exp(-expo)
    e = np.exp(-sd)
    alive = (T >= T_THRESH) & live
    w = np.where(alive, (1 - e) * T, 0.0)
    outs = (w.sum(1), (w * ts).sum(1), (w[..., None] * rgb_d).sum(1), (w * ts * ts).sum(1))
    gws, gd, gi, gz = (c.astype(np.float64) for c in cts)
    a = gws[:, None] + gd[:, None] * ts + (gi[:, None, :] * rgb_d).sum(-1) + gz[:, None] * ts * ts
    aw = a * w
    suffix = np.cumsum(aw[:, ::-1], 1)[:, ::-1] - aw
    dsd = np.where(alive, a * e * T, 0.0) - suffix
    dsig = np.zeros(len(sig))
    drgb = np.zeros((len(sig), 3))
    dts = g(comp.dts.numpy().astype(np.float64))
    dsig[idx[live]] = (dts * dsd)[live]
    drgb[idx[live]] = (w[..., None] * gi[:, None, :])[live]
    return outs, expo[live], dsig, drgb, np.abs(aw).sum(), np.abs(a[live]).max()


@pytest.mark.parametrize("N,S", [(300, 8), (32768, 12)], ids=["small", "bench"])
def test_composite_compact_matches_float64(N, S):
    comp, sig, rgb = _compact_buffer(4, N, S, sig_range=(0.0, 400.0))
    rng = np.random.default_rng(5)
    cts = [rng.standard_normal(s).astype(np.float32) for s in ((N,), (N,), (N, 3), (N,))]
    refs, _, dsig64, drgb64, _, _ = _float64_reference(comp, sig, rgb, cts)
    args = (comp.dts, comp.ts, comp.ray_id, comp.offsets, comp.counts, N, T_THRESH)
    outs = PRM.composite_compact_plain(torch.from_numpy(sig), torch.from_numpy(rgb), *args)
    for got, ref in zip(outs, refs):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    dsig, drgb = PRM.composite_compact_backward_plain(
        torch.from_numpy(sig), torch.from_numpy(rgb), *args, *map(torch.from_numpy, cts))
    np.testing.assert_allclose(dsig.numpy(), dsig64, rtol=0, atol=1e-6 * np.abs(dsig64).max())
    np.testing.assert_allclose(drgb.numpy(), drgb64, rtol=0, atol=1e-6)
    pad = comp.ray_id.numpy() >= N
    assert pad.any() and (dsig.numpy()[pad] == 0).all() and (drgb.numpy()[pad] == 0).all()


def _ulp(x) -> float:
    return float(np.spacing(np.float32(abs(x))))


@pytest.mark.parametrize("order", ["port_first", "jax_first"])
def test_composite_compact_matches_jax(order):
    """Forward (weights_sum, depth, image, z_variance) and ``jax.vjp`` with
    cotangents at all four outputs, in both call orders (the port's plain
    version first in a process, and after the JAX calls)."""
    N, S = 60, 8
    comp, sig, rgb = _compact_buffer(6, N, S)
    jcomp = JRM.CompactSamples(*[jnp.asarray(x.numpy()) for x in comp])
    rng = np.random.default_rng(7)
    cts = [rng.standard_normal(s).astype(np.float32) for s in ((N,), (N,), (N, 3), (N,))]

    def run_jax():
        out, vjp = jax.vjp(lambda s, c: JRM.composite_compact(s, c, jcomp, N, T_THRESH),
                           jnp.asarray(sig), jnp.asarray(rgb))
        return [np.asarray(x) for x in out], [np.asarray(x) for x in vjp(tuple(map(jnp.asarray, cts)))]

    def run_port():
        ts, tr = torch.from_numpy(sig).requires_grad_(True), torch.from_numpy(rgb).requires_grad_(True)
        out = PRM.composite_compact(ts, tr, comp, N, T_THRESH)
        grads = torch.autograd.grad(out, [ts, tr], [torch.from_numpy(c) for c in cts])
        return [x.detach().numpy() for x in out], [g.numpy() for g in grads]

    if order == "port_first":
        (outs_p, grads_p), (outs_j, grads_j) = run_port(), run_jax()
    else:
        (outs_j, grads_j), (outs_p, grads_p) = run_jax(), run_port()

    # the JAX formula's error, from the buffer's own sums: each exponent is
    # off by at most eps, so each weight by alpha T eps and a ray's weight
    # sum by eps * weights_sum <= eps; JAX's segment sums add 8 ulp of the
    # buffer-wide sum of that output
    sd = (sig * comp.dts.numpy()).astype(np.float32)
    c_end = float(np.cumsum(sd, dtype=np.float32)[-1])
    assert c_end < 1e3
    eps = 4 * _ulp(c_end)
    ws = outs_p[0].astype(np.float64)
    assert ws.min() > 0.1  # z_variance divides by weights_sum
    ts_max = float(comp.ts.numpy().max())
    tols = [eps * scale + 8 * _ulp(np.abs(o).sum())
            for o, scale in zip(outs_p[:3], (1.0, ts_max, 1.0))]
    tol_z2 = eps * ts_max**2 + 8 * _ulp(ts_max**2 * ws.sum())
    # z_var = z2/ws - (depth/ws)^2: first-order error through each sum
    tols.append(4 * (tol_z2 + ts_max * tols[1] + ts_max**2 * tols[0]) / ws.min())
    for k, (got, ref, tol) in enumerate(zip(outs_p, outs_j, tols)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=f"output {k}")

    # gradients: the cotangents at (weights_sum, depth, image, z2) that the
    # z_variance cotangent amounts to, then d sd_i = alive a_i e_i T_i - R_i
    # is off by eps (|a_i| + sum_k |a_k w_k|) <= 2 eps max|a| plus JAX's
    # reverse cumsum of a w, 8 ulp of its buffer-wide sum; times max dt
    depth, z2 = outs_p[1].astype(np.float64), outs_p[3] > 0
    g_zv = np.where(z2, cts[3], 0.0)
    eff = [cts[0] + g_zv * (-(outs_p[3] + (depth / ws) ** 2) / ws + 2 * depth**2 / ws**3),
           cts[1] - g_zv * 2 * depth / ws**2, cts[2], g_zv / ws]
    _, expo, _, _, sum_aw, a_max = _float64_reference(comp, sig, rgb, eff)
    assert np.abs(expo - np.log(1 / T_THRESH)).min() > 1e-3  # no alive flag near the cut
    assert (expo > np.log(1 / T_THRESH)).any()  # the cut is exercised
    gtol = (2 * eps * a_max + 8 * _ulp(sum_aw)) * float(comp.dts.numpy().max())
    np.testing.assert_allclose(grads_p[0], grads_j[0], rtol=0, atol=gtol, err_msg="dsigma")
    np.testing.assert_allclose(grads_p[1], grads_j[1], rtol=0, atol=eps * np.abs(cts[2]).max(),
                               err_msg="drgb")
