"""Gradients of the port's differentiable ops against ``jax.vjp`` / ``jax.grad``
of the JAX package (CPU). Inputs and cotangents are made with numpy and
handed to both.

Tolerances, stated per comparison:
* float32: the port's backward passes are the same linear maps summed in
  another order (the IDWT adjoint as taps instead of a transposed banded
  matmul, the plane gradient as ``index_add_`` instead of a scatter, the
  compositor's analytic reverse pass instead of autodiff through a cumprod):
  atol 1e-5 relative to the largest gradient (compositor: 1e-4, the reverse
  pass re-associates products of up to 20 factors).
* bfloat16: both round at the same points (each 1-D adjoint, the planes'
  cast, the plane gradient's cast); a sum reduced in another order may round
  one bf16 ulp apart, so 2^-7 relative to the largest gradient.
* ``wavelet_l1``: equal to float32 rounding (1e-7), including the +1
  gradient of |x| at zero coefficients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.ops import raymarch as JRM
from trinerflet_tpu.ops import wavelets as JW
from trinerflet_tpu_torch.carry import params_from_jax
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.models import triplane as PT
from trinerflet_tpu_torch.ops import grid_sample as PGS
from trinerflet_tpu_torch.ops import raymarch as PRM
from trinerflet_tpu_torch.ops import wavelets as PW

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REL = {"float32": 1e-5, "bfloat16": 2.0**-7}


def _close(got, ref, rel):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= rel * scale, (np.abs(got - ref).max(), rel * scale)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype).requires_grad_(True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("crop", [False, True])
def test_idwt2d_grad_matches_jax(dtype, crop):
    jd, pd = DT[dtype]
    rng = np.random.default_rng(0)
    n = 21
    yl = rng.standard_normal((2, 3, n + crop, n + crop)).astype(np.float32)
    yh = (0.3 * rng.standard_normal((2, 3, 3, n, n))).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a, b: JW.idwt2d(a, b, "bior6.8"),
                         jnp.asarray(yl, jd), jnp.asarray(yh, jd))
    ct = rng.standard_normal(out_j.shape).astype(np.float32)
    g_yl, g_yh = vjp(jnp.asarray(ct, jd))
    tyl, tyh = _t(yl, pd), _t(yh, pd)
    out_p = PW.idwt2d(tyl, tyh, "bior6.8")
    p_yl, p_yh = torch.autograd.grad(out_p, [tyl, tyh], torch.from_numpy(ct).to(pd))
    assert p_yl.dtype == pd and p_yl.shape == tyl.shape
    _close(p_yl.float(), g_yl.astype(jnp.float32), REL[dtype])
    _close(p_yh.float(), g_yh.astype(jnp.float32), REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_planes_grad_matches_jax(dtype):
    """Through the whole ladder: the bf16 casts of the coefficients and the
    planes, 2x, the pads and three IDWT levels."""
    cfg_kw = dict(triplane=dict(channels=4, resolution=64, wavelet_scale=8), bound=1.5,
                  compute_dtype=dtype, plane_dtype=dtype)
    tri = cfg_kw["triplane"]
    cj = JN.NeRFConfig(triplane=JT.TriplaneConfig(**tri), **{k: v for k, v in cfg_kw.items() if k != "triplane"})
    cp = PN.NeRFConfig(triplane=PT.TriplaneConfig(**tri), **{k: v for k, v in cfg_kw.items() if k != "triplane"})
    rng = np.random.default_rng(1)
    b = cj.triplane.base_resolution
    enc = {"base": (0.5 * rng.standard_normal((3, 4, b, b))).astype(np.float32),
           "wavelets": {f"level_{i}": (0.1 * rng.standard_normal((3, 4, 3, s, s))).astype(np.float32)
                        for i, s in enumerate(cj.triplane.yh_sizes)}}
    jf, pf = JN.NeRFField(cj), PN.NeRFField(cp)
    jenc = jax.tree.map(jnp.asarray, enc)
    planes_j, vjp = jax.vjp(lambda e: jf.build_planes({"encoder": e})["full"], jenc)
    ct = rng.standard_normal(planes_j.shape).astype(np.float32)
    (g_enc,) = vjp(jnp.asarray(ct, planes_j.dtype))
    penc = {"base": _t(enc["base"], torch.float32),
            "wavelets": {k: _t(v, torch.float32) for k, v in enc["wavelets"].items()}}
    planes_p = pf.build_planes({"encoder": penc})["full"]
    assert planes_p.dtype == DT[dtype][1]
    leaves = [penc["base"]] + [penc["wavelets"][k] for k in sorted(penc["wavelets"])]
    grads = torch.autograd.grad(planes_p, leaves, torch.from_numpy(ct).to(planes_p.dtype))
    refs = [g_enc["base"]] + [g_enc["wavelets"][k] for k in sorted(g_enc["wavelets"])]
    for got, ref in zip(grads, refs):
        assert got.dtype == torch.float32
        # bf16: the cotangent passes four rounding points per level
        _close(got, ref, REL[dtype] if dtype == "float32" else 2.0**-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_points_grad_matches_jax(dtype):
    jd, pd = DT[dtype]
    rng = np.random.default_rng(2)
    planes = rng.standard_normal((3, 24, 20, 8)).astype(np.float32)
    xyz = rng.uniform(-1.7, 1.7, (3000, 3)).astype(np.float32)  # past the bound: clamp
    xyz[:40] = 0.0  # many samples on shared texels
    tcfg = JT.TriplaneConfig(channels=8, resolution=64, wavelet_scale=4)
    feats_j, vjp = jax.vjp(lambda p: JT.sample_triplane({"full": p}, jnp.asarray(xyz), tcfg, lbound=1.5),
                           jnp.asarray(planes, jd))
    ct = rng.standard_normal(feats_j.shape).astype(np.float32)
    ct[100:200] = 0.0  # masked samples send no gradient
    (g_j,) = vjp(jnp.asarray(ct, feats_j.dtype))
    tp = _t(planes, pd)
    feats_p = PGS.sample_points(tp, torch.from_numpy(xyz), 1.5).reshape(3000, -1)
    np.testing.assert_allclose(feats_p.detach().numpy(), np.asarray(feats_j, np.float32), rtol=0, atol=1e-5)
    (g_p,) = torch.autograd.grad(feats_p, [tp], torch.from_numpy(ct))
    assert g_p.dtype == pd
    _close(g_p.float(), g_j.astype(jnp.float32), REL[dtype])


@pytest.mark.parametrize("T", [20, 64, 576])  # the per-ray B, the proposal P, the dense 512 + 64
@pytest.mark.parametrize("order", ["port_first", "jax_first"])
@pytest.mark.parametrize("t_thresh", [0.0, 1e-4])
def test_composite_dense_grad_matches_jax(t_thresh, order, T):
    """Cotangents at all four outputs (weights_sum, depth, image, weights),
    in both call orders. With JAX's computations first, the port's first
    plain composite in a process used to come out up to 1e-4 off: torch's
    CPU exp (MKL's vector library) erred on its first call in a process
    running JAX's CPU runtime; the plain versions now take exp as exp2
    (``ops/activation.plain_exp``), ROADMAP Queue 3."""
    rng = np.random.default_rng(3)
    N = 300
    sig = (rng.random((N, T)) * 80).astype(np.float32)
    rgb = rng.random((N, T, 3)).astype(np.float32)
    dl = (rng.random((N, T)) * 0.05).astype(np.float32)
    ts = np.cumsum(dl, 1).astype(np.float32)
    mask = rng.random((N, T)) < 0.8
    cts = [rng.standard_normal(s).astype(np.float32) for s in ((N,), (N,), (N, 3), (N, T))]

    def run_port():
        tsig, trgb = _t(sig, torch.float32), _t(rgb, torch.float32)
        outs = PRM.composite_dense(tsig, trgb, torch.from_numpy(dl), torch.from_numpy(ts),
                                   torch.from_numpy(mask), t_thresh=t_thresh)
        grads = torch.autograd.grad(outs, [tsig, trgb], [torch.from_numpy(c) for c in cts])
        return [o.detach().numpy() for o in outs], grads

    def run_jax():
        outs, vjp = jax.vjp(lambda s, c: JRM.composite_dense(s, c, jnp.asarray(dl), jnp.asarray(ts),
                                                             jnp.asarray(mask), t_thresh=t_thresh),
                            jnp.asarray(sig), jnp.asarray(rgb))
        return outs, vjp(tuple(jnp.asarray(c) for c in cts))

    if order == "port_first":
        (outs_p, (p_sig, p_rgb)), (outs_j, (g_sig, g_rgb)) = run_port(), run_jax()
    else:
        (outs_j, (g_sig, g_rgb)), (outs_p, (p_sig, p_rgb)) = run_jax(), run_port()
    for a, b in zip(outs_p, outs_j):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    _close(p_sig, g_sig, 1e-4)
    _close(p_rgb, g_rgb, 1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_wavelet_l1_grad_matches_jax_at_zero(weighted):
    tcfg_kw = dict(channels=4, resolution=64, wavelet_scale=8)
    cj, cp = JT.TriplaneConfig(**tcfg_kw), PT.TriplaneConfig(**tcfg_kw)
    rng = np.random.default_rng(4)
    b = cj.base_resolution
    enc = {"base": rng.standard_normal((3, 4, b, b)).astype(np.float32), "wavelets": {}}
    for i, s in enumerate(cj.yh_sizes):
        v = rng.standard_normal((3, 4, 3, s, s)).astype(np.float32)
        v[rng.random(v.shape) < 0.5] = 0.0  # zero coefficients, as at initialisation
        enc["wavelets"][f"level_{i}"] = v
    jenc = jax.tree.map(jnp.asarray, enc)
    reg_j, g_j = jax.value_and_grad(lambda e: JT.wavelet_l1(e, cj, weighted))(jenc)
    penc = params_from_jax({"encoder": enc, "sigma_net": {}, "color_net": {}}, device="cpu")["encoder"]
    leaves = [penc["wavelets"][k].requires_grad_(True) for k in sorted(penc["wavelets"])]
    reg_p = PT.wavelet_l1(penc, cp, weighted)
    np.testing.assert_allclose(float(reg_p.detach()), float(reg_j), rtol=1e-6)
    for got, k in zip(torch.autograd.grad(reg_p, leaves), sorted(penc["wavelets"])):
        ref = np.asarray(g_j["wavelets"][k])
        zero = enc["wavelets"][k] == 0
        assert (ref[zero] > 0).all()  # JAX: d|x|/dx = +1 at x = 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-12)
