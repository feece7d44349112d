"""Parity of the PyTorch port's NeRF field with the JAX package (CPU).

Both fields read the same planes (built by the JAX package and carried over)
and the same numpy-made MLP weights. Tolerances:
* float32: rtol 1e-5 on sigma (exp of the density head), atol 1e-6 on
  rgb -- the matmuls sum in another order.
* bf16: both round every layer's output to bf16; a float32 summation-order
  difference can move one value across a bf16 boundary (2^-8 relative) and
  the next layer carries it on. sigma = exp(h) turns an absolute error in h
  into a relative one, so sigma is held to rtol 0.05 and rgb (a sigmoid) to
  atol 0.02, with at least 95% of values equal to float32 precision.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu_torch.carry import params_from_jax
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.models import triplane as PT
from trinerflet_tpu_torch.ops.activation import trunc_exp

DIMS = dict(channels=8, resolution=64, wavelet_scale=4)


def _params(seed, cfg):
    rng = np.random.default_rng(seed)
    tri = cfg.triplane
    b = tri.base_resolution

    def mlp(dims):
        return {f"w{i}": rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(np.float32) / np.sqrt(dims[i])
                for i in range(len(dims) - 1)}

    return {
        "encoder": {"base": (0.3 * rng.standard_normal((3, tri.channels, b, b))).astype(np.float32),
                    "wavelets": {f"level_{i}": (0.1 * rng.standard_normal((3, tri.channels, 3, s, s))).astype(np.float32)
                                 for i, s in enumerate(tri.yh_sizes)}},
        "sigma_net": mlp([tri.feature_dim, 64, 16]),
        "color_net": mlp([16 + 15, 64, 64, 3]),
    }


def _jax_tree(t):
    return {k: _jax_tree(v) for k, v in t.items()} if isinstance(t, dict) else jnp.asarray(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_density_and_color_match_jax(dtype):
    kw = dict(bound=1.5, compute_dtype=dtype, plane_dtype=dtype)
    cj = JN.NeRFConfig(triplane=JT.TriplaneConfig(**DIMS), **kw)
    cp = PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS), **kw)
    p = _params(0, cj)
    jf, pf = JN.NeRFField(cj), PN.NeRFField(cp)
    jparams = _jax_tree(p)
    jplanes = jf.build_planes(jparams)
    pparams = params_from_jax(p, device="cpu")
    pplanes = {"full": torch.from_numpy(np.array(jplanes["full"].astype(jnp.float32)))
               .to(getattr(torch, dtype))}
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.5, 1.5, (2000, 3)).astype(np.float32)
    d = rng.standard_normal((2000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    js, jg = jf.density(jparams, jplanes, jnp.asarray(x))
    ps, pg = pf.density(pparams, pplanes, torch.from_numpy(x))
    jrgb = np.asarray(jf.color(jparams, jnp.asarray(d), jg))
    prgb = pf.color(pparams, torch.from_numpy(d), pg).numpy()
    js, ps = np.asarray(js), ps.numpy()
    assert ps.dtype == np.float32 and prgb.shape == (2000, 3)
    if dtype == "float32":
        np.testing.assert_allclose(ps, js, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(prgb, jrgb, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(ps, js, rtol=0.05)
        np.testing.assert_allclose(prgb, jrgb, rtol=0, atol=0.02)
        assert np.mean(np.isclose(ps, js, rtol=1e-6)) >= 0.95
        assert np.mean(np.isclose(prgb, jrgb, rtol=1e-6)) >= 0.95


def test_trunc_exp_forward_and_clamped_grad():
    x = torch.tensor([-30.0, 0.0, 2.0, 30.0], requires_grad=True)
    y = trunc_exp(x)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.exp([-30.0, 0.0, 2.0, 30.0]), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.exp([-15.0, 0.0, 2.0, 15.0]), rtol=1e-6)
    xb = torch.tensor([1.0], dtype=torch.bfloat16, requires_grad=True)
    yb = trunc_exp(xb)
    yb.backward(torch.ones(1))
    assert yb.dtype == torch.float32 and xb.grad.dtype == torch.bfloat16


def test_unported_field_options_raise():
    """k-planes and the background network are ported (their parity tests
    are in tests/test_torch_variants.py), and so are the SR snapshot
    planes: a field with ``low_res_scale`` 2 samples ``low_res`` and
    ``full`` as the JAX field does (float32 tolerances above). What still
    raises is an encoding the JAX package does not define."""
    assert PN.NeRFField(PN.NeRFConfig(encoding="k_planes")).cfg.in_dim == 48
    cfg = PN.NeRFConfig(encoding="k_planes", bg_radius=2.0)
    params = PN.init_nerf_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert params["bg_net"]["w0"].shape == (cfg.in_dim_dir + 2, cfg.hidden_dim_bg)
    cj = JN.NeRFConfig(triplane=JT.TriplaneConfig(**DIMS, low_res_scale=2), bound=1.5)
    cp = PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS, low_res_scale=2), bound=1.5)
    p = _params(4, cj)
    jf, pf = JN.NeRFField(cj), PN.NeRFField(cp)
    jparams, pparams = _jax_tree(p), params_from_jax(p, device="cpu")
    jplanes, pplanes = jf.build_planes(jparams), pf.build_planes(pparams)
    assert set(pplanes) == set(jplanes) == {"full", "low_res"}
    assert tuple(pplanes["low_res"].shape) == (3, 32, 32, 8)
    x = np.random.default_rng(5).uniform(-1.5, 1.5, (1500, 3)).astype(np.float32)
    for mode in ("low_res", "full"):
        js, jg = jf.density(jparams, jplanes, jnp.asarray(x), resolution_mode=mode)
        ps, pg = pf.density(pparams, pplanes, torch.from_numpy(x), resolution_mode=mode)
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6, err_msg=mode)
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=0, atol=1e-5, err_msg=mode)
    low, full = (pf.density(pparams, pplanes, torch.from_numpy(x), resolution_mode=m)[0]
                 for m in ("low_res", "full"))
    assert not torch.equal(low, full)
    with pytest.raises(ValueError, match="unknown encoding"):
        PN.NeRFField(PN.NeRFConfig(encoding="bogus"))


def test_params_from_jax_keeps_layout_and_rejects_unported():
    cj = JN.NeRFConfig(triplane=JT.TriplaneConfig(**DIMS))
    p = _params(3, cj)
    got = params_from_jax(p, device="cpu")
    for k in ("sigma_net", "color_net"):
        for n, w in p[k].items():
            np.testing.assert_array_equal(got[k][n].numpy(), w)
    np.testing.assert_array_equal(got["encoder"]["base"].numpy(), p["encoder"]["base"])
    assert got["encoder"]["wavelets"].keys() == p["encoder"]["wavelets"].keys()
    with pytest.raises(KeyError):
        params_from_jax({"encoder": p["encoder"], "sigma_net": {}}, device="cpu")
    got = params_from_jax(dict(p, encoder=dict(p["encoder"], rotation=np.ones(4, np.float32))), device="cpu")
    np.testing.assert_array_equal(got["encoder"]["rotation"].numpy(), np.ones(4))  # the learned rotation carries
    with pytest.raises(KeyError, match="skew"):
        params_from_jax(dict(p, encoder=dict(p["encoder"], skew=np.ones(4))), device="cpu")
