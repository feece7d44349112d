"""Parity of the PyTorch port's triplane encoder with the JAX package (CPU).

Parameters are made with numpy (wavelet levels filled with non-zero values
so the detail bands are exercised) and carried into the port with
``params_from_jax``. Tolerances:
* float32 planes: atol 2e-5 -- two synthesis levels, each summing the same
  products in another order (banded matmul vs taps).
* bf16 planes: both packages round at the same points; a float32 ordering
  difference can move one value across a bf16 boundary at level 1, and the
  next level spreads that ulp over its taps, so atol = 2^-6 x max|plane|
  (a few bf16 ulps at the plane's scale).
* sampling of the same planes: atol 1e-6 (float32 bilinear weights).
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

DIMS = dict(channels=8, resolution=64, wavelet_scale=4)


def _enc(seed, cfg):
    rng = np.random.default_rng(seed)
    b = cfg.base_resolution
    return {
        "base": (0.1 * rng.standard_normal((3, cfg.channels, b, b))).astype(np.float32),
        "wavelets": {f"level_{i}": (0.05 * rng.standard_normal((3, cfg.channels, 3, s, s))).astype(np.float32)
                     for i, s in enumerate(cfg.yh_sizes)},
    }


def _jax_tree(t):
    return {k: _jax_tree(v) for k, v in t.items()} if isinstance(t, dict) else jnp.asarray(t)


def _torch_tree(t):
    return {k: _torch_tree(v) for k, v in t.items()} if isinstance(t, dict) else torch.from_numpy(t)


def test_config_shapes_match_jax():
    for kw in (DIMS, dict(channels=16, resolution=1024, wavelet_scale=16),
               dict(channels=4, resolution=256, wavelet_scale=8, current_scale=2)):
        j, p = JT.TriplaneConfig(**kw), PT.TriplaneConfig(**kw)
        assert (p.levels, p.base_resolution, p.yh_sizes, p.num_learnable_levels) == \
            (j.levels, j.base_resolution, j.yh_sizes, j.num_learnable_levels)


@pytest.mark.parametrize("max_res", [-1, 32])
def test_build_planes_f32_matches_jax(max_res):
    cfg_j, cfg_p = JT.TriplaneConfig(**DIMS), PT.TriplaneConfig(**DIMS)
    enc = _enc(0, cfg_j)
    ref = np.asarray(JT.build_planes(_jax_tree(enc), cfg_j, max_res)["full"])
    got = PT.build_planes(params_from_jax({"encoder": enc, "sigma_net": {}, "color_net": {}},
                                          device="cpu")["encoder"], cfg_p, max_res)["full"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)


def test_frozen_levels_are_zero_like_jax():
    kw = dict(DIMS, current_scale=2)  # top level frozen at zero
    cfg_j, cfg_p = JT.TriplaneConfig(**kw), PT.TriplaneConfig(**kw)
    enc = _enc(1, cfg_j)
    enc["wavelets"] = {"level_0": enc["wavelets"]["level_0"]}
    ref = np.asarray(JT.build_planes(_jax_tree(enc), cfg_j)["full"])
    got = PT.build_planes({"base": torch.from_numpy(enc["base"]),
                           "wavelets": {"level_0": torch.from_numpy(enc["wavelets"]["level_0"])}},
                          cfg_p)["full"]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)


def test_build_planes_bf16_matches_jax():
    # through the field, which casts the pyramid to bf16 before the ladder
    ncfg_j = JN.NeRFConfig(triplane=JT.TriplaneConfig(**DIMS), plane_dtype="bfloat16")
    ncfg_p = PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS), plane_dtype="bfloat16")
    enc = _enc(2, ncfg_j.triplane)
    ref = np.asarray(JN.NeRFField(ncfg_j).build_planes({"encoder": _jax_tree(enc)})["full"]
                     .astype(jnp.float32))
    got = PN.NeRFField(ncfg_p).build_planes(
        params_from_jax({"encoder": enc, "sigma_net": {}, "color_net": {}}, device="cpu"))["full"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=2.0**-6 * np.abs(ref).max())


@pytest.mark.parametrize("plane_dtype", ["float32", "bfloat16"])
def test_sample_triplane_matches_jax(plane_dtype):
    rng = np.random.default_rng(3)
    planes = rng.standard_normal((3, 64, 64, 8)).astype(np.float32)
    jp = jnp.asarray(planes, getattr(jnp, plane_dtype))
    pp = torch.from_numpy(planes).to(getattr(torch, plane_dtype))
    pts = rng.uniform(-1.6, 1.6, (3000, 3)).astype(np.float32)
    cfg_j, cfg_p = JT.TriplaneConfig(**DIMS), PT.TriplaneConfig(**DIMS)
    ref = np.asarray(JT.sample_triplane({"full": jp}, jnp.asarray(pts), cfg_j, lbound=1.5))
    got = PT.sample_triplane({"full": pp}, torch.from_numpy(pts), cfg_p, lbound=1.5)
    assert got.shape == ref.shape == (3000, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_unported_variants_raise():
    """The zoom-in planes and the learned transform are ported (parity in
    tests/test_torch_variants.py); the SR snapshot planes still raise."""
    cfg = PT.TriplaneConfig(channels=4, resolution=64, wavelet_scale=4, upscale_ratio_bound=0.5,
                            learned_rotation=True, lbound_auto_scale=True)
    params = PT.init_triplane_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in params["upscale"].items()} == {
        "level_0": (3, 4, 3, 32, 32), "level_1": (3, 4, 3, 32, 32)}
    assert params["rotation"].tolist() == [1.0, 0.0, 0.0, 0.0] and params["lbound_scale"].item() == 1.0
    _snapshot_planes_match_jax()


def _snapshot_planes_match_jax():
    """The SR snapshot planes against JAX's (float32 atol 2e-5, as above),
    whole, stopped at ``max_resolution``, and with ``high_res`` on a side
    the ladder never has (it is then ``full``); ``modes`` builds only as far
    as the finest plane it names and gives the same bits as the whole build."""
    for kw, max_res in ((dict(low_res_scale=4, high_res_scale=2), -1),
                        (dict(low_res_scale=4, high_res_scale=2), 32),
                        (dict(low_res_scale=2, high_res_scale=64), -1)):
        cj = JT.TriplaneConfig(channels=8, resolution=64, wavelet_scale=8, **kw)
        cp = PT.TriplaneConfig(channels=8, resolution=64, wavelet_scale=8, **kw)
        enc = _enc(6, cj)
        jp = JT.build_planes(_jax_tree(enc), cj, max_resolution=max_res)
        pp = PT.build_planes(_torch_tree(enc), cp, max_resolution=max_res)
        assert set(pp) == set(jp), (kw, max_res)
        for k in jp:
            assert tuple(pp[k].shape) == jp[k].shape, (k, kw, max_res)
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=2e-5,
                                       err_msg=f"{k} {kw} {max_res}")
    penc = _torch_tree(enc)
    whole = PT.build_planes(penc, cp)
    calls = []
    real = PT.W.idwt2d
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PT.W, "idwt2d", lambda *a: calls.append(a[0].shape[-1]) or real(*a))
        low = PT.build_planes(penc, cp, modes=("low_res",))
    assert set(low) == {"low_res"} and len(calls) == 2  # two of the three levels: 8 -> 16 -> 32
    assert torch.equal(low["low_res"], whole["low_res"])
    assert torch.equal(PT.build_planes(penc, cp, modes=("high_res",))["high_res"], whole["full"])
