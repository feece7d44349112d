"""Parity of the PyTorch port's wavelet ops with the JAX package (CPU).

Inputs come from numpy and go to both packages. Tolerances:
* float32: atol 1e-5 -- both sum the same products in float32, in another
  order (the JAX package as a banded matmul, the port tap by tap); at the
  magnitudes here (|x| < 10) that is a few float32 ulps.
* bfloat16: both round at the same points (after each 1-D operator and each
  ``lo + hi`` add, taps pre-rounded to bf16); only the float32 summation
  order differs, which can move a value across a bf16 rounding boundary.
  Each output must lie within one bf16 ulp of the JAX value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trinerflet_tpu.ops import wavelets as JW
from trinerflet_tpu_torch.ops import wavelets as PW

WAVELETS = ("haar", "bior2.2", "bior2.6", "bior4.4", "bior6.8")


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("name", WAVELETS)
def test_filter_bank_and_sizes_match_jax(name):
    for a, b in zip(PW.filter_bank(name), JW.filter_bank(name)):
        np.testing.assert_array_equal(a, b)
    assert PW.synthesis_pads(name) == JW.synthesis_pads(name)
    assert PW.idwt_pad(name) == JW.idwt_pad(name)
    for n in (5, 16, 33, 64):
        assert PW.dwt_output_size(n, name) == JW.dwt_output_size(n, name)
        assert PW.idwt_output_size(n, name) == JW.idwt_output_size(n, name)
    for res, lv, gate in ((64, 2, 0), (512, 3, 0), (1024, 4, 0), (256, 3, 40)):
        assert PW.wavelet_pyramid_shapes(res, lv, name, gate) == \
            JW.wavelet_pyramid_shapes(res, lv, name, gate)


def test_full_width_pyramid_shapes():
    # the serving config: 1024^2 planes, bior6.8, wavelet_scale 16
    assert PW.wavelet_pyramid_shapes(1024, 4, "bior6.8") == (64, [64, 128, 256, 512])


def test_bf16_taps_equal_jax_operator_entries():
    # the JAX package rounds its banded operator (float64) to bf16; the port
    # rounds the taps themselves -- the same values must come out
    n = 12
    g0, g1 = PW.synthesis_taps("bior6.8", torch.bfloat16)
    S0, S1 = JW._synthesis_operator(n, "bior6.8")
    for S, g in ((S0, g0), (S1, g1)):
        q = np.asarray(jnp.asarray(S, jnp.bfloat16).astype(jnp.float32))
        nz = q[S != 0]
        assert set(np.unique(nz).tolist()) <= set(g.tolist())


def _inputs(seed, n, shape_yl=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    yl = rng.standard_normal(shape_yl or (2, 3, n, n)).astype(dtype)
    yh = (0.5 * rng.standard_normal((2, 3, 3, n, n))).astype(dtype)
    return yl, yh


@pytest.mark.parametrize("name", WAVELETS)
def test_idwt2d_f32_matches_jax(name):
    yl, yh = _inputs(0, 20)
    ref = np.asarray(JW.idwt2d(jnp.asarray(yl), jnp.asarray(yh), name))
    got = PW.idwt2d(torch.from_numpy(yl), torch.from_numpy(yh), name).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ("bior6.8", "bior4.4", "haar"))
def test_idwt2d_bf16_matches_jax_within_one_ulp(name):
    yl, yh = _inputs(1, 24)
    jyl, jyh = jnp.asarray(yl, jnp.bfloat16), jnp.asarray(yh, jnp.bfloat16)
    ref = np.asarray(JW.idwt2d(jyl, jyh, name).astype(jnp.float32))
    got = PW.idwt2d(torch.from_numpy(yl).to(torch.bfloat16),
                    torch.from_numpy(yh).to(torch.bfloat16), name)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - ref) <= bf16_ulp(ref))


def test_idwt2d_crops_trailing_lowpass_like_jax():
    # lowpass one larger than the detail bands: the trailing row/col is
    # dropped (pytorch_wavelets' behaviour, reproduced on purpose)
    yl, yh = _inputs(2, 15, shape_yl=(2, 3, 16, 16))
    ref = np.asarray(JW.idwt2d(jnp.asarray(yl), jnp.asarray(yh), "bior6.8"))
    got = PW.idwt2d(torch.from_numpy(yl), torch.from_numpy(yh), "bior6.8").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        PW.idwt2d(torch.zeros(1, 1, 18, 18), torch.zeros(1, 1, 3, 15, 15))


@pytest.mark.parametrize("name", ("bior6.8", "haar"))
def test_dwt2d_matches_jax_and_reconstructs(name):
    """The analysis level (plain; sizing and tests only): equal to the JAX
    package's to float32 summation order (atol 1e-5), and its inverse is
    ``idwt2d`` away from the zero-padded borders (atol 1e-4)."""
    x = np.random.default_rng(4).standard_normal((2, 3, 40, 40)).astype(np.float32)
    jyl, jyh = JW.dwt2d(jnp.asarray(x), name)
    pyl, pyh = PW.dwt2d(torch.from_numpy(x), name)
    assert pyl.shape == jyl.shape and pyh.shape == jyh.shape
    np.testing.assert_allclose(pyl.numpy(), np.asarray(jyl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pyh.numpy(), np.asarray(jyh), rtol=0, atol=1e-5)
    rec = PW.idwt2d(pyl, pyh, name).numpy()
    L = len(PW.filter_bank(name)[0])
    c = (rec.shape[-1] - 40) // 2  # the reconstruction's border offset
    np.testing.assert_allclose(rec[..., c + L : c + 40 - L, c + L : c + 40 - L],
                               x[..., L : 40 - L, L : 40 - L], rtol=0, atol=1e-4)
