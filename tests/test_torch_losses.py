"""The loss library and the Morton codes: the PyTorch port against the JAX
package (CPU).

Tolerances: every loss's value within 1e-6 relative, and its gradient in
each input within 1e-6 of that gradient's largest entry (float32, the same
formula; an entry's division and the mean's scale may round in another
order, 3e-6 of that entry at most); the O(N) distortion loss also
against the O(N^2) double sum within 1e-4 relative (``test_extras.py``'s
bound); Morton codes, their inverse and packbits bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trinerflet_tpu.ops import losses as JL
from trinerflet_tpu.ops import morton as JM
from trinerflet_tpu_torch.ops import losses as PL
from trinerflet_tpu_torch.ops import morton as PM


def _pair(seed, shape, zero_frac=0.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    if zero_frac:  # ties (d = 0) and zero targets: |x|'s gradient at 0
        k = rng.random(shape) < zero_frac
        a[k] = b[k]
        b[rng.random(shape) < zero_frac] = 0.0
    return a, b


def _check(jfn, pfn, arrays, **kw):
    jv, jg = jax.value_and_grad(lambda *xs: jfn(*xs, **kw), argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    pv = pfn(*ts, **kw)
    pg = torch.autograd.grad(pv, ts)
    np.testing.assert_allclose(float(pv.detach()), float(jv), rtol=1e-6)
    for g, j in zip(pg, jg):
        j = np.asarray(j)
        assert np.abs(g.numpy() - j).max() <= 1e-6 * np.abs(j).max()


@pytest.mark.parametrize("seed", [0, 1])
def test_mape_matches_jax(seed):
    _check(JL.mape_loss, PL.mape_loss, _pair(seed, (64, 3), 0.1))


@pytest.mark.parametrize("delta", [0.1, 0.5, 2.0])
def test_huber_matches_jax(delta):
    _check(JL.huber_loss, PL.huber_loss, _pair(2, (128, 3), 0.1), delta=delta)


@pytest.mark.parametrize("T", [1, 16, 64])
def test_distortion_loss_matches_jax_and_the_quadratic_sum(T):
    rng = np.random.default_rng(3)
    N = 8
    w = (rng.random((N, T)) * 0.1).astype(np.float32)
    m = np.sort(rng.random((N, T)), -1).astype(np.float32)
    iv = (rng.random((N, T)) * 0.02).astype(np.float32)
    _check(JL.eff_distortion_loss, PL.eff_distortion_loss, (w, m, iv))
    fast = float(PL.eff_distortion_loss(*(torch.from_numpy(a) for a in (w, m, iv))))
    w64, m64 = w.astype(np.float64), m.astype(np.float64)
    ref = sum(np.sum(w64[n][:, None] * w64[n][None, :] * np.abs(m64[n][:, None] - m64[n][None, :]))
              + (w64[n] ** 2 * iv[n]).sum() / 3.0 for n in range(N)) / N
    np.testing.assert_allclose(fast, ref, rtol=1e-4)


EDGES = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1023, 1023, 1023], [512, 511, 1],
                  [1024, 0, 2047], [-1, 5, 7], [2**31 - 1, -2**31, 3]], np.int32)


def test_morton_codes_match_jax_bit_for_bit():
    rng = np.random.default_rng(4)
    coords = np.concatenate([rng.integers(0, 1024, (5000, 3)).astype(np.int32), EDGES])
    got = PM.morton3d(torch.from_numpy(coords))
    want = np.asarray(JM.morton3d(jnp.asarray(coords)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    inside = coords[:5005]
    np.testing.assert_array_equal(PM.morton3d_invert(got[:5005]).numpy(), inside)
    assert int(PM.morton3d(torch.tensor([[7, 7, 7]], dtype=torch.int32))[0]) == 511


def test_morton_invert_matches_jax_bit_for_bit():
    rng = np.random.default_rng(5)
    codes = np.concatenate([rng.integers(-2**31, 2**31 - 1, 5000, dtype=np.int64).astype(np.int32),
                            np.array([0, 1, 2**30 - 1, 2**31 - 1, -1, -2**31], np.int32)])
    got = PM.morton3d_invert(torch.from_numpy(codes).reshape(2, -1))
    want = np.asarray(JM.morton3d_invert(jnp.asarray(codes).reshape(2, -1)))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("thresh", [0.0, 0.3, 0.999])
def test_packbits_matches_jax_bit_for_bit(thresh):
    rng = np.random.default_rng(6)
    grid = rng.random((3, 5, 64)).astype(np.float32)
    grid[0, 0, :8] = [0.5, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.5]
    got = PM.packbits(torch.from_numpy(grid), thresh)
    want = np.asarray(JM.packbits(jnp.asarray(grid), thresh))
    assert got.dtype == torch.uint8 and got.shape == (3, 5, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    if thresh == 0.3:
        assert got[0, 0, 0] == 0b10000101
