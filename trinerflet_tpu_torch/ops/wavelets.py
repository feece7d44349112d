"""2D DWT of the wavelet triplane (port of ``trinerflet_tpu/ops/wavelets.py``).

The filter banks are DERIVED here in numpy float64 (the same construction as
the JAX package, copied so this package never imports it) and perfect
reconstruction is asserted when a bank is first built.

``idwt2d`` is one synthesis level, differentiable in ``yl`` and ``yh``: its
backward is the adjoint (a stride-2 analysis-shaped correlation with the
same taps). On CUDA tensors it launches kernel K4 forward and adjoint
(``kernels/csrc/idwt.cu``); on CPU tensors it runs ``idwt2d_plain`` /
``idwt2d_adjoint_plain``, which reproduce the JAX package's rounding points:
each 1-D operator (and its adjoint) and each ``lo + hi`` add rounds to the
plane dtype, with the filter taps pre-rounded to that dtype. ``dwt2d``
(analysis) serves sizing and tests only.
"""

from __future__ import annotations

import ctypes
import functools
from math import comb, floor, sqrt
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..kernels import _build

__all__ = [
    "filter_bank",
    "synthesis_pads",
    "idwt_pad",
    "dwt_output_size",
    "idwt_output_size",
    "wavelet_pyramid_shapes",
    "synthesis_taps",
    "dwt2d",
    "idwt2d",
    "idwt2d_plain",
    "idwt2d_adjoint_plain",
    "SUPPORTED_WAVELETS",
]

SUPPORTED_WAVELETS = ("haar", "bior2.2", "bior2.6", "bior4.4", "bior6.8")

# per-side pad that makes one inverse level exactly double the resolution:
# out = 2*(R + 2*pad) - L + 2 == 2R  <=>  pad = (L - 2) / 4
_IDWT_PAD = {"bior6.8": 4, "bior2.6": 3, "bior4.4": 2, "bior2.2": 1, "haar": 0}


# ---------------------------------------------------------------------------
# Filter construction (numpy, float64)
# ---------------------------------------------------------------------------

def _y_poly_to_z(p_y: np.ndarray) -> np.ndarray:
    """Polynomial in y = sin^2(w/2) = (2 - z - 1/z)/4 -> centered symmetric
    Laurent coefficients in z."""
    y = np.array([-0.25, 0.5, -0.25], dtype=complex)
    out = np.array([p_y[0]], dtype=complex)
    acc = np.array([1.0 + 0j])
    for k in range(1, len(p_y)):
        acc = np.convolve(acc, y)
        term = p_y[k] * acc
        n = max(len(out), len(term))

        def _pad(a, n=n):
            d = (n - len(a)) // 2
            return np.pad(a, (d, d))

        out = _pad(out) + _pad(term)
    return out


def _poly_from_roots(roots: Sequence[complex]) -> np.ndarray:
    p = np.array([1.0 + 0j])
    for r in roots:
        p = np.convolve(p, np.array([-r, 1.0 + 0j]))
    return p


def _cos_window(n: int) -> np.ndarray:
    return np.array([comb(n, k) for k in range(n + 1)], dtype=float) / 2.0**n


def _spline_pair(n_syn: int, n_ana: int) -> Tuple[np.ndarray, np.ndarray]:
    """CDF B-spline biorthogonal pair."""
    rec_lo = _cos_window(n_syn) * sqrt(2.0)
    q = (n_syn + n_ana) // 2
    p_y = np.array([comb(q - 1 + k, k) for k in range(q)], dtype=float)
    qa = _y_poly_to_z(p_y.astype(complex))
    dec_lo = sqrt(2.0) * np.convolve(_cos_window(n_ana), qa.real)
    return dec_lo, rec_lo


def _factored_pair(p: int, n_syn: int, n_ana: int, syn_pair_idx: int) -> Tuple[np.ndarray, np.ndarray]:
    """Near-orthogonal pair (bior4.4 / bior6.8): factor the order-p half-band
    polynomial's roots between analysis and synthesis."""
    half_band = np.array([comb(p - 1 + k, k) for k in range(p)], dtype=float)
    roots = np.roots(half_band[::-1])
    real = sorted((r for r in roots if abs(r.imag) < 1e-9), key=lambda r: r.real)
    pairs: List[Tuple[complex, complex]] = []
    used = set()
    croots = [r for r in roots if abs(r.imag) >= 1e-9]
    for i, r in enumerate(croots):
        if i in used:
            continue
        for j in range(i + 1, len(croots)):
            if j not in used and abs(croots[j] - np.conj(r)) < 1e-8:
                pairs.append((r, croots[j]))
                used.add(i)
                used.add(j)
                break
    if real:  # bior4.4: the single real root goes to synthesis
        syn_roots = [real[0]]
    else:  # bior6.8: one conjugate pair goes to synthesis
        pairs.sort(key=lambda pr: pr[0].real)
        syn_roots = list(pairs[syn_pair_idx])
    ana_roots = [r for r in roots if not any(abs(r - s) < 1e-9 for s in syn_roots)]
    qs = _y_poly_to_z(_poly_from_roots(syn_roots))
    qa = _y_poly_to_z(_poly_from_roots(ana_roots))
    rec_lo = np.convolve(_cos_window(n_syn), qs.real)
    dec_lo = np.convolve(_cos_window(n_ana), qa.real)
    rec_lo = rec_lo / rec_lo.sum() * sqrt(2.0)
    dec_lo = dec_lo / dec_lo.sum() * sqrt(2.0)
    return dec_lo, rec_lo


def _pad_to_common_even(dec_lo: np.ndarray, rec_lo: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad both lowpass filters to one even length, symmetry centers
    aligned (odd remainder in front)."""
    L = max(len(dec_lo), len(rec_lo))
    if L % 2:
        L += 1

    def _pad(f):
        extra = L - len(f)
        front = (extra + 1) // 2
        return np.pad(f, (front, extra - front))

    return _pad(dec_lo), _pad(rec_lo)


def _shift(f: np.ndarray, s: int) -> np.ndarray:
    """Shift right by ``s`` (negative = left), zero fill, same length."""
    out = np.zeros_like(f)
    if s >= 0:
        out[s:] = f[: len(f) - s]
    else:
        out[:s] = f[-s:]
    if abs(np.abs(out).sum() - np.abs(f).sum()) >= 1e-12:
        raise ValueError("filter shift dropped taps")
    return out


@functools.lru_cache(maxsize=None)
def filter_bank(name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(dec_lo, dec_hi, rec_lo, rec_hi)`` float64, one common even length.

    Analysis = zero pad, convolution with the dec filters, stride-2 at phase
    0; synthesis = stride-2 transposed convolution with the rec filters. For
    odd natural support (the bior family) the high-pass pair carries a
    one-tap shift and synthesis crops asymmetrically (``synthesis_pads``).
    """
    if name not in SUPPORTED_WAVELETS:
        raise ValueError(f"unsupported wavelet {name!r}; options: {SUPPORTED_WAVELETS}")
    if name == "haar":
        dec_lo = rec_lo = np.array([1.0, 1.0]) / sqrt(2.0)
    elif name == "bior2.2":
        dec_lo, rec_lo = _spline_pair(2, 2)
    elif name == "bior2.6":
        dec_lo, rec_lo = _spline_pair(2, 6)
    elif name == "bior4.4":
        dec_lo, rec_lo = _factored_pair(4, 4, 4, 0)
    else:  # bior6.8
        dec_lo, rec_lo = _factored_pair(7, 6, 8, 1)
    odd_support = len(dec_lo) % 2 == 1
    dec_lo, rec_lo = _pad_to_common_even(dec_lo, rec_lo)
    L = len(dec_lo)
    signs = (-1.0) ** np.arange(L)
    if odd_support:
        dec_hi = signs * _shift(rec_lo, 1)
        rec_hi = signs * _shift(dec_lo, -1)
    else:
        dec_hi = signs * rec_lo
        rec_hi = -signs * dec_lo
    _verify_pr(dec_lo, dec_hi, rec_lo, rec_hi, synthesis_pads(name))
    return dec_lo, dec_hi, rec_lo, rec_hi


@functools.lru_cache(maxsize=None)
def synthesis_pads(name: str) -> Tuple[int, int]:
    """(left, right) padding of the dilated synthesis correlation; sums to 2
    so that out = 2N - L + 2."""
    if name == "haar":
        return (1, 1)
    return (0, 2)


def _verify_pr(dec_lo, dec_hi, rec_lo, rec_hi, pads) -> None:
    """1D numpy perfect-reconstruction self-check of the full pipeline."""
    L = len(dec_lo)
    rng = np.random.default_rng(0)
    N = 16 * L
    x = np.zeros(N)
    x[3 * L : N - 3 * L] = rng.standard_normal(N - 6 * L)

    def _ana(f):
        outsize = floor((N + L - 1) / 2)
        p_total = 2 * outsize - N + L - 2
        xp = np.pad(x, (p_total // 2, p_total - p_total // 2))
        return np.convolve(xp, f, mode="valid")[::2]

    lo, hi = _ana(dec_lo), _ana(dec_hi)

    def _up(a):
        u = np.zeros(2 * len(a) - 1)
        u[::2] = a
        return u

    y = np.convolve(_up(lo), rec_lo) + np.convolve(_up(hi), rec_hi)
    a = (L - 2) + (1 - pads[0])  # front crop implied by the synthesis padding
    y = y[a : a + 2 * len(lo) - L + 2]
    m = min(len(y), N)
    yc = y[(len(y) - m) // 2 :][:m]
    xc = x[(N - m) // 2 :][:m]
    err = np.abs(yc[3 * L : m - 3 * L] - xc[3 * L : m - 3 * L]).max()
    if err >= 1e-8:
        raise ValueError(f"filter bank failed perfect reconstruction (err={err})")


def idwt_pad(name: str) -> int:
    """Per-side pad that makes one inverse level exactly double resolution."""
    pad = (len(filter_bank(name)[0]) - 2) // 4
    if pad != _IDWT_PAD[name]:
        raise ValueError(f"idwt pad {pad} != table {_IDWT_PAD[name]} for {name}")
    return pad


# ---------------------------------------------------------------------------
# Size arithmetic
# ---------------------------------------------------------------------------

def dwt_output_size(n: int, name: str) -> int:
    L = len(filter_bank(name)[0])
    return floor((n + L - 1) / 2)


def idwt_output_size(n: int, name: str) -> int:
    L = len(filter_bank(name)[0])
    return 2 * n - L + 2


def wavelet_pyramid_shapes(
    resolution: int, levels: int, name: str, base_resolution_gate: int = 0,
) -> Tuple[int, List[int]]:
    """Shape arithmetic of the dummy forward-DWT init: from ``resolution``
    apply ``levels`` forward DWTs, cropping ``pad`` per side while the
    lowpass is above ``base_resolution_gate``. Returns ``(base, yh_sizes)``,
    ``yh_sizes`` coarsest first (the order the inverse pyramid reads them)."""
    pad = idwt_pad(name)
    sizes = []
    n = resolution
    for _ in range(levels):
        n_out = dwt_output_size(n, name)
        if pad > 0 and n_out > base_resolution_gate:
            n_out -= 2 * pad
        sizes.append(n_out)
        n = n_out
    return n, sizes[::-1]


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def synthesis_taps(name: str, dtype: torch.dtype) -> Tuple[np.ndarray, np.ndarray]:
    """``(rec_lo, rec_hi)`` as float32 arrays, rounded to ``dtype`` first
    (both packages multiply the same rounded taps: the JAX package rounds its
    operator entries straight from float64, as torch's cast does here)."""
    _, _, rec_lo, rec_hi = filter_bank(name)
    return tuple(torch.from_numpy(g).to(dtype).float().numpy() for g in (rec_lo, rec_hi))


def _synthesis_axis(x: torch.Tensor, g: np.ndarray, pads: Tuple[int, int]) -> torch.Tensor:
    """One 1-D synthesis operator along the LAST axis, in float32:
    ``out[j] = sum_i x[i] * g[j - 2i + L - 1 - pl]`` for j in [0, 2n - L + pl + pr)."""
    n = x.shape[-1]
    L = len(g)
    pl, pr = pads
    n_out = 2 * n - L + pl + pr
    full = x.new_zeros(x.shape[:-1] + (2 * n + L - 2,), dtype=torch.float32)
    x32 = x.float()
    for t in range(L):
        if g[t] != 0.0:
            full[..., t : t + 2 * n - 1 : 2] += x32 * float(g[t])
    start = L - 1 - pl
    return full[..., start : start + n_out]


def _synthesis_1d(lo, hi, g0, g1, axis: int, pads) -> torch.Tensor:
    """lo @ S0 + hi @ S1 along ``axis`` (-1 = W, -2 = H) with the JAX
    package's rounding: each product rounds to the input dtype, then the add."""
    dtype = lo.dtype
    if axis == -2:
        lo, hi = lo.transpose(-1, -2), hi.transpose(-1, -2)
    a = _synthesis_axis(lo, g0, pads).to(dtype)
    b = _synthesis_axis(hi, g1, pads).to(dtype)
    out = (a.float() + b.float()).to(dtype)
    return out.transpose(-1, -2) if axis == -2 else out


def _adjoint_axis(y: torch.Tensor, g: np.ndarray, pads: Tuple[int, int], n: int) -> torch.Tensor:
    """Adjoint of ``_synthesis_axis`` along the LAST axis, in float32:
    ``x[i] = sum_t y[2i + t - (L - 1 - pl)] * g[t]`` for i in [0, n)."""
    L = len(g)
    start = L - 1 - pads[0]
    full = y.new_zeros(y.shape[:-1] + (2 * n + L - 2,), dtype=torch.float32)
    full[..., start : start + y.shape[-1]] = y.float()
    x = y.new_zeros(y.shape[:-1] + (n,), dtype=torch.float32)
    for t in range(L):
        if g[t] != 0.0:
            x += full[..., t : t + 2 * n - 1 : 2] * float(g[t])
    return x


def _adjoint_1d(ct, g0, g1, axis: int, n: int, pads):
    """Adjoint of ``_synthesis_1d``: the cotangent of the output -> those of
    lo and hi, each rounded to the cotangent's dtype (the JAX package rounds
    where its forward cast the operator's f32 result)."""
    dtype = ct.dtype
    if axis == -2:
        ct = ct.transpose(-1, -2)
    a = _adjoint_axis(ct, g0, pads, n).to(dtype)
    b = _adjoint_axis(ct, g1, pads, n).to(dtype)
    if axis == -2:
        a, b = a.transpose(-1, -2), b.transpose(-1, -2)
    return a, b


def idwt2d_adjoint_plain(g: torch.Tensor, name: str = "bior6.8") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the K4 adjoint: the cotangent (B, C, Ho, Wo) of
    ``idwt2d_plain`` -> those of yl (B, C, H, W) and yh (B, C, 3, H, W)."""
    g0, g1 = synthesis_taps(name, g.dtype)
    pads = synthesis_pads(name)
    L = len(g0)
    H, W = (g.shape[-2] + L - sum(pads)) // 2, (g.shape[-1] + L - sum(pads)) // 2
    d_lo, d_hi = _adjoint_1d(g, g0, g1, -2, H, pads)
    d_yl, d_lh = _adjoint_1d(d_lo, g0, g1, -1, W, pads)
    d_hl, d_hh = _adjoint_1d(d_hi, g0, g1, -1, W, pads)
    return d_yl, torch.stack([d_hl, d_lh, d_hh], dim=2)


def _analysis_1d(x: torch.Tensor, f: np.ndarray, axis: int) -> torch.Tensor:
    """Zero-padded stride-2 analysis along ``axis`` (-1 = W, -2 = H) with the
    JAX package's operator: ``out[j] = sum_t x[2j + t - front] * f[L-1-t]``,
    f32 sums, rounded to x's dtype."""
    dtype = x.dtype
    if axis == -2:
        x = x.transpose(-1, -2)
    n = x.shape[-1]
    L = len(f)
    n_out = floor((n + L - 1) / 2)
    front = (2 * n_out - n + L - 2) // 2
    fq = torch.from_numpy(np.asarray(f)).to(dtype).float().numpy()
    xp = x.new_zeros(x.shape[:-1] + (2 * n_out + L,), dtype=torch.float32)
    xp[..., front : front + n] = x.float()
    out = x.new_zeros(x.shape[:-1] + (n_out,), dtype=torch.float32)
    for t in range(L):
        out += xp[..., t : t + 2 * n_out - 1 : 2] * float(fq[L - 1 - t])
    out = out.to(dtype)
    return out.transpose(-1, -2) if axis == -2 else out


def dwt2d(x: torch.Tensor, name: str = "bior6.8") -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-level 2D analysis (plain PyTorch; sizing and tests only).
    x (B, C, H, W) -> yl (B, C, H', W'), yh (B, C, 3, H', W') with bands
    (hl, lh, hh) as ``idwt2d`` reads them."""
    dec_lo, dec_hi, _, _ = filter_bank(name)
    lo_h, hi_h = _analysis_1d(x, dec_lo, -2), _analysis_1d(x, dec_hi, -2)
    ll, lh = _analysis_1d(lo_h, dec_lo, -1), _analysis_1d(lo_h, dec_hi, -1)
    hl, hh = _analysis_1d(hi_h, dec_lo, -1), _analysis_1d(hi_h, dec_hi, -1)
    return ll, torch.stack([hl, lh, hh], dim=2)


def _crop_lowpass(yl: torch.Tensor, yh: torch.Tensor) -> torch.Tensor:
    # A forward DWT of an odd-sized input reconstructs one row/col too many,
    # so the next level's lowpass can exceed its detail bands by one;
    # pytorch_wavelets' DWTInverse crops the trailing row/col in that case
    # and the reference relies on it. Reproduced on purpose.
    if yl.shape[-2] > yh.shape[-2]:
        yl = yl[..., :-1, :]
    if yl.shape[-1] > yh.shape[-1]:
        yl = yl[..., :-1]
    if yl.shape[-2:] != yh.shape[-2:]:
        raise ValueError(
            f"idwt2d: lowpass {tuple(yl.shape[-2:])} and detail "
            f"{tuple(yh.shape[-2:])} spatial sizes differ by more than one")
    return yl


def idwt2d_plain(yl: torch.Tensor, yh: torch.Tensor, name: str = "bior6.8") -> torch.Tensor:
    """Plain PyTorch single-level synthesis. yl (B, C, H, W), yh (B, C, 3, H, W)
    with bands (hl, lh, hh) -> (B, C, 2H - L + 2, 2W - L + 2)."""
    yl = _crop_lowpass(yl, yh)
    g0, g1 = synthesis_taps(name, yl.dtype)
    pads = synthesis_pads(name)
    hl, lh, hh = yh[:, :, 0], yh[:, :, 1], yh[:, :, 2]
    lo = _synthesis_1d(yl, lh, g0, g1, -1, pads)
    hi = _synthesis_1d(hl, hh, g0, g1, -1, pads)
    return _synthesis_1d(lo, hi, g0, g1, -2, pads)


class _Idwt2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, yl, yh, name):
        ctx.name = name
        if yl.is_cuda:
            return _idwt2d_cuda(yl, yh, name)
        return idwt2d_plain(yl, yh, name)

    @staticmethod
    @kernels.first_order
    def backward(ctx, g):
        if g.is_cuda:
            d_yl, d_yh = _idwt2d_adjoint_cuda(g, ctx.name)
        else:
            d_yl, d_yh = idwt2d_adjoint_plain(g, ctx.name)
        return d_yl, d_yh, None


def idwt2d(yl: torch.Tensor, yh: torch.Tensor, name: str = "bior6.8") -> torch.Tensor:
    """Single-level 2D synthesis: kernel K4 on CUDA tensors, the plain version
    on CPU tensors; differentiable (K4 adjoint / its plain version). The
    trailing-lowpass crop is a slice outside the autograd function, so its
    adjoint (zero padding) is autograd's."""
    return _Idwt2d.apply(_crop_lowpass(yl, yh), yh, name)


# ---------------------------------------------------------------------------
# K4 wrapper
# ---------------------------------------------------------------------------

_IDWT_ARGS = {
    "idwt_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2,
    "idwt_adjoint_launch": [ctypes.c_void_p] + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3,
}


def _kernel_taps(name: str, dtype: torch.dtype):
    """The bank's taps as ctypes float arrays, its length and left pad; the
    kernel is instantiated for the banks of ``SUPPORTED_WAVELETS`` only."""
    g0, g1 = synthesis_taps(name, dtype)
    L = len(g0)
    c_g0 = (ctypes.c_float * L)(*g0.tolist())
    c_g1 = (ctypes.c_float * L)(*g1.tolist())
    return c_g0, c_g1, L, synthesis_pads(name)[0]


def _check_plane_size(*shapes) -> None:
    for s in shapes:
        if s[-1] * s[-2] >= 2**31:
            raise ValueError(f"idwt2d kernel: a plane of {tuple(s[-2:])} is too large "
                             f"for its 32-bit offsets")


def _idwt2d_cuda(yl: torch.Tensor, yh: torch.Tensor, name: str) -> torch.Tensor:
    if yl.dtype not in (torch.bfloat16, torch.float32) or yh.dtype != yl.dtype:
        raise TypeError(f"idwt2d kernel takes bf16 or f32 yl/yh of one dtype, "
                        f"got {yl.dtype}/{yh.dtype}")
    if yl.dim() != 4 or yh.dim() != 5 or yh.shape[2] != 3 or yh.shape[:2] != yl.shape[:2]:
        raise ValueError(f"idwt2d kernel: bad shapes yl {tuple(yl.shape)} yh {tuple(yh.shape)}")
    if yh.device != yl.device:
        raise ValueError("idwt2d kernel: yl and yh on different devices")
    yl, yh = yl.contiguous(), yh.contiguous()
    c_g0, c_g1, L, pl = _kernel_taps(name, yl.dtype)
    B, C, H, W = yl.shape
    Wo, Ho = 2 * W - L + 2, 2 * H - L + 2
    out = torch.empty((B, C, Ho, Wo), device=yl.device, dtype=yl.dtype)
    if out.numel() == 0:
        return out
    _check_plane_size(yl.shape, out.shape)
    fn = _build.function("idwt", "idwt_launch", _IDWT_ARGS["idwt_launch"])
    _build.check(fn(_build.ptr(yl), _build.ptr(yh), B * C, H, W, int(yl.dtype == torch.bfloat16),
                    c_g0, c_g1, L, pl, _build.ptr(out), _build.stream(yl.device)), "idwt")
    kernels.launches["idwt"] += 1
    return out


def _idwt2d_adjoint_cuda(g: torch.Tensor, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    if g.dtype not in (torch.bfloat16, torch.float32) or g.dim() != 4:
        raise TypeError(f"idwt2d adjoint kernel takes a bf16 or f32 (B, C, Ho, Wo) cotangent, "
                        f"got {g.dtype} {tuple(g.shape)}")
    g = g.contiguous()
    c_g0, c_g1, L, pl = _kernel_taps(name, g.dtype)
    B, C, Ho, Wo = g.shape
    H, W = (Ho + L - 2) // 2, (Wo + L - 2) // 2
    d_yl = torch.empty((B, C, H, W), device=g.device, dtype=g.dtype)
    d_yh = torch.empty((B, C, 3, H, W), device=g.device, dtype=g.dtype)
    if d_yl.numel() == 0:
        return d_yl, d_yh
    _check_plane_size(g.shape, d_yl.shape)
    fn = _build.function("idwt", "idwt_adjoint_launch", _IDWT_ARGS["idwt_adjoint_launch"])
    _build.check(fn(_build.ptr(g), B * C, Ho, Wo, int(g.dtype == torch.bfloat16), c_g0, c_g1, L, pl,
                    _build.ptr(d_yl), _build.ptr(d_yh), _build.stream(g.device)), "idwt_adjoint")
    kernels.launches["idwt_adjoint"] += 1
    return d_yl, d_yh
