"""Image resize with the JAX package's semantics (``jax.image.resize``).

The SR app resizes with ``jax.image.resize(x, shape, "bilinear")`` (the LR
condition of the upscaler, the resize guidance, the bilinear baseline,
LPIPS on small crops) and upsamples the UNet's and VAE's features with
``"nearest"``. Neither is ``F.interpolate``'s default arithmetic, so both
are written out here:

* ``bilinear``: every axis whose size changes is contracted with a
  (in, out) weight matrix: the triangle kernel at half-pixel centres
  (sample = (o + 0.5) in / out - 0.5), widened by in / out when shrinking
  (antialiasing), each column renormalised to sum 1 (so the edges are not
  darkened), and zero where the sample lies outside [-0.5, in - 0.5].
* ``nearest``: index floor((o + 0.5) in / out) in float32.

Any axis may change, as in JAX (callers pass the full output shape).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["resize", "bilinear_weights"]

_EPS32 = float(np.finfo(np.float32).eps)


def bilinear_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in_size, out_size) float32 weights of one axis of the bilinear
    resize (``jax._src.image.scale.compute_weight_mat`` with the triangle
    kernel, no translation and antialiasing, JAX's default)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs() / kernel_scale
    w = torch.clamp_min(1.0 - x.abs(), 0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        offsets = (torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n
        x = x.index_select(d, torch.floor(offsets).long())
    return x


def resize(x: torch.Tensor, shape: Sequence[int], method: str = "bilinear") -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for ``method`` "bilinear"
    (alias "linear") or "nearest". Integer inputs come back as float32."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} must have one size per axis of x {tuple(x.shape)}")
    if method == "nearest":
        return _nearest(x, shape)
    if method not in ("bilinear", "linear"):
        raise ValueError(f"unknown resize method {method!r} (bilinear, nearest)")
    if not x.is_floating_point():
        x = x.float()
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        w = bilinear_weights(m, n, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x
