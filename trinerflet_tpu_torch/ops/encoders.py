"""Direction and position encoders (port of ``trinerflet_tpu/ops/encoders.py``):
real spherical harmonics in the instant-ngp / shencoder closed form, up to
degree 4 (the serving recipes' ``sh_degree``), and the frequency encoding."""

from __future__ import annotations

import torch

from .._device import SLICE_LATER, not_ported

__all__ = ["sh_dim", "sh_encode", "freq_dim", "freq_encode"]


def sh_dim(degree: int) -> int:
    return degree**2


def freq_dim(input_dim: int, degree: int) -> int:
    return input_dim + 2 * input_dim * degree


def freq_encode(x: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{d-1} x), cos(2^{d-1} x)]:
    x (..., D) -> (..., D + 2*D*degree)."""
    outs = [x]
    for k in range(degree):
        s = x * (2.0**k)
        outs += [torch.sin(s), torch.cos(s)]
    return torch.cat(outs, dim=-1)


def sh_encode(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """d (..., 3), not necessarily unit -> (..., degree^2)."""
    if not 1 <= degree <= 8:
        raise ValueError(f"sh degree must be in [1, 8], got {degree}")
    if degree > 4:
        raise not_ported(f"sh_encode degree {degree}", SLICE_LATER)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree >= 3:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(out, dim=-1)
