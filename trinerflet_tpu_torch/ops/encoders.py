"""Direction and position encoders (port of ``trinerflet_tpu/ops/encoders.py``):
real spherical harmonics in the instant-ngp / shencoder closed form up to
degree 7, degree 8 by the associated Legendre recurrence (as the JAX
package), and the frequency encoding."""

from __future__ import annotations

import math

import torch

__all__ = ["sh_dim", "sh_encode", "sh_encode_general", "freq_dim", "freq_encode"]


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
    if degree == 8:
        return sh_encode_general(d, degree)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    x4, y4, z4 = x2 * x2, y2 * y2, z2 * z2
    x6, y6, z6 = x4 * x2, y4 * y2, z4 * z2
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
    if degree >= 5:
        out += [
            2.5033429417967046 * xy * (x2 - y2),
            1.7701307697799304 * yz * (-3.0 * x2 + y2),
            0.94617469575756008 * xy * (7.0 * z2 - 1.0),
            0.66904654355728921 * yz * (3.0 - 7.0 * z2),
            -3.1735664074561294 * z2 + 3.7024941420321507 * z4 + 0.31735664074561293,
            0.66904654355728921 * xz * (3.0 - 7.0 * z2),
            0.47308734787878004 * (x2 - y2) * (7.0 * z2 - 1.0),
            1.7701307697799304 * xz * (-x2 + 3.0 * y2),
            -3.7550144126950569 * x2 * y2 + 0.62583573544917614 * x4 + 0.62583573544917614 * y4,
        ]
    if degree >= 6:
        out += [
            0.65638205684017015 * y * (10.0 * x2 * y2 - 5.0 * x4 - y4),
            8.3026492595241645 * xy * z * (x2 - y2),
            -0.48923829943525038 * y * (3.0 * x2 - y2) * (9.0 * z2 - 1.0),
            4.7935367849733241 * xy * z * (3.0 * z2 - 1.0),
            0.45294665119569694 * y * (14.0 * z2 - 21.0 * z4 - 1.0),
            0.1169503224534236 * z * (-70.0 * z2 + 63.0 * z4 + 15.0),
            0.45294665119569694 * x * (14.0 * z2 - 21.0 * z4 - 1.0),
            2.3967683924866621 * z * (x2 - y2) * (3.0 * z2 - 1.0),
            -0.48923829943525038 * x * (x2 - 3.0 * y2) * (9.0 * z2 - 1.0),
            2.0756623148810411 * z * (-6.0 * x2 * y2 + x4 + y4),
            0.65638205684017015 * x * (10.0 * x2 * y2 - x4 - 5.0 * y4),
        ]
    if degree >= 7:
        out += [
            1.3663682103838286 * xy * (-10.0 * x2 * y2 + 3.0 * x4 + 3.0 * y4),
            2.3666191622317521 * yz * (10.0 * x2 * y2 - 5.0 * x4 - y4),
            2.0182596029148963 * xy * (x2 - y2) * (11.0 * z2 - 1.0),
            -0.92120525951492349 * yz * (3.0 * x2 - y2) * (11.0 * z2 - 3.0),
            0.92120525951492349 * xy * (-18.0 * z2 + 33.0 * z4 + 1.0),
            0.58262136251873131 * yz * (30.0 * z2 - 33.0 * z4 - 5.0),
            6.6747662381009842 * z2 - 20.024298714302954 * z4 + 14.684485723822165 * z6
            - 0.31784601133814211,
            0.58262136251873131 * xz * (30.0 * z2 - 33.0 * z4 - 5.0),
            0.46060262975746175 * (x2 - y2) * (11.0 * z2 * (3.0 * z2 - 1.0) - 7.0 * z2 + 1.0),
            -0.92120525951492349 * xz * (x2 - 3.0 * y2) * (11.0 * z2 - 3.0),
            0.50456490072872406 * (11.0 * z2 - 1.0) * (-6.0 * x2 * y2 + x4 + y4),
            2.3666191622317521 * xz * (10.0 * x2 * y2 - x4 - 5.0 * y4),
            10.247761577878714 * x2 * y4 - 10.247761577878714 * x4 * y2
            + 0.6831841051919143 * x6 - 0.6831841051919143 * y6,
        ]
    return torch.stack(out, dim=-1)


def sh_encode_general(d: torch.Tensor, degree: int) -> torch.Tensor:
    """Real spherical harmonics of any degree by the associated Legendre
    recurrence, in the closed form's convention (Condon-Shortley phase, z
    the polar axis, order -l..+l): sin^m is folded into A_m + i B_m =
    (x + i y)^m, and P~_l^m is the Legendre function without it."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    L = degree
    A, B = [torch.ones_like(x), x], [torch.zeros_like(x), y]
    for m in range(2, L):
        A.append(x * A[m - 1] - y * B[m - 1])
        B.append(x * B[m - 1] + y * A[m - 1])

    def K(l, m):
        return math.sqrt((2 * l + 1) / (4 * math.pi) * math.factorial(l - m) / math.factorial(l + m))

    P = {}
    for m in range(L):
        P[(m, m)] = torch.ones_like(z) if m == 0 else P[(m - 1, m - 1)] * (-(2 * m - 1))
        if m + 1 < L:
            P[(m + 1, m)] = z * (2 * m + 1) * P[(m, m)]
        for l in range(m + 2, L):
            P[(l, m)] = ((2 * l - 1) * z * P[(l - 1, m)] - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    out = [None] * (L * L)
    for l in range(L):
        out[l * l + l] = K(l, 0) * P[(l, 0)]
        for m in range(1, l + 1):
            base = math.sqrt(2.0) * K(l, m) * P[(l, m)]
            out[l * l + l - m] = base * B[m]
            out[l * l + l + m] = base * A[m]
    return torch.stack(out, dim=-1)
