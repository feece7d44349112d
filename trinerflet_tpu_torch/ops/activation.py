"""Density activation: exp with a clamped gradient (port of
``trinerflet_tpu/ops/activation.py``). The forward is exp in float32 whatever
the input dtype; the backward uses exp(clamp(x, -15, 15)) so low-precision
training cannot blow up through the density head.

``plain_exp`` is the exponential of the port's plain versions. ``trunc_exp``'s
backward is plain torch on both devices, so it stays differentiable (a
second derivative through it is autograd's); the kernel functions' backwards
are not (``kernels.first_order``)."""

from __future__ import annotations

import torch

__all__ = ["plain_exp", "trunc_exp"]

LOG2E = 1.4426950408889634


def plain_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x); on the CPU as exp2(x * log2(e)) in float64, rounded back to
    x's dtype. torch's CPU exp of float32 calls MKL's vector library, whose
    first call in a process that runs JAX's CPU runtime came out up to
    1.5e-4 relative off in about one process in 30 (every later call
    exact); exp2 is vectorised without it, and in float64 the product
    x * log2(e) costs nothing at float32 precision."""
    if x.is_cuda:
        return torch.exp(x)
    return torch.exp2(x.double() * LOG2E).to(x.dtype)


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x32 = x.float()
        ctx.save_for_backward(x32)
        ctx.in_dtype = x.dtype
        return plain_exp(x32)

    @staticmethod
    def backward(ctx, g):
        (x32,) = ctx.saved_tensors
        return (g * plain_exp(torch.clamp(x32, -15.0, 15.0))).to(ctx.in_dtype)


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
