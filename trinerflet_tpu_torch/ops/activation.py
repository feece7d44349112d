"""Density activation: exp with a clamped gradient (port of
``trinerflet_tpu/ops/activation.py``). The forward is exp in float32 whatever
the input dtype; the backward uses exp(clamp(x, -15, 15)) so low-precision
training cannot blow up through the density head."""

from __future__ import annotations

import torch

__all__ = ["trunc_exp"]


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x32 = x.float()
        ctx.save_for_backward(x32)
        ctx.in_dtype = x.dtype
        return torch.exp(x32)

    @staticmethod
    def backward(ctx, g):
        (x32,) = ctx.saved_tensors
        return (g * torch.exp(torch.clamp(x32, -15.0, 15.0))).to(ctx.in_dtype)


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
