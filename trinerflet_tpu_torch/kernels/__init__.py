"""Hand-written CUDA kernels (``csrc/*.cu``, built for ``sm_90a``) and their
launch counters.

Each kernel's wrapper lives beside its plain PyTorch version in the module
that uses it (``ops/raymarch.py``, ``ops/grid_sample.py``, ``ops/wavelets.py``,
``render/renderer.py``, ``models/gridencoder.py``, ``models/registry.py``) and adds one to
``launches[name]`` for every CUDA kernel it launches, and nowhere else.
Backward kernels count under their own names (``*_bwd``,
``grid_sample_bwd_xyz`` for K2x, ``grid_encode_bwd_x`` for K7x,
``idwt_adjoint``). ``reset_launches`` zeroes every count,
so a run can show which kernels a path went through.

``first_order`` marks the backward of each kernel's autograd function.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.autograd.function import once_differentiable

# name -> CUDA kernel launches since the last reset_launches()
launches: Dict[str, int] = {
    "march": 0, "march_flat": 0, "grid_sample": 0, "grid_sample_bwd": 0, "grid_sample_bwd_xyz": 0,
    "composite": 0, "composite_bwd": 0,
    "idwt": 0, "idwt_adjoint": 0, "occupancy": 0, "compact": 0, "composite_compact": 0,
    "composite_compact_bwd": 0, "grid_encode": 0, "grid_encode_bwd": 0, "grid_encode_bwd_x": 0,
    "volume_grid": 0, "volume_grid_bwd": 0, "textured_bg": 0, "textured_bg_bwd": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def first_order(backward):
    """Mark the backward of a kernel's ``torch.autograd.Function``: it is
    differentiable once. Under ``create_graph=True`` every gradient it
    returns carries torch's ``once_differentiable`` error node, so a second
    derivative through it raises ``RuntimeError`` on both devices. (The CUDA
    backwards write fresh tensors that carry no graph, and torch's decorator
    alone passes them through when the incoming cotangent needs no gradient,
    as ``autograd.grad(y.sum(), x, create_graph=True)``'s does: the second
    derivative would come out as a silent zero.)"""
    inner = once_differentiable(backward)

    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        if torch.is_grad_enabled():
            grads = tuple(g.detach().requires_grad_(True)
                          if torch.is_tensor(g) and g.is_floating_point() and not g.requires_grad
                          else g for g in grads)
        return inner(ctx, *grads)

    return wrapper
