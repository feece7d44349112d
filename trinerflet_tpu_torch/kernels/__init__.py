"""Hand-written CUDA kernels (``csrc/*.cu``, built for ``sm_90a``) and their
launch counters.

Each kernel's wrapper lives beside its plain PyTorch version in the module
that uses it (``ops/raymarch.py``, ``ops/grid_sample.py``, ``ops/wavelets.py``,
``render/renderer.py``, ``models/gridencoder.py``, ``models/registry.py``) and adds one to
``launches[name]`` for every CUDA kernel it launches, and nowhere else.
Backward kernels count under their own names (``*_bwd``,
``grid_sample_bwd_xyz`` for K2x, ``grid_encode_bwd_x`` for K7x,
``idwt_adjoint``), and the second derivatives of the three samplers'
coordinate gradients under theirs (``grid_sample_bwd_xyz_bwd`` for K2x²,
``grid_encode_bwd_x_bwd`` for K7x², ``volume_grid_bwd_x_bwd`` for K10²).
``reset_launches`` zeroes every count, so a run can show which kernels a
path went through.

``first_order`` marks the backward of each kernel's autograd function that
is differentiable once; the samplers' coordinate gradients are
differentiable twice (their backwards are autograd functions whose own
backwards are K2x², K7x² and K10², marked ``first_order``), so a third
derivative raises. ``wanted`` tells a backward whether the engine will use
an input's gradient, so the samplers skip the ones nobody reads (an
analytic normal's inner gradient wants the points' alone).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch.autograd.function import once_differentiable

# name -> CUDA kernel launches since the last reset_launches()
launches: Dict[str, int] = {
    "march": 0, "march_flat": 0, "grid_sample": 0, "grid_sample_bwd": 0, "grid_sample_bwd_xyz": 0,
    "composite": 0, "composite_bwd": 0,
    "idwt": 0, "idwt_adjoint": 0, "occupancy": 0, "compact": 0, "composite_compact": 0,
    "composite_compact_bwd": 0, "grid_encode": 0, "grid_encode_bwd": 0, "grid_encode_bwd_x": 0,
    "volume_grid": 0, "volume_grid_bwd": 0, "textured_bg": 0, "textured_bg_bwd": 0,
    "grid_sample_bwd_xyz_bwd": 0, "grid_encode_bwd_x_bwd": 0, "volume_grid_bwd_x_bwd": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def wanted(ctx, i: int, edge: Optional[int] = None) -> bool:
    """Whether a backward computes the gradient of its input ``i``: it was
    asked for at the forward (``needs_input_grad``) and the engine will run
    the input's own node. ``torch.autograd.grad(out, inputs)`` runs a
    function's backward whenever any of its inputs leads to ``inputs``: an
    analytic normal's inner gradient in the points runs the samplers'
    backwards, whose plane, table and grid gradients lead nowhere there,
    and the loss's gradient runs them again, whose point gradient leads
    nowhere. The engine cannot tell about a leaf's node under
    ``autograd.grad``: then it is computed (the normal passes views, not
    leaves); any other error of the engine's propagates. ``edge`` is the
    input's place among the function's tensor inputs
    (``ctx.next_functions``), when a non-tensor input comes before it."""
    if not ctx.needs_input_grad[i]:
        return False
    node = ctx.next_functions[i if edge is None else edge][0]
    try:
        return bool(torch._C._will_engine_execute_node(node))
    except RuntimeError:
        if node.name() != "torch::autograd::AccumulateGrad":
            raise
        return True


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
