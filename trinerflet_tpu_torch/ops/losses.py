"""Loss library (port of ``trinerflet_tpu/ops/losses.py``): the MAPE and
Huber losses and the O(N) mip-NeRF-360 distortion loss, as plain
differentiable torch (the JAX versions are plain XLA)."""

from __future__ import annotations

import torch

__all__ = ["mape_loss", "huber_loss", "eff_distortion_loss"]


def mape_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute percentage error: mean(|pred - target| / (|target| + 0.01))."""
    d = pred - target
    return (_abs(d) / (_abs(target) + 1e-2)).mean()


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 0.1) -> torch.Tensor:
    """mean(0.5 q^2 + delta (|d| - q)), q = min(|d|, delta)."""
    d = _abs(pred - target)
    q = torch.clamp_max(d, delta)
    return (0.5 * q * q + delta * (d - q)).mean()


def eff_distortion_loss(weights: torch.Tensor, mids: torch.Tensor,
                        intervals: torch.Tensor) -> torch.Tensor:
    """O(N) distortion loss over per-ray sample weights (N, T), sample
    midpoints and interval lengths, by the prefix-sum identity
    sum_{i,j} w_i w_j |m_i - m_j| = 2 sum_i w_i (m_i W_{<i} - S_{<i}) with
    W = cumsum(w), S = cumsum(w m), plus sum_i w_i^2 l_i / 3; the mean over
    rays."""
    w = weights
    wm = w * mids
    cw = torch.cumsum(w, dim=-1) - w
    cwm = torch.cumsum(wm, dim=-1) - wm
    cross = 2.0 * (wm * cw - w * cwm).sum(-1)
    intra = (w * w * intervals).sum(-1) / 3.0
    return (cross + intra).mean()


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's gradient at 0 (+1; torch's ``abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)
