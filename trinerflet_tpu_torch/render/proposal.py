"""Proposal-network sampling (port of ``trinerflet_tpu/render/proposal.py``,
the nerfacc PropNetEstimator counterpart).

A cheap density proxy -- a small multiresolution grid (kernel K7 on CUDA)
and a 1-layer head -- is evaluated on a coarse jittered ladder; its
transmittance weights place the main field's samples by inverse CDF
(``ops/raymarch.sample_pdf``), the main field is composited on them (K3),
and the proxy is trained with the interlevel (histogram-bound) loss against
the main field's weights.

``_ray_weights`` (shared with ``render_dense``) is ``composite_dense``'s
``weights`` (the same factors in the same order), so it runs through K3
with zero colours and depths: K3's backward already takes the weights'
cotangent, which is all the interlevel loss sends back.

Random draws: the jitter (N, P+1) and the final-level uniforms (N, F), in
that order (the JAX package's key splits inside ``render_proposal``), are
passed in (``jitter``, ``u``) or drawn from ``generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from .._device import DeviceLike, resolve_device
from ..models.gridencoder import GridEncoderConfig, grid_encode, init_grid_params
from ..ops import raymarch as RM
from ..ops.raymarch import _inv
from ..ops.activation import trunc_exp
from .renderer import RenderConfig, _background, _linspace, _ray_weights, _uniform

__all__ = ["ProposalConfig", "init_proposal_params", "proposal_density", "render_proposal",
           "interlevel_loss"]


@dataclasses.dataclass(frozen=True)
class ProposalConfig:
    num_proposal_samples: int = 64
    num_final_samples: int = 32
    grid: GridEncoderConfig = dataclasses.field(
        default_factory=lambda: GridEncoderConfig(
            num_levels=5, level_dim=2, base_resolution=16,
            desired_resolution=128, log2_hashmap_size=17,
        )
    )


def init_proposal_params(cfg: ProposalConfig, generator: Optional[torch.Generator] = None,
                         device: DeviceLike = None) -> Dict:
    """The grid at std 0.1 (larger than the field encoder's: a ~0 product of
    two tiny factors is a saddle that starves the histogram loss's gradient)
    and the head ``w`` (dim, 1) ~ U(-dim^-0.5, dim^-0.5), on ``device``
    (``cuda`` by default)."""
    device = resolve_device(device)
    dim = cfg.grid.output_dim
    grid = init_grid_params(cfg.grid, generator, device, std=0.1)
    u = torch.rand((dim, 1), generator=generator, dtype=torch.float32)
    return {"grid": grid, "w": ((2.0 * u - 1.0) * dim**-0.5).to(device)}


def proposal_density(params: Dict, pts: torch.Tensor, cfg: ProposalConfig,
                     bound: float) -> torch.Tensor:
    feats = grid_encode(params["grid"], pts, cfg.grid, bound)
    return trunc_exp(feats @ params["w"])[..., 0]


def render_proposal(
    density_fn: Callable,     # main field: pts (M, 3) -> (sigma (M,), geo (M, G))
    color_fn: Callable,       # (dirs (M, 3), geo) -> rgb (M, 3)
    prop_params: Dict,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    cfg: RenderConfig,
    pcfg: ProposalConfig,
    bg_color=None,
    perturb: bool = False,
    jitter: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Proposal-guided volume rendering. Returns image, depth, weights_sum
    and what the interlevel loss needs: ``prop_weights`` (N, P),
    ``prop_bins`` (N, P+1), ``weights`` (N, F) and ``bins`` (N, F). With
    ``perturb`` the ladder is jittered by ``jitter`` and the final samples
    drawn at ``u`` (both U[0, 1), drawn from ``generator`` when absent);
    without it the ladder is uniform and u a midpoint linspace."""
    N = rays_o.shape[0]
    P, F = pcfg.num_proposal_samples, pcfg.num_final_samples
    dev = rays_o.device
    aabb = torch.tensor(cfg.aabb, dtype=torch.float32, device=dev)
    nears, fars = RM.near_far_from_aabb(rays_o, rays_d, aabb, cfg.min_near)
    hit = nears < 1e30
    nears = torch.where(hit, nears, 0.0)[:, None]
    fars = torch.where(hit, fars, 1e-3)[:, None]

    # ---- proposal level: uniform bins
    bins_p = nears + (fars - nears) * _linspace(0.0, 1.0, P + 1, dev)[None, :]  # (N, P+1) edges
    if perturb:
        if jitter is None:
            jitter = _uniform((N, P + 1), generator, dev)
        jitter = (jitter.to(dev, torch.float32) - 0.5) * (fars - nears) * _inv(P)  # jit's / P
        bins_p = torch.sort(bins_p + jitter, dim=-1).values
    mid_p = 0.5 * (bins_p[:, 1:] + bins_p[:, :-1])                        # (N, P)
    dt_p = bins_p[:, 1:] - bins_p[:, :-1]
    pts_p = (rays_o[:, None] + rays_d[:, None] * mid_p[..., None]).clamp(-cfg.bound, cfg.bound)
    sig_p = proposal_density(prop_params, pts_p.reshape(-1, 3), pcfg, cfg.bound).reshape(N, P)
    w_p = _ray_weights(sig_p, dt_p)                                       # (N, P)

    # ---- final level: inverse-CDF placement from the proposal weights
    if perturb:
        if u is None:
            u = _uniform((N, F), generator, dev)
        u = u.to(dev, torch.float32)
    else:
        u = _linspace(0.5 / F, 1 - 0.5 / F, F, dev).expand(N, F)
    t_f = RM.sample_pdf(bins_p, w_p.detach(), F, u)                     # (N, F)
    t_f = torch.sort(t_f, dim=-1).values
    dt_f = torch.diff(t_f, dim=-1)
    dt_f = torch.cat([dt_f, (fars - nears) * _inv(F) * torch.ones_like(dt_f[:, :1])], -1)
    pts_f = (rays_o[:, None] + rays_d[:, None] * t_f[..., None]).clamp(-cfg.bound, cfg.bound)
    sigmas, geos = density_fn(pts_f.reshape(-1, 3))
    sigmas = sigmas.reshape(N, F)
    dirs = rays_d[:, None].expand(N, F, 3)
    rgbs = color_fn(dirs.reshape(-1, 3), geos).reshape(N, F, 3)

    ori_z = torch.clamp((t_f - nears) / (fars - nears), 0, 1)
    ws, depth, image, weights = RM.composite_dense(cfg.density_scale * sigmas, rgbs, dt_f, ori_z)
    image = image + (1.0 - ws)[:, None] * _background(rays_o, rays_d, bg_color, None, cfg)
    return {
        "image": image, "depth": depth, "weights_sum": ws,
        "prop_weights": w_p, "prop_bins": bins_p,
        "weights": weights, "bins": t_f,
    }


def interlevel_loss(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Histogram-bound proposal loss (mip-NeRF 360 / nerfacc prop loss): the
    proposal's mass over each final-sample interval must upper-bound the
    final weights; penalise clip(w_final - w_prop_envelope, 0)^2 / (w_prop
    envelope + w_final). The envelope is the OUTER measure: the total mass
    of every proposal bin overlapping the interval."""
    pb = out["bins"].detach()             # (N, F) final sample ts
    wf = out["weights"].detach()          # (N, F)
    bins_p = out["prop_bins"]             # (N, P+1)
    w_p = out["prop_weights"]             # (N, P)
    cw = torch.cat([torch.zeros_like(w_p[:, :1]), torch.cumsum(w_p, -1)], -1)
    starts, ends = bins_p[:, :-1], bins_p[:, 1:]
    t_lo = pb
    t_hi = torch.cat([pb[:, 1:], pb[:, -1:]], -1)
    hi_idx = (starts[:, None, :] < t_hi[:, :, None]).sum(-1)   # (N, F)
    lo_idx = (ends[:, None, :] <= t_lo[:, :, None]).sum(-1)
    P = w_p.shape[1]
    envelope = (torch.gather(cw, -1, hi_idx.clamp(0, P))
                - torch.gather(cw, -1, lo_idx.clamp(0, P)))
    deficit = torch.clamp_min(wf - envelope, 0.0)
    return (deficit**2 / torch.clamp_min(envelope + wf, 1e-6)).mean()
