"""Two-phase NeRF super-resolution system (port of ``trinerflet_tpu/sr/system.py``).

* Phase 1 (``step < sr_start_step``): fit the wavelet triplane on LR views,
  rendering with the planes decoded at ``resolution / low_res_scale``
  (the ``low_res`` snapshot: the ladder runs only that far, K4 on CUDA).
* Phase 2: a per-view pseudo-GT cache, refreshed every
  ``hr_fit_refresh_every`` steps by rendering the whole HR view (chunked,
  at the training budget) and refining it with the guidance's
  ``generate_sr``; each step renders an HR crop aligned to the LR grid
  against the cached pseudo-GT with L2 + L1, LR-SR consistency (the HR
  estimate average-pooled to LR against the LR ground truth), the wavelet
  L1, and optionally LPIPS of that consistency and SDS.
* Planes-only finetuning with a minimum resolution below which wavelet
  levels get no gradient (``sr_planes_only``, ``sr_min_res``).
* ``evaluate`` reports LR PSNR and HR PSNR / SSIM (and LPIPS with weights)
  beside the bilinear-upscale baseline and writes
  ``final_results_{step}.json``.

The optimiser is the port's Adam (0.9, 0.99, 1e-15) under the trainer's
``lr_schedule`` (``train/trainer.py``), without EMA, as the JAX package's
optax chain.

Differences from the JAX package, none of which changes a result:

* PyTorch runs eagerly: the steps update the parameters and Adam's moments
  in place and return the state with its step advanced. Random draws come
  from the state's ``torch.Generator``; the steps take them injected
  instead (``batch``: ``img_idx`` / ``pix_idx`` / ``noise``; ``jitter``),
  as the trainer's do. The pseudo-GT refresh of step s draws from a
  generator seeded with (seed + 1) * 1,000,003 + s (JAX folds s into a
  key of seed + 1).
* A step builds only the planes it reads (``low_res`` in phase 1 and in
  the grid upkeep): JAX's compiler drops the unread levels.
* ``render_view`` builds the planes once for all its chunks (the JAX
  package's jitted chunk rebuilds them each call), returns a (H, W, 3)
  tensor on the system's device and does not pad its last chunk; the
  pseudo-GT cache lives on the device.
* The guidance takes NCHW images.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..data.rays import rays_full_image, sample_ray_batch, sample_ray_batch_pregen
from ..models.nerf import NeRFConfig, NeRFField, init_nerf_params
from ..models.triplane import wavelet_l1
from ..ops.resize import resize
from ..render import renderer as R
from ..train.metrics import psnr as psnr_fn, ssim as ssim_fn
from ..train.trainer import TrainConfig, _fresh_adam, _leaves, _map, adam_update, lr_schedule
from .config import C, ScheduledFloat
from .data import SRSceneData

__all__ = ["SRConfig", "SRSystem", "SRState"]


@dataclasses.dataclass(frozen=True)
class SRConfig:
    total_steps: int = 6000
    sr_start_step: int = 2000
    hr_fit_refresh_every: int = 500
    lr: float = 1e-2
    sched_base: float = 0.1
    sched_exp: float = 2.5
    num_rays_lr: int = 4096
    crop_size_lr: int = 24            # crop side in LR pixels; the HR crop is x scale
    background_color: float = 0.0
    # loss weights (scheduled scalars allowed)
    lambda_lr: ScheduledFloat = 1.0
    lambda_l2_hr: ScheduledFloat = 1.0
    lambda_l1_hr: ScheduledFloat = 0.0
    lambda_lr_consistency: ScheduledFloat = 1.0
    # LPIPS(downscaled HR estimate, LR GT); needs lpips_params
    lambda_lr_consistency_perceptual: ScheduledFloat = 0.0
    lambda_sds: ScheduledFloat = 0.0
    wavelet_regularization: ScheduledFloat = 0.1
    weighted_regularization: bool = False
    # phase 1 reads a globally shuffled LR ray stream instead of per-view draws
    low_res_shuffled: bool = False
    # planes-only finetuning
    sr_planes_only: bool = False
    sr_min_res: int = -1
    update_extra_interval: int = 16
    eval_chunk: int = 16384
    seed: int = 0


class SRState(NamedTuple):
    params: Dict               # leaf tensors with requires_grad, updated in place
    opt_state: Dict            # {"count": int, "mu": tree, "nu": tree} (Adam)
    occ: R.OccupancyState
    step: int
    rng: torch.Generator       # on the system's device


def _nchw(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) -> (1, 3, H, W)."""
    return img.permute(2, 0, 1)[None]


class SRSystem:
    def __init__(self, nerf_cfg: NeRFConfig, render_cfg: R.RenderConfig, cfg: SRConfig, guidance,
                 workspace: Optional[str] = None, lpips_params=None, lpips_net: str = "vgg",
                 device: DeviceLike = None):
        if nerf_cfg.triplane.low_res_scale <= 1:
            raise ValueError("SR needs a dual-resolution triplane (triplane.low_res_scale > 1)")
        self.device = resolve_device(device)
        self.nerf_cfg = nerf_cfg
        self.render_cfg = render_cfg
        self.cfg = cfg
        self.guidance = guidance
        self.field = NeRFField(nerf_cfg)
        self.lpips_params = lpips_params  # None: the perceptual terms are off
        self.lpips_net = lpips_net
        self.workspace = workspace
        if workspace:
            os.makedirs(workspace, exist_ok=True)
        self.lr_fn = lr_schedule(TrainConfig(lr=cfg.lr, iters=cfg.total_steps,
                                             sched_base=cfg.sched_base, sched_exp=cfg.sched_exp))
        # deep test-time budgets for full-frame renders
        self.eval_render_cfg = render_cfg.for_eval()
        ratio = max(1, self.eval_render_cfg.samples_per_ray_budget
                    // max(render_cfg.samples_per_ray_budget, 1))
        self.eval_chunk = max(1024, cfg.eval_chunk // ratio)
        # SDS runs in the HR step only when its schedule can be nonzero
        self._use_sds = not (isinstance(cfg.lambda_sds, (int, float)) and cfg.lambda_sds == 0)
        self._base_render_cfg = render_cfg
        self._march_retunes = 0

    def _maybe_retune_march(self, state: SRState) -> None:
        """Shrink the coarse-segment span to the live occupied bbox's
        diagonal (at most twice, once the occupancy has settled)."""
        cfg = self.render_cfg
        if (cfg.march != "hierarchical" or self._march_retunes >= 2
                or int(state.occ.iter_density) < 6):
            return
        target = R.tuned_num_coarse(cfg, state.occ.bbox.detach().cpu().numpy())
        if target is not None:
            self.render_cfg = dataclasses.replace(cfg, num_coarse_override=target)
            self.eval_render_cfg = dataclasses.replace(
                self._base_render_cfg, num_coarse_override=target).for_eval()
            self._march_retunes += 1

    # ------------------------------------------------------------------ init

    def init_state(self, generator: Optional[torch.Generator] = None,
                   density_grid: Optional[np.ndarray] = None) -> SRState:
        """Seeded params (``SRConfig.seed`` by default), zero Adam moments,
        an empty occupancy state (or one holding ``density_grid``, e.g.
        from ``mark_untrained_grid``) and the step generator."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        params = _map(lambda t: t.requires_grad_(True),
                      init_nerf_params(self.nerf_cfg, generator, self.device))
        return SRState(params=params, opt_state=_fresh_adam(params),
                       occ=R.init_occupancy(self.render_cfg, self.device, density_grid), step=0,
                       rng=torch.Generator(device=self.device).manual_seed(self.cfg.seed))

    # -------------------------------------------------------------- internal

    def _mode(self, mode: str) -> str:
        """``high_res`` is ``full`` without a high-res snapshot."""
        return "full" if mode == "high_res" and self.nerf_cfg.triplane.high_res_scale <= 1 else mode

    def _render(self, params, occ: R.OccupancyState, rays_o, rays_d, mode: str,
                noise: Optional[torch.Tensor] = None, train: bool = True, planes=None):
        """One chunk of rays on ``planes[mode]`` (built here, only as far as
        that plane, unless given)."""
        mode = self._mode(mode)
        if planes is None:
            planes = self.field.build_planes(params, modes=(mode,))

        def field_fn(xyzs, dirs):
            return self.field(params, planes, xyzs, dirs, resolution_mode=mode)

        bg = torch.full((rays_o.shape[0], 3), self.cfg.background_color, device=rays_o.device)
        return R.render_occgrid(field_fn, rays_o, rays_d, occ.occ,
                                self.render_cfg if train else self.eval_render_cfg,
                                noise=noise, bg_color=bg, occ_coarse=occ.occ_coarse,
                                occ_bbox=occ.bbox, with_stats=False)

    def _noise(self, state: SRState, n: int, batch: Optional[Dict]) -> torch.Tensor:
        """The render's perturbation (n,) in [0, 1): injected or drawn."""
        if batch is not None and "noise" in batch:
            return batch["noise"].to(self.device, torch.float32)
        return torch.rand((n,), generator=state.rng, device=state.rng.device).to(self.device)

    def _mask_grads(self, names, grads):
        """Zero the gradients of the planes-only / min-res policy: the MLPs
        with ``sr_planes_only``; with ``sr_min_res`` the base plane and the
        wavelet levels whose side is below it."""
        cfg = self.cfg
        out = []
        for n, g in zip(names, grads):
            top = n.split(".")[0]
            zero = cfg.sr_planes_only and top in ("sigma_net", "color_net", "bg_net")
            if cfg.sr_min_res > 0 and (n == "encoder.base" or n.startswith("encoder.wavelets.")):
                zero = zero or g.shape[-1] < cfg.sr_min_res
            out.append(torch.zeros_like(g) if zero else g)
        return out

    def _apply_grads(self, state: SRState, loss: torch.Tensor) -> SRState:
        """Gradients of ``loss`` for every leaf (zero where it has none, as
        JAX's tree gradient), the masks, then Adam in place."""
        named = _leaves(state.params)
        leaves = [p for _, p in named]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        if self.cfg.sr_planes_only or self.cfg.sr_min_res > 0:
            grads = self._mask_grads([n for n, _ in named], grads)
        with torch.no_grad():
            count = adam_update(leaves, grads, state.opt_state, self.lr_fn)
        return state._replace(opt_state=dict(state.opt_state, count=count), step=state.step + 1)

    def _reg(self, params) -> torch.Tensor:
        return wavelet_l1(params["encoder"], self.nerf_cfg.triplane, self.cfg.weighted_regularization)

    def _finish(self, state: SRState, loss, aux):
        state = self._apply_grads(state, loss)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        return state, aux

    # ------------------------------------------------------------ phase 1

    def _lr_step(self, state: SRState, data: Dict, weights: Dict, batch: Optional[Dict] = None):
        """One phase-1 step on ``num_rays_lr`` uniformly drawn LR pixels
        (``data``: images (V, h, w, 3), poses, intrinsics on the device)."""
        batch = batch or {}
        N = self.cfg.num_rays_lr
        rays_o, rays_d, pixels = sample_ray_batch(data["images"], data["poses"], data["intrinsics"],
                                                  N, state.rng, batch.get("img_idx"),
                                                  batch.get("pix_idx"))
        return self._lr_stream_step(state, rays_o, rays_d, pixels[..., :3], weights, batch)

    def _lr_stream_step(self, state: SRState, rays_o, rays_d, rgb, weights: Dict,
                        batch: Optional[Dict] = None):
        """A phase-1 step on given rays (the shuffled stream, precomputed
        LLFF / NDC rays, or ``_lr_step``'s draw)."""
        params = state.params
        out = self._render(params, state.occ, rays_o, rays_d, "low_res",
                           noise=self._noise(state, rays_o.shape[0], batch))
        loss_lr = ((out["image"] - rgb) ** 2).mean()
        reg = self._reg(params)
        loss = weights["lr"] * loss_lr + weights["reg"] * reg
        return self._finish(state, loss, {"loss_lr": loss_lr, "reg": reg})

    # ------------------------------------------------------------ phase 2

    def _hr_step(self, state: SRState, rays_o, rays_d, pseudo_gt, lr_gt, weights: Dict,
                 sds_t_bounds=None, batch: Optional[Dict] = None):
        """One phase-2 step on an HR crop: ``pseudo_gt`` (hc, wc, 3), the LR
        ground truth under it ``lr_gt`` (hc / s, wc / s, 3)."""
        params = state.params
        scale = pseudo_gt.shape[0] // lr_gt.shape[0]
        out = self._render(params, state.occ, rays_o, rays_d, "high_res",
                           noise=self._noise(state, rays_o.shape[0], batch))
        pred = out["image"].reshape(pseudo_gt.shape)
        l2 = ((pred - pseudo_gt) ** 2).mean()
        l1 = (pred - pseudo_gt).abs().mean()
        h, w, _ = pred.shape
        pred_lr = pred.reshape(h // scale, scale, w // scale, scale, 3).mean((1, 3))
        cons = ((pred_lr - lr_gt) ** 2).mean()
        reg = self._reg(params)
        loss = (weights["l2_hr"] * l2 + weights["l1_hr"] * l1
                + weights["consistency"] * cons + weights["reg"] * reg)
        aux = {"l2_hr": l2, "l1_hr": l1, "consistency": cons, "reg": reg}
        if self.lpips_params is not None:
            from ..utils.lpips import lpips as lpips_dist

            percep = lpips_dist(self.lpips_params, _nchw(torch.clamp(pred_lr, 0, 1)),
                                _nchw(torch.clamp(lr_gt, 0, 1)), net=self.lpips_net).mean()
            loss = loss + weights["percep"] * percep
            aux["consistency_perceptual"] = percep
        if self._use_sds and sds_t_bounds is not None:
            sds = self.guidance.sds_loss(_nchw(lr_gt), _nchw(pred), t_bounds=sds_t_bounds,
                                         generator=state.rng)
            loss = loss + weights["sds"] * sds
            aux["sds"] = sds
        return self._finish(state, loss, aux)

    # --------------------------------------------------------------- shared

    @torch.no_grad()
    def _update_grid(self, state: SRState, jitter: Optional[torch.Tensor] = None) -> SRState:
        """A full density-grid refresh on the ``low_res`` planes."""
        planes = self.field.build_planes(state.params, modes=("low_res",))

        def density_fn(pts):
            return self.field.density(state.params, planes, pts, resolution_mode="low_res")[0]

        occ = R.update_density_grid(state.occ, density_fn, self.render_cfg, jitter=jitter,
                                    generator=state.rng)
        return state._replace(occ=occ)

    @torch.no_grad()
    def render_view(self, params, occ, pose, intrinsics, H: int, W: int, mode: str = "full",
                    rays=None, deep: bool = True) -> torch.Tensor:
        """A whole view (H, W, 3), chunked; ``rays=(rays_o, rays_d)`` (numpy
        or tensors) overrides the pinhole camera. ``deep=False`` renders at
        the training budget (the pseudo-GT refresh); ``deep=True`` at the
        test-time budget (evaluation)."""
        if rays is not None:
            rays_o, rays_d = (torch.as_tensor(np.asarray(r) if not torch.is_tensor(r) else r)
                              .reshape(-1, 3).to(self.device, torch.float32) for r in rays)
        else:
            rays_o, rays_d = (torch.from_numpy(r).to(self.device)
                              for r in rays_full_image(np.asarray(pose), intrinsics, H, W))
        chunk = self.eval_chunk if deep else max(self.eval_chunk, self.cfg.eval_chunk)
        planes = self.field.build_planes(params, modes=(self._mode(mode),))  # once for every chunk
        outs = [self._render(params, occ, rays_o[s : s + chunk], rays_d[s : s + chunk], mode,
                             train=not deep, planes=planes)["image"]
                for s in range(0, H * W, chunk)]
        return torch.cat(outs).reshape(H, W, 3)

    # ----------------------------------------------------------------- train

    def fit(self, state: SRState, scene: SRSceneData, log_every: int = 200,
            callback=None) -> SRState:
        from .data import shuffled_ray_stream, view_ray_grid

        cfg = self.cfg
        dev = self.device
        scale = scene.scale
        pregen = scene.pregen_rays

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

        lr_images = t(scene.lr.images[..., :3])
        stream = None
        if cfg.low_res_shuffled:
            stream = shuffled_ray_stream(scene.lr, cfg.num_rays_lr, cfg.seed, cfg.background_color)
        elif pregen:
            lr_ro, lr_rd = t(scene.lr.rays_o), t(scene.lr.rays_d)
        else:
            data = {"images": lr_images, "poses": t(scene.lr.poses),
                    "intrinsics": t([float(np.float32(x)) for x in scene.lr.intrinsics])}
        V = scene.num_views
        grids = [view_ray_grid(scene.hr, v) for v in range(V)]
        hr_ro = torch.stack([t(g[0]) for g in grids])
        hr_rd = torch.stack([t(g[1]) for g in grids])
        Hh, Wh = scene.hr.H, scene.hr.W

        cache = torch.zeros((V, Hh, Wh, 3), device=dev)
        cache_step = np.full((V,), -(10**9), np.int64)
        host_rng = np.random.default_rng(cfg.seed)
        crop_hr = cfg.crop_size_lr * scale
        cl = cfg.crop_size_lr

        t0 = time.time()
        base_step = int(state.step)
        for it in range(cfg.total_steps):
            step = base_step + it
            if step % cfg.update_extra_interval == 0:
                state = self._update_grid(state)
                self._maybe_retune_march(state)

            if step < cfg.sr_start_step:
                weights = {"lr": C(cfg.lambda_lr, step), "reg": C(cfg.wavelet_regularization, step)}
                if stream is not None:
                    ro_c, rd_c, rgb_c = next(stream)
                    state, aux = self._lr_stream_step(state, t(ro_c), t(rd_c), t(rgb_c), weights)
                elif pregen:
                    ro_c, rd_c, rgb_c = sample_ray_batch_pregen(lr_images, lr_ro, lr_rd,
                                                                cfg.num_rays_lr, state.rng)
                    state, aux = self._lr_stream_step(state, ro_c, rd_c, rgb_c, weights)
                else:
                    state, aux = self._lr_step(state, data, weights)
            else:
                v = int(host_rng.integers(0, V))
                if step - cache_step[v] >= cfg.hr_fit_refresh_every:
                    hr_render = self.render_view(state.params, state.occ, None, None, Hh, Wh,
                                                 mode="high_res", rays=(hr_ro[v], hr_rd[v]),
                                                 deep=False)
                    gen = torch.Generator(device=dev).manual_seed((cfg.seed + 1) * 1_000_003 + step)
                    pseudo = self.guidance.generate_sr(_nchw(lr_images[v]), _nchw(hr_render),
                                                       step=step, generator=gen)
                    cache[v] = pseudo[0].permute(1, 2, 0)
                    cache_step[v] = step

                # a crop aligned to the LR grid
                x0l = int(host_rng.integers(0, scene.lr.H - cl + 1))
                y0l = int(host_rng.integers(0, scene.lr.W - cl + 1))
                x0, y0 = x0l * scale, y0l * scale
                ro = hr_ro[v, x0 : x0 + crop_hr, y0 : y0 + crop_hr].reshape(-1, 3)
                rd = hr_rd[v, x0 : x0 + crop_hr, y0 : y0 + crop_hr].reshape(-1, 3)
                pgt = cache[v, x0 : x0 + crop_hr, y0 : y0 + crop_hr]
                lgt = lr_images[v, x0l : x0l + cl, y0l : y0l + cl]
                weights = {
                    "l2_hr": C(cfg.lambda_l2_hr, step),
                    "l1_hr": C(cfg.lambda_l1_hr, step),
                    "consistency": C(cfg.lambda_lr_consistency, step),
                    "reg": C(cfg.wavelet_regularization, step),
                    "percep": C(cfg.lambda_lr_consistency_perceptual, step),
                    "sds": C(cfg.lambda_sds, step),
                }
                sds_t_bounds = self.guidance.step_bounds(step) if self._use_sds else None
                state, aux = self._hr_step(state, ro, rd, pgt, lgt, weights, sds_t_bounds)

            if log_every and (it % log_every == 0 or it == cfg.total_steps - 1):
                print(f"sr step {step:6d} loss {float(aux['loss']):.5f} "
                      f"({'LR' if step < cfg.sr_start_step else 'HR'} phase, "
                      f"{(it + 1) / max(time.time() - t0, 1e-9):.1f} it/s)")
            if callback:
                callback(state, aux)
        return state

    # ----------------------------------------------------------------- eval

    def evaluate(self, state: SRState, scene: SRSceneData, tag: str = "final_results") -> Dict:
        """Per view: LR PSNR of the ``low_res`` render, HR PSNR and SSIM of
        the ``high_res`` render, the bilinear upsample's HR PSNR (and LPIPS
        with weights); their means and the per-frame rows, written to
        ``{workspace}/{tag}_{step}.json``."""
        from .data import view_ray_grid

        lpips_fn = None
        if self.lpips_params is not None:
            from ..utils.lpips import make_lpips_fn

            lpips_fn = make_lpips_fn(params=self.lpips_params, net=self.lpips_net)
        per_frame = []
        for v in range(scene.num_views):
            lr_pred = self.render_view(state.params, state.occ, None, None, scene.lr.H, scene.lr.W,
                                       mode="low_res", rays=view_ray_grid(scene.lr, v))
            hr_pred = self.render_view(state.params, state.occ, None, None, scene.hr.H, scene.hr.W,
                                       mode="high_res", rays=view_ray_grid(scene.hr, v))
            lr_gt = torch.from_numpy(np.ascontiguousarray(scene.lr.images[v][..., :3])).to(self.device)
            hr_gt = torch.from_numpy(np.ascontiguousarray(scene.hr.images[v][..., :3])).to(self.device)
            bilinear = resize(lr_gt, hr_gt.shape)
            m = {
                "view": v,
                "PSNR_lr": psnr_fn(lr_pred, lr_gt),
                "PSNR_hr": psnr_fn(hr_pred, hr_gt),
                "PSNR_bilinear": psnr_fn(bilinear, hr_gt),
                "SSIM_hr": ssim_fn(hr_pred, hr_gt),
            }
            if lpips_fn is not None:
                m["LPIPS_hr"] = lpips_fn(torch.clamp(hr_pred, 0, 1), hr_gt)
            per_frame.append(m)
        results: Dict[str, Any] = {k: float(np.mean([m[k] for m in per_frame]))
                                   for k in ("PSNR_lr", "PSNR_hr", "PSNR_bilinear", "SSIM_hr")}
        results["per_frame"] = per_frame
        if lpips_fn is not None:
            results["LPIPS_hr"] = float(np.mean([m["LPIPS_hr"] for m in per_frame]))
        if self.workspace:
            with open(os.path.join(self.workspace, f"{tag}_{int(state.step)}.json"), "w") as f:
                json.dump(results, f, indent=2)
        return results
