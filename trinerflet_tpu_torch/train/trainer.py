"""Training loop (port of ``trinerflet_tpu/train/trainer.py``): Adam with the
exponential-decay schedule, the parameter EMA, the loss, the occupancy
refresh cadence, the march-span retune, and full-frame rendering from a
trained state.

Differences from the JAX package, none of which changes a result:

* PyTorch runs eagerly, so there is no jitted, donated step. ``train_step``
  updates the parameters, the Adam moments and the EMA in place (no second
  copy of the state) and returns the state with its counters advanced; the
  ``TrainState`` passed in is consumed.
* Random draws come from the state's ``torch.Generator`` (on the trainer's
  device); tests pass the draws in instead (``batch``, ``jitter``).
* ``render_rays`` / ``render_image`` build the planes once per call (the
  values are identical) and do not pad the last chunk (rays are
  independent).

This slice trains the per-ray (N, B) layout with ``budget_autotune=False``:
the budget tuner and the global layout it engages (K5), error-map sampling,
pregenerated rays, random backgrounds and CLIP guidance come with slice 3.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import SLICE_3, SLICE_LATER, DeviceLike, not_ported, resolve_device
from ..data.rays import rays_full_image, sample_ray_batch
from ..models.nerf import NeRFConfig, NeRFField, init_nerf_params
from ..models.triplane import wavelet_l1
from ..render import renderer as R

__all__ = ["TrainConfig", "TrainState", "Trainer", "lr_schedule"]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.99, 1e-15


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-2
    iters: int = 5000
    warmup_steps: int = 0
    warmup_factor: float = 1e-3
    sched_base: float = 0.1
    sched_exp: float = 2.5
    num_rays: int = 4096
    ema_decay: float = 0.95
    wavelet_regularization: float = 0.1
    weighted_regularization: bool = False
    background_color: float = 0.0
    train_rand_bg: bool = False
    criterion: str = "mse"
    huber_delta: float = 0.1
    alpha_bce: float = 0.0
    z_variance_reg: float = -1.0
    mlp_weight_decay: float = -1.0
    update_extra_interval: int = 16
    renderer: str = "occgrid"
    proposal_samples: int = 64
    proposal_final: int = 32
    lambda_interlevel: float = 1.0
    error_map: bool = False
    eval_chunk: int = 16384
    budget_autotune: bool = True
    budget_trunc_tol: float = 3e-3
    seed: int = 0


class TrainState(NamedTuple):
    params: Dict               # leaf tensors with requires_grad, updated in place
    opt_state: Dict            # {"count": int, "mu": tree, "nu": tree} (Adam)
    ema_params: Dict
    ema_count: int
    occ: R.OccupancyState
    step: int
    rng: torch.Generator       # on the trainer's device


def lr_schedule(cfg: TrainConfig):
    """step -> learning rate (float32): linear warmup from warmup_factor,
    then lr * sched_base ** (min(t / iters, 1) ** sched_exp)."""
    warmup = max(cfg.warmup_steps, 0)
    f32 = np.float32

    def fn(step) -> np.float32:
        s = f32(step)
        frac = np.minimum(np.maximum(s - f32(warmup), f32(0.0)) / f32(cfg.iters), f32(1.0))
        decay = f32(cfg.sched_base) ** (frac ** f32(cfg.sched_exp))
        if warmup > 0 and s < warmup:
            wf = (f32(cfg.sched_base * cfg.warmup_factor)
                  + s * f32(1 - cfg.warmup_factor) / f32(max(warmup - 1, 1)))
            return f32(cfg.lr) * wf
        return f32(cfg.lr) * decay

    return fn


def _criterion(cfg: TrainConfig, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    d = pred - gt
    if cfg.criterion == "huber":
        ad = d.abs()
        q = torch.clamp_max(ad, cfg.huber_delta)
        return (0.5 * q * q + cfg.huber_delta * (ad - q)).mean(-1)
    return (d * d).mean(-1)


def _leaves(tree: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) pairs of a nest of dicts, in key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves(v, f"{prefix}{k}.")
        else:
            out.append((prefix + k, v))
    return out


def _map(fn, tree: Dict) -> Dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


class Trainer:
    def __init__(self, nerf_cfg: NeRFConfig, render_cfg: R.RenderConfig,
                 train_cfg: TrainConfig, device: DeviceLike = None):
        if train_cfg.renderer != "occgrid":
            raise not_ported(f"the {train_cfg.renderer!r} renderer", SLICE_LATER)
        self.device = resolve_device(device)
        self.nerf_cfg = nerf_cfg
        self.render_cfg = render_cfg
        self.cfg = train_cfg
        self.field = NeRFField(nerf_cfg)
        self.lr_fn = lr_schedule(train_cfg)
        # deep test-time rendering: wider per-ray budget, smaller ray chunks
        self.eval_render_cfg = render_cfg.for_eval()
        ratio = max(1, self.eval_render_cfg.samples_per_ray_budget
                    // max(render_cfg.samples_per_ray_budget, 1))
        self.eval_chunk = max(1024, train_cfg.eval_chunk // ratio)
        self._base_render_cfg = render_cfg   # configured (pre-retune) shapes
        self._march_retunes = 0

    # ------------------------------------------------------------------ state

    def init_params(self, generator: Optional[torch.Generator] = None) -> Dict:
        """Seeded random parameters (``TrainConfig.seed`` by default)."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        return init_nerf_params(self.nerf_cfg, generator, self.device)

    def init_occupancy(self, density_grid=None) -> R.OccupancyState:
        return R.init_occupancy(self.render_cfg, self.device, density_grid)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   density_grid: Optional[np.ndarray] = None) -> TrainState:
        """Fresh training state: seeded params, zero Adam moments, the EMA
        equal to the params, an empty occupancy state (or one holding
        ``density_grid``, e.g. from ``mark_untrained_grid``) and the step
        generator seeded with ``TrainConfig.seed``."""
        params = _map(lambda t: t.requires_grad_(True), self.init_params(generator))
        return TrainState(
            params=params,
            opt_state={"count": 0, "mu": _map(torch.zeros_like, params),
                       "nu": _map(torch.zeros_like, params)},
            ema_params=_map(lambda t: t.detach().clone(), params),
            ema_count=0,
            occ=self.init_occupancy(density_grid),
            step=0,
            rng=torch.Generator(device=self.device).manual_seed(self.cfg.seed),
        )

    @torch.no_grad()
    def update_grid(self, params: Dict, occ: R.OccupancyState,
                    jitter: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    full: bool = True) -> R.OccupancyState:
        """One density-grid refresh: every cell (``full``) or training's
        rotating quarter. The sweep needs planes no finer than twice the
        grid resolution."""
        self._check_device(params, occ)
        planes = self.field.build_planes(params, max_resolution=2 * self.render_cfg.grid_size)

        def density_fn(pts):
            return self.field.density(params, planes, pts)[0]

        return R.update_density_grid(occ, density_fn, self.render_cfg,
                                     fraction=1.0 if full else 0.25, jitter=jitter,
                                     generator=generator)

    def _check_device(self, params: Dict, occ: R.OccupancyState) -> None:
        """Params and state must live on the trainer's device: a state carried
        onto another device would otherwise run there until the first mixed op."""
        for name, t in (("params", params["encoder"]["base"]), ("occupancy", occ.occ)):
            if t.device.type != self.device.type:
                raise ValueError(f"{name} are on {t.device}, the trainer on {self.device}; "
                                 f"move them or build the trainer with device={t.device.type!r}")

    def scene_to_device(self, scene) -> Dict:
        """A pinhole scene (``SceneData``) as the train step reads it."""
        if getattr(scene, "rays_o", None) is not None:
            raise not_ported("training on pregenerated rays", SLICE_3)
        return {
            "images": torch.as_tensor(np.asarray(scene.images), dtype=torch.float32,
                                      device=self.device),
            "poses": torch.as_tensor(np.asarray(scene.poses), dtype=torch.float32,
                                     device=self.device),
            "intrinsics": tuple(float(np.float32(x)) for x in scene.intrinsics),
        }

    # ------------------------------------------------------------ train step

    def _check_train_ported(self) -> None:
        cfg = self.cfg
        for on, what in ((cfg.budget_autotune, "budget_autotune=True (the budget tuner and the "
                                               "global layout it engages)"),
                         (cfg.error_map, "error-map ray sampling"),
                         (cfg.train_rand_bg, "random training backgrounds")):
            if on:
                raise not_ported(what, SLICE_3)

    def set_clip_guidance(self, *args, **kwargs):
        raise not_ported("CLIP guidance steps", SLICE_3)

    def _loss_fn(self, params: Dict, occ: R.OccupancyState, data: Dict,
                 batch: Optional[Dict], with_stats: bool, generator: torch.Generator):
        cfg = self.cfg
        N = cfg.num_rays
        batch = batch or {}
        rays_o, rays_d, pixels = sample_ray_batch(
            data["images"], data["poses"], data["intrinsics"], N, generator,
            batch.get("img_idx"), batch.get("pix_idx"))
        noise = batch.get("noise")
        if noise is None:
            noise = torch.rand((N,), generator=generator, device=generator.device)
        noise = noise.to(self.device, torch.float32)
        bg = torch.full((N, 3), cfg.background_color, dtype=torch.float32, device=self.device)
        if pixels.shape[-1] == 4:
            gt = pixels[..., :3] * pixels[..., 3:] + bg * (1 - pixels[..., 3:])
        else:
            gt = pixels

        planes = self.field.build_planes(params)

        def field_fn(xyzs, dirs):
            return self.field(params, planes, xyzs, dirs)

        out = R.render_occgrid(field_fn, rays_o, rays_d, occ.occ, self.render_cfg, noise=noise,
                               bg_color=bg, occ_coarse=occ.occ_coarse, occ_bbox=occ.bbox,
                               with_stats=with_stats)
        pred = out["image"]
        loss = _criterion(cfg, pred, gt).mean()
        aux = {"mse": ((pred - gt) ** 2).mean()}
        if cfg.wavelet_regularization > 0:
            reg = wavelet_l1(params["encoder"], self.nerf_cfg.triplane, cfg.weighted_regularization)
            loss = loss + cfg.wavelet_regularization * reg
            aux["wavelet_reg"] = reg
        if cfg.alpha_bce > 0:
            alpha = torch.clamp(out["weights_sum"], 0.01, 0.99)
            loss = loss + (-cfg.alpha_bce * torch.log(alpha).mean())
        if cfg.z_variance_reg > 0:
            loss = loss + cfg.z_variance_reg * out["z_variance"].mean()
        for k in ("num_samples", "samples_p99", "overflow_frac", "trunc_T", "samples_mean",
                  "span_p99", "span_trunc_T", "needed_seg_p99"):
            if k in out:
                aux[k] = out[k]
        return loss, aux

    def train_step(self, state: TrainState, data: Dict, with_stats: bool = True,
                   batch: Optional[Dict] = None) -> Tuple[TrainState, Dict]:
        """One optimisation step on ``num_rays`` rays: loss, gradients (the
        K4 adjoint, K2 and K3 backward kernels on CUDA), Adam and the EMA.
        ``batch`` may hold ``img_idx``, ``pix_idx`` and ``noise`` (N,) to
        inject the step's draws. Returns (new state, aux with ``loss``)."""
        self._check_train_ported()
        self._check_device(state.params, state.occ)
        named = _leaves(state.params)
        leaves = [p.requires_grad_(True) for _, p in named]
        loss, aux = self._loss_fn(state.params, state.occ, data, batch, with_stats, state.rng)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        with torch.no_grad():
            count = self._adam([n for n, _ in named], leaves, grads, state.opt_state)
            ema_count = self._ema(state, leaves)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        opt_state = dict(state.opt_state, count=count)
        return state._replace(opt_state=opt_state, ema_count=ema_count,
                              step=state.step + 1), aux

    def _adam(self, names: List[str], params: List[torch.Tensor], grads: List[torch.Tensor],
              opt: Dict) -> int:
        """optax.chain(scale_by_adam(0.9, 0.99, 1e-15)[, add_decayed_weights
        on the MLP groups], scale_by_schedule(-lr)) applied in place."""
        mu = [t for _, t in _leaves(opt["mu"])]
        nu = [t for _, t in _leaves(opt["nu"])]
        count = opt["count"] + 1
        f32 = np.float32
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, grads, alpha=1 - ADAM_B1)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - ADAM_B2)
        bc1 = float(f32(1) - f32(ADAM_B1) ** f32(count))
        bc2 = float(f32(1) - f32(ADAM_B2) ** f32(count))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        if self.cfg.mlp_weight_decay > 0:
            for name, u, p in zip(names, upd, params):
                if name.split(".")[0] in ("sigma_net", "color_net"):
                    u.add_(p, alpha=self.cfg.mlp_weight_decay)
        torch._foreach_mul_(upd, -float(self.lr_fn(count - 1)))
        torch._foreach_add_(params, upd)
        return count

    def _ema(self, state: TrainState, params: List[torch.Tensor]) -> int:
        """ema = ema * d + p * (1 - d), d = min(ema_decay, (1 + n) / (10 + n))."""
        if self.cfg.ema_decay <= 0:
            return state.ema_count
        n = state.ema_count + 1
        f32 = np.float32
        d = min(f32(self.cfg.ema_decay), (f32(1) + f32(n)) / (f32(10) + f32(n)))
        ema = [t for _, t in _leaves(state.ema_params)]
        torch._foreach_mul_(ema, float(d))
        torch._foreach_add_(ema, torch._foreach_mul(params, float(f32(1) - d)))
        return n

    def _maybe_retune_march(self, state: TrainState) -> None:
        """The march-span lever of the JAX package's retune: once the
        occupancy has settled (iter_density >= 6), size ``num_coarse`` to the
        occupied bbox's diagonal (at most 4 retunes). The sample-budget and
        global-layout levers belong to ``budget_autotune`` (slice 3)."""
        cfg = self.render_cfg
        if self._march_retunes >= 4 or int(state.occ.iter_density) < 6:
            return
        bbox_t = R.tuned_num_coarse(cfg, state.occ.bbox.detach().cpu().numpy())
        worst = int(math.ceil(cfg.bound * cfg.max_steps / cfg.fine_per_coarse))
        cur = cfg.num_coarse_override or worst
        if bbox_t is not None and (bbox_t < int(cur * 0.9) or bbox_t > cur):
            self.render_cfg = dataclasses.replace(cfg, num_coarse_override=bbox_t)
            # eval derives from the configured cfg: the exact-safe bbox span
            self.eval_render_cfg = dataclasses.replace(
                self._base_render_cfg, num_coarse_override=bbox_t).for_eval()
            self._march_retunes += 1

    def fit(self, state: TrainState, scene, log_every: int = 100, callback=None) -> TrainState:
        """Run ``iters`` (+ warmup) steps on the JAX package's cadence: every
        ``update_extra_interval`` steps a density refresh (full while
        iter_density < 16, then the rotating quarter) and the march retune;
        the p99 statistics only on the step before each refresh."""
        self._check_train_ported()
        data = self.scene_to_device(scene)
        total = self.cfg.iters + max(self.cfg.warmup_steps, 0)
        interval = self.cfg.update_extra_interval
        t0 = time.time()
        for it in range(total):
            st = state.step
            if st % interval == 0:
                occ = self.update_grid(state.params, state.occ, generator=state.rng,
                                       full=int(state.occ.iter_density) < 16)
                state = state._replace(occ=occ)
                self._maybe_retune_march(state)
            state, aux = self.train_step(state, data, with_stats=(st + 1) % interval == 0)
            if log_every and (it % log_every == 0 or it == total - 1):
                dt = time.time() - t0
                print(f"step {state.step:6d} loss {float(aux['loss']):.5f} "
                      f"({self.cfg.num_rays * (it + 1) / max(dt, 1e-9):,.0f} rays/s)")
            if callback is not None:
                callback(state, aux)
        return state

    # -------------------------------------------------------------- rendering

    def _render_chunk_impl(self, params, planes, occ: R.OccupancyState, rays_o, rays_d, bg_color):
        def field_fn(xyzs, dirs):
            return self.field(params, planes, xyzs, dirs)

        return R.render_occgrid(
            field_fn, rays_o, rays_d, occ.occ, self.eval_render_cfg, bg_color=bg_color,
            occ_coarse=occ.occ_coarse, occ_bbox=occ.bbox)

    def render_rays(self, params, occ, rays_o, rays_d, H, W, bg_color=None):
        """Full-frame render of precomputed rays in eval chunks."""
        if bg_color is None:
            bg_color = self.cfg.background_color
        return self._render_chunked(params, occ, rays_o, rays_d, H, W, bg_color)

    def render_image(self, params, occ, pose, intrinsics, H, W,
                     bg_color=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-frame render of one view in eval chunks.
        Returns (image (H, W, 3), depth (H, W)) on the trainer's device."""
        if bg_color is None:
            bg_color = self.cfg.background_color
        rays_o, rays_d = rays_full_image(np.asarray(pose), intrinsics, H, W)
        return self._render_chunked(params, occ, rays_o, rays_d, H, W, bg_color)

    @torch.no_grad()
    def _render_chunked(self, params, occ, rays_o, rays_d, H, W, bg_color):
        self._check_device(params, occ)
        rays_o = torch.as_tensor(rays_o, dtype=torch.float32, device=self.device).reshape(-1, 3)
        rays_d = torch.as_tensor(rays_d, dtype=torch.float32, device=self.device).reshape(-1, 3)
        planes = self.field.build_planes(params)
        imgs, deps = [], []
        for s in range(0, H * W, self.eval_chunk):
            out = self._render_chunk_impl(params, planes, occ, rays_o[s : s + self.eval_chunk],
                                          rays_d[s : s + self.eval_chunk], bg_color)
            imgs.append(out["image"])
            deps.append(out["depth"])
        return torch.cat(imgs).reshape(H, W, 3), torch.cat(deps).reshape(H, W)
