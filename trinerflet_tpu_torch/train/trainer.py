"""Training loop (port of ``trinerflet_tpu/train/trainer.py``): Adam with the
exponential-decay schedule, the parameter EMA, the loss, the occupancy
refresh cadence, the retune of the march's shapes (span, per-ray budget,
global layout), error-map and pregenerated-ray batches, random backgrounds,
CLIP guidance steps, full-frame rendering and evaluation (PSNR / SSIM), on
the occupancy-grid renderer, the proposal renderer (``renderer="proposal"``:
a grid-backed density proxy places the samples and trains on the interlevel
loss) or the dense renderer (``renderer="dense"``: uniform depths with
optional importance upsampling). The last two have no occupancy refresh and
no retune; their CLIP steps render through the dense renderer, as the JAX
package's do. Checkpoints are the JAX package's files (``train/
checkpoint.py``), read and written by both packages; ``load_model_for_stage``
grows a stage into the next and ``save_mesh`` exports the density's
iso-surface.

Differences from the JAX package, none of which changes a result:

* PyTorch runs eagerly, so there is no jitted, donated step. ``train_step``
  updates the parameters, the Adam moments and the EMA in place (no second
  copy of the state) and returns the state with its counters advanced; the
  ``TrainState`` passed in is consumed.
* Random draws come from the state's ``torch.Generator`` (on the trainer's
  device); tests pass the draws in instead (``batch``, ``jitter``).
* A non-triplane field with ``wavelet_regularization > 0`` raises at
  construction (the JAX package fails when it traces the step), and so does
  a renderer other than occgrid, proposal and dense (the JAX package renders
  any other name densely).
* ``render_rays`` / ``render_image`` build the planes once per call (the
  values are identical) and do not pad the last chunk (rays are
  independent).
* A retune re-plans the shapes of the next call (budget B, ``num_coarse``,
  the layout and its slots); there is nothing to recompile.
* On a process grid (``Trainer(..., mesh=parallel.make_mesh(M))``) every
  rank draws the global batch and keeps its contiguous data shard, and the
  collectives are explicit (``parallel/sharding.py``). The retune's
  statistics are the global batch's (gathered over the data group), and on
  the global layouts a data rank keeps the samples that one process's
  buffer of the global batch keeps at its place in row order (the host
  reads the shards' counts). A mesh ``evaluate`` splits the views over the
  data index, gathers the metric rows and writes ``<tag>.json`` on the
  primary rank; each view's PNGs come from the rank of model index 0 that
  rendered it. PNGs go through a small zlib PNG writer (no OpenCV).
* The wavelet levels that ``load_model_for_stage`` adds are drawn from a
  torch generator seeded with seed + 7, not from JAX's PRNG key of that
  seed; every carried leaf is the same.
* With a workspace, ``fit``'s log lines go through the port's
  ``ExperimentLogger`` (``log_trinerflet.txt``, tensorboardX scalars where
  it is installed) and ``__init__`` writes ``config.json``, as the JAX
  trainer does; the scalars read their floats on log steps only.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..data.images import write_png
from ..data.rays import (rand_poses, rays_full_image, sample_ray_batch,
                         sample_ray_batch_error_map, sample_ray_batch_pregen)
from ..models.nerf import NeRFConfig, NeRFField, init_nerf_params
from ..models.triplane import grow_params, wavelet_l1
from ..render import renderer as R
from ..render.proposal import ProposalConfig, init_proposal_params, interlevel_loss, render_proposal
from . import checkpoint, metrics

__all__ = ["TrainConfig", "TrainState", "Trainer", "adam_update", "lr_schedule", "global_slots_for",
           "write_png"]

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
    error_map: Optional[torch.Tensor] = None  # (V, G*G) sampling weights when enabled


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


def adam_update(params: List[torch.Tensor], grads: List[torch.Tensor], opt: Dict, lr_fn,
                decay: Optional[List[float]] = None) -> int:
    """optax.chain(scale_by_adam(0.9, 0.99, 1e-15)[, add_decayed_weights
    (``decay``: a coefficient per leaf, 0 for none)], scale_by_schedule(-lr))
    in place on ``params`` (leaves in ``_leaves`` order, as ``opt``'s
    ``mu`` / ``nu``). Returns the new update count."""
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
    if decay is not None:
        for u, p, wd in zip(upd, params, decay):
            if wd:
                u.add_(p, alpha=wd)
    torch._foreach_mul_(upd, -float(lr_fn(count - 1)))
    torch._foreach_add_(params, upd)
    return count


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


def _fresh_adam(params: Dict) -> Dict:
    return {"count": 0, "mu": _map(torch.zeros_like, params), "nu": _map(torch.zeros_like, params)}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _ema_of(prev: Optional[float], x: float) -> float:
    """The retune statistics' EMA: 0.5 prev + 0.5 x (x on the first read)."""
    return x if prev is None else 0.5 * prev + 0.5 * x


def global_slots_for(mean_samples: float) -> int:
    """Slots per ray of the global layout for a live mean of kept samples per
    ray: a buffer 1.5 x the mean, rounded up to an even count, at least 4."""
    return max(4, int(math.ceil(mean_samples * 1.5 / 2) * 2))


class Trainer:
    def __init__(self, nerf_cfg: NeRFConfig, render_cfg: R.RenderConfig,
                 train_cfg: TrainConfig, device: DeviceLike = None,
                 workspace: Optional[str] = None, mesh=None):
        """``mesh`` (``parallel.make_mesh``): train and evaluate on a (data,
        model) process grid, this process being one rank; ``train_step``
        then computes what one process computes for the same global batch,
        up to the order of float sums. Every rank makes the same calls in
        the same order."""
        if train_cfg.renderer not in ("occgrid", "proposal", "dense"):
            raise ValueError(f"unknown renderer {train_cfg.renderer!r} (occgrid, proposal, dense)")
        if train_cfg.wavelet_regularization > 0 and nerf_cfg.encoding != "triplane_wavelet":
            raise ValueError(f"wavelet_regularization > 0 regularises the wavelet triplane; the "
                             f"{nerf_cfg.encoding!r} field has none (set it to 0)")
        self.device = resolve_device(device)
        if mesh is not None and train_cfg.num_rays % mesh.data:
            raise ValueError(f"num_rays {train_cfg.num_rays} does not split into {mesh.data} "
                             f"data shards")
        self.mesh = mesh
        self.nerf_cfg = nerf_cfg
        self.render_cfg = render_cfg
        self.cfg = train_cfg
        self.field = NeRFField(nerf_cfg, mesh)
        self.lr_fn = lr_schedule(train_cfg)
        self.workspace = workspace
        self.logger = None
        if workspace and self._primary():
            from ..utils.logging import ExperimentLogger

            os.makedirs(workspace, exist_ok=True)
            self.logger = ExperimentLogger(workspace)
            self.logger.config({"nerf": nerf_cfg, "render": render_cfg, "train": train_cfg})
        # deep test-time rendering: wider per-ray budget, smaller ray chunks
        self.eval_render_cfg = render_cfg.for_eval()
        ratio = max(1, self.eval_render_cfg.samples_per_ray_budget
                    // max(render_cfg.samples_per_ray_budget, 1))
        self.eval_chunk = max(1024, train_cfg.eval_chunk // ratio)
        self._base_render_cfg = render_cfg   # configured (pre-retune) shapes
        self._budget_max = render_cfg.samples_per_ray_budget
        # retune state (trainer state, not TrainState): per-lever counts and
        # the EMAs of the statistics each lever reads
        self._march_retunes = self._budget_retunes = self._global_retunes = 0
        self._span_trunc_ema = self._span_p99_ema = self._needed_seg_ema = None
        self._budget_p99_ema = self._trunc_T_ema = None
        self.clip_loss: Optional[Callable] = None  # set_clip_guidance
        self.rand_pose_interval = -1
        self.prop_cfg = None
        if train_cfg.renderer == "proposal":
            self.prop_cfg = ProposalConfig(num_proposal_samples=train_cfg.proposal_samples,
                                           num_final_samples=train_cfg.proposal_final)

    # ------------------------------------------------------------------ state

    def init_params(self, generator: Optional[torch.Generator] = None) -> Dict:
        """Seeded random parameters (``TrainConfig.seed`` by default), with
        the ``proposal`` subtree on the proposal renderer."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        params = init_nerf_params(self.nerf_cfg, generator, self.device)
        if self.prop_cfg is not None:
            params["proposal"] = init_proposal_params(self.prop_cfg, generator, self.device)
        return params

    def init_occupancy(self, density_grid=None) -> R.OccupancyState:
        return R.init_occupancy(self.render_cfg, self.device, density_grid)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   density_grid: Optional[np.ndarray] = None) -> TrainState:
        """Fresh training state: seeded params, zero Adam moments, the EMA
        equal to the params, an empty occupancy state (or one holding
        ``density_grid``, e.g. from ``mark_untrained_grid``) and the step
        generator seeded with ``TrainConfig.seed``. On a mesh, this rank's
        shard of the same state (``parallel.shard_state``)."""
        state = self._full_state(generator, density_grid)
        return self._shard(state)

    def _shard(self, state: TrainState) -> TrainState:
        if self.mesh is None:
            return state
        from ..parallel.sharding import shard_state

        return shard_state(self.mesh, state)

    def _primary(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _full_state(self, generator, density_grid=None) -> TrainState:
        params = _map(lambda t: t.requires_grad_(True), self.init_params(generator))
        return TrainState(
            params=params,
            opt_state=_fresh_adam(params),
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
        """Params (every leaf) and state must live on the trainer's device: a
        state carried onto another device would otherwise run there until the
        first mixed op."""
        for name, t in [("params", t) for _, t in _leaves(params)] + [("occupancy", occ.occ)]:
            if t.device.type != self.device.type:
                raise ValueError(f"{name} are on {t.device}, the trainer on {self.device}; "
                                 f"move them or build the trainer with device={t.device.type!r}")

    def scene_to_device(self, scene) -> Dict:
        """A scene as the train step reads it: a pinhole ``SceneData``, or
        any scene with pregenerated per-view ray grids (``rays_o`` /
        ``rays_d`` (V, H, W, 3), e.g. NDC rays)."""
        if getattr(scene, "rays_o", None) is not None:
            return {k: torch.as_tensor(np.asarray(getattr(scene, k)), dtype=torch.float32,
                                       device=self.device)
                    for k in ("images", "rays_o", "rays_d")}
        return {
            "images": torch.as_tensor(np.asarray(scene.images), dtype=torch.float32,
                                      device=self.device),
            "poses": torch.as_tensor(np.asarray(scene.poses), dtype=torch.float32,
                                     device=self.device),
            # on the device: the rays divide by them truly (``rays_for_pixels``)
            "intrinsics": torch.tensor([float(np.float32(x)) for x in scene.intrinsics],
                                       dtype=torch.float32, device=self.device),
        }

    # ------------------------------------------------------------ train step

    def _loss_fn(self, params: Dict, occ: R.OccupancyState, data: Dict,
                 batch: Optional[Dict], with_stats: bool, generator: torch.Generator,
                 error_map: Optional[torch.Tensor] = None):
        """Loss and aux of one batch. The draws come from ``generator`` in
        the order batch, background, then noise (occgrid) or jitter and u
        (proposal, dense), unless ``batch`` holds them: ``img_idx`` /
        ``pix_idx`` (uniform and pregenerated batches), ``img_idx`` / ``u`` /
        ``jx`` / ``jy`` (error-map batches), ``bg`` (N, 3)
        (``train_rand_bg``), ``noise`` (N,), ``prop_jitter`` (N, P+1) and
        ``prop_u`` (N, F), ``dense_jitter`` (N, num_steps) and ``dense_u``
        (N, upsample_steps).
        With error-map sampling aux carries ``_new_error_map``, the map after
        its EMA update."""
        cfg = self.cfg
        N = cfg.num_rays
        batch = batch or {}
        err_info = None
        if "rays_o" in data:
            rays_o, rays_d, pixels = sample_ray_batch_pregen(
                data["images"], data["rays_o"], data["rays_d"], N, generator,
                batch.get("img_idx"), batch.get("pix_idx"))
        elif cfg.error_map and error_map is not None:
            rays_o, rays_d, pixels, err_info = sample_ray_batch_error_map(
                data["images"], data["poses"], data["intrinsics"], N, error_map, generator,
                batch.get("img_idx"), batch.get("u"), batch.get("jx"), batch.get("jy"))
        else:
            rays_o, rays_d, pixels = sample_ray_batch(
                data["images"], data["poses"], data["intrinsics"], N, generator,
                batch.get("img_idx"), batch.get("pix_idx"))
        shard = self._data_shard
        rays_o, rays_d, pixels = shard(rays_o), shard(rays_d), shard(pixels)
        if cfg.train_rand_bg:
            bg = batch.get("bg")
            if bg is None:
                bg = torch.rand((N, 3), generator=generator, device=generator.device)
            bg = shard(bg.to(self.device, torch.float32))
        else:
            bg = torch.full((rays_o.shape[0], 3), cfg.background_color, dtype=torch.float32,
                            device=self.device)
        if pixels.shape[-1] == 4:
            gt = pixels[..., :3] * pixels[..., 3:] + bg * (1 - pixels[..., 3:])
        else:
            gt = pixels

        planes = self.field.build_planes(params)
        if cfg.renderer == "proposal":
            jitter, u = self._global_draws(batch, generator, ("prop_jitter", self.prop_cfg.
                                                              num_proposal_samples + 1),
                                           ("prop_u", self.prop_cfg.num_final_samples))
            out = render_proposal(
                lambda x: self.field.density(params, planes, x),
                lambda d, g: self.field.color(params, d, g),
                params["proposal"], rays_o, rays_d, self.render_cfg, self.prop_cfg, bg_color=bg,
                perturb=True, jitter=jitter, u=u, generator=generator)
        elif cfg.renderer == "dense":
            ups = self.render_cfg.upsample_steps
            jitter, u = self._global_draws(batch, generator,
                                           ("dense_jitter", self.render_cfg.num_steps),
                                           ("dense_u", ups if ups > 0 else None))
            out = R.render_dense(
                lambda x: self.field.density(params, planes, x),
                lambda d, g: self.field.color(params, d, g),
                rays_o, rays_d, self.render_cfg, bg_color=bg, perturb=True,
                jitter=jitter, u=u, generator=generator)
        else:
            noise = batch.get("noise")
            if noise is None:
                noise = torch.rand((N,), generator=generator, device=generator.device)

            def field_fn(xyzs, dirs):
                return self.field(params, planes, xyzs, dirs)

            out = R.render_occgrid(field_fn, rays_o, rays_d, occ.occ, self.render_cfg,
                                   noise=shard(noise.to(self.device, torch.float32)), bg_color=bg,
                                   occ_coarse=occ.occ_coarse, occ_bbox=occ.bbox,
                                   with_stats=with_stats, ray_gather=self._ray_gather())
        pred = out["image"]
        loss_pix = _criterion(cfg, pred, gt)
        loss = loss_pix.mean()
        aux = {"mse": ((pred - gt) ** 2).mean()}
        if cfg.renderer == "proposal" and cfg.lambda_interlevel > 0:
            il = interlevel_loss(out)
            loss = loss + cfg.lambda_interlevel * il
            aux["interlevel"] = il
        if cfg.wavelet_regularization > 0:
            reg = wavelet_l1(params["encoder"], self.nerf_cfg.triplane, cfg.weighted_regularization)
            if self.mesh is not None and self.mesh.model > 1:
                # the global mean |coef| of a level is the mean of its
                # channel shards' means
                reg = reg / self.mesh.model
            loss = loss + cfg.wavelet_regularization * reg
            aux["wavelet_reg"] = reg
        if cfg.alpha_bce > 0:
            alpha = torch.clamp(out["weights_sum"], 0.01, 0.99)
            loss = loss + (-cfg.alpha_bce * torch.log(alpha).mean())
        if cfg.z_variance_reg > 0 and "z_variance" in out:
            loss = loss + cfg.z_variance_reg * out["z_variance"].mean()
        for k in ("num_samples", "samples_p99", "overflow_frac", "global_fill", "trunc_T",
                  "samples_mean", "span_p99", "span_trunc_T", "needed_seg_p99"):
            if k in out:
                aux[k] = out[k]
        if err_info is not None:
            # EMA of the per-cell training error: 0.1 old + 0.9 new, at the
            # global batch's cells (a mesh gathers the errors in its order)
            img_idx, cell = err_info
            err = loss_pix.detach()
            gather = self._ray_gather()
            if gather is not None:
                err = gather(err)
            flat = img_idx * error_map.shape[1] + cell
            new_map = error_map.reshape(-1).clone()
            new_map[flat] = 0.1 * error_map.reshape(-1)[flat] + 0.9 * err
            aux["_new_error_map"] = new_map.reshape(error_map.shape)
        return loss, aux

    def _data_shard(self, t: torch.Tensor) -> torch.Tensor:
        """This data rank's contiguous rows of a global-batch tensor."""
        if self.mesh is None:
            return t
        n = t.shape[0] // self.mesh.data
        return t[self.mesh.data_index * n:(self.mesh.data_index + 1) * n]

    def _ray_gather(self) -> Optional[Callable]:
        """The data group's gather of per-ray rows in global order (None
        off a mesh or on one data rank)."""
        if self.mesh is None or self.mesh.data == 1:
            return None
        from ..parallel.sharding import RayGather

        return RayGather(self.mesh)

    def _global_draws(self, batch: Dict, generator: torch.Generator, *specs):
        """The (name, width) draws of the proposal or dense renderer: the
        injected ones, or on a data axis of several ranks the global batch's
        drawn here in the renderer's order (U[0, 1) of (N, width) each),
        then this rank's rows; else None (the renderer draws them)."""
        N = self.cfg.num_rays
        out = []
        for name, width in specs:
            t = batch.get(name)
            if t is None and width is not None and self._ray_gather() is not None:
                t = torch.rand((N, width), generator=generator, dtype=torch.float32,
                               device=generator.device)
            out.append(None if t is None else self._data_shard(t.to(self.device, torch.float32)))
        return out

    def _global_aux(self, aux: Dict, reg_term: Optional[torch.Tensor]) -> Dict:
        """The logged scalars of the global batch: on a mesh the data
        rank's means averaged over the data group and the regulariser's
        channel shards summed over the model group."""
        mesh = self.mesh
        if mesh is None:
            return aux
        from ..parallel.sharding import DATA_AXIS, MODEL_AXIS

        keys = [k for k in ("loss", "mse", "interlevel") if k in aux]
        out = dict(aux)
        if reg_term is not None:
            out["loss"] = aux["loss"] - reg_term
        if mesh.data > 1:
            vals = mesh.all_reduce(torch.stack([out[k].float() for k in keys]), DATA_AXIS) / mesh.data
            out.update(zip(keys, vals.unbind()))
        if reg_term is not None:
            terms = torch.stack([reg_term.float(), aux["wavelet_reg"].float()])
            if mesh.model > 1:
                terms = mesh.all_reduce(terms, MODEL_AXIS)
            out["loss"] = out["loss"] + terms[0]
            out["wavelet_reg"] = terms[1]
        return out

    def train_step(self, state: TrainState, data: Dict, with_stats: bool = True,
                   batch: Optional[Dict] = None) -> Tuple[TrainState, Dict]:
        """One optimisation step on ``num_rays`` rays: loss, gradients (the
        K4 adjoint, K2 and K3 backward kernels on CUDA), Adam and the EMA.
        ``batch`` may hold the step's draws (see ``_loss_fn``). Returns (new
        state, aux with ``loss``)."""
        self._check_device(state.params, state.occ)
        named = _leaves(state.params)
        leaves = [p.requires_grad_(True) for _, p in named]
        loss, aux = self._loss_fn(state.params, state.occ, data, batch, with_stats, state.rng,
                                  state.error_map)
        error_map = aux.pop("_new_error_map", state.error_map)
        state = self._apply_grads(state, named, leaves, loss)
        return state._replace(error_map=error_map), self._step_aux(loss, aux)

    def _step_aux(self, loss: torch.Tensor, aux: Dict) -> Dict:
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        reg_term = None
        if "wavelet_reg" in aux:
            reg_term = self.cfg.wavelet_regularization * aux["wavelet_reg"]
        return self._global_aux(aux, reg_term)

    def gradients(self, state: TrainState, data: Dict, with_stats: bool = True,
                  batch: Optional[Dict] = None) -> Tuple[Dict, Dict]:
        """The gradient ``train_step`` would apply (after the mesh's
        reductions) as a tree like ``state.params``, and the step's aux;
        nothing is updated except the generator's draws."""
        named = _leaves(state.params)
        leaves = [p.requires_grad_(True) for _, p in named]
        loss, aux = self._loss_fn(state.params, state.occ, data, batch, with_stats, state.rng,
                                  state.error_map)
        aux.pop("_new_error_map", None)
        grads = self._grads(named, leaves, loss)
        tree: Dict = {}
        for (name, _), g in zip(named, grads):
            node = tree
            *path, last = name.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[last] = g
        return tree, self._step_aux(loss, aux)

    def _grads(self, named, leaves: List[torch.Tensor], loss: torch.Tensor) -> List[torch.Tensor]:
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        if self.mesh is not None:
            from ..parallel.sharding import reduce_gradients

            grads = reduce_gradients(self.mesh, [n for n, _ in named], grads)
        return grads

    def _apply_grads(self, state: TrainState, named, leaves: List[torch.Tensor],
                     loss: torch.Tensor) -> TrainState:
        """Gradients of ``loss`` (reduced over the mesh), then Adam and the
        EMA in place; the step advances."""
        grads = self._grads(named, leaves, loss)
        with torch.no_grad():
            count = self._adam([n for n, _ in named], leaves, grads, state.opt_state)
            ema_count = self._ema(state, leaves)
        return state._replace(opt_state=dict(state.opt_state, count=count), ema_count=ema_count,
                              step=state.step + 1)

    def _adam(self, names: List[str], params: List[torch.Tensor], grads: List[torch.Tensor],
              opt: Dict) -> int:
        """optax.chain(scale_by_adam(0.9, 0.99, 1e-15)[, add_decayed_weights
        on the MLP groups], scale_by_schedule(-lr)) applied in place."""
        decay = None
        if self.cfg.mlp_weight_decay > 0:
            decay = [self.cfg.mlp_weight_decay if n.split(".")[0] in ("sigma_net", "color_net") else 0.0
                     for n in names]
        return adam_update(params, grads, opt, self.lr_fn, decay)

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

    def _maybe_retune_march(self, state: TrainState, aux: Optional[Dict] = None) -> None:
        """Adapt the march's shapes to the live statistics (the JAX package's
        retune, lever for lever). All levers wait for the occupancy to
        settle (iter_density >= 6); each retunes at most 4 times. ``aux`` is
        the last train step's (its floats are read here, once per refresh).

        (a) Span: ``num_coarse`` to the occupied bbox's diagonal and, with
            ``budget_autotune``, to min(the span-p99 rule, the needed-segment
            rule) while spatially truncated rays end opaque (EMA of
            span_trunc_T <= budget_trunc_tol), else grow back to the worst
            case; a multiple of 8 in [8, worst]. Eval keeps the configured
            config with the bbox span.
        (b) Budget B (``budget_autotune``): x2 (up to the configured B)
            while > 2% of rays overflow and the EMA of capped rays' residual
            transmittance exceeds the tolerance, else min(1.3 x p99 EMA,
            1.4 x live mean) rounded up to 4, floor 8.
        (c) Layout (``budget_autotune``): switch to the global buffer at
            S = max(4, ceil(1.5 mean / 2) 2) slots per ray when S <= 0.8 B;
            double S when the buffer is over 85% full, back to per-ray once
            S >= B."""
        cfg = self.render_cfg
        if (cfg.march != "hierarchical" or self.cfg.renderer != "occgrid"
                or int(state.occ.iter_density) < 6):
            return
        tune = self.cfg.budget_autotune and aux is not None
        if self._march_retunes < 4:
            bbox_t = R.tuned_num_coarse(cfg, state.occ.bbox.detach().cpu().numpy())
            span_t = None
            seg = 2.0 * math.sqrt(3.0) / cfg.max_steps * cfg.fine_per_coarse
            worst = int(math.ceil(cfg.bound * cfg.max_steps / cfg.fine_per_coarse))
            if tune and "span_p99" in aux:
                self._span_trunc_ema = _ema_of(self._span_trunc_ema, float(aux["span_trunc_T"]))
                self._span_p99_ema = _ema_of(self._span_p99_ema, float(aux["span_p99"]))
                if aux.get("needed_seg_p99") is not None:
                    self._needed_seg_ema = _ema_of(self._needed_seg_ema,
                                                   float(aux["needed_seg_p99"]))
                if self._span_trunc_ema <= self.cfg.budget_trunc_tol:
                    span_t = int(math.ceil(self._span_p99_ema * 1.1 / seg)) + 2
                    if self._needed_seg_ema is not None:
                        span_t = min(span_t, int(math.ceil(self._needed_seg_ema * 1.1)) + 2)
                    span_t = min(worst, max(8, (span_t + 7) // 8 * 8))
                elif cfg.num_coarse_override:
                    span_t = worst  # truncated rays are losing visible mass
            cands = [t for t in (bbox_t, span_t) if t is not None]
            target = min(cands) if cands else None
            cur = cfg.num_coarse_override or worst
            if target is not None and (target < int(cur * 0.9) or target > cur):
                self.render_cfg = dataclasses.replace(cfg, num_coarse_override=target)
                # eval derives from the configured cfg: the exact-safe bbox span
                self.eval_render_cfg = dataclasses.replace(
                    self._base_render_cfg,
                    num_coarse_override=bbox_t or self._base_render_cfg.num_coarse_override,
                ).for_eval()
                self._march_retunes += 1

        if tune and self._budget_retunes < 4 and "samples_p99" in aux:
            self._budget_p99_ema = _ema_of(self._budget_p99_ema, float(aux["samples_p99"]))
            self._trunc_T_ema = _ema_of(self._trunc_T_ema, float(aux.get("trunc_T", 1.0)))
            cfg = self.render_cfg
            cur = cfg.samples_per_ray_budget
            if float(aux["overflow_frac"]) > 0.02 and self._trunc_T_ema > self.cfg.budget_trunc_tol:
                target = min(self._budget_max, cur * 2)
            else:
                t_p99 = int(math.ceil(self._budget_p99_ema * 1.3 / 4) * 4)
                t_mean = int(math.ceil(float(aux.get("samples_mean", cur)) * 1.4 / 4) * 4)
                target = min(self._budget_max, max(8, min(t_p99, t_mean)))
            if target > cur or target < int(cur * 0.75):
                self.render_cfg = dataclasses.replace(cfg, samples_per_ray_budget=target)
                self._budget_retunes += 1

        if tune and self._global_retunes < 4 and "num_samples" in aux:
            cfg = self.render_cfg
            B = cfg.samples_per_ray_budget
            if cfg.compaction == "global" and float(aux.get("global_fill", 0.0)) > 0.85:
                slots = cfg.global_slots_per_ray * 2
                if slots >= B:  # the buffer would be as large as the per-ray layout
                    self.render_cfg = dataclasses.replace(cfg, compaction="per_ray",
                                                          global_slots_per_ray=0)
                else:
                    self.render_cfg = dataclasses.replace(cfg, global_slots_per_ray=slots)
                self._global_retunes += 1
            elif cfg.compaction == "per_ray" and self._global_retunes == 0:
                slots = global_slots_for(float(aux["num_samples"]) / self.cfg.num_rays)
                if slots <= int(B * 0.8):
                    self.render_cfg = dataclasses.replace(cfg, compaction="global",
                                                          global_slots_per_ray=slots)
                    self._global_retunes += 1

    def fit(self, state: TrainState, scene, log_every: int = 100, callback=None) -> TrainState:
        """Run ``iters`` (+ warmup) steps on the JAX package's cadence: on
        the occgrid renderer every ``update_extra_interval`` steps a density
        refresh (full while iter_density < 16, then the rotating quarter)
        and the retune on the last step's aux; the p99 statistics only on
        the step before each refresh. The proposal and dense renderers have
        neither.
        With error-map sampling the map starts at ones over min(128, H,
        W)^2 cells per view. With CLIP guidance
        (``set_clip_guidance``) one CLIP step follows every k supervised
        steps (k = ``rand_pose_interval`` > 0), or every step is one (k = 0)."""
        data = self.scene_to_device(scene)
        if self.cfg.error_map and state.error_map is None and "poses" in data:
            V, H, W = data["images"].shape[:3]
            state = state._replace(error_map=torch.ones((V, min(128, H, W) ** 2),
                                                        dtype=torch.float32, device=self.device))
        total = self.cfg.iters + max(self.cfg.warmup_steps, 0)
        interval = self.cfg.update_extra_interval
        k = self.rand_pose_interval
        t0 = time.time()
        last_aux = None
        for it in range(total):
            st = state.step
            if self.cfg.renderer == "occgrid" and st % interval == 0:
                occ = self.update_grid(state.params, state.occ, generator=state.rng,
                                       full=int(state.occ.iter_density) < 16)
                state = state._replace(occ=occ)
                self._maybe_retune_march(state, last_aux)
            if self.clip_loss is not None and (k == 0 or (k > 0 and it % (k + 1) == k)):
                state, clip_l = self.clip_guidance_step(state)
                if k == 0:
                    if callback is not None:
                        callback(state, {"loss": clip_l, "clip_loss": clip_l})
                    continue
            state, aux = self.train_step(state, data, with_stats=(st + 1) % interval == 0)
            last_aux = aux
            if log_every and (it % log_every == 0 or it == total - 1):
                dt = time.time() - t0
                msg = (f"step {state.step:6d} loss {float(aux['loss']):.5f} "
                       f"({self.cfg.num_rays * (it + 1) / max(dt, 1e-9):,.0f} rays/s)")
                if self.logger is not None:
                    self.logger.text(msg)
                    scal = {k: v for k, v in aux.items() if v.ndim == 0}
                    scal["lr"] = self.lr_fn(state.step)
                    self.logger.scalars(state.step, scal)
                elif self._primary():
                    print(msg)
            if callback is not None:
                callback(state, aux)
        return state

    # ---------------------------------------------------------- CLIP guidance

    def set_clip_guidance(self, clip_loss: Callable, rand_pose_interval: int,
                          radius: Optional[float] = None) -> None:
        """Enable random-pose CLIP steps: ``clip_loss(image (1, H, W, 3)) ->
        scalar`` is any differentiable callable (``utils.clip_loss.CLIPLoss``
        for the CLIP network). ``rand_pose_interval`` k: one CLIP step after every k
        supervised steps; k = 0: CLIP steps only. The render is a full frame
        of side max(16, sqrt(num_rays)) from an orbit pose at ``radius``
        (the scene bound by default), perturbed, on the occgrid renderer or
        else the dense one."""
        self.clip_loss = clip_loss
        self.rand_pose_interval = int(rand_pose_interval)
        self.clip_radius = radius if radius is not None else self.render_cfg.bound
        side = max(16, int(math.sqrt(self.cfg.num_rays)))
        self.clip_hw = (side, side)
        self._clip_rng = np.random.default_rng(self.cfg.seed + 7)

    def _clip_loss_fn(self, params: Dict, occ: R.OccupancyState, rays_o, rays_d,
                      generator: torch.Generator, noise=None, jitter=None, u=None):
        """CLIP loss of a perturbed render on a white background: the
        occgrid renderer (ray ``noise``) or else the dense one (``jitter``
        and ``u``); absent draws come from ``generator``."""
        H, W = self.clip_hw
        planes = self.field.build_planes(params)
        bg = torch.ones((rays_o.shape[0], 3), dtype=torch.float32, device=self.device)
        if self.cfg.renderer == "occgrid":
            if noise is None:
                noise = torch.rand((rays_o.shape[0],), generator=generator, device=generator.device)

            def field_fn(xyzs, dirs):
                return self.field(params, planes, xyzs, dirs)

            out = R.render_occgrid(field_fn, rays_o, rays_d, occ.occ, self.render_cfg,
                                   noise=noise.to(self.device, torch.float32), bg_color=bg,
                                   occ_coarse=occ.occ_coarse, occ_bbox=occ.bbox, with_stats=False)
        else:
            out = R.render_dense(lambda x: self.field.density(params, planes, x),
                                 lambda d, g: self.field.color(params, d, g),
                                 rays_o, rays_d, self.render_cfg, bg_color=bg, perturb=True,
                                 jitter=jitter, u=u, generator=generator)
        return self.clip_loss(out["image"].reshape(1, H, W, 3))

    def _clip_step(self, state: TrainState, rays_o: torch.Tensor, rays_d: torch.Tensor,
                   noise: Optional[torch.Tensor] = None, jitter: Optional[torch.Tensor] = None,
                   u: Optional[torch.Tensor] = None) -> Tuple[TrainState, torch.Tensor]:
        """One optimisation step on the CLIP loss of the given rays (Adam and
        the EMA as a supervised step). The render's draws may be injected:
        ``noise`` (N,) on the occgrid renderer, ``jitter`` (N, num_steps)
        and ``u`` (N, upsample_steps) on the dense one."""
        self._check_device(state.params, state.occ)
        named = _leaves(state.params)
        leaves = [p.requires_grad_(True) for _, p in named]
        loss = self._clip_loss_fn(state.params, state.occ, rays_o, rays_d, state.rng, noise,
                                  jitter, u)
        return self._apply_grads(state, named, leaves, loss), loss.detach()

    def clip_guidance_step(self, state: TrainState) -> Tuple[TrainState, torch.Tensor]:
        """Draw one random orbit pose on the host and take a CLIP step
        (focal for a ~53 degree field of view at the render size)."""
        H, W = self.clip_hw
        pose = rand_poses(self._clip_rng, 1, radius=self.clip_radius)[0]
        f = 0.5 * W / math.tan(0.5 * math.radians(53.0))
        ro, rd = rays_full_image(pose, (f, f, W / 2, H / 2), H, W)
        return self._clip_step(state, torch.as_tensor(ro, device=self.device),
                               torch.as_tensor(rd, device=self.device))

    # -------------------------------------------------------------- rendering

    def _render_chunk_impl(self, params, planes, occ: R.OccupancyState, rays_o, rays_d, bg_color):
        if self.cfg.renderer == "proposal":
            return render_proposal(
                lambda x: self.field.density(params, planes, x),
                lambda d, g: self.field.color(params, d, g),
                params["proposal"], rays_o, rays_d, self.eval_render_cfg, self.prop_cfg,
                bg_color=bg_color, perturb=False)
        if self.cfg.renderer == "dense":
            return R.render_dense(
                lambda x: self.field.density(params, planes, x),
                lambda d, g: self.field.color(params, d, g),
                rays_o, rays_d, self.eval_render_cfg, bg_color=bg_color, occ=occ.occ)

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

    # ------------------------------------------------------------- evaluation

    def evaluate(self, state: TrainState, scene, use_ema: bool = True,
                 save_dir: Optional[str] = None, tag: str = "results") -> Dict:
        """Render every view of ``scene`` with the eval config (EMA params by
        default) and score it against the ground truth, alpha composited over
        the background: returns {"PSNR", "SSIM" (means), "per_image"}. Writes
        ``<workspace>/<tag>.json`` when a workspace is set, and with
        ``save_dir`` each view's RGB and span-normalised depth as PNGs.
        On a mesh each data index renders its round-robin views (its model
        group together), the rows are gathered (``parallel.multihost``) and
        every rank returns the whole table; the table is written on the
        primary rank, each view's PNGs by the model index 0 rank that
        rendered it."""
        from ..parallel.multihost import allgather_rows, process_view_slice

        params = state.ema_params if (use_ema and self.cfg.ema_decay > 0) else state.params
        mesh = self.mesh
        views = range(scene.num_views) if mesh is None else process_view_slice(scene.num_views, mesh)
        write_pngs = save_dir and (mesh is None or mesh.model_index == 0)
        rows = []
        for v in views:
            if getattr(scene, "rays_o", None) is not None:
                img, dep = self.render_rays(params, state.occ, scene.rays_o[v], scene.rays_d[v],
                                            scene.H, scene.W)
            else:
                img, dep = self.render_image(params, state.occ, scene.poses[v], scene.intrinsics,
                                             scene.H, scene.W)
            gt = torch.as_tensor(np.asarray(scene.images[v]), dtype=torch.float32,
                                 device=self.device)
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + self.cfg.background_color * (1 - gt[..., 3:])
            rows.append({"view": v, "PSNR": metrics.psnr(img, gt), "SSIM": metrics.ssim(img, gt)})
            if write_pngs:
                os.makedirs(save_dir, exist_ok=True)
                rgb8 = (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
                write_png(os.path.join(save_dir, f"{tag}_{v:03d}.png"), rgb8)
                d8 = (dep.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
                write_png(os.path.join(save_dir, f"{tag}_{v:03d}_depth.png"), d8)
        if mesh is not None:
            table = allgather_rows(np.asarray([[r["view"], r["PSNR"], r["SSIM"]] for r in rows],
                                              np.float32).reshape(-1, 3), scene.num_views, mesh)
            rows = [{"view": int(r[0]), "PSNR": float(r[1]), "SSIM": float(r[2])} for r in table]
        results = {
            "PSNR": float(np.mean([r["PSNR"] for r in rows])) if rows else float("nan"),
            "SSIM": float(np.mean([r["SSIM"] for r in rows])) if rows else float("nan"),
            "per_image": rows,
        }
        if self.workspace and self._primary():
            with open(os.path.join(self.workspace, f"{tag}.json"), "w") as f:
                json.dump(results, f, indent=2)
        return results

    def save_mesh(self, state: TrainState, path: str, resolution: int = 256,
                  threshold: float = 10.0):
        """The density's iso-surface as an OBJ: the field (``state.params``)
        queried on the trainer's device over a resolution^3 grid of
        [-bound, bound]^3, marching tetrahedra on the host. Returns
        (vertices, faces)."""
        from ..ops.meshing import extract_mesh, write_obj

        params = state.params
        with torch.no_grad():
            planes = self.field.build_planes(params)

            def density_fn(pts):
                x = torch.as_tensor(pts, dtype=torch.float32, device=self.device)
                return _to_numpy(self.field.density(params, planes, x)[0].float())

            verts, faces = extract_mesh(density_fn, bound=self.nerf_cfg.bound,
                                        resolution=resolution, threshold=threshold)
        if self._primary():
            write_obj(path, verts, faces)
        return verts, faces

    # ----------------------------------------------------------- checkpoints

    def save_checkpoint(self, state: TrainState, path: str, full: bool = True) -> None:
        """The JAX package's checkpoint (``train/checkpoint.py``): params, EMA
        and its count, step, the density grid and its mean, and with
        ``full`` the optimiser state as the JAX trainer's optax chain. On a
        mesh every rank calls it: the shards are gathered over the model
        group and the primary rank writes the file a single process
        writes."""
        if self.mesh is not None:
            from ..parallel.sharding import gather_state

            state = gather_state(self.mesh, state)
            if not self._primary():
                return
        payload = {
            "params": _map(_to_numpy, state.params),
            "ema_params": _map(_to_numpy, state.ema_params),
            "ema_count": int(state.ema_count),
            "step": int(state.step),
            "density_grid": _to_numpy(state.occ.density_grid),
            "mean_density": float(state.occ.mean_density),
        }
        if full:
            adam = dict(state.opt_state, mu=_map(_to_numpy, state.opt_state["mu"]),
                        nu=_map(_to_numpy, state.opt_state["nu"]))
            payload["opt_state"] = checkpoint.optax_chain_state(adam, self.cfg.mlp_weight_decay > 0)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        checkpoint.save(path, payload)

    def load_checkpoint(self, path: str, state: Optional[TrainState] = None) -> TrainState:
        """A checkpoint of either package into ``state`` (a fresh
        ``init_state()`` by default): params, EMA, counts, the density grid
        and its stored mean, the Adam state when the file holds one. occ,
        occ_coarse and bbox are rebuilt from the grid at the stored mean's
        threshold (K6 on CUDA); ``iter_density``, the step generator and the
        error map stay ``state``'s. On a mesh every rank loads the file and
        keeps its shard."""
        from ..carry import adam_state_from_jax, params_from_jax

        payload = checkpoint.load(path)
        cut = self._shard_tree
        if state is None:
            state = self.init_state()
        mean = float(payload["mean_density"])
        grid = torch.as_tensor(np.asarray(payload["density_grid"], np.float32), device=self.device)
        occ_bits, occ_coarse, bbox = R.occupancy_rebuild(grid, mean, self.render_cfg)
        occ = state.occ._replace(
            density_grid=grid,
            mean_density=torch.tensor(mean, dtype=torch.float32, device=self.device),
            occ=occ_bits, occ_coarse=occ_coarse, bbox=bbox)
        state = state._replace(
            params=_map(lambda t: t.requires_grad_(True),
                        cut(params_from_jax(payload["params"], self.device))),
            ema_params=cut(params_from_jax(payload["ema_params"], self.device)),
            ema_count=int(payload["ema_count"]),
            step=int(payload["step"]),
            occ=occ,
        )
        if "opt_state" in payload:
            adam = adam_state_from_jax(payload["opt_state"], self.device)
            state = state._replace(opt_state=dict(adam, mu=cut(adam["mu"]), nu=cut(adam["nu"])))
        return state

    def _shard_tree(self, tree: Dict) -> Dict:
        """This rank's slice of a full-width param-shaped tree (the tree
        itself off a mesh)."""
        if self.mesh is None:
            return tree
        from ..parallel.sharding import shard_params

        return shard_params(self.mesh, tree)

    def load_model_for_stage(self, path: str, generator: Optional[torch.Generator],
                             old_nerf_cfg: NeRFConfig) -> TrainState:
        """Cross-stage resume: a fresh state (``init_state(generator)``) whose
        triplane pyramid takes over the previous (smaller) stage's base and
        every level of matching shape (``grow_params``; new levels drawn
        with seed + 7), and whose MLPs are the previous stage's; fresh Adam
        moments, the EMA equal to the params."""
        from ..carry import params_from_jax

        old = params_from_jax(checkpoint.load(path)["params"], self.device)
        state = self._full_state(generator)
        new = dict(state.params)
        new["encoder"] = grow_params(old["encoder"], old_nerf_cfg.triplane, self.nerf_cfg.triplane,
                                     torch.Generator().manual_seed(self.cfg.seed + 7), self.device)
        for k in ("sigma_net", "color_net", "bg_net"):
            if k in old and k in new:
                new[k] = old[k]
        params = _map(lambda t: t.detach().requires_grad_(True), new)
        return self._shard(state._replace(params=params, opt_state=_fresh_adam(params),
                                          ema_params=_map(lambda t: t.detach().clone(), params)))
