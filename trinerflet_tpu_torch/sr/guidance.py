"""Diffusion x4-upscaler guidance: SDEdit refinement and SDS gradients (port
of ``trinerflet_tpu/sr/guidance.py``).

* ``DiffusionSchedule``: DDPM / DDIM schedule math of diffusers 0.16 with
  the x4 upscaler's scheduler config (scaled-linear betas in [1e-4, 0.02],
  1,000 train steps, ``steps_offset=1``, ``set_alpha_to_one=False``).
* ``UpscalerGuidance.generate_sr``: SDEdit. Noise the LR condition at
  ``noise_level``; run the DDIM ladder conditioned on ``concat(latents,
  noisy_LR)``: timesteps above ``ignore_t`` only re-noise the encoded HR
  render toward the next timestep, those below denoise with classifier-free
  guidance (text, or image CFG with a noised "-1" image when
  ``guidance_scale_sr > 1``).
* ``sds_loss``: the reparameterised score-distillation loss; ``step_bounds``
  the timestep range with the linear anneal of ``max_step_percent``.

The denoiser is abstract: ``denoiser(latents_cat (B, C, H, W), t,
noise_level, text_cond) -> eps``; ``sr.diffusion.make_unet_denoiser`` plugs
in the x4 upscaler's UNet. Without weights, ``OracleDenoiser`` and
``ConditioningDenoiser`` run the same DDIM algebra, and
``make_resize_guidance`` gives a weights-free pseudo-GT.

Images are NCHW in [0, 1] here (the JAX package's are NHWC). Every random
draw goes through ``_randn`` / ``_randint`` with the caller's generator, in
the JAX package's order (the tests hand both packages the same draws).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..ops.resize import resize
from .config import C, ScheduledFloat

__all__ = [
    "DiffusionSchedule", "GuidanceConfig", "UpscalerGuidance", "Text2ImgGuidance",
    "OracleDenoiser", "ConditioningDenoiser", "make_oracle_guidance", "make_cond_guidance",
    "make_resize_guidance",
]


def _randn(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """N(0, 1) float32 of ``shape`` on ``device``, drawn on the generator's
    device."""
    gdev = generator.device if generator is not None else device
    return torch.randn(tuple(shape), generator=generator, device=gdev).to(device)


def _randint(lo: int, hi: int, generator: Optional[torch.Generator]) -> int:
    """An integer in [lo, hi)."""
    gdev = generator.device if generator is not None else "cpu"
    return int(torch.randint(lo, hi, (), generator=generator, device=gdev))


class DiffusionSchedule:
    """DDPM / DDIM noise schedule of diffusers 0.16 with the x4 upscaler's
    scheduler config; float32 like the JAX package's. ``alphas_cumprod``
    lives on the CPU and its entries move to the caller's device."""

    def __init__(self, num_train_timesteps: int = 1000, beta_start: float = 0.0001,
                 beta_end: float = 0.02, steps_offset: int = 1, set_alpha_to_one: bool = False):
        self.num_train_timesteps = num_train_timesteps
        self.steps_offset = steps_offset
        self.betas = torch.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                                    dtype=torch.float32) ** 2
        self.alphas = 1.0 - self.betas
        self.alphas_cumprod = torch.cumprod(self.alphas, dim=0)
        self.final_alpha_cumprod = (torch.tensor(1.0) if set_alpha_to_one
                                    else self.alphas_cumprod[0])

    def _a(self, t: int, device) -> torch.Tensor:
        return self.alphas_cumprod[int(t)].to(device)

    def add_noise(self, x: torch.Tensor, noise: torch.Tensor, t: int) -> torch.Tensor:
        a = self._a(t, x.device)
        return torch.sqrt(a) * x + torch.sqrt(1.0 - a) * noise

    def ddim_timesteps(self, num_inference_steps: int) -> torch.Tensor:
        """Descending ladder: diffusers 0.16 'leading' spacing plus
        ``steps_offset``."""
        step = self.num_train_timesteps // num_inference_steps
        ts = torch.round(torch.arange(num_inference_steps, dtype=torch.float32) * step).to(torch.int32)
        return ts.flip(0) + self.steps_offset

    def ddim_step(self, eps: torch.Tensor, t: int, t_prev: int, x: torch.Tensor):
        """Deterministic (eta 0) DDIM update; ``t_prev < 0`` takes the final
        alpha. Returns (x_prev, pred_x0)."""
        a_t = self._a(t, x.device)
        a_prev = self._a(t_prev, x.device) if t_prev >= 0 else self.final_alpha_cumprod.to(x.device)
        pred_x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * eps, pred_x0


# denoiser(latents_cat (B, Cl+Cc, H, W), t (int), noise_level (int), text_cond (bool))
#   -> predicted eps (B, Cl, H, W)
Denoiser = Callable[[torch.Tensor, int, int, bool], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    num_train_timesteps: int = 1000
    num_inference_steps: int = 75
    min_step_percent: ScheduledFloat = 0.02
    max_step_percent: ScheduledFloat = 0.98
    noise_level: int = 20                  # the LR condition's noising label
    guidance_scale: float = 7.5            # text CFG
    guidance_scale_sr: float = -1.0        # image CFG (> 1 enables; uncond = a -1 image)
    sr_start_step: int = 0                 # the anneal's origin for max_step_percent
    anneal_end_step: int = -1              # step at which the max reaches its final value
    max_step_percent_final: float = -1.0   # <= 0 disables the anneal
    latent_scale: int = 1                  # spatial down-factor of the latent space


def _cond_image(lr_image: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The LR image in [-1, 1], resized (bilinear) to ``like``'s spatial size."""
    cond = 2.0 * lr_image - 1.0
    if cond.shape[2:] != like.shape[2:]:
        cond = resize(cond, cond.shape[:2] + like.shape[2:])
    return cond


class UpscalerGuidance:
    """SDEdit pseudo-GT generation and SDS gradients over an abstract denoiser."""

    def __init__(self, cfg: GuidanceConfig, denoiser: Denoiser,
                 encode: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 decode: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.cfg = cfg
        self.schedule = DiffusionSchedule(cfg.num_train_timesteps)
        self.denoiser = denoiser
        self.encode = encode or (lambda x: x)
        self.decode = decode or (lambda z: z)

    def step_bounds(self, step: int) -> Tuple[int, int]:
        """(min_step, max_step) with the linear anneal of the max."""
        cfg = self.cfg
        mn = C(cfg.min_step_percent, step)
        mx = C(cfg.max_step_percent, step)
        if cfg.max_step_percent_final > 0 and cfg.anneal_end_step > cfg.sr_start_step:
            t = (step - cfg.sr_start_step) / (cfg.anneal_end_step - cfg.sr_start_step)
            t = min(max(t, 0.0), 1.0)
            mx = mx + (cfg.max_step_percent_final - mx) * t
        T = cfg.num_train_timesteps
        return int(T * mn), int(T * mx)

    def _ignore_t(self, step: int, ignore_t: Optional[int], generator) -> int:
        if ignore_t is not None:
            return ignore_t
        mn, mx = self.step_bounds(step)
        return _randint(mn, mx + 1, generator)

    @torch.no_grad()
    def generate_sr(self, lr_image: torch.Tensor, hr_render: torch.Tensor, step: int = 0,
                    ignore_t: Optional[int] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The diffusion-refined pseudo-GT of the NeRF's HR render
        (B, 3, H, W), conditioned on the LR ground truth (B, 3, h, w), both
        in [0, 1]. Returns (B, 3, H, W) in [0, 1]."""
        cfg = self.cfg
        sch = self.schedule
        ignore_t = self._ignore_t(step, ignore_t, generator)
        image_hr = self.encode(hr_render)
        dev = image_hr.device
        cond = _cond_image(lr_image, image_hr)
        noise_level = cfg.noise_level
        image = sch.add_noise(cond, _randn(cond.shape, generator, dev), noise_level)
        x = _randn(image_hr.shape, generator, dev)  # init_noise_sigma = 1 (DDIM)

        use_text_cfg = cfg.guidance_scale > 1.0
        use_img_cfg = cfg.guidance_scale_sr > 1.0 and use_text_cfg
        image_uncond = image
        if use_img_cfg:
            image_uncond = sch.add_noise(torch.zeros_like(cond) - 1.0,
                                         _randn(cond.shape, generator, dev), noise_level)

        timesteps = [int(v) for v in sch.ddim_timesteps(cfg.num_inference_steps)]
        for i, t in enumerate(timesteps):
            if t > ignore_t:
                # SDEdit: stay on the "encode + noise" trajectory of the render
                t_next = timesteps[i + 1] if i + 1 < len(timesteps) else 0
                x = sch.add_noise(image_hr, _randn(image_hr.shape, generator, dev), t_next)
                continue
            eps_c = self.denoiser(torch.cat([x, image], dim=1), t, noise_level, True)
            if use_text_cfg or use_img_cfg:
                eps_u = self.denoiser(torch.cat([x, image_uncond], dim=1), t, noise_level,
                                      not use_text_cfg)
                scale = cfg.guidance_scale_sr if use_img_cfg else cfg.guidance_scale
                eps = eps_u + scale * (eps_c - eps_u)
            else:
                eps = eps_c
            t_prev = timesteps[i + 1] if i + 1 < len(timesteps) else -1
            x, _ = sch.ddim_step(eps, t, t_prev, x)
        return torch.clamp(self.decode(x), 0.0, 1.0)

    def _t_of(self, step: int, t_bounds, generator) -> int:
        if t_bounds is not None:
            return _randint(int(t_bounds[0]), int(t_bounds[1]) + 1, generator)
        mn, mx = self.step_bounds(step)
        return _randint(mn, mx + 1, generator)

    def sds_loss(self, lr_image: torch.Tensor, hr_render: torch.Tensor, step: int = 0,
                 t_bounds: Optional[Tuple[int, int]] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Score-distillation loss, differentiable in ``hr_render``: with
        grad = w(t) (eps_pred - eps), 0.5 ||latents - sg(latents - grad)||^2
        per batch entry. ``t_bounds`` (min, max) overrides the step's
        timestep range."""
        cfg = self.cfg
        sch = self.schedule
        t = self._t_of(step, t_bounds, generator)
        latents = self.encode(hr_render)
        dev = latents.device
        cond = _cond_image(lr_image, latents)
        image = sch.add_noise(cond, _randn(cond.shape, generator, dev), cfg.noise_level)
        noise = _randn(latents.shape, generator, dev)
        latents_noisy = sch.add_noise(latents.detach(), noise, t)
        with torch.no_grad():
            eps_pred = self.denoiser(torch.cat([latents_noisy, image], dim=1), t, cfg.noise_level, True)
        grad = (1.0 - sch._a(t, dev)) * (eps_pred - noise)
        target = (latents - grad).detach()
        return 0.5 * ((latents - target) ** 2).sum() / latents.shape[0]


class Text2ImgGuidance(UpscalerGuidance):
    """A text-to-image prior: img2img SDEdit and SDS with text CFG only; the
    denoiser sees (latents, t, noise_level [ignored], text_cond) and the
    ``lr_image`` argument is ignored."""

    @torch.no_grad()
    def generate_sr(self, lr_image, hr_render, step: int = 0, ignore_t: Optional[int] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        sch = self.schedule
        ignore_t = self._ignore_t(step, ignore_t, generator)
        latents = self.encode(hr_render)
        dev = latents.device
        x = _randn(latents.shape, generator, dev)
        use_cfg = cfg.guidance_scale > 1.0
        timesteps = [int(v) for v in sch.ddim_timesteps(cfg.num_inference_steps)]
        nl = cfg.noise_level
        for i, t in enumerate(timesteps):
            if t > ignore_t:
                t_next = timesteps[i + 1] if i + 1 < len(timesteps) else 0
                x = sch.add_noise(latents, _randn(latents.shape, generator, dev), t_next)
                continue
            eps_c = self.denoiser(x, t, nl, True)
            if use_cfg:
                eps_u = self.denoiser(x, t, nl, False)
                eps = eps_u + cfg.guidance_scale * (eps_c - eps_u)
            else:
                eps = eps_c
            t_prev = timesteps[i + 1] if i + 1 < len(timesteps) else -1
            x, _ = sch.ddim_step(eps, t, t_prev, x)
        return torch.clamp(self.decode(x), 0.0, 1.0)

    def sds_loss(self, lr_image, hr_render, step: int = 0, t_bounds=None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        sch = self.schedule
        t = self._t_of(step, t_bounds, generator)
        latents = self.encode(hr_render)
        dev = latents.device
        noise = _randn(latents.shape, generator, dev)
        latents_noisy = sch.add_noise(latents.detach(), noise, t)
        nl = cfg.noise_level
        with torch.no_grad():
            eps_pred = self.denoiser(latents_noisy, t, nl, True)
            if cfg.guidance_scale > 1.0:
                eps_u = self.denoiser(latents_noisy, t, nl, False)
                eps_pred = eps_u + cfg.guidance_scale * (eps_pred - eps_u)
        grad = (1.0 - sch._a(t, dev)) * (eps_pred - noise)
        target = (latents - grad).detach()
        return 0.5 * ((latents - target) ** 2).sum() / latents.shape[0]


# ---------------------------------------------------------------------------
# Offline denoisers
# ---------------------------------------------------------------------------

class OracleDenoiser:
    """A denoiser whose eps prediction makes DDIM's pred_x0 equal a known
    target: the whole SDEdit / DDIM algebra without weights (and the
    'cheating upscaler' of the SR tests: pseudo-GT == GT)."""

    def __init__(self, target: torch.Tensor, schedule: DiffusionSchedule):
        self.target = target
        self.schedule = schedule

    def __call__(self, latents_in, t, noise_level, text_cond):
        x = latents_in[:, : self.target.shape[1]]
        a = self.schedule._a(t, x.device)
        return (x - torch.sqrt(a) * self.target) / torch.sqrt(torch.clamp_min(1.0 - a, 1e-8))


def make_oracle_guidance(cfg: GuidanceConfig, target_hr: torch.Tensor) -> UpscalerGuidance:
    sch = DiffusionSchedule(cfg.num_train_timesteps)
    return UpscalerGuidance(cfg, OracleDenoiser(2.0 * target_hr - 1.0, sch),
                            encode=lambda x: 2.0 * x - 1.0, decode=lambda z: 0.5 * (z + 1.0))


class ConditioningDenoiser:
    """A weights-free denoiser that steers DDIM's pred_x0 toward the
    (noised) LR conditioning channels it receives: the diffusion loop then
    upsamples faithfully to the view's LR input, from what a real denoiser
    sees at call time."""

    def __init__(self, schedule: DiffusionSchedule, latent_channels: int = 3):
        self.schedule = schedule
        self.latent_channels = latent_channels

    def __call__(self, latents_in, t, noise_level, text_cond):
        lc = self.latent_channels
        x = latents_in[:, :lc]
        cond = latents_in[:, lc:][:, :lc]
        # the conditioning was noised at noise_level: its expectation is
        # sqrt(a_nl) * the clean condition
        a_nl = self.schedule._a(noise_level, x.device)
        target = cond / torch.sqrt(torch.clamp_min(a_nl, 1e-8))
        a = self.schedule._a(t, x.device)
        return (x - torch.sqrt(a) * target) / torch.sqrt(torch.clamp_min(1.0 - a, 1e-8))


def make_cond_guidance(cfg: GuidanceConfig) -> UpscalerGuidance:
    """SDEdit guidance with the conditioning-faithful denoiser (no weights)."""
    sch = DiffusionSchedule(cfg.num_train_timesteps)
    return UpscalerGuidance(cfg, ConditioningDenoiser(sch),
                            encode=lambda x: 2.0 * x - 1.0, decode=lambda z: 0.5 * (z + 1.0))


class _ResizeGuidance:
    """The weights-free fallback: pseudo-GT = 0.7 bilinear upsample of the
    LR ground truth + 0.3 the HR render."""

    def __init__(self, cfg: GuidanceConfig):
        self.cfg = cfg

    @torch.no_grad()
    def generate_sr(self, lr_image, hr_render, step=0, ignore_t=None, generator=None):
        return torch.clamp(0.7 * resize(lr_image, hr_render.shape) + 0.3 * hr_render, 0.0, 1.0)

    def step_bounds(self, step):
        return 0, self.cfg.num_train_timesteps

    def sds_loss(self, lr_image, hr_render, step=0, t_bounds=None, generator=None):
        up = resize(lr_image, hr_render.shape).detach()
        return ((hr_render - up) ** 2).mean()


def make_resize_guidance(cfg: GuidanceConfig, scale: int = 4) -> _ResizeGuidance:
    return _ResizeGuidance(cfg)
