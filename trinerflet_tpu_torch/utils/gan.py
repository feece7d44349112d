"""Taming-transformers-style GAN stack (port of
``trinerflet_tpu/utils/gan.py``): the diagonal Gaussian posterior, the
PatchGAN discriminator with per-call batch statistics, the hinge and
vanilla losses, the taming encoder and decoder, the global image encoder,
and ``gan_render``, which decodes a low-resolution render (RGB and latent
moments) into an upsampled RGB conditioned on a global image code.

The public tensors are channel-last (B, H, W, C), as the JAX package's;
the layers are the port's SR blocks (``sr/diffusion.py``: NCHW, OIHW conv
weights, (out, in) linear weights), so a JAX tree carries over with
``carry.gan_params_from_jax``. Random draws come from a ``torch.Generator``
or are passed in (``noise``); the JAX package's threefry streams are not
reproduced. The 224^2 resize of the global code's input is
``jax.image.resize``'s bilinear (``ops/resize.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..ops.resize import resize
from ..sr.diffusion import _attention, _conv, _downsample, _group_norm, _Init, _resnet_block, _upsample

__all__ = [
    "DiagonalGaussian", "GANConfig",
    "init_discriminator", "discriminator_apply",
    "hinge_d_loss", "vanilla_d_loss", "generator_loss", "discriminator_loss",
    "adopt_weight",
    "init_taming_encoder", "taming_encoder_apply",
    "init_taming_decoder", "taming_decoder_apply",
    "init_global_encoder", "global_encoder_apply",
    "init_gan_stack", "gan_render",
]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Diagonal Gaussian posterior
# ---------------------------------------------------------------------------

class DiagonalGaussian:
    """Channel-last diagonal Gaussian over (B, H, W, 2C) = [mean | logvar]."""

    def __init__(self, parameters: torch.Tensor, deterministic: bool = False):
        self.mean, logvar = torch.chunk(parameters, 2, dim=-1)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.deterministic = deterministic
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise, the standard normal ``noise`` drawn from
        ``generator`` when not given."""
        if self.deterministic:
            return self.mean
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, dtype=self.mean.dtype,
                                device=generator.device if generator is not None else self.mean.device)
        return self.mean + self.std * noise.to(self.mean.device, self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussian"] = None) -> torch.Tensor:
        """KL per batch element, summed over (H, W, C)."""
        if self.deterministic:
            return torch.zeros((self.mean.shape[0],), dtype=self.mean.dtype, device=self.mean.device)
        dims = (1, 2, 3)
        if other is None:
            return 0.5 * (self.mean ** 2 + self.var - 1.0 - self.logvar).sum(dims)
        return 0.5 * ((self.mean - other.mean) ** 2 / other.var + self.var / other.var - 1.0
                      - self.logvar + other.logvar).sum(dims)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        """Negative log likelihood per batch element."""
        if self.deterministic:
            return torch.zeros((sample.shape[0],), dtype=sample.dtype, device=sample.device)
        logtwopi = math.log(2.0 * math.pi)
        return 0.5 * (logtwopi + self.logvar + (sample - self.mean) ** 2 / self.var).sum((1, 2, 3))


# ---------------------------------------------------------------------------
# PatchGAN discriminator
# ---------------------------------------------------------------------------

def _init_conv_n02(init: _Init, kh, kw, ci, co) -> Dict:
    """A conv with the taming ``weights_init``: normal std 0.02 weights."""
    p = init.conv(kh, kw, ci, co)
    w = torch.randn(tuple(p["weight"].shape), generator=init.gen, dtype=torch.float32)
    p["weight"] = (0.02 * w).to(init.device)
    return p


def init_discriminator(generator: Optional[torch.Generator] = None, input_nc: int = 3,
                       ndf: int = 64, n_layers: int = 3, device: DeviceLike = None) -> Dict:
    """PatchGAN: a 4x4 stride-2 conv ladder -> a 1-channel logits map."""
    init = _Init(generator or torch.Generator().manual_seed(0), resolve_device(device))
    layers = {"0": _init_conv_n02(init, 4, 4, input_nc, ndf)}
    nf = ndf
    for n in range(1, n_layers + 1):
        nf_prev, nf = nf, min(ndf * 2 ** n, ndf * 8)
        layers[str(n)] = {"conv": _init_conv_n02(init, 4, 4, nf_prev, nf), "norm": init.norm(nf)}
    layers["out"] = _init_conv_n02(init, 4, 4, nf, 1)
    return {"layers": layers}


def _batch_norm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Batch statistics of this call (train-mode BatchNorm2d, no running
    statistics), NCHW."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * p["weight"][None, :, None, None]
            + p["bias"][None, :, None, None])


def discriminator_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> patch logits (B, H', W', 1)."""
    layers = params["layers"]
    n_layers = len([k for k in layers if k.isdigit()]) - 1
    h = F.leaky_relu(_conv(layers["0"], _nchw(x), stride=2, pad=1), 0.2)
    for n in range(1, n_layers + 1):
        stride = 2 if n < n_layers else 1  # the last inner layer is stride 1
        h = _conv(layers[str(n)]["conv"], h, stride=stride, pad=1)
        h = F.leaky_relu(_batch_norm(layers[str(n)]["norm"], h), 0.2)
    return _nhwc(_conv(layers["out"], h, stride=1, pad=1))


# ---------------------------------------------------------------------------
# GAN losses
# ---------------------------------------------------------------------------

def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def generator_loss(disc_params: Dict, reconstructions: torch.Tensor,
                   cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-E[D(recon)]; the caller holds ``disc_params`` fixed in this branch."""
    x = reconstructions if cond is None else torch.cat([reconstructions, cond], dim=-1)
    return -discriminator_apply(disc_params, x).mean()


def discriminator_loss(disc_params: Dict, inputs: torch.Tensor, reconstructions: torch.Tensor,
                       cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The hinge loss on real and fake; both images are detached."""
    real, fake = inputs.detach(), reconstructions.detach()
    if cond is not None:
        real = torch.cat([real, cond], dim=-1)
        fake = torch.cat([fake, cond], dim=-1)
    return hinge_d_loss(discriminator_apply(disc_params, real),
                        discriminator_apply(disc_params, fake))


def adopt_weight(weight: float, global_step, threshold: int = 0, value: float = 0.0) -> torch.Tensor:
    """taming's GAN-loss warm-up gate: ``value`` before ``threshold`` steps."""
    step = torch.as_tensor(global_step)
    return torch.where(step < threshold, torch.tensor(value), torch.tensor(weight))


# ---------------------------------------------------------------------------
# Taming encoder / decoder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GANConfig:
    """The gan-volume-renderer instantiation."""
    ch: int = 64                      # generator base width
    ch_enc: int = 32                  # local-encoder base width
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 1
    z_channels: int = 4
    in_channels: int = 7              # lr_rgb (3) + z_map (4)
    out_ch: int = 3
    global_code_dim: int = 64         # GlobalEncoder(n_class=64)
    disc_ndf: int = 64
    disc_layers: int = 3
    groups: int = 32


def _g(c: int, groups: int) -> int:
    return min(groups, c) if c % min(groups, c) == 0 else 1


def init_taming_encoder(generator: Optional[torch.Generator], cfg: GANConfig, in_channels: int = 3,
                        device: DeviceLike = None) -> Dict:
    init = _Init(generator or torch.Generator().manual_seed(0), resolve_device(device))
    ch = cfg.ch_enc
    p = {"conv_in": init.conv(3, 3, in_channels, ch)}
    widths = [ch * m for m in cfg.ch_mult]
    c = ch
    for i, w in enumerate(widths):
        blocks = {}
        for b in range(cfg.num_res_blocks):
            blocks[str(b)] = init.resnet(c, w)
            c = w
        lvl = {"blocks": blocks}
        if i < len(widths) - 1:
            lvl["down"] = {"conv": init.conv(3, 3, c, c)}
        p[f"down_{i}"] = lvl
    p["mid"] = {"block_1": init.resnet(c, c), "attn": init.attention(c),
                "attn_norm": init.norm(c), "block_2": init.resnet(c, c)}
    p["norm_out"] = init.norm(c)
    p["conv_out"] = init.conv(3, 3, c, 2 * cfg.z_channels)
    return p


def _self_attention(p: Dict, norm: Dict, h: torch.Tensor, groups: int) -> torch.Tensor:
    B, C, H, W = h.shape
    a = _group_norm(norm, h, _g(C, groups), eps=1e-6)
    tokens = a.permute(0, 2, 3, 1).reshape(B, H * W, C)
    out = _attention(p, tokens, heads=1).reshape(B, H, W, C).permute(0, 3, 1, 2)
    return h + out


def taming_encoder_apply(params: Dict, cfg: GANConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> posterior moments (B, H/2^(L-1), W/2^(L-1), 2z)."""
    h = _conv(params["conv_in"], _nchw(x))
    for i in range(len(cfg.ch_mult)):
        lvl = params[f"down_{i}"]
        for b in range(cfg.num_res_blocks):
            h = _resnet_block(lvl["blocks"][str(b)], h, None, _g(h.shape[1], cfg.groups), eps=1e-6)
        if "down" in lvl:
            h = _downsample(lvl["down"], h)
    m = params["mid"]
    h = _resnet_block(m["block_1"], h, None, cfg.groups, eps=1e-6)
    h = _self_attention(m["attn"], m["attn_norm"], h, cfg.groups)
    h = _resnet_block(m["block_2"], h, None, cfg.groups, eps=1e-6)
    h = _group_norm(params["norm_out"], h, _g(h.shape[1], cfg.groups), eps=1e-6)
    return _nhwc(_conv(params["conv_out"], F.silu(h)))


def init_taming_decoder(generator: Optional[torch.Generator], cfg: GANConfig,
                        device: DeviceLike = None) -> Dict:
    """The generator: latent + RGB map -> upsampled RGB, every resnet block
    conditioned on the global code (as its time embedding)."""
    init = _Init(generator or torch.Generator().manual_seed(0), resolve_device(device))
    widths = [cfg.ch * m for m in cfg.ch_mult]
    c = widths[-1]
    p = {"conv_in": init.conv(3, 3, cfg.in_channels, c)}
    p["mid"] = {"block_1": init.resnet(c, c, cfg.global_code_dim), "attn": init.attention(c),
                "attn_norm": init.norm(c), "block_2": init.resnet(c, c, cfg.global_code_dim)}
    for i, w in enumerate(reversed(widths)):
        blocks = {}
        for b in range(cfg.num_res_blocks + 1):
            blocks[str(b)] = init.resnet(c, w, cfg.global_code_dim)
            c = w
        lvl = {"blocks": blocks}
        if i < len(widths) - 1:
            lvl["up"] = {"conv": init.conv(3, 3, c, c)}
        p[f"up_{i}"] = lvl
    p["norm_out"] = init.norm(c)
    p["conv_out"] = init.conv(3, 3, c, cfg.out_ch)
    return p


def taming_decoder_apply(params: Dict, cfg: GANConfig, z: torch.Tensor,
                         global_code: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z (B, h, w, in_channels) -> (B, h 2^(L-1), w 2^(L-1), out_ch)."""
    h = _conv(params["conv_in"], _nchw(z))

    def res(p, h):
        return _resnet_block(p, h, global_code, _g(h.shape[1], cfg.groups), eps=1e-6)

    m = params["mid"]
    h = res(m["block_1"], h)
    h = _self_attention(m["attn"], m["attn_norm"], h, cfg.groups)
    h = res(m["block_2"], h)
    for i in range(len(cfg.ch_mult)):
        lvl = params[f"up_{i}"]
        for b in range(cfg.num_res_blocks + 1):
            h = res(lvl["blocks"][str(b)], h)
        if "up" in lvl:
            h = _upsample(lvl["up"], h)
    h = _group_norm(params["norm_out"], h, _g(h.shape[1], cfg.groups), eps=1e-6)
    return _nhwc(_conv(params["conv_out"], F.silu(h)))


# ---------------------------------------------------------------------------
# Global image encoder
# ---------------------------------------------------------------------------

def init_global_encoder(generator: Optional[torch.Generator] = None, n_class: int = 64,
                        width: int = 32, device: DeviceLike = None) -> Dict:
    init = _Init(generator or torch.Generator().manual_seed(0), resolve_device(device))
    p, c = {"conv_in": init.conv(3, 3, 3, width)}, width
    for i in range(4):  # 4 stride-2 stages with squeeze-excitation
        co = min(c * 2, 256)
        p[f"stage_{i}"] = {"conv": init.conv(3, 3, c, co), "norm": init.norm(co),
                           "se_down": init.linear(co, max(co // 4, 8)),
                           "se_up": init.linear(max(co // 4, 8), co)}
        c = co
    p["head"] = init.linear(c, n_class)
    return p


def global_encoder_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 3) -> global code (B, n_class)."""
    h = F.silu(_conv(params["conv_in"], _nchw(x), stride=2, pad=1))
    for i in range(4):
        s = params[f"stage_{i}"]
        h = _conv(s["conv"], h, stride=2, pad=1)
        h = F.silu(_group_norm(s["norm"], h, _g(h.shape[1], 8)))
        se = h.mean(dim=(2, 3))
        se = torch.sigmoid(F.linear(se, s["se_down"]["weight"], s["se_down"]["bias"]))
        se = torch.sigmoid(F.linear(se, s["se_up"]["weight"], s["se_up"]["bias"]))
        h = h * se[:, :, None, None]
    return F.linear(h.mean(dim=(2, 3)), params["head"]["weight"], params["head"]["bias"])


# ---------------------------------------------------------------------------
# The gan-volume-renderer's decoding
# ---------------------------------------------------------------------------

def init_gan_stack(generator: Optional[torch.Generator], cfg: GANConfig,
                   device: DeviceLike = None) -> Dict:
    """Seeded random weights of the four networks (``cuda`` by default)."""
    device = resolve_device(device)
    generator = generator or torch.Generator().manual_seed(0)
    return {
        "generator": init_taming_decoder(generator, cfg, device),
        "local_encoder": init_taming_encoder(generator, cfg, 3, device),
        "global_encoder": init_global_encoder(generator, cfg.global_code_dim, device=device),
        "discriminator": init_discriminator(generator, cfg.out_ch, cfg.disc_ndf, cfg.disc_layers,
                                            device),
    }


def gan_render(params: Dict, cfg: GANConfig, comp_rgb_latent: torch.Tensor,
               generator: Optional[torch.Generator] = None, gt_rgb: Optional[torch.Tensor] = None,
               generator_level: int = 0, sample_posterior: bool = False,
               noise: Optional[torch.Tensor] = None,
               noise_level2: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Decode a low-res render (B, h, w, 3 + 2z): RGB and latent moments)
    into a 2^(L-1)-times upsampled RGB.

    Level 0 takes the global code from the low-res RGB, level 1 from
    ``gt_rgb``, level 2 the code and the latent from ``gt_rgb`` (through the
    local encoder; its sample bilinearly resized to (h, w)). The standard
    normal draws, ``noise`` for ``sample_posterior`` and ``noise_level2``
    for level 2's sample, come from ``generator`` when not given."""
    lr_rgb = comp_rgb_latent[..., :3]
    posterior = DiagonalGaussian(comp_rgb_latent[..., 3:])
    z_map = posterior.sample(generator, noise) if sample_posterior else posterior.mode()
    if generator_level >= 1:
        if gt_rgb is None:
            raise ValueError("generator levels 1 and 2 need gt_rgb")
        code_src = gt_rgb
    else:
        code_src = lr_rgb
    B, h, w, _ = lr_rgb.shape
    g_code = global_encoder_apply(params["global_encoder"], resize(code_src, (B, 224, 224, 3)))
    if generator_level == 2:
        posterior = DiagonalGaussian(taming_encoder_apply(params["local_encoder"], cfg, gt_rgb))
        z_map = posterior.sample(generator, noise_level2)
        z_map = resize(z_map, (B, h, w, z_map.shape[-1]))
    gan_rgb = taming_decoder_apply(params["generator"], cfg, torch.cat([lr_rgb, z_map], dim=-1),
                                   g_code)
    return {
        "comp_lr_rgb": lr_rgb,
        "comp_gan_rgb": torch.clamp(gan_rgb, 0.0, 1.0),
        "posterior_mean": posterior.mean,
        "posterior_logvar": posterior.logvar,
        "posterior_kl": posterior.kl(),
    }
