"""Stable Diffusion x4-upscaler networks: UNet2DCondition and VAE (port of
``trinerflet_tpu/sr/diffusion.py``).

The UNet takes ``concat(latents, noisy_LR_image)`` (7 channels), a
timestep, the ``noise_level`` class label and text-encoder states, and
predicts the noise; the VAE decodes 4-channel latents to images at 4x the
spatial size.

* Parameter trees mirror the diffusers state dict: nested dicts keyed by
  the checkpoint's names ("down_blocks.0.resnets.1.conv1" ->
  params["down_blocks"]["0"]["resnets"]["1"]["conv1"]). Tensors are NCHW
  and conv weights OIHW, diffusers' own layouts, so a ``.safetensors``
  checkpoint loads with no transpose (``load_safetensors_params``, a
  reader of the format written here: this package does not import
  ``safetensors``). Linear weights are (out, in).
* ``SD_X4_UPSCALER_UNET`` / ``_VAE`` carry the published x4-upscaler
  structure; ``*_config_from_json`` rebuild it from a checkpoint's own
  ``config.json``.
* ``init_unet_params`` / ``init_vae_params`` make seeded random trees of the
  real shapes (no pretrained weights are in the repository).

The layers are plain PyTorch (``F.conv2d``, ``F.linear``, ``F.group_norm``,
``F.scaled_dot_product_attention``), as the JAX package leaves them to XLA.
Arithmetic the JAX package has and diffusers does not, kept on purpose:
the GEGLU feed-forward's gate goes through the tanh approximation of GELU
(``jax.nn.gelu``'s default; diffusers uses exact GELU). The epsilons are
JAX's: UNet resnets 1e-5, VAE resnets, the VAE's norms and every
transformer's group norm 1e-6, layer norms 1e-5.
"""

from __future__ import annotations

import dataclasses
import json
import math
import struct
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device

__all__ = [
    "UNetConfig", "VAEConfig",
    "SD_X4_UPSCALER_UNET", "SD_X4_UPSCALER_VAE",
    "init_unet_params", "unet_apply",
    "init_vae_params", "vae_encode", "vae_decode",
    "read_safetensors", "load_safetensors_params", "unet_config_from_json",
    "vae_config_from_json", "make_unet_denoiser", "make_text2img_denoiser",
    "SD2_TEXT2IMG_UNET",
]


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 7
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (256, 512, 512, 1024)
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        "UpBlock2D",
    )
    mid_block_type: str = "UNetMidBlock2DCrossAttn"
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    # diffusers legacy: the number of heads in SD-family configs
    attention_head_dim: Tuple[int, ...] = (8, 8, 8, 8)
    norm_num_groups: int = 32
    use_linear_projection: bool = True
    num_class_embeds: Optional[int] = None
    class_embed_type: Optional[str] = "timestep"  # noise_level conditioning
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    resnet_time_scale_shift: str = "default"

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.08333
    mid_attention: bool = True

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


SD_X4_UPSCALER_UNET = UNetConfig()
SD_X4_UPSCALER_VAE = VAEConfig()


def unet_config_from_json(path: str) -> UNetConfig:
    with open(path) as f:
        c = json.load(f)
    heads = c.get("attention_head_dim", 8)
    if not isinstance(heads, (list, tuple)):
        heads = [heads] * len(c["block_out_channels"])
    return UNetConfig(
        in_channels=c["in_channels"],
        out_channels=c["out_channels"],
        block_out_channels=tuple(c["block_out_channels"]),
        down_block_types=tuple(c["down_block_types"]),
        up_block_types=tuple(c["up_block_types"]),
        mid_block_type=c.get("mid_block_type", "UNetMidBlock2DCrossAttn"),
        layers_per_block=c.get("layers_per_block", 2),
        cross_attention_dim=c.get("cross_attention_dim", 1024),
        attention_head_dim=tuple(heads),
        norm_num_groups=c.get("norm_num_groups", 32),
        use_linear_projection=c.get("use_linear_projection", False),
        num_class_embeds=c.get("num_class_embeds"),
        class_embed_type=c.get("class_embed_type"),
        flip_sin_to_cos=c.get("flip_sin_to_cos", True),
        freq_shift=c.get("freq_shift", 0),
    )


def vae_config_from_json(path: str) -> VAEConfig:
    with open(path) as f:
        c = json.load(f)
    return VAEConfig(
        in_channels=c["in_channels"],
        out_channels=c["out_channels"],
        latent_channels=c["latent_channels"],
        block_out_channels=tuple(c["block_out_channels"]),
        layers_per_block=c.get("layers_per_block", 2),
        norm_num_groups=c.get("norm_num_groups", 32),
        scaling_factor=c.get("scaling_factor", 0.08333),
    )


# ---------------------------------------------------------------------------
# Layers (NCHW, OIHW conv weights, (out, in) linear weights)
# ---------------------------------------------------------------------------

def _linear(p, x):
    return F.linear(x, p["weight"], p.get("bias"))


def _conv(p, x, stride: int = 1, pad: int = 1):
    return F.conv2d(x, p["weight"], p["bias"], stride=stride, padding=pad)


def _group_norm(p, x, groups: int, eps: float = 1e-5):
    return F.group_norm(x, groups, p["weight"], p["bias"], eps)


def _layer_norm(p, x, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], p["weight"], p["bias"], eps)


def _attention(p, x, context=None, heads: int = 8):
    """Softmax attention (diffusers' to_q / to_k / to_v / to_out.0) over
    (B, N, C) tokens; the scores scaled by 1 / sqrt(C / heads)."""
    ctx = x if context is None else context
    q, k, v = _linear(p["to_q"], x), _linear(p["to_k"], ctx), _linear(p["to_v"], ctx)
    B, N, C = q.shape
    d = C // heads

    def split(t):
        return t.reshape(B, t.shape[1], heads, d).transpose(1, 2)

    out = F.scaled_dot_product_attention(split(q), split(k), split(v))
    return _linear(p["to_out"]["0"], out.transpose(1, 2).reshape(B, N, C))


def _geglu_ff(p, x):
    a, gate = _linear(p["net"]["0"]["proj"], x).chunk(2, dim=-1)
    return _linear(p["net"]["2"], a * F.gelu(gate, approximate="tanh"))


def _basic_transformer_block(p, x, context, heads: int):
    x = x + _attention(p["attn1"], _layer_norm(p["norm1"], x), None, heads)
    x = x + _attention(p["attn2"], _layer_norm(p["norm2"], x), context, heads)
    return x + _geglu_ff(p["ff"], _layer_norm(p["norm3"], x))


def _tokens(x):
    """(B, C, H, W) -> (B, H*W, C)."""
    B, C, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, H * W, C)


def _image(t, H: int, W: int):
    """(B, H*W, C) -> (B, C, H, W)."""
    B, _, C = t.shape
    return t.reshape(B, H, W, C).permute(0, 3, 1, 2)


def _transformer_2d(p, x, context, heads: int, groups: int, linear_proj: bool):
    B, C, H, W = x.shape
    h = _group_norm(p["norm"], x, groups, eps=1e-6)
    h = _linear(p["proj_in"], _tokens(h)) if linear_proj else _tokens(_conv(p["proj_in"], h, 1, 0))
    for i in range(len(p["transformer_blocks"])):
        h = _basic_transformer_block(p["transformer_blocks"][str(i)], h, context, heads)
    h = _image(_linear(p["proj_out"], h), H, W) if linear_proj else _conv(p["proj_out"], _image(h, H, W), 1, 0)
    return h + x


def _resnet_block(p, x, temb, groups: int, eps: float = 1e-5):
    h = _conv(p["conv1"], F.silu(_group_norm(p["norm1"], x, groups, eps)))
    if temb is not None and "time_emb_proj" in p:
        h = h + _linear(p["time_emb_proj"], F.silu(temb))[:, :, None, None]
    h = _conv(p["conv2"], F.silu(_group_norm(p["norm2"], h, groups, eps)))
    if "conv_shortcut" in p:
        x = _conv(p["conv_shortcut"], x, 1, 0)
    return x + h


def _downsample(p, x):
    return _conv(p["conv"], x, stride=2, pad=1)


def _upsample(p, x, size=None):
    """A nearest resize, then a 3x3 conv. Doubling (``size`` None, or twice
    the input's) reads input o // 2 at output o, which is jax.image.resize's
    floor((o + 0.5) / 2). The UNet passes the next skip's size: where a side
    is not a multiple of 2^(levels - 1) (a 100^2 latent goes 100 -> 50 -> 25
    -> 13), doubling would not meet the skip, and diffusers'
    ``forward_upsample_size`` resizes to the skip's size instead (the JAX
    package's UNet stops there with a shape error)."""
    if size is None:
        size = (2 * x.shape[-2], 2 * x.shape[-1])
    return _conv(p["conv"], F.interpolate(x, size=tuple(size), mode="nearest"))


def _timestep_embedding(t, dim: int, flip_sin_to_cos: bool, shift: float,
                        max_period: float = 10000.0):
    """diffusers' get_timestep_embedding: t (B,) -> (B, dim) float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        out = F.pad(out, (0, 1))
    return out


def _batch_of(v, B: int, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1).expand(B)


# ---------------------------------------------------------------------------
# UNet forward
# ---------------------------------------------------------------------------

def unet_apply(params: Dict, cfg: UNetConfig, sample: torch.Tensor, timestep,
               encoder_hidden_states: torch.Tensor, class_labels=None) -> torch.Tensor:
    """Noise prediction (B, out_channels, H, W) for ``sample`` (B,
    in_channels, H, W) at ``timestep`` (scalar or (B,)), with the text
    states (B, L, cross_attention_dim) and the noise level as the class
    label."""
    B = sample.shape[0]
    dev = sample.device
    g = cfg.norm_num_groups
    t = _batch_of(timestep, B, dev)

    def embed(pp, v):
        e = _timestep_embedding(v, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        return _linear(pp["linear_2"], F.silu(_linear(pp["linear_1"], e.to(sample.dtype))))

    temb = embed(params["time_embedding"], t)
    if cfg.class_embed_type == "timestep" and class_labels is not None:
        temb = temb + embed(params["class_embedding"], _batch_of(class_labels, B, dev))
    elif cfg.num_class_embeds is not None and class_labels is not None:
        cl = torch.as_tensor(class_labels, device=dev).reshape(-1).expand(B).long()
        temb = temb + params["class_embedding"]["weight"][cl]

    ctx = encoder_hidden_states
    h = _conv(params["conv_in"], sample)
    skips = [h]
    for bi, btype in enumerate(cfg.down_block_types):
        bp = params["down_blocks"][str(bi)]
        heads = cfg.attention_head_dim[bi]
        for li in range(cfg.layers_per_block):
            h = _resnet_block(bp["resnets"][str(li)], h, temb, g)
            if "CrossAttn" in btype:
                h = _transformer_2d(bp["attentions"][str(li)], h, ctx, heads, g, cfg.use_linear_projection)
            skips.append(h)
        if "downsamplers" in bp:
            h = _downsample(bp["downsamplers"]["0"], h)
            skips.append(h)

    mp = params["mid_block"]
    h = _resnet_block(mp["resnets"]["0"], h, temb, g)
    if "attentions" in mp:
        h = _transformer_2d(mp["attentions"]["0"], h, ctx, cfg.attention_head_dim[-1], g,
                            cfg.use_linear_projection)
    h = _resnet_block(mp["resnets"]["1"], h, temb, g)

    for bi, btype in enumerate(cfg.up_block_types):
        bp = params["up_blocks"][str(bi)]
        heads = cfg.attention_head_dim[len(cfg.block_out_channels) - 1 - bi]
        for li in range(cfg.layers_per_block + 1):
            h = _resnet_block(bp["resnets"][str(li)], torch.cat([h, skips.pop()], dim=1), temb, g)
            if "CrossAttn" in btype:
                h = _transformer_2d(bp["attentions"][str(li)], h, ctx, heads, g, cfg.use_linear_projection)
        if "upsamplers" in bp:
            h = _upsample(bp["upsamplers"]["0"], h, skips[-1].shape[-2:])

    h = F.silu(_group_norm(params["conv_norm_out"], h, g))
    return _conv(params["conv_out"], h)


# ---------------------------------------------------------------------------
# VAE forward
# ---------------------------------------------------------------------------

def _vae_mid(p, x, groups: int, attention: bool):
    x = _resnet_block(p["resnets"]["0"], x, None, groups, eps=1e-6)
    if attention and "attentions" in p:
        B, C, H, W = x.shape
        h = _group_norm(p["attentions"]["0"]["group_norm"], x, groups, eps=1e-6)
        x = x + _image(_attention(p["attentions"]["0"], _tokens(h), None, heads=1), H, W)
    return _resnet_block(p["resnets"]["1"], x, None, groups, eps=1e-6)


def vae_encode(params: Dict, cfg: VAEConfig, x: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Image in [-1, 1] (B, 3, H, W) -> latents * scaling_factor: the
    posterior's mean, or a sample of it drawn with ``generator``."""
    g = cfg.norm_num_groups
    e = params["encoder"]
    h = _conv(e["conv_in"], x)
    for bi in range(len(cfg.block_out_channels)):
        bp = e["down_blocks"][str(bi)]
        for li in range(cfg.layers_per_block):
            h = _resnet_block(bp["resnets"][str(li)], h, None, g, eps=1e-6)
        if "downsamplers" in bp:
            # diffusers pads the VAE's downsampling asymmetrically: one
            # column right, one row below, then a stride-2 valid conv
            h = _conv(bp["downsamplers"]["0"]["conv"], F.pad(h, (0, 1, 0, 1)), stride=2, pad=0)
    h = _vae_mid(e["mid_block"], h, g, cfg.mid_attention)
    h = F.silu(_group_norm(e["conv_norm_out"], h, g, eps=1e-6))
    moments = _conv(params["quant_conv"], _conv(e["conv_out"], h), 1, 0)
    mean, logvar = moments.chunk(2, dim=1)
    if generator is not None:
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        noise = torch.randn(mean.shape, generator=generator, device=generator.device).to(mean)
        mean = mean + std * noise
    return mean * cfg.scaling_factor


def vae_decode(params: Dict, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """Latents (scaled) (B, 4, h, w) -> image in [-1, 1] (B, 3, sh, sw)."""
    g = cfg.norm_num_groups
    d = params["decoder"]
    h = _conv(params["post_quant_conv"], z / cfg.scaling_factor, 1, 0)
    h = _conv(d["conv_in"], h)
    h = _vae_mid(d["mid_block"], h, g, cfg.mid_attention)
    for bi in range(len(cfg.block_out_channels)):
        bp = d["up_blocks"][str(bi)]
        for li in range(cfg.layers_per_block + 1):
            h = _resnet_block(bp["resnets"][str(li)], h, None, g, eps=1e-6)
        if "upsamplers" in bp:
            h = _upsample(bp["upsamplers"]["0"], h)
    h = F.silu(_group_norm(d["conv_norm_out"], h, g, eps=1e-6))
    return _conv(d["conv_out"], h)


# ---------------------------------------------------------------------------
# Random init (the real shapes; no pretrained weights are in the repository)
# ---------------------------------------------------------------------------

class _Init:
    """Seeded random trees: conv and linear weights U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), zero biases, unit norms; made on the CPU with
    ``generator`` and moved to ``device``."""

    def __init__(self, generator: torch.Generator, device):
        self.gen = generator
        self.device = device

    def _u(self, shape, s):
        u = torch.rand(shape, generator=self.gen, dtype=torch.float32)
        return ((2.0 * u - 1.0) * s).to(self.device)

    def _zeros(self, n):
        return torch.zeros((n,), device=self.device)

    def conv(self, kh, kw, ci, co):
        return {"weight": self._u((co, ci, kh, kw), 1.0 / math.sqrt(kh * kw * ci)),
                "bias": self._zeros(co)}

    def linear(self, ci, co, bias=True):
        p = {"weight": self._u((co, ci), 1.0 / math.sqrt(ci))}
        if bias:
            p["bias"] = self._zeros(co)
        return p

    def norm(self, c):
        return {"weight": torch.ones((c,), device=self.device), "bias": self._zeros(c)}

    def resnet(self, ci, co, temb_dim=None):
        p = {"norm1": self.norm(ci), "conv1": self.conv(3, 3, ci, co),
             "norm2": self.norm(co), "conv2": self.conv(3, 3, co, co)}
        if temb_dim:
            p["time_emb_proj"] = self.linear(temb_dim, co)
        if ci != co:
            p["conv_shortcut"] = self.conv(1, 1, ci, co)
        return p

    def attention(self, c, ctx_dim=None, qkv_bias=False):
        ctx = ctx_dim or c
        return {
            "to_q": self.linear(c, c, bias=qkv_bias),
            "to_k": self.linear(ctx, c, bias=qkv_bias),
            "to_v": self.linear(ctx, c, bias=qkv_bias),
            "to_out": {"0": self.linear(c, c)},
        }

    def transformer(self, c, ctx_dim, linear_proj):
        return {
            "norm": self.norm(c),
            "proj_in": self.linear(c, c) if linear_proj else self.conv(1, 1, c, c),
            "transformer_blocks": {"0": {
                "norm1": self.norm(c), "attn1": self.attention(c),
                "norm2": self.norm(c), "attn2": self.attention(c, ctx_dim),
                "norm3": self.norm(c),
                "ff": {"net": {"0": {"proj": self.linear(c, 8 * c)},
                               "2": self.linear(4 * c, c)}},
            }},
            "proj_out": self.linear(c, c) if linear_proj else self.conv(1, 1, c, c),
        }


def init_unet_params(cfg: UNetConfig, generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> Dict:
    """Seeded random UNet parameters of ``cfg``'s shapes on ``device``
    (``cuda`` by default)."""
    I = _Init(generator or torch.Generator().manual_seed(0), resolve_device(device))
    ch = cfg.block_out_channels
    ted = cfg.time_embed_dim
    params: Dict[str, Any] = {
        "conv_in": I.conv(3, 3, cfg.in_channels, ch[0]),
        "time_embedding": {"linear_1": I.linear(ch[0], ted), "linear_2": I.linear(ted, ted)},
        "conv_norm_out": I.norm(ch[0]),
        "conv_out": I.conv(3, 3, ch[0], cfg.out_channels),
    }
    if cfg.class_embed_type == "timestep":
        params["class_embedding"] = {"linear_1": I.linear(ch[0], ted), "linear_2": I.linear(ted, ted)}
    elif cfg.num_class_embeds:
        w = torch.randn((cfg.num_class_embeds, ted), generator=I.gen)
        params["class_embedding"] = {"weight": (0.02 * w).to(I.device)}

    down: Dict[str, Any] = {}
    cin = ch[0]
    for bi, btype in enumerate(cfg.down_block_types):
        cout = ch[bi]
        bp: Dict[str, Any] = {"resnets": {}}
        if "CrossAttn" in btype:
            bp["attentions"] = {}
        for li in range(cfg.layers_per_block):
            bp["resnets"][str(li)] = I.resnet(cin if li == 0 else cout, cout, ted)
            if "CrossAttn" in btype:
                bp["attentions"][str(li)] = I.transformer(cout, cfg.cross_attention_dim,
                                                          cfg.use_linear_projection)
        if bi < len(ch) - 1:
            bp["downsamplers"] = {"0": {"conv": I.conv(3, 3, cout, cout)}}
        down[str(bi)] = bp
        cin = cout
    params["down_blocks"] = down
    params["mid_block"] = {
        "resnets": {"0": I.resnet(ch[-1], ch[-1], ted), "1": I.resnet(ch[-1], ch[-1], ted)},
        "attentions": {"0": I.transformer(ch[-1], cfg.cross_attention_dim, cfg.use_linear_projection)},
    }

    up: Dict[str, Any] = {}
    rev = list(reversed(ch))
    h_ch = ch[-1]
    # the skip channels, in the order the forward pushes them
    skip_chs = [ch[0]]
    for bi in range(len(ch)):
        skip_chs += [ch[bi]] * cfg.layers_per_block
        if bi < len(ch) - 1:
            skip_chs.append(ch[bi])
    for bi, btype in enumerate(cfg.up_block_types):
        cout = rev[bi]
        bp = {"resnets": {}}
        if "CrossAttn" in btype:
            bp["attentions"] = {}
        for li in range(cfg.layers_per_block + 1):
            bp["resnets"][str(li)] = I.resnet(h_ch + skip_chs.pop(), cout, ted)
            h_ch = cout
            if "CrossAttn" in btype:
                bp["attentions"][str(li)] = I.transformer(cout, cfg.cross_attention_dim,
                                                          cfg.use_linear_projection)
        if bi < len(ch) - 1:
            bp["upsamplers"] = {"0": {"conv": I.conv(3, 3, cout, cout)}}
        up[str(bi)] = bp
    params["up_blocks"] = up
    return params


def init_vae_params(cfg: VAEConfig, generator: Optional[torch.Generator] = None,
                    device: DeviceLike = None) -> Dict:
    """Seeded random VAE parameters of ``cfg``'s shapes on ``device``."""
    I = _Init(generator or torch.Generator().manual_seed(0), resolve_device(device))
    ch = cfg.block_out_channels

    def mid():
        return {"resnets": {"0": I.resnet(ch[-1], ch[-1]), "1": I.resnet(ch[-1], ch[-1])},
                "attentions": {"0": {**I.attention(ch[-1], qkv_bias=True),
                                     "group_norm": I.norm(ch[-1])}}}

    enc: Dict[str, Any] = {"conv_in": I.conv(3, 3, cfg.in_channels, ch[0]), "down_blocks": {},
                           "conv_norm_out": I.norm(ch[-1]),
                           "conv_out": I.conv(3, 3, ch[-1], 2 * cfg.latent_channels)}
    cin = ch[0]
    for bi in range(len(ch)):
        bp = {"resnets": {str(li): I.resnet(cin if li == 0 else ch[bi], ch[bi])
                          for li in range(cfg.layers_per_block)}}
        if bi < len(ch) - 1:
            bp["downsamplers"] = {"0": {"conv": I.conv(3, 3, ch[bi], ch[bi])}}
        enc["down_blocks"][str(bi)] = bp
        cin = ch[bi]
    enc["mid_block"] = mid()

    dec: Dict[str, Any] = {"conv_in": I.conv(3, 3, cfg.latent_channels, ch[-1]), "up_blocks": {},
                           "conv_norm_out": I.norm(ch[0]),
                           "conv_out": I.conv(3, 3, ch[0], cfg.out_channels)}
    dec["mid_block"] = mid()
    rev = list(reversed(ch))
    cin = ch[-1]
    for bi in range(len(ch)):
        bp = {"resnets": {str(li): I.resnet(cin if li == 0 else rev[bi], rev[bi])
                          for li in range(cfg.layers_per_block + 1)}}
        if bi < len(ch) - 1:
            bp["upsamplers"] = {"0": {"conv": I.conv(3, 3, rev[bi], rev[bi])}}
        dec["up_blocks"][str(bi)] = bp
        cin = rev[bi]
    return {
        "encoder": enc, "decoder": dec,
        "quant_conv": I.conv(1, 1, 2 * cfg.latent_channels, 2 * cfg.latent_channels),
        "post_quant_conv": I.conv(1, 1, cfg.latent_channels, cfg.latent_channels),
    }


# ---------------------------------------------------------------------------
# Weight loading: the safetensors format, read here
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as {name: CPU tensor}: an 8-byte
    little-endian header length, a JSON header {name: {"dtype", "shape",
    "data_offsets": [begin, end]}} (and an optional "__metadata__"), then
    the raw little-endian buffers. A dtype outside the format's
    F64 / F32 / F16 / BF16 / I64 / I32 / I16 / I8 / U8 / BOOL raises."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8 : 8 + n])
    buf = bytearray(data[8 + n :])
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']!r}, which this "
                             f"reader does not know ({', '.join(_ST_DTYPES)})")
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = math.prod(shape)
        if end - begin != count * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} holds {end - begin} bytes, its shape "
                             f"{shape} and dtype {info['dtype']} need {count * dtype.itemsize}")
        t = torch.frombuffer(buf, dtype=dtype, count=count, offset=begin) if count else \
            torch.empty((0,), dtype=dtype)
        out[name] = t.reshape(shape).clone()
    return out


def load_safetensors_params(path: str, dtype=torch.float32, device: DeviceLike = None) -> Dict:
    """A flat diffusers state dict -> the nested tree, as ``dtype`` on
    ``device`` (``cuda`` by default). Conv weights stay OIHW."""
    device = resolve_device(device)
    tree: Dict[str, Any] = {}
    for name, t in read_safetensors(path).items():
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.to(device, dtype)
    return tree


# ---------------------------------------------------------------------------
# Guidance glue
# ---------------------------------------------------------------------------

def make_unet_denoiser(unet_params: Dict, unet_cfg: UNetConfig, text_embeds: torch.Tensor,
                       uncond_embeds: torch.Tensor, dtype=torch.float32):
    """The UNet as the guidance's denoiser: (latents_cat (B, C, H, W), t,
    noise_level, text_cond) -> eps, run under ``no_grad`` (the guidance
    never differentiates the denoiser)."""

    def denoiser(latents_cat, t, noise_level, text_cond: bool):
        embeds = text_embeds if text_cond else uncond_embeds
        B = latents_cat.shape[0]
        with torch.no_grad():
            ctx = embeds.expand((B,) + tuple(embeds.shape[1:])).to(dtype)
            return unet_apply(unet_params, unet_cfg, latents_cat.to(dtype), t, ctx,
                              class_labels=noise_level)

    return denoiser


# The SD2.x text-to-image UNet (diffusers' stable-diffusion-2 unet config:
# 4-channel latents, no class embedding, linear transformer projections):
# the prior of the generation system, as opposed to the x4 upscaler.
SD2_TEXT2IMG_UNET = UNetConfig(
    in_channels=4, out_channels=4,
    block_out_channels=(320, 640, 1280, 1280),
    down_block_types=(
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "DownBlock2D",
    ),
    up_block_types=(
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    ),
    layers_per_block=2, cross_attention_dim=1024,
    attention_head_dim=(5, 10, 20, 20), use_linear_projection=True,
    class_embed_type=None,
)


def make_text2img_denoiser(unet_params: Dict, unet_cfg: UNetConfig, text_embeds: torch.Tensor,
                           uncond_embeds: torch.Tensor, dtype=torch.float32):
    """A text-to-image UNet (no image concat, no noise-level class
    embedding) as the Text2ImgGuidance denoiser: (latents, t, noise_level
    [ignored], text_cond) -> eps."""

    def denoiser(latents, t, noise_level, text_cond: bool):
        embeds = text_embeds if text_cond else uncond_embeds
        B = latents.shape[0]
        with torch.no_grad():
            ctx = embeds.expand((B,) + tuple(embeds.shape[1:])).to(dtype)
            return unet_apply(unet_params, unet_cfg, latents.to(dtype), t, ctx)

    return denoiser
