"""CLIP text-image guidance for ``--rand_pose`` (port of
``trinerflet_tpu/utils/clip_loss.py``).

The vision tower is the pre-LN ViT of ``transformers.CLIPVisionModel``, its
parameters keyed by that model's state-dict names (the upstream
``pre_layrnorm`` spelling included), so a published ViT-B/16 checkpoint
loads by name through ``state_dict_to_tree``. The text side is
``sr/text.py``'s transformer with CLIP's pooled output (the hidden state at
the EOS token, the largest id) and ``text_projection``. ``CLIPLoss`` scores
[0, 1] renders with ``-(img_z . text_z).sum(-1).mean()``.

Images are NHWC (B, H, W, 3), as the trainer renders them and as in the JAX
package.

Differences from the JAX package, none of which changes a result:

* The patch embedding keeps the state dict's OIHW weight (D, 3, P, P) and
  runs as a stride-P ``F.conv2d``; the JAX package flattens the patches in
  (i, j, c) order against a (P * P * 3, D) kernel.
  ``carry.clip_params_from_jax`` turns that kernel back.
* The random initialisers draw from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..ops.resize import resize
from ..sr.text import TextConfig, _act, _lin, _ln, init_text_params, text_encode

__all__ = [
    "VisionConfig", "init_vision_params", "vision_encode", "image_features", "text_features",
    "preprocess", "state_dict_to_tree", "init_clip_params", "CLIPLoss",
]

# OpenAI CLIP's preprocessing constants
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """ViT-B/16 by default."""
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    projection_dim: int = 512
    hidden_act: str = "quick_gelu"

    @classmethod
    def from_json(cls, path: str) -> "VisionConfig":
        """From a transformers ``CLIPModel`` (or vision-only) ``config.json``."""
        with open(path) as f:
            c = json.load(f)
        v = c.get("vision_config", c)
        return cls(
            image_size=v["image_size"], patch_size=v["patch_size"],
            hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
            num_heads=v["num_attention_heads"], intermediate_size=v["intermediate_size"],
            projection_dim=c.get("projection_dim", v.get("projection_dim", 512)),
            hidden_act=v.get("hidden_act", "quick_gelu"),
        )


def _attn(lp: Dict, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, L, D = x.shape
    d = D // num_heads
    q, k, v = (_lin(lp[n], x).reshape(B, L, num_heads, d).transpose(1, 2)
               for n in ("q_proj", "k_proj", "v_proj"))
    o = F.scaled_dot_product_attention(q, k, v)
    return _lin(lp["out_proj"], o.transpose(1, 2).reshape(B, L, D))


def vision_encode(params: Dict, cfg: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    """Preprocessed images (B, S, S, 3) -> the pooled CLS embedding (B, D)."""
    vm = params["vision_model"]
    emb = vm["embeddings"]
    B = images.shape[0]
    x = F.conv2d(images.permute(0, 3, 1, 2), emb["patch_embedding"]["weight"],
                 stride=cfg.patch_size)                       # (B, D, S/P, S/P)
    x = x.flatten(2).transpose(1, 2)                          # patches in row-major order
    cls = emb["class_embedding"].expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + emb["position_embedding"]["weight"][None]
    x = _ln(vm["pre_layrnorm"], x)
    for i in range(cfg.num_layers):
        lp = vm["encoder"]["layers"][str(i)]
        x = x + _attn(lp["self_attn"], _ln(lp["layer_norm1"], x), cfg.num_heads)
        h = _ln(lp["layer_norm2"], x)
        x = x + _lin(lp["mlp"]["fc2"], _act(cfg.hidden_act, _lin(lp["mlp"]["fc1"], h)))
    return _ln(vm["post_layernorm"], x[:, 0])


def _normalize(z: torch.Tensor) -> torch.Tensor:
    return z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-10)


def image_features(params: Dict, cfg: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    """Preprocessed images -> L2-normalised joint-space features (B, P)."""
    return _normalize(F.linear(vision_encode(params, cfg, images),
                               params["visual_projection"]["weight"]))


def text_features(params: Dict, cfg: TextConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B, L) -> L2-normalised joint-space features (B, P): the
    hidden state at the EOS position (the argmax of the ids; EOS has the
    largest id in CLIP's vocabulary), projected."""
    h = text_encode(params, cfg, tokens)
    pooled = h[torch.arange(h.shape[0], device=h.device), tokens.long().argmax(-1)]
    return _normalize(F.linear(pooled, params["text_projection"]["weight"]))


def preprocess(images: torch.Tensor, size: int) -> torch.Tensor:
    """[0, 1] RGB (B, H, W, 3) -> resized to (B, size, size, 3) with the JAX
    package's antialiased bilinear resize (up or down) and normalised with
    CLIP's mean and std."""
    x = resize(images, (images.shape[0], size, size, 3))
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def state_dict_to_tree(flat: Dict, dtype=torch.float32, device: DeviceLike = None) -> Dict:
    """A flat transformers CLIP state dict (tensors or arrays) -> the nested
    param tree on ``device`` (``cuda`` by default); ``position_ids`` buffers
    are dropped, the patch embedding stays OIHW."""
    device = resolve_device(device)
    tree: Dict = {}
    for name, arr in flat.items():
        if name.endswith("position_ids"):
            continue
        t = arr if torch.is_tensor(arr) else torch.from_numpy(np.asarray(arr))
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.to(device, dtype)
    return tree


def init_vision_params(cfg: VisionConfig, generator: Optional[torch.Generator] = None,
                       device: DeviceLike = None) -> Dict:
    """Seeded random vision tower on ``device`` (``cuda`` by default):
    linear weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)), zero biases, unit
    layer norms; the class and patch embeddings N(0, 0.02^2), positions
    N(0, 0.01^2)."""
    gen = generator or torch.Generator().manual_seed(0)
    device = resolve_device(device)

    def lin(ci, co):
        s = 1.0 / math.sqrt(ci)
        u = torch.rand((co, ci), generator=gen)
        return {"weight": ((2.0 * u - 1.0) * s).to(device), "bias": torch.zeros((co,), device=device)}

    def ln(D):
        return {"weight": torch.ones((D,), device=device), "bias": torch.zeros((D,), device=device)}

    D = cfg.hidden_size
    P = cfg.patch_size
    n_pos = (cfg.image_size // P) ** 2 + 1
    layers = {}
    for i in range(cfg.num_layers):
        layers[str(i)] = {
            "layer_norm1": ln(D),
            "self_attn": {n: lin(D, D) for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm2": ln(D),
            "mlp": {"fc1": lin(D, cfg.intermediate_size), "fc2": lin(cfg.intermediate_size, D)},
        }
    return {"vision_model": {
        "embeddings": {
            "class_embedding": (0.02 * torch.randn((D,), generator=gen)).to(device),
            "patch_embedding": {"weight": (0.02 * torch.randn((D, 3, P, P), generator=gen)).to(device)},
            "position_embedding": {"weight": (0.01 * torch.randn((n_pos, D), generator=gen)).to(device)},
        },
        "pre_layrnorm": ln(D),
        "encoder": {"layers": layers},
        "post_layernorm": ln(D),
    }}


def init_clip_params(vcfg: VisionConfig, tcfg: TextConfig, generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> Dict:
    """A random whole CLIP tree (both towers and both projections)."""
    gen = generator or torch.Generator().manual_seed(0)
    device = resolve_device(device)
    params = init_vision_params(vcfg, gen, device)
    params.update(init_text_params(tcfg, gen, device))
    P = vcfg.projection_dim
    for name, width in (("visual_projection", vcfg.hidden_size), ("text_projection", tcfg.hidden_size)):
        s = 1.0 / math.sqrt(width)
        params[name] = {"weight": ((2.0 * torch.rand((P, width), generator=gen) - 1.0) * s).to(device)}
    return params


class CLIPLoss:
    """Text-image guidance loss: ``prepare_text(texts)`` embeds the prompts
    once; ``__call__(images)`` scores [0, 1] renders (B, H, W, 3) with
    ``-(img_z . text_z).sum(-1).mean()`` (``prompt_index`` picks the
    prompt), differentiable in the images and never in the text features.

    Built from a param tree (``state_dict_to_tree`` of a checkpoint, or
    ``init_clip_params``), or from any ``loss_fn(images) -> scalar``."""

    def __init__(self, params: Optional[Dict] = None, vision_cfg: Optional[VisionConfig] = None,
                 text_cfg: Optional[TextConfig] = None,
                 tokenizer: Optional[Callable[[str], np.ndarray]] = None,
                 loss_fn: Optional[Callable] = None):
        if params is None and loss_fn is None:
            raise NotImplementedError(
                "CLIP guidance needs ViT weights, and none are in the repository: give params= "
                "(state_dict_to_tree of a ViT-B/16 checkpoint) or loss_fn=callable(images) -> "
                "scalar to train with --rand_pose")
        self.params = params
        self.vision_cfg = vision_cfg or VisionConfig()
        self.text_cfg = text_cfg
        self.tokenizer = tokenizer
        self.loss_fn = loss_fn
        self.text_zs: Optional[torch.Tensor] = None

    def _device(self) -> torch.device:
        return self.params["visual_projection"]["weight"].device

    def prepare_text(self, texts: Sequence[str], tokens: Optional[np.ndarray] = None) -> None:
        """Embed the prompts once; ``tokens`` (N, L) stands in for the
        tokenizer."""
        if self.loss_fn is not None:
            return
        if tokens is None:
            if self.tokenizer is None:
                raise ValueError("prepare_text needs a tokenizer or tokens=")
            tokens = np.concatenate([self.tokenizer(t) for t in texts], axis=0)
        with torch.no_grad():
            self.text_zs = text_features(self.params, self.text_cfg,
                                         torch.as_tensor(np.asarray(tokens), device=self._device()))

    def __call__(self, images: torch.Tensor, prompt_index: int = 0) -> torch.Tensor:
        """images (B, H, W, 3) in [0, 1] -> a scalar loss."""
        if self.loss_fn is not None:
            return self.loss_fn(images)
        if self.text_zs is None:
            raise ValueError("call prepare_text first")
        img_z = image_features(self.params, self.vision_cfg, preprocess(images, self.vision_cfg.image_size))
        return -(img_z * self.text_zs[prompt_index].detach()).sum(-1).mean()
