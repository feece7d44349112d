"""LPIPS perceptual distance (Zhang et al. 2018), port of
``trinerflet_tpu/utils/lpips.py``.

The ``lpips`` package v0.1's network: scale the input to [-1, 1], the
ScalingLayer, a backbone's features at 5 taps (alex: relu1..relu5; vgg16:
relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), unit-normalise each tap over
channels, squared difference, a non-negative per-channel 1x1 "lin" to one
channel, spatial mean, sum over the taps. Used by the SR app's evaluation
and its LR-SR perceptual consistency term, and by ``LPIPSMeter``.

Images are NCHW here. Parameters keep the JAX package's tree:
``backbone.conv{i}`` with ``w`` (OIHW, torchvision's layout) and ``b``, and
``lins``, a list of (C, 1) weights. No weights are in the repository:
``load_torch_state_dict`` converts a torchvision ``alexnet`` / ``vgg16``
state dict and the lpips package's lin checkpoint (``.pth`` through
``torch.load(weights_only=True)``, or ``.safetensors``), and without them
the meters report NaN.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..ops.resize import resize

__all__ = ["lpips", "init_lpips_params", "load_torch_state_dict", "make_lpips_fn",
           "ALEX_CHANNELS", "VGG_CHANNELS"]

ALEX_CHANNELS = (64, 192, 384, 256, 256)
VGG_CHANNELS = (64, 128, 256, 512, 512)

# (out_channels, kernel, stride, pad) per conv; "M" a 3x3/2 (alex) or 2x2/2
# (vgg) max pool; "|" a feature tap after the preceding conv's ReLU
_ALEX_LAYOUT = [
    (64, 11, 4, 2), "|", "M",
    (192, 5, 1, 2), "|", "M",
    (384, 3, 1, 1), "|",
    (256, 3, 1, 1), "|",
    (256, 3, 1, 1), "|",
]
_VGG_LAYOUT = [
    (64, 3, 1, 1), (64, 3, 1, 1), "|", "M",
    (128, 3, 1, 1), (128, 3, 1, 1), "|", "M",
    (256, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1), "|", "M",
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), "|", "M",
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), "|",
]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _layout(net: str):
    if net == "alex":
        return _ALEX_LAYOUT, ALEX_CHANNELS
    if net == "vgg":
        return _VGG_LAYOUT, VGG_CHANNELS
    raise ValueError(f"net must be 'alex' or 'vgg', got {net!r}")


def _features(params: Dict, x: torch.Tensor, net: str) -> List[torch.Tensor]:
    layout, _ = _layout(net)
    pool_k = 3 if net == "alex" else 2
    taps = []
    ci = 0
    for item in layout:
        if item == "M":
            x = F.max_pool2d(x, pool_k, 2)
        elif item == "|":
            taps.append(x)
        else:
            _, _, s, p = item
            c = params["backbone"][f"conv{ci}"]
            x = torch.relu(F.conv2d(x, c["w"], c["b"], stride=s, padding=p))
            ci += 1
    return taps


def lpips(params: Dict, img0: torch.Tensor, img1: torch.Tensor, net: str = "vgg",
          normalize: bool = True) -> torch.Tensor:
    """(N,) distances between two (N, 3, H, W) batches (a (3, H, W) image
    is one), in [0, 1] with ``normalize`` (``lpips.LPIPS()(x, y,
    normalize=True)``), else in [-1, 1]. Crops under 64 px a side are
    first upsampled (bilinear, the JAX package's resize) by the least
    integer factor that brings both sides to 64, so every tap stays
    non-empty."""
    if img0.ndim == 3:
        img0, img1 = img0[None], img1[None]
    x0, x1 = img0.float(), img1.float()
    h, w = x0.shape[2:]
    if h < 64 or w < 64:
        s = max(-(-64 // h), -(-64 // w))
        shape = (x0.shape[0], x0.shape[1], h * s, w * s)
        x0, x1 = resize(x0, shape), resize(x1, shape)
    if normalize:
        x0, x1 = 2.0 * x0 - 1.0, 2.0 * x1 - 1.0
    shift = torch.tensor(_SHIFT, device=x0.device)[None, :, None, None]
    scale = torch.tensor(_SCALE, device=x0.device)[None, :, None, None]
    x0, x1 = (x0 - shift) / scale, (x1 - shift) / scale
    total = torch.zeros((x0.shape[0],), device=x0.device)
    for t0, t1, lin in zip(_features(params, x0, net), _features(params, x1, net), params["lins"]):
        n0 = t0 * torch.rsqrt((t0 * t0).sum(1, keepdim=True) + 1e-10)
        n1 = t1 * torch.rsqrt((t1 * t1).sum(1, keepdim=True) + 1e-10)
        d = (n0 - n1) ** 2
        total = total + (d * lin.abs()[:, 0][None, :, None, None]).sum(1).mean(dim=(1, 2))
    return total


def init_lpips_params(net: str = "vgg", generator: Optional[torch.Generator] = None,
                      device: DeviceLike = None) -> Dict:
    """Random parameters of the real shapes (conv weights N(0, 1/fan_in),
    lins U(0, 1/C)) on ``device`` (``cuda`` by default)."""
    gen = generator or torch.Generator().manual_seed(0)
    device = resolve_device(device)
    layout, tap_channels = _layout(net)
    backbone = {}
    cin, ci = 3, 0
    for item in layout:
        if isinstance(item, tuple):
            cout, k, _, _ = item
            w = torch.randn((cout, cin, k, k), generator=gen) / math.sqrt(k * k * cin)
            backbone[f"conv{ci}"] = {"w": w.to(device), "b": torch.zeros((cout,), device=device)}
            cin, ci = cout, ci + 1
    lins = [(torch.rand((c, 1), generator=gen) / c).to(device) for c in tap_channels]
    return {"backbone": backbone, "lins": lins}


def load_torch_state_dict(backbone_sd: Dict, lin_sd: Dict, net: str = "vgg",
                          device: DeviceLike = None) -> Dict:
    """torchvision backbone + lpips lin state dicts -> the tree, on
    ``device``. backbone_sd: ``alexnet`` / ``vgg16`` with conv weights at
    ``features.{idx}.weight`` (OIHW); lin_sd: ``lin{i}.model.1.weight`` (or
    the older ``lins.{i}.model.1.weight``), each (1, C, 1, 1). Values may be
    tensors or numpy arrays."""
    device = resolve_device(device)
    layout, tap_channels = _layout(net)

    def t(v):
        return torch.as_tensor(np.asarray(v.detach().cpu() if torch.is_tensor(v) else v),
                               dtype=torch.float32).to(device)

    feat_indices = []
    idx = 0
    for item in layout:  # torchvision's features interleave convs, ReLUs and pools
        if item == "M":
            idx += 1
        elif isinstance(item, tuple):
            feat_indices.append(idx)
            idx += 2
    backbone = {f"conv{ci}": {"w": t(backbone_sd[f"features.{fi}.weight"]),
                              "b": t(backbone_sd[f"features.{fi}.bias"])}
                for ci, fi in enumerate(feat_indices)}
    lins = []
    for i, c in enumerate(tap_channels):
        key = f"lin{i}.model.1.weight"
        if key not in lin_sd:
            key = f"lins.{i}.model.1.weight"
        lins.append(t(lin_sd[key]).reshape(c, 1))
    return {"backbone": backbone, "lins": lins}


def load_any(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from ``.safetensors`` or a torch ``.pth`` (read with
    ``weights_only=True``)."""
    if path.endswith(".safetensors"):
        from ..sr.diffusion import read_safetensors

        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def make_lpips_fn(backbone_path: Optional[str] = None, lin_path: Optional[str] = None,
                  net: str = "vgg", params: Optional[Dict] = None, device: DeviceLike = None):
    """``fn(img0, img1) -> float``, the mean distance of (H, W, 3) or
    (N, H, W, 3) images in [0, 1] (tensors or numpy), or None when no
    weights are given (the callers then leave LPIPS out)."""
    if params is None:
        if not (backbone_path and lin_path):
            return None
        params = load_torch_state_dict(load_any(backbone_path), load_any(lin_path), net, device)
    dev = params["lins"][0].device

    def nchw(a):
        t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(dev, torch.float32)
        t = t[None] if t.ndim == 3 else t
        return t.permute(0, 3, 1, 2)

    def dist(a, b) -> float:
        with torch.no_grad():
            return float(lpips(params, nchw(a), nchw(b), net=net).mean())

    return dist
