"""Position-encoding factory (port of ``trinerflet_tpu/models/encodings.py``):
one place that maps an encoding name to (params, apply_fn, output_dim).

  * None / "None" / "identity" -- the point itself
  * "frequency"        -- sin/cos bands (``ops/encoders.freq_encode``)
  * "sphere_harmonics" -- real SH (``ops/encoders.sh_encode``)
  * "hashgrid" / "tiledgrid" -- the multiresolution grid (``models/gridencoder``,
    kernel K7 on CUDA)
  * "k_planes" / "multiscale_k_planes[_mul]" -- three axis-aligned feature
    planes per scale, sampled bilinearly (kernel K2 on CUDA, plane gradients
    only) and concatenated or multiplied across the planes

The wavelet triplane is the field's own encoding (``models/nerf.NeRFConfig``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..ops.encoders import freq_dim, freq_encode, sh_dim, sh_encode
from ..ops.grid_sample import sample_points
from .gridencoder import GridEncoderConfig, grid_encode, init_grid_params

__all__ = ["get_encoder", "encoder_apply", "encoder_dim", "grid_config", "KPlanesConfig",
           "kplanes_config", "init_kplanes_params", "kplanes_encode"]

_KPLANES = ("k_planes", "multiscale_k_planes", "multiscale_k_planes_mul")


def grid_config(name: str, input_dim: int = 3,
                grid_cfg: Optional[GridEncoderConfig] = None) -> GridEncoderConfig:
    """The grid of a "hashgrid" / "tiledgrid" encoding: ``grid_cfg``, or the
    JAX package's default (16 levels of 2 features, 16 -> 2048, 2^19 rows)."""
    return grid_cfg or GridEncoderConfig(input_dim=input_dim,
                                         gridtype="hash" if name == "hashgrid" else "tiled")


@dataclasses.dataclass(frozen=True)
class KPlanesConfig:
    channels: int = 16
    resolutions: Tuple[int, ...] = (128,)   # one entry per scale
    combine: str = "concat"                  # "concat" | "mul" (the product over the planes)
    init_sigma: float = 0.1

    @property
    def output_dim(self) -> int:
        per_scale = self.channels if self.combine == "mul" else 3 * self.channels
        return per_scale * len(self.resolutions)


def kplanes_config(name: str, kplanes_cfg: Optional[KPlanesConfig] = None) -> KPlanesConfig:
    """``kplanes_cfg``, or the JAX package's default for the name: one 128^2
    scale for "k_planes", (64, 128, 256) for the multiscale ones, the
    product combine for "_mul", 16 channels."""
    return kplanes_cfg or KPlanesConfig(combine="mul" if name.endswith("_mul") else "concat",
                                        resolutions=(128,) if name == "k_planes" else (64, 128, 256))


def init_kplanes_params(cfg: KPlanesConfig, generator: Optional[torch.Generator] = None,
                        device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``scale_{i}`` (3, C, R_i, R_i) ~ N(0, init_sigma), plus 1 for the
    product combine (multiplicative planes start near 1), on ``device``."""
    device = resolve_device(device)
    out = {}
    for i, res in enumerate(cfg.resolutions):
        n = cfg.init_sigma * torch.randn((3, cfg.channels, res, res), generator=generator)
        out[f"scale_{i}"] = (1.0 + n if cfg.combine == "mul" else n).to(device)
    return out


def kplanes_encode(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: KPlanesConfig,
                   bound: float) -> torch.Tensor:
    """x (N, 3) in [-bound, bound] -> (N, output_dim) f32: per scale the three
    planes sampled at the point's projections (K2 on CUDA), concatenated,
    or multiplied together with the product combine."""
    feats = []
    for i in range(len(cfg.resolutions)):
        planes = params[f"scale_{i}"].permute(0, 2, 3, 1).contiguous()  # (3, H, W, C)
        s = sample_points(planes, x, bound)  # (N, 3, C)
        feats.append(s.prod(dim=1) if cfg.combine == "mul" else s.reshape(x.shape[0], -1))
    return torch.cat(feats, dim=-1)


def encoder_dim(name: Optional[str], *, input_dim: int = 3, degree: int = 4,
                grid_cfg: Optional[GridEncoderConfig] = None,
                kplanes_cfg: Optional[KPlanesConfig] = None) -> int:
    """The encoding's output width, from the configuration alone."""
    if name in (None, "None", "identity"):
        return input_dim
    if name == "frequency":
        return freq_dim(input_dim, degree)
    if name == "sphere_harmonics":
        return sh_dim(degree)
    if name in ("hashgrid", "tiledgrid"):
        return grid_config(name, input_dim, grid_cfg).output_dim
    if name in _KPLANES:
        return kplanes_config(name, kplanes_cfg).output_dim
    if name == "triplane_wavelet":
        raise ValueError("triplane_wavelet is the NeRFField default; construct it via "
                         "models.nerf.NeRFConfig/NeRFField")
    raise ValueError(f"unknown encoding {name!r}")


def encoder_apply(name: Optional[str], *, input_dim: int = 3, degree: int = 4,
                  grid_cfg: Optional[GridEncoderConfig] = None,
                  kplanes_cfg: Optional[KPlanesConfig] = None, bound: float = 1.0):
    """apply_fn(params, x) -> feats of the encoding, without its params."""
    encoder_dim(name, input_dim=input_dim, degree=degree, grid_cfg=grid_cfg)  # raises on the rest
    if name in (None, "None", "identity"):
        return lambda p, x: x
    if name == "frequency":
        return lambda p, x: freq_encode(x, degree)
    if name == "sphere_harmonics":
        return lambda p, x: sh_encode(x, degree)
    if name in _KPLANES:
        kcfg = kplanes_config(name, kplanes_cfg)
        return lambda p, x: kplanes_encode(p, x, kcfg, bound)
    cfg = grid_config(name, input_dim, grid_cfg)
    return lambda p, x: grid_encode(p, x, cfg, bound)


def get_encoder(name: Optional[str], generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, *, input_dim: int = 3, degree: int = 4,
                grid_cfg: Optional[GridEncoderConfig] = None,
                kplanes_cfg: Optional[KPlanesConfig] = None, bound: float = 1.0):
    """Returns (params on ``device`` -- ``cuda`` by default --,
    apply_fn(params, x) -> feats, output_dim); the grid and k-planes tables
    are drawn from ``generator``, the other encodings have no params."""
    kw = dict(input_dim=input_dim, degree=degree, grid_cfg=grid_cfg, kplanes_cfg=kplanes_cfg)
    apply_fn = encoder_apply(name, bound=bound, **kw)
    params = {}
    if name in ("hashgrid", "tiledgrid"):
        params = init_grid_params(grid_config(name, input_dim, grid_cfg), generator, device)
    elif name in _KPLANES:
        params = init_kplanes_params(kplanes_config(name, kplanes_cfg), generator, device)
    return params, apply_fn, encoder_dim(name, **kw)
