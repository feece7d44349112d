"""Position-encoding factory (port of ``trinerflet_tpu/models/encodings.py``):
one place that maps an encoding name to (params, apply_fn, output_dim).

  * None / "None" / "identity" -- the point itself
  * "frequency"        -- sin/cos bands (``ops/encoders.freq_encode``)
  * "sphere_harmonics" -- real SH (``ops/encoders.sh_encode``)
  * "hashgrid" / "tiledgrid" -- the multiresolution grid (``models/gridencoder``,
    kernel K7 on CUDA)

The k-planes encodings come with a later slice; the wavelet triplane is the
field's own encoding (``models/nerf.NeRFConfig``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .._device import SLICE_LATER, DeviceLike, not_ported
from ..ops.encoders import freq_dim, freq_encode, sh_dim, sh_encode
from .gridencoder import GridEncoderConfig, grid_encode, init_grid_params

__all__ = ["get_encoder", "encoder_apply", "encoder_dim", "grid_config"]

_KPLANES = ("k_planes", "multiscale_k_planes", "multiscale_k_planes_mul")


def grid_config(name: str, input_dim: int = 3,
                grid_cfg: Optional[GridEncoderConfig] = None) -> GridEncoderConfig:
    """The grid of a "hashgrid" / "tiledgrid" encoding: ``grid_cfg``, or the
    JAX package's default (16 levels of 2 features, 16 -> 2048, 2^19 rows)."""
    return grid_cfg or GridEncoderConfig(input_dim=input_dim,
                                         gridtype="hash" if name == "hashgrid" else "tiled")


def encoder_dim(name: Optional[str], *, input_dim: int = 3, degree: int = 4,
                grid_cfg: Optional[GridEncoderConfig] = None) -> int:
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
        raise not_ported(f"encoding {name!r}", SLICE_LATER)
    if name == "triplane_wavelet":
        raise ValueError("triplane_wavelet is the NeRFField default; construct it via "
                         "models.nerf.NeRFConfig/NeRFField")
    raise ValueError(f"unknown encoding {name!r}")


def encoder_apply(name: Optional[str], *, input_dim: int = 3, degree: int = 4,
                  grid_cfg: Optional[GridEncoderConfig] = None, bound: float = 1.0):
    """apply_fn(params, x) -> feats of the encoding, without its params."""
    encoder_dim(name, input_dim=input_dim, degree=degree, grid_cfg=grid_cfg)  # raises on the rest
    if name in (None, "None", "identity"):
        return lambda p, x: x
    if name == "frequency":
        return lambda p, x: freq_encode(x, degree)
    if name == "sphere_harmonics":
        return lambda p, x: sh_encode(x, degree)
    cfg = grid_config(name, input_dim, grid_cfg)
    return lambda p, x: grid_encode(p, x, cfg, bound)


def get_encoder(name: Optional[str], generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, *, input_dim: int = 3, degree: int = 4,
                grid_cfg: Optional[GridEncoderConfig] = None, bound: float = 1.0):
    """Returns (params on ``device`` -- ``cuda`` by default --,
    apply_fn(params, x) -> feats, output_dim); the grid tables are drawn from
    ``generator``, the other encodings have no params."""
    kw = dict(input_dim=input_dim, degree=degree, grid_cfg=grid_cfg)
    apply_fn = encoder_apply(name, bound=bound, **kw)
    params = {}
    if name in ("hashgrid", "tiledgrid"):
        params = init_grid_params(grid_config(name, input_dim, grid_cfg), generator, device)
    return params, apply_fn, encoder_dim(name, **kw)
