"""Carry a trained state from the JAX package into this one.

The inputs are trees of array-likes (numpy arrays, or anything
``np.asarray`` accepts, such as the JAX package's device arrays), so this
module needs neither JAX nor the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .render.renderer import OccupancyState

__all__ = ["params_from_jax", "occupancy_from_jax"]


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(t, device):
    if isinstance(t, Mapping):
        return {k: _tree(v, device) for k, v in t.items()}
    return _tensor(t, device)


def params_from_jax(tree: Mapping[str, Any], device: DeviceLike = None) -> Dict:
    """The JAX param dict (``encoder.base``, ``encoder.wavelets.level_i``,
    ``sigma_net.w*``, ``color_net.w*``) as this package's params: the same
    keys and layouts, as tensors on ``device`` (``cuda`` by default)."""
    for key in ("encoder", "sigma_net", "color_net"):
        if key not in tree:
            raise KeyError(f"params_from_jax: missing {key!r}")
    enc = tree["encoder"]
    if "base" not in enc or "wavelets" not in enc:
        raise KeyError("params_from_jax: encoder must hold 'base' and 'wavelets' "
                       "(only the wavelet triplane is ported)")
    extra = set(enc) - {"base", "wavelets"}
    if extra:
        raise KeyError(f"params_from_jax: encoder variants not ported: {sorted(extra)}")
    device = resolve_device(device)
    return {"encoder": _tree(enc, device), "sigma_net": _tree(tree["sigma_net"], device),
            "color_net": _tree(tree["color_net"], device)}


def occupancy_from_jax(state: Any, device: DeviceLike = None) -> OccupancyState:
    """The JAX ``OccupancyState`` (or a mapping with its fields) as this
    package's, on ``device`` (``cuda`` by default): density_grid, occ,
    occ_coarse, mean_density, iter_density, bbox. The TPU-only brick tables
    are not carried."""
    def get(k):
        return state[k] if isinstance(state, Mapping) else getattr(state, k)

    device = resolve_device(device)
    return OccupancyState(**{k: _tensor(get(k), device) for k in OccupancyState._fields})
