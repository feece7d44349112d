"""Carry a trained state from the JAX package into this one.

The inputs are trees of array-likes (numpy arrays, or anything
``np.asarray`` accepts, such as the JAX package's device arrays), so this
module needs neither JAX nor the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .render.renderer import OccupancyState
from .train.trainer import TrainState, _map

__all__ = ["params_from_jax", "occupancy_from_jax", "adam_state_from_jax", "train_state_from_jax",
           "network_params_from_jax", "sr_state_from_jax", "clip_params_from_jax",
           "gan_params_from_jax"]


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(t, device):
    if isinstance(t, Mapping):
        return {k: _tree(v, device) for k, v in t.items()}
    return _tensor(t, device)


def _check_tables(tree: Mapping[str, Any], where: str, kplanes: bool = False) -> None:
    """A grid encoder's tables ``level_0`` ... ``level_{L-1}`` (or, with
    ``kplanes``, k-planes' ``scale_0`` ... ``scale_{S-1}``) and nothing else."""
    n = len(tree)
    kinds = [{f"level_{l}" for l in range(n)}] + ([{f"scale_{i}" for i in range(n)}] if kplanes else [])
    if not tree or set(tree) not in kinds:
        raise KeyError(f"params_from_jax: {where} must hold grid tables level_0..level_L-1"
                       f"{' or k-planes tables scale_0..scale_S-1' if kplanes else ''}, "
                       f"got {sorted(tree)}")


_TRIPLANE_KEYS = {"base", "wavelets", "upscale", "rotation", "lbound_scale"}


_REGISTRY_KEYS = {"sdf_net", "feature_net", "log_beta", "env_net", "bg_texture", "normal_net"}


def params_from_jax(tree: Mapping[str, Any], device: DeviceLike = None) -> Dict:
    """The JAX param dict as this package's params: the same keys and
    layouts, as tensors on ``device`` (``cuda`` by default). ``encoder``
    holds the wavelet triplane (``base``, ``wavelets.level_i`` and, when
    configured, ``upscale.level_i``, ``rotation`` and ``lbound_scale``), a
    grid encoder's tables (``level_{l}``), k-planes' tables (``scale_{i}``),
    a registry voxel grid (``grid``) or nothing; ``sigma_net.w*``,
    ``color_net.w*`` and, with a background network, ``bg_net.w*``; on the
    proposal renderer ``proposal`` holds ``grid.level_{l}`` and ``w``. A
    registry field's tree (``models/registry.py``) has no ``sigma_net`` on
    the volume-grid and SDF geometries, and may hold ``sdf_net``,
    ``feature_net``, the 0-dim ``log_beta``, ``env_net``, ``bg_texture``
    and ``normal_net``."""
    for key in ("encoder", "color_net"):
        if key not in tree:
            raise KeyError(f"params_from_jax: missing {key!r}")
    enc = tree["encoder"]
    if "sigma_net" not in tree and set(enc) != {"grid"} and "sdf_net" not in tree:
        raise KeyError("params_from_jax: missing 'sigma_net' (only a registry volume-grid or SDF "
                       "field has none)")
    extra = set(tree) - {"encoder", "sigma_net", "color_net", "bg_net", "proposal"} - _REGISTRY_KEYS
    if extra:
        raise KeyError(f"params_from_jax: params not ported: {sorted(extra)}")
    if "base" in enc or "wavelets" in enc:
        if "base" not in enc or "wavelets" not in enc:
            raise KeyError("params_from_jax: a triplane encoder must hold 'base' and 'wavelets'")
        extra = set(enc) - _TRIPLANE_KEYS
        if extra:
            raise KeyError(f"params_from_jax: encoder variants not ported: {sorted(extra)}")
    elif enc and set(enc) != {"grid"}:
        _check_tables(enc, "a non-triplane encoder", kplanes=True)
    device = resolve_device(device)
    out = {k: _tree(v, device) for k, v in tree.items() if k != "proposal"}
    if "proposal" in tree:
        prop = tree["proposal"]
        if set(prop) != {"grid", "w"}:
            raise KeyError(f"params_from_jax: proposal must hold 'grid' and 'w', got {sorted(prop)}")
        _check_tables(prop["grid"], "proposal.grid")
        out["proposal"] = _tree(prop, device)
    return out


def _get(obj, k, *default):
    if isinstance(obj, Mapping):
        return obj[k] if not default else obj.get(k, default[0])
    return getattr(obj, k, *default)


def occupancy_from_jax(state: Any, device: DeviceLike = None) -> OccupancyState:
    """The JAX ``OccupancyState`` (or a mapping with its fields) as this
    package's, on ``device`` (``cuda`` by default): density_grid, occ,
    occ_coarse, mean_density, iter_density, bbox. The TPU-only brick tables
    are not carried."""
    device = resolve_device(device)
    return OccupancyState(**{k: _tensor(_get(state, k), device) for k in OccupancyState._fields})


def adam_state_from_jax(opt_state: Any, device: DeviceLike = None) -> Dict:
    """The trainer's Adam state ({"count", "mu", "nu"}, trees on ``device``)
    from the JAX optax chain's state: its first entry, ``ScaleByAdamState``
    (or a stand-in with the same fields, as a checkpoint holds it)."""
    device = resolve_device(device)
    adam = opt_state[0]
    return {"count": int(np.asarray(_get(adam, "count"))),
            "mu": params_from_jax(_get(adam, "mu"), device),
            "nu": params_from_jax(_get(adam, "nu"), device)}


def train_state_from_jax(state: Any, device: DeviceLike = None, seed: int = 0, mesh=None):
    """The JAX ``TrainState`` (or a mapping with its fields) as this
    package's, on ``device`` (``cuda`` by default), so training continues
    where the JAX package stopped: params, the Adam moments and count (the
    first entry of the optax chain's state, ``ScaleByAdamState``), the EMA
    and its count, the occupancy state, the step and the error map (when
    set), on either renderer and for every ported encoder. A JAX PRNG key
    does not carry over: the step generator is seeded
    with ``seed``. The retune's EMAs and counters belong to the trainer, not
    to the state, and are not carried: a continued run re-learns them.
    With a ``mesh`` (``parallel.make_mesh``) the state comes back as this
    rank's shard (``parallel.shard_state``), so the JAX state continues on
    the port's grid."""
    device = resolve_device(device)
    error_map = _get(state, "error_map", None)
    params = _map(lambda t: t.requires_grad_(True), params_from_jax(_get(state, "params"), device))
    out = TrainState(
        params=params,
        opt_state=adam_state_from_jax(_get(state, "opt_state"), device),
        ema_params=params_from_jax(_get(state, "ema_params"), device),
        ema_count=int(np.asarray(_get(state, "ema_count"))),
        occ=occupancy_from_jax(_get(state, "occ"), device),
        step=int(np.asarray(_get(state, "step"))),
        rng=torch.Generator(device=device).manual_seed(seed),
        error_map=None if error_map is None else _tensor(error_map, device),
    )
    if mesh is None:
        return out
    from .parallel.sharding import shard_state

    return shard_state(mesh, out)



def network_params_from_jax(tree: Any, device: DeviceLike = None):
    """A network tree of the SR app from the JAX package (the x4 upscaler's
    UNet and VAE, the CLIP text encoder, LPIPS) as this package's, on
    ``device`` (``cuda`` by default): the same keys and lists, conv kernels
    HWIO -> OIHW (every 4-D leaf), everything else as it is."""
    device = resolve_device(device)

    def conv(t):
        if isinstance(t, Mapping):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        a = np.asarray(t)
        if a.ndim == 4:
            a = np.transpose(a, (3, 2, 0, 1))
        return _tensor(np.ascontiguousarray(a), device)

    return conv(tree)


def gan_params_from_jax(tree: Any, device: DeviceLike = None) -> Dict:
    """A GAN stack tree of the JAX package (``utils/gan.py``: generator,
    local and global encoders, discriminator) as this package's, on
    ``device``: conv kernels HWIO -> OIHW, everything else as it is."""
    return network_params_from_jax(tree, device)


def clip_params_from_jax(tree: Any, device: DeviceLike = None) -> Dict:
    """A CLIP tree of the JAX package (``utils/clip_loss.py``) as this
    package's, on ``device`` (``cuda`` by default): the same keys and
    values, except the patch embedding, whose (P * P * 3, D) matmul kernel
    in (i, j, c) order becomes the state dict's OIHW ``weight`` (D, 3, P, P)
    again."""
    device = resolve_device(device)
    out = _tree(tree, device)
    if "vision_model" in out:
        pe = out["vision_model"]["embeddings"]["patch_embedding"]
        k = pe.pop("kernel")
        P = int(round(math.sqrt(k.shape[0] // 3)))
        pe["weight"] = k.reshape(P, P, 3, k.shape[1]).permute(3, 2, 0, 1).contiguous()
    return out


def sr_state_from_jax(state: Any, device: DeviceLike = None, seed: int = 0):
    """The JAX ``SRState`` (or a mapping with its fields) as this package's
    ``sr.system.SRState``, on ``device``: params, the Adam moments and count
    (the optax chain's first entry), the occupancy state and the step; the
    step generator is seeded with ``seed`` (a JAX key does not carry)."""
    from .sr.system import SRState

    device = resolve_device(device)
    params = _map(lambda t: t.requires_grad_(True), params_from_jax(_get(state, "params"), device))
    return SRState(
        params=params,
        opt_state=adam_state_from_jax(_get(state, "opt_state"), device),
        occ=occupancy_from_jax(_get(state, "occ"), device),
        step=int(np.asarray(_get(state, "step"))),
        rng=torch.Generator(device=device).manual_seed(seed),
    )
