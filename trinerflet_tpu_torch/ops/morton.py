"""Morton (Z-order) codes and occupancy bit packing (port of
``trinerflet_tpu/ops/morton.py``), bit for bit. The renderer indexes its
occupancy grid row-major; these serve checkpoint interchange with
morton-ordered grids and tests. torch has no uint32 product on every
device, so the uint32 arithmetic runs in int64 and is masked to 32 bits."""

from __future__ import annotations

import torch

__all__ = ["morton3d", "morton3d_invert", "packbits"]

_U32 = 0xFFFFFFFF


def _u32(v: torch.Tensor) -> torch.Tensor:
    """int values as uint32 in int64 (two's complement wrap of negatives)."""
    return v.to(torch.int64) & _U32


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    v = _u32(v)
    v = (v * 0x00010001) & _U32 & 0xFF0000FF
    v = (v * 0x00000101) & _U32 & 0x0F00F00F
    v = (v * 0x00000011) & _U32 & 0xC30C30C3
    v = (v * 0x00000005) & _U32 & 0x49249249
    return v


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """uint32 in int64 -> int32 with the same bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """Interleave 10-bit x/y/z coords into a 30-bit morton code.
    coords: (..., 3) int in [0, 1024) -> int32 (...,)."""
    x = _expand_bits(coords[..., 0])
    y = _expand_bits(coords[..., 1])
    z = _expand_bits(coords[..., 2])
    return _to_i32((x | (y << 1) | (z << 2)) & _U32)


def _compact_bits(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(indices: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`morton3d`. indices: (...,) int -> (..., 3) int32."""
    i = _u32(indices)
    return torch.stack([_compact_bits(i), _compact_bits(i >> 1), _compact_bits(i >> 2)],
                       dim=-1).to(torch.int32)


def packbits(grid: torch.Tensor, thresh) -> torch.Tensor:
    """Pack ``grid > thresh`` into a uint8 bitfield, bit i of byte n covering
    element 8n+i. grid: (..., M) with M % 8 == 0 -> (..., M // 8) uint8."""
    occ = (grid > thresh).to(torch.int32)
    occ = occ.reshape(*grid.shape[:-1], grid.shape[-1] // 8, 8)
    weights = 2 ** torch.arange(8, dtype=torch.int32, device=grid.device)
    return (occ * weights).sum(dim=-1).to(torch.uint8)
