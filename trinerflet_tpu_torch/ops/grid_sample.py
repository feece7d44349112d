"""Bilinear sampling of the three feature planes (port of
``trinerflet_tpu/ops/grid_sample.py``).

Semantics are torch ``F.grid_sample(bilinear, padding_mode='border',
align_corners=True)`` on channel-last ``(H, W, C)`` planes, with the JAX
package's corner law: the continuous coordinate is clamped into the plane,
then ``x0 = min(floor(x), W - 2)`` and the four corners are ``x0, x0 + 1``
by ``y0, y0 + 1``. The sum is the JAX quad sampler's: four corner rows times
the weights ``[(1-wx)(1-wy), wx(1-wy), (1-wx)wy, wx wy]``, in float32.

``sample_points`` is the serving path's entry: project world points onto the
three planes and sample each. On a CUDA tensor it launches kernel K2
(``kernels/csrc/grid_sample.cu``), which fuses the projection; on a CPU
tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..kernels import _build

__all__ = ["grid_sample_2d", "sample_planes", "project_to_planes",
           "sample_points", "sample_points_plain"]


def grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """plane (H, W, C) with H, W >= 2, coords (N, 2) in [-1, 1]
    (``coords[:, 0]`` indexes W) -> (N, C) float32 (bf16 planes promote like
    the JAX package)."""
    H, W, C = plane.shape
    x = torch.clamp((coords[:, 0] + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    y = torch.clamp((coords[:, 1] + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    x0 = torch.clamp(torch.floor(x), 0, W - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, H - 2).to(torch.int64)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    w = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy], dim=1)
    idx = y0 * W + x0
    flat = plane.reshape(H * W, C)
    rows = torch.stack([flat[idx], flat[idx + 1], flat[idx + W], flat[idx + W + 1]], dim=1)
    return (rows * w).sum(dim=1)


def sample_planes(planes: torch.Tensor, coords2d: torch.Tensor) -> torch.Tensor:
    """planes (P, H, W, C), coords2d (P, N, 2) -> (N, P, C)."""
    out = torch.stack([grid_sample_2d(planes[p], coords2d[p]) for p in range(planes.shape[0])])
    return out.transpose(0, 1)


def project_to_planes(coords: torch.Tensor, lbound: float) -> torch.Tensor:
    """(N, 3) world coords -> (3, N, 2) per-plane coords: plane 0 spans
    (x, z), plane 1 (x, y), plane 2 (y, z), each divided by ``lbound``."""
    c = coords / lbound
    return torch.stack([c[:, [0, 2]], c[:, [0, 1]], c[:, [1, 2]]], dim=0)


def sample_points_plain(planes: torch.Tensor, xyz: torch.Tensor, lbound: float) -> torch.Tensor:
    """Plain version of K2: planes (3, H, W, C), xyz (M, 3) -> (M, 3, C) f32."""
    return sample_planes(planes, project_to_planes(xyz, lbound))


def sample_points(planes: torch.Tensor, xyz: torch.Tensor, lbound: float) -> torch.Tensor:
    """Triplane features at world points: (M, 3, C) float32."""
    if xyz.is_cuda:
        return _sample_points_cuda(planes, xyz, lbound)
    return sample_points_plain(planes, xyz, lbound)


# ---------------------------------------------------------------------------
# K2 wrapper
# ---------------------------------------------------------------------------

_K2_CHANNELS = (4, 8, 16, 32)
_K2_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p]


def _sample_points_cuda(planes: torch.Tensor, xyz: torch.Tensor, lbound: float) -> torch.Tensor:
    if planes.device != xyz.device:
        raise ValueError("sample_points kernel: planes and points on different devices")
    if planes.dim() != 4 or planes.shape[0] != 3:
        raise ValueError(f"sample_points kernel: planes must be (3, H, W, C), got {tuple(planes.shape)}")
    if planes.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sample_points kernel: planes must be bf16 or f32, got {planes.dtype}")
    if xyz.dim() != 2 or xyz.shape[1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"sample_points kernel: xyz must be (M, 3) f32, got {tuple(xyz.shape)} {xyz.dtype}")
    _, H, W, C = planes.shape
    if C not in _K2_CHANNELS or H < 2 or W < 2:
        raise ValueError(f"sample_points kernel: C in {_K2_CHANNELS} and H, W >= 2, got {tuple(planes.shape)}")
    if not planes.is_contiguous() or planes.data_ptr() % 16:
        raise ValueError("sample_points kernel: planes must be contiguous channel-last "
                         "and 16-byte aligned (it reads rows with 16-byte loads)")
    xyz = xyz.contiguous()
    M = xyz.shape[0]
    out = torch.empty((M, 3, C), device=xyz.device, dtype=torch.float32)
    if M == 0:
        return out
    fn = _build.function("grid_sample", "sample_points_launch", _K2_ARGS)
    code = fn(_build.ptr(planes), _build.ptr(xyz), M, H, W, C,
              int(planes.dtype == torch.bfloat16), float(lbound),
              _build.ptr(out), _build.stream(xyz.device))
    _build.check(code, "sample_points")
    kernels.launches["grid_sample"] += 1
    return out
