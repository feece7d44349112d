"""Image reading and area resizing for the scene loaders.

The JAX package's loaders read with ``cv2.imread`` and shrink with
``cv2.resize(..., interpolation=cv2.INTER_AREA)``. The port reads PNG with
its host library (``trinerflet_tpu_torch/native``) and resizes with numpy, so
a scene of PNGs loads with no image library installed:

* ``read_image`` gives what ``cv2.imread`` gives after the JAX loaders' BGR
  to RGB flip and ``astype(np.float32) / 255.0``: with ``color=False``
  (``IMREAD_UNCHANGED``) grey as (H, W), grey with alpha as RGBA, RGB and
  RGBA as they are; with ``color=True`` (``IMREAD_COLOR``) always RGB, grey
  repeated and alpha dropped. Other formats (JPEG: real LLFF and COLMAP
  captures) go through ``cv2`` or PIL, whichever is installed; with neither,
  reading one raises naming the file and the missing decoder.
* ``resize_area`` is ``INTER_AREA``: a block mean at integer factors, area
  weights at other shrinking sizes, and OpenCV's area-mode linear weights
  when an axis grows. Sums run in float64 (OpenCV sums in float32), so the
  results agree within 1e-6.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import List, Sequence

import numpy as np

from .. import native

__all__ = ["read_image", "read_images", "resize_area", "downscale_area", "write_png"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == _PNG_SIGNATURE


def _decode_other(path: str) -> np.ndarray:
    """A non-PNG image as (H, W, C) uint8 RGB(A) or grey, through cv2 or PIL."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError(f"cv2 cannot decode {path}")
        if img.dtype != np.uint8:
            raise ValueError(f"{path}: {img.dtype} pixels; the loaders take 8-bit images")
        if img.ndim == 2:
            return img[..., None]
        return np.concatenate([img[..., 2::-1], img[..., 3:]], -1)  # BGR(A) -> RGB(A)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: no decoder for this image; the host library reads PNG, other "
                           f"formats need cv2 or PIL and neither is installed") from None
    with Image.open(path) as im:
        if im.mode not in ("L", "LA", "RGB", "RGBA"):
            raise ValueError(f"{path}: PIL mode {im.mode}; the loaders take 8-bit images")
        img = np.asarray(im)
    return img[..., None] if img.ndim == 2 else img


def _channels(px: np.ndarray, color: bool) -> np.ndarray:
    """(H, W, C) uint8 in RGB(A) order -> cv2's channel count, RGB(A) order."""
    c = px.shape[-1]
    if color:
        return np.repeat(px[..., :1], 3, -1) if c <= 2 else px[..., :3]
    if c == 1:
        return px[..., 0]
    if c == 2:
        return np.concatenate([np.repeat(px[..., :1], 3, -1), px[..., 1:]], -1)
    return px


def _to_float(px: np.ndarray) -> np.ndarray:
    return px.astype(np.float32) / 255.0


def read_image(path: str, color: bool = False) -> np.ndarray:
    """One image as float32 in [0, 1] (see the module docstring for the
    channels). Raises ``FileNotFoundError`` for a missing file."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    px = native.decode_png(path) if _is_png(path) else _decode_other(path)
    return _to_float(_channels(px, color))


def read_images(paths: Sequence[str], color: bool = False) -> List[np.ndarray]:
    """Many images as ``read_image`` gives them; PNGs of one shape are
    decoded together on all host cores."""
    paths = [os.fspath(p) for p in paths]
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    if len(paths) > 1 and all(_is_png(p) for p in paths):
        shapes = {native.png_shape(p) for p in paths}
        if len(shapes) == 1:
            return [_to_float(_channels(px, color)) for px in native.decode_png_batch(paths)]
    return [read_image(p, color) for p in paths]


def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of OpenCV's area decimation along one axis
    (``computeResizeAreaTab``): src / dst >= 1."""
    scale = src / dst
    w = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] += np.float32((s1 - f1) / cell)
        for s in range(s1, s2):
            w[d, s] += np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[d, s2] += np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return w


def _linear_area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of OpenCV's INTER_AREA on a growing axis: linear
    taps at area-mode offsets."""
    inv = dst / src
    scale = 1.0 / inv
    w = np.zeros((dst, src), np.float64)
    for d in range(dst):
        s = math.floor(d * scale)
        f = float(np.float32((d + 1) - (s + 1) * inv))
        f = 0.0 if f <= 0 else f - math.floor(f)
        if s < 0:
            s, f = 0, 0.0
        if s >= src - 1:
            s, f = src - 1, 0.0
        w[d, s] += np.float32(1.0 - f)
        if f:
            w[d, s + 1] += np.float32(f)
    return w


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)`` on a
    float32 (H, W) or (H, W, C) image."""
    H, W = img.shape[:2]
    if (H, W) == (height, width):
        return np.array(img, np.float32)
    sx, sy = W / width, H / height
    x = np.asarray(img, np.float64)
    if sx >= 1 and sy >= 1 and sx == int(sx) and sy == int(sy):  # the block mean
        kx, ky = int(sx), int(sy)
        x = x[: height * ky, : width * kx]
        x = x.reshape((height, ky, width, kx) + x.shape[2:]).mean(axis=(1, 3))
        return x.astype(np.float32)
    weights = _area_weights if (sx >= 1 and sy >= 1) else _linear_area_weights
    wy, wx = weights(H, height), weights(W, width)
    out = np.tensordot(wy, x, axes=(1, 0))                    # (height, W, ...)
    out = np.moveaxis(np.tensordot(wx, out, axes=(1, 1)), 0, 1)  # (height, width, ...)
    return out.astype(np.float32)


def downscale_area(img: np.ndarray, factor: int) -> np.ndarray:
    """The loaders' integer minification: ``resize_area`` to (W // factor,
    H // factor)."""
    if factor <= 1:
        return img
    return resize_area(img, img.shape[1] // factor, img.shape[0] // factor)


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit PNG of a uint8 (H, W) grey or (H, W, C) grey + alpha, RGB or
    RGBA array, written with zlib alone (no image library)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    H, W = img.shape[:2]
    color = 0 if img.ndim == 2 else {1: 0, 2: 4, 3: 2, 4: 6}[img.shape[2]]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(H))  # filter 0 per row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
