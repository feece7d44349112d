"""ctypes bindings of the port's host library (``trinerflet_native.cpp``
beside this file): the PNG decoder, a threaded batch decoder, marching
tetrahedra and a baseline JPEG encoder (the HTTP viewer's frames).

The library is built with ``g++`` at first use into ``build/native/`` at the
root of the checkout (listed in ``.gitignore``), under a name that carries a
hash of its source and flags, as the CUDA kernels are. A failed build raises
``RuntimeError`` with the compiler's message; nothing falls back to another
decoder or mesher.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["load", "png_shape", "decode_png", "decode_png_batch", "marching_tetrahedra", "encode_jpeg"]

_SRC = Path(__file__).resolve().parent / "trinerflet_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp"]
_LIBS = ["-lz"]

_lib: Optional[ctypes.CDLL] = None

# tn_decode_png_file's codes
_ERRORS = {-1: "not a PNG file", -2: "truncated PNG", -3: "bit depth other than 8, or interlaced",
           -4: "palette or unknown colour type", -5: "inflate failed", -6: "output buffer too small",
           -7: "unknown scanline filter", -11: "read failed", -20: "another shape or channel count"}


def _target() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS + _LIBS).encode())
    return BUILD_DIR / f"trinerflet_native-{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The built library with its signatures set; builds it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    out = _target()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++"] + _FLAGS + [str(_SRC), "-o", str(tmp)] + _LIBS
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"the host library cannot be built: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"the host library failed to build (g++ exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.tn_decode_png_file.argtypes = [ctypes.c_char_p, i32p, i32p, i32p, ctypes.c_void_p,
                                       ctypes.c_long]
    lib.tn_decode_png_file.restype = ctypes.c_int
    lib.tn_decode_png_batch.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p,
                                                                                 i32p]
    lib.tn_decode_png_batch.restype = ctypes.c_int
    lib.tn_marching_tets.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_float] * 5
                                     + [ctypes.c_void_p, ctypes.c_long])
    lib.tn_marching_tets.restype = ctypes.c_long
    lib.tn_encode_jpeg.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_long]
    lib.tn_encode_jpeg.restype = ctypes.c_long
    _lib = lib
    return lib


def png_shape(path: str) -> Tuple[int, int, int]:
    """(H, W, channels) from a PNG's header (channels 1, 2, 3 or 4; 0 for a
    colour type the decoder does not take)."""
    with open(path, "rb") as f:
        head = f.read(26)
    if len(head) < 26 or head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"not a PNG file: {path}")
    w, h = struct.unpack(">II", head[16:24])
    return h, w, {0: 1, 4: 2, 2: 3, 6: 4}.get(head[25], 0)


def _raise(code: int, path: str):
    if code == -10:
        raise FileNotFoundError(path)
    raise ValueError(f"PNG decode failed ({code}: {_ERRORS.get(code, 'unknown error')}): {path}")


def decode_png(path: str) -> np.ndarray:
    """One 8-bit PNG -> (H, W, C) uint8 in the file's channel order (grey,
    grey + alpha, RGB or RGBA)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    lib = load()
    h, w, _ = png_shape(path)
    out = np.empty((h * w * 4,), np.uint8)
    ww, hh, ch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.tn_decode_png_file(path.encode(), ctypes.byref(ww), ctypes.byref(hh),
                                ctypes.byref(ch), out.ctypes.data, out.size)
    if rc != 0:
        _raise(rc, path)
    return out[: hh.value * ww.value * ch.value].reshape(hh.value, ww.value, ch.value)


def decode_png_batch(paths: Sequence[str]) -> np.ndarray:
    """PNGs of one shape and channel count, decoded on all host cores ->
    (V, H, W, C) uint8."""
    paths = list(paths)
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    lib = load()
    H, W, C = png_shape(paths[0])
    if C == 0:
        _raise(-4, paths[0])
    out = np.empty((len(paths), H, W, C), np.uint8)
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    bad = ctypes.c_int(-1)
    rc = lib.tn_decode_png_batch(blob, len(paths), H, W, C, out.ctypes.data, ctypes.byref(bad))
    if rc != 0:
        _raise(rc, paths[bad.value])
    return out


def marching_tetrahedra(grid: np.ndarray, threshold: float, origin=(0.0, 0.0, 0.0),
                        spacing: float = 1.0) -> np.ndarray:
    """Iso-surface of an (X, Y, Z) grid on all host cores -> (T, 3, 3)
    float32 triangle soup at ``origin + index * spacing``."""
    lib = load()
    g = np.ascontiguousarray(grid, np.float32)
    X, Y, Z = g.shape
    args = [g.ctypes.data, X, Y, Z, float(threshold)] + [float(v) for v in origin] + [float(spacing)]
    n = lib.tn_marching_tets(*args, None, 0)
    out = np.empty((int(n), 3, 3), np.float32)
    if n:
        lib.tn_marching_tets(*args, out.ctypes.data, int(n))
    return out


def encode_jpeg(rgb: np.ndarray, quality: int = 90) -> bytes:
    """(H, W, 3) uint8 RGB -> baseline JPEG bytes (JFIF, YCbCr 4:2:0, the
    Annex K tables scaled to ``quality`` the IJG way, Huffman coded)."""
    a = np.ascontiguousarray(rgb)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, got {a.dtype} {a.shape}")
    lib = load()
    H, W = a.shape[:2]
    out = np.empty((((H + 15) // 16) * ((W + 15) // 16) * 256 * 10 + 2048,), np.uint8)
    n = lib.tn_encode_jpeg(a.ctypes.data, H, W, int(quality), out.ctypes.data, out.size)
    if n < 0:
        raise ValueError(f"encode_jpeg failed ({n}) on a {a.shape} image")
    return out[:n].tobytes()
