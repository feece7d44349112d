"""Build the CUDA kernels with ``nvcc`` at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launcher (no PyTorch headers), so a
build takes seconds. The shared library lands in ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``) under a name that carries a
hash of its source and flags, so an edited source is rebuilt and an unchanged
one is reused. ``build_all`` starts one ``nvcc`` per source, all at once.

Launchers take device pointers and the stream as ``c_void_p`` and return the
``cudaGetLastError()`` code after the launch; ``check`` raises on a nonzero
code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

# name -> extra nvcc flags. march.cu and march_flat.cu need the plain
# versions' exact arithmetic (their masks must agree bit for bit), so they
# turn off nvcc's contraction of a*b+c and use fmaf() exactly where the
# reference fuses;
# occupancy.cu does the same for the bbox's float32 arithmetic, and
# compact.cu for the sample positions and distances K5 copies (o + d*t and
# t + dt - t0 round as two operations, as in the plain version), and
# gridencoder.cu for the cell coordinate that decides K7's corners (one fused
# multiply-add where XLA fuses, every other operation rounded alone), and
# volume_grid.cu for the voxel coordinate (the same), and textured_bg.cu and
# grid_sample.cu for the texel coordinates (every operation rounded alone,
# as op-by-op JAX computes them; grid_sample.cu's sums too, as its plain
# versions sum).
SOURCES: Dict[str, List[str]] = {
    "march": ["-fmad=false"],
    "march_flat": ["-fmad=false"],
    "grid_sample": ["-fmad=false"],
    "composite": [],
    "idwt": [],
    "occupancy": ["-fmad=false"],
    "compact": ["-fmad=false"],
    "gridencoder": ["-fmad=false"],
    "volume_grid": ["-fmad=false"],
    "textured_bg": ["-fmad=false"],
}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from csrc/*.cu at first use")


def _flags(name: str) -> List[str]:
    return _ARCH + _COMMON + SOURCES[name]


def _target(name: str) -> Path:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every listed kernel not yet built, one ``nvcc`` each, all in
    parallel. Returns seconds spent per kernel built (0.0 when cached)."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    secs = {n: 0.0 for n in names}
    for n in names:
        out = _target(n)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc] + _flags(n) + ["-o", str(tmp), str(_CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    errors = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: list, restype=ctypes.c_int):
    """The C launcher ``symbol`` of kernel ``name`` with its ctypes
    signature set (pointers and the stream as c_void_p)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {code}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def stream_scratch(cache: dict, device, words: int, dtype):
    """Scratch of at least ``words`` elements that a kernel needs zero and
    leaves zero (tickets, tile counters), kept in ``cache`` between calls
    per (device, stream): calls on one stream run in order, and a fresh
    zeroed buffer would cost another launch. Returns (key, buffer); the
    caller drops ``cache[key]`` after a failed launch, which may leave it
    dirty."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = cache.get(key)
    if buf is None or buf.numel() < words:
        grown = max(words, 2 * (0 if buf is None else buf.numel()))
        buf = cache[key] = torch.zeros((grown,), device=device, dtype=dtype)
    return key, buf
