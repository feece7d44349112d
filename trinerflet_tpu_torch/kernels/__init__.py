"""Hand-written CUDA kernels (``csrc/*.cu``, built for ``sm_90a``) and their
launch counters.

Each kernel's wrapper lives beside its plain PyTorch version in the module
that uses it (``ops/raymarch.py``, ``ops/grid_sample.py``, ``ops/wavelets.py``,
``render/renderer.py``, ``models/gridencoder.py``) and adds one to ``launches[name]`` for every CUDA
kernel it launches, and nowhere else. Backward kernels count under their own
names (``*_bwd``, ``grid_sample_bwd_xyz`` for K2x, ``idwt_adjoint``). ``reset_launches`` zeroes every count,
so a run can show which kernels a path went through.
"""

from __future__ import annotations

from typing import Dict

# name -> CUDA kernel launches since the last reset_launches()
launches: Dict[str, int] = {
    "march": 0, "march_flat": 0, "grid_sample": 0, "grid_sample_bwd": 0, "grid_sample_bwd_xyz": 0,
    "composite": 0, "composite_bwd": 0,
    "idwt": 0, "idwt_adjoint": 0, "occupancy": 0, "compact": 0, "composite_compact": 0,
    "composite_compact_bwd": 0, "grid_encode": 0, "grid_encode_bwd": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
