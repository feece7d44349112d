"""PyTorch + CUDA port of the wavelet-triplane NeRF (occupancy-grid,
proposal and dense renderers; triplane, hash-grid and table-free encodings).

This package runs beside the JAX package ``trinerflet_tpu`` and mirrors its
module names, public layouts and arithmetic. It imports ``torch`` and numpy
only; every hot-path kernel is a hand-written CUDA kernel for Hopper
(``kernels/csrc``) with a plain PyTorch version beside it. Tensors on the CPU
take the plain version; tensors on a CUDA device launch the kernel.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; when
CUDA is asked for and absent they raise (see ``_device.resolve_device``).

What this package covers: serving (novel-view rendering from a trained
state), training with the budget autotuner and its global sample layout on
the hierarchical march or on the flat march (which also walks the
``dt_gamma`` ladder), with the proposal estimator or with the dense
renderer, the hash / tiled grid field, k-planes, the triplane's variants,
the model registry (``models/registry.py``: voxel-grid and SDF geometry,
materials, backgrounds, every normal type), evaluation, checkpoints (the
JAX package's files, read and written by both), stage growth, mesh export,
the scene loaders (Blender, LLFF, COLMAP, NSVF, NeRF++, Topia, RTMV; PNG
through the host library in ``native/``) and the CLI (``python -m
trinerflet_tpu_torch.cli``). The CLI's ``--gui`` and ``--rand_pose``,
training through analytic normals and the super-resolution app raise
``NotImplementedError`` naming the slice that ports them.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
