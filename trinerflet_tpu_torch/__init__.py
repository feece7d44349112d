"""PyTorch + CUDA port of the wavelet-triplane NeRF (occupancy-grid,
proposal and dense renderers; triplane, hash-grid and table-free encodings)
and its super-resolution app.

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
through the host library in ``native/``), the CLI (``python -m
trinerflet_tpu_torch.cli``) and the super-resolution app (``sr/``: the
dual-resolution triplane's two-phase system, the x4 upscaler's UNet and
VAE, the CLIP text encoder, the guidances and the YAML launcher ``python -m
trinerflet_tpu_torch.sr.launch``; ``utils/lpips.py``).

Still missing, each raising ``NotImplementedError`` that names where it is
queued: the CLI's ``--gui`` (``utils/gui.py``, ``utils/viewer.py``) and
``--rand_pose`` (``utils/clip_loss.py``), the SR launcher's
``system.kind: generation`` (``sr/text_to_3d.py``), and training through
analytic normals (the kernels' second derivatives). Not ported yet and not
reachable from the port's entry points: ``parallel/`` (multi-card
training), ``utils/logging.py`` and ``utils/gan.py``, ``ops/losses.py``,
``ops/morton.py`` and ``webapp.py``.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
