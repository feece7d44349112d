"""PyTorch + CUDA port of the wavelet-triplane NeRF (occupancy-grid,
proposal and dense renderers; triplane, hash-grid and table-free encodings),
its super-resolution and text-to-3D apps, and their viewer and launcher.

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
trinerflet_tpu_torch.cli``, with CLIP guidance for ``--rand_pose`` in
``utils/clip_loss.py`` and the HTTP viewer for ``--gui`` in
``utils/gui.py``), the super-resolution app (``sr/``: the dual-resolution
triplane's two-phase system, the x4 upscaler's UNet and VAE, the CLIP text
encoder, the guidances and the YAML launcher ``python -m
trinerflet_tpu_torch.sr.launch``; ``utils/lpips.py``), text-to-3D
generation (``sr/text_to_3d.py``), the experiment logger
(``utils/logging.py``), the orbit turntable (``utils/viewer.py``), the
web launcher (``python -m trinerflet_tpu_torch.webapp``), multi-process
training and evaluation on a (data, model) process grid over
``torch.distributed`` (``parallel/``: ``make_mesh``, ``Trainer(...,
mesh=...)``, ``python -m trinerflet_tpu_torch.parallel.launch``), the loss
library (``ops/losses.py``), Morton codes (``ops/morton.py``) and the GAN
stack (``utils/gan.py``).

Still missing: training through analytic normals (the kernels' second
derivatives), which raises ``NotImplementedError`` naming where it is
queued. It is the last gap against the JAX package, where only its tests
reach it.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
