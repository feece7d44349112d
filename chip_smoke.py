"""Drive the PyTorch port's serving and training paths, its CLI, its
super-resolution and text-to-3D apps, CLIP guidance, the HTTP viewer, the
web launcher, multi-process training over torch.distributed and the GAN
stack on one NVIDIA GPU and check them: the wavelet-triplane field on the occupancy-grid renderer (the
hierarchical march, and the flat march on the dt_gamma ladder), the
proposal renderer, the hash-grid field, the dense renderer, the triplane's
variants (learned rotation and lbound zoom, zoom-in planes, background net),
k-planes, and the model registry (the voxel grid, the textured and
env-map backgrounds, the SDF, the diffuse material, analytic normals).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
1. print the card (``nvidia-smi`` name and power limit);
2. build kernels K1-K11 (with K1f, K2x, K3c, K7x and K2x², K7x², K10²) from
   ``trinerflet_tpu_torch/kernels/csrc`` with nvcc, one process per source,
   in parallel; print the launch floor (``time_ms`` of a one-element
   ``fill_``), which the launch-bound rows (K3, K3c, K11) set their time
   beside in their notes;
3. serve: the full-width bench model (1024^2 x 16-channel bf16 wavelet
   triplane, bior6.8, 4 IDWT levels, bf16 MLPs, bound 1.5, 128^3 x 2-cascade
   occupancy grid, max_steps 1024, 20 samples per ray), seeded random weights
   with small non-zero wavelet levels; camera culling over 8 orbit cameras,
   one full density-grid refresh, then ``Trainer.render_image`` of two
   800x800 views with every launch counter zeroed just before and read just
   after; one full eval chunk (16,384 rays) of the first view is rendered
   again through the plain versions on the CPU (a wrapper runs its plain
   version only for CPU tensors) and compared;
4. serve kernels: K1-K4 forward on the serve path's own inputs against their
   plain PyTorch versions on the card, with time, the plain version's time,
   the least time the card could take (bound) and, where one PyTorch call
   computes the same function, that call's time; and K1f on the serve
   state's grid at dt_gamma 0 (bound 1.5: 1,536 candidates per ray), both
   modes, held to its plain version bit for bit;
5. per-ray train: ``bench.py``'s step (32,768 rays, the same model, wavelet
   L1 0.4, Adam + EMA, refresh every 16 steps) with ``budget_autotune=False``
   on the synthetic scene (8 views of 256^2), cut to 64 warm-up steps and
   one timed window of 50: counters zeroed just before, read just after; the
   loss must fall;
6. per-ray train kernels: one more step and one partial refresh record the
   arguments the path hands each kernel wrapper; each kernel (K1 with the
   training stride, K2 forward and backward, K3 forward and backward, the K4
   adjoint, K6) is held to its plain version on those arguments and timed
   beside its bound and library call, in rows that carry this path's
   launches; then the 4,096-ray step check: one step's loss and per-group
   gradients at full width with an injected batch and noise, on the card
   (kernels) and on the CPU (plain versions);
7. autotune train: ``bench.py``'s configuration as bench.py runs it, with
   ``budget_autotune=True``: 320 warm-up steps on the bench cadence (full
   refreshes while iter_density < 16, then the rotating quarter; the retune
   on the last step's aux at every refresh), then 5 timed windows of 50
   steps (median); bench.py's summary (budget, layout, num_coarse, stride,
   kept samples per ray, loss); counters zeroed and read around the whole
   phase; one step under ``torch.profiler``; then, as in 6, one step's
   arguments at the shapes the tuner chose hold each kernel it launched to
   its plain version, in rows that carry this path's launches;
8. evaluate: ``Trainer.evaluate`` of the trained state on the 8 views
   (PSNR and SSIM must be finite);
9. global layout: the trained state continues on ``compaction="global"``
   with S slots per ray from the tuner's rule on the live mean, at full
   width: counters zeroed, 2 windows of 50 steps with refreshes, counters
   read (K5 and K3c forward and backward must have launched), ms/step,
   buffer use; one step under the profiler; then, as in 6, one step's
   arguments hold every kernel of the layout to its plain version (K1, K2
   forward and backward on the M = N*S buffer's points, the K4 adjoint, K6,
   K5 bit for bit, K3c forward and backward at a stated tolerance), each
   timed; then the 4,096-ray step check on the global layout;
10. proposal renderer: bench.py's model with ``renderer="proposal"`` (64 +
    32 samples, the 5-level proposal grid), 64 warm-up steps and one timed
    window of 50 (no refresh, no retune); counters zeroed and read around
    it: K7 forward and backward, K2, K3 and K4 must have launched and K1,
    K5 and K6 not; the loss and the interlevel loss must fall; one step
    under the profiler; evaluate on the 8 views and one 800^2 view; one
    captured step holds K7 forward (N x 64 points, 5 levels; bit for bit,
    a second call the same bits) and backward,
    K2, K3 (both calls) and the K4 adjoint to their plain versions; the
    4,096-ray step check on the initial parameters (the trained field sits
    on the reference's black plateau, where the check is ill-conditioned);
11. hash-grid field: ``NeRFConfig(encoding="hashgrid")`` at the JAX
    package's default grid (16 levels, 2^19 rows) on bench.py's
    occupancy-grid configuration with the tuner on, 64 + 50 steps on the
    refresh cadence (K7, K1, K3 and K6 must launch, K2 and K4 not); the
    loss must fall; one step under the profiler; one 800^2 view; one
    captured step and refresh hold K7 forward (every call) and backward,
    K1, K3 and K6 to their plain versions; the 4,096-ray step check;
12. flat march: ``scripts/bench_dtgamma_march.py``'s LLFF-like
    configuration as the CLI runs it (bench's triplane and MLPs at bound 4,
    3 cascades, max_steps 1024, B 20, dt_gamma 1/128 with the march left at
    its default, so render_occgrid takes the flat branch and the retune
    runs; 32,768 rays, the tuner on) on bench's synthetic scene, whose
    cameras (radius 2) sit inside the bound-4 box as a forward-facing
    capture's do; 64 + 50 steps on the refresh cadence (K1f, K2, K4 and K6
    must launch, with K3 or K5 + K3c, and K1 not); the loss must fall; one
    step under the profiler; evaluate; one 800^2 view; a captured step holds
    every kernel of the path to its plain version (K1f and K5 bit for bit, a
    second call the same bits), and K1f's per-ray mode at B = 13 on that
    step's rays, where some rays' spread rank runs past their count; the
    4,096-ray step check; then the layout the tuner did not end on, forced
    for a few steps (the per-ray selection or the exact global compaction:
    K1f's other mode and K5 bit for bit), its own captured step's rows;
13. dense renderer: bench's model with ``renderer="dense"``, 512 uniform +
    64 importance samples per ray, 4,096 rays; 16 + 16 steps (K2, K3 and K4
    forward and backward must launch; K1, K1f, K5 and K6 not); the loss
    must fall; one step under the profiler; one 800^2 view; a captured
    step holds K2, K3 at T = 512 (the upsampling weights) and 576 and the
    K4 adjoint to their plain versions; the step check on the initial
    parameters (as the proposal phase's);
14. the triplane's variants: bench's model and step (the tuner on) with the
    learned rotation, the lbound zoom and two zoom-in levels at ratio 0.5
    (``--triplane_rotation --lbound_auto_scale --upscale_ratio_bound
    0.5``), the background network (bg_radius 4) and SH degree 8; 64 + 50
    steps on the refresh cadence (K2x must launch and K2's plane-only
    backward not: every training sample is differentiated in its point);
    the quaternion and lbound_scale must move and the loss fall; one
    profiled step, evaluate, one 800^2 view; a captured step holds K2
    forward on ``full`` and both zoom-in planes, K2x on each (its plane
    gradient bit for bit the K2 backward's on the same rows), K4 forward
    and adjoint on the crops, and the path's march, layout and upkeep to
    their plain versions; the 4,096-ray step check (the gradients of the
    quaternion, lbound_scale and the zoom-in levels included; the unused
    background net's exactly zero); one direct ``render_occgrid`` chunk
    with ``bg_fn=field.background``, card against CPU;
15. k-planes: ``NeRFConfig(encoding="multiscale_k_planes_mul")`` at the JAX
    package's default (64, 128, 256) x 16 on bench's occgrid configuration,
    64 + 50 steps (K2 forward and backward must launch; K4 and K2x not);
    one 800^2 view, a captured step's rows, the step check on the initial
    parameters after one full refresh (as the proposal phase's);
16. registry-grid: ``make_field(..., "volume-grid",
    "neural-radiance-material", "textured-background")`` at the JAX
    package's defaults (a 64^3 x 16 f32 voxel grid, a 64 x 128 texture)
    behind ``bg_fn`` (bg_radius 4), on bench's rays, scene and render
    configuration with every cell occupied (as the JAX registry tests
    render), MSE and the trainer's Adam: 64 + 50 steps (K10 and K11 forward
    and backward, K1 and K3 must launch; K2, K4, K6 not), one 800^2 view in
    chunks of 16,384 rays, one step under the profiler; a captured step
    holds K10 and K11 forward and backward to their plain versions on the
    CPU (K10 forward bit for bit); one 16,384-ray chunk of the trained grid
    with the diffuse material's analytic normals (K10's backward for dL/dx
    alone) holds and times K10's coordinate gradient, and K11's forward on
    its one camera's rays (the share of a warp's taps that share a texel
    row in the backward row's note and this one's); the step check;
17. registry-sdf: ``implicit-sdf`` on bench's triplane with
    ``diffuse-with-point-light-material`` (finite-difference normals) and
    the env-map background: 64 + 50 steps; the step check on the initial
    parameters with float32 MLPs (a finite difference divides the bf16
    MLPs' rounding by eps); one 800^2 view with analytic normals under
    ``torch.no_grad()`` (K2x launches, no parameter gradient does); the
    analytic normals at its samples against the CPU plain versions and
    against finite differences (float32 copies, eps 0.05 of a cell);
18. registry-hash-normals: the hash-grid phase's trained field under the
    diffuse material with analytic normals: one 800^2 view (K7 and K7x),
    K7x held to its plain version on a captured chunk (bit for bit at the
    field's C = 2) and timed beside the K7 forward on the same chunk, the
    same normal checks;
19. registry-sdf-analytic: phase 17's field with analytic normals, trained
    through them (the loss differentiated through the normal into every
    parameter, as JAX's ``jax.value_and_grad`` does): bench's 32,768 rays,
    32 + 32 steps with the trainer's Adam on a full grid; K2, K2x, K2x²,
    K4 and its adjoint must launch, and K2x only as one launch a call
    (the normal's inner gradient runs no plane-gradient pass); the loss
    must fall; one step under the profiler; a captured step's K2x² held to
    its plain version on the CPU and timed beside its bound, the plain
    version and ``autograd.grad`` twice through ``F.grid_sample`` (NCHW);
    the step check on the initial parameters with float32 MLPs
    (1,024 rays; every parameter's gradient card vs CPU);
20. registry-hash-analytic: the hash-grid field (``hashgrid_configs``)
    under the diffuse material with analytic normals, the same steps and
    checks: K7, K7x and K7x² must launch; K7x² held to its plain version
    at the field's C = 2 (no library call);
21. registry-grid-analytic: phase 16's voxel grid (64^3 x 16 f32) under
    the diffuse material with analytic normals, the same steps and checks:
    K10, K10x and K10² must launch; the library call is ``F.grid_sample``
    5-D differentiated twice;
22. cli: a synthetic Blender scene (30 training, 8 val and 8 test views of
    400^2, rendered on the card by ``write_synthetic_scene``; PNG decode
    ms per view), then ``trinerflet_tpu_torch.cli`` on the README's
    two-stage recipe at its widths (512^2 then 1024^2 x 16, 8 then 16
    wavelet levels, 20,000 then 60,000 rays, -O, dt_gamma 0, wavelet L1
    0.2), 256 + 256 steps with an evaluation and a rotating checkpoint every
    128; counters zeroed and read around it (K1, K2 forward and backward, K4
    forward and adjoint, K6, and K3 or K3c must launch); the workspace's
    checkpoints and results; the field's density quantiles on a 96^3
    sweep; ms/step by stage; a save / load round trip on
    the card (params, EMA, Adam moments, occ, occ_coarse, bbox, one view and
    one step on the same batch bit for bit); the step check on stage 2; one
    profiled step and a captured step's rows; ``--test --test_with_ema``
    (a finite PSNR above a black render's, the test PNGs, a non-empty
    ``mesh.obj`` at resolution 192, the video or its frames; K6's rebuild of
    the checkpoint's occupancy held to its plain version) and ``--test
    --save_planes``;
23. sr: ``configs/triplane-sr100_400-srtex.yaml`` through
    ``sr.launch.build``, ``SRSystem.fit`` and ``evaluate`` at its widths
    (1024^2 x 16 bior6.8 planes with the 256^2 ``low_res`` snapshot, 64-wide
    bf16 MLPs, a 128^3 grid, 8,192 LR rays, 32-LR-pixel crops, 100^2 LR and
    400^2 HR views, the resize guidance), the views and steps cut (8 views,
    400 + 200 steps, a refresh every 100; each cut printed); counters
    zeroed before fit and read at the phase switch and its end (K1-K4
    forward and backward and K6 must launch in each phase); ms/step of each
    phase, one step of each under the profiler, seconds per pseudo-GT
    refresh; captured steps of both phases and one HR view chunk hold K1,
    K2 forward and backward (on the 256^2 snapshot in phase 1), K3, K4
    forward (to the snapshot, and to 1024^2) and adjoint and K6 to their
    plain versions, timed; evaluate (LR PSNR, HR PSNR and SSIM beside the
    bilinear baseline; LR PSNR 3 dB above a black render's); then the x4
    upscaler's UNet (468.4 M), VAE (55.3 M) and text encoder (23 x 1024) at
    their published widths with seeded random weights: one generate_sr on
    a 100^2 LR view and its 400^2 render (4 DDIM steps, ignore_t 600, text
    CFG 7.5), ms per UNet call, VAE encode / decode ms, peak memory, one
    text_encode; one UNet call and one VAE decode at 16^2 latents and the
    text encoder held to the CPU (float32, TF32 off);
24. gen: text-to-3D generation through ``sr.launch.build`` on a generation
    config made of the srtex recipe's model, triplane and renderer sections
    (its widths), ``TextTo3DConfig``'s defaults (128^2 views, 8 a round,
    64^2 crops) and the weights-free conditioning guidance (the full DDIM
    tail); the steps and the refresh period cut (4,000 -> 400, 400 -> 100,
    each cut printed); counters zeroed and read around ``fit`` (K1, K2
    forward and backward, K3 forward and backward, K4 forward and adjoint
    and K6 must launch); ms/step, seconds per refresh, one profiled step; a
    captured step's and a refresh view's kernel rows; the step check (one
    step's gradients, card vs CPU plain versions); finite losses; the
    turntable (ms per frame, its file or frames);
25. t2i: one ``Text2ImgGuidance.generate_sr`` refresh of a 128^2 render with
    seeded random weights at Stable Diffusion 2.1-base's published widths
    (the UNet 4 -> 4, (320, 640, 1280, 1280), heads (5, 10, 20, 20),
    cross-attention 1024, linear projections, no class embedding; the VAE
    (128, 256, 512, 512), scaling 0.18215; 77 x 1024 prompt embeddings): ms
    per UNet call at 16^2 latents, VAE encode and decode ms, peak memory;
    one UNet call at 8^2 latents held to the CPU (float32, TF32 off);
26. clip: a --clip_ckpt directory at ViT-B/16's published widths (seeded
    random weights as ``pytorch_model.bin``, a character vocabulary), then
    ``trinerflet_tpu_torch.cli`` on the cli phase's scene at the README's
    stage-1 widths with ``--rand_pose 3`` for 64 steps: the launches of the
    run and of its CLIP steps, ms per CLIP step beside ms per supervised
    step, a captured CLIP step's kernel rows, the step check on one CLIP
    step, ``CLIPLoss`` card vs CPU (float32, TF32 off);
27. gui: ``cli --gui --test`` over the cli phase's checkpoint, a loopback
    client fetching the page, /state, five 800^2 frames (each the native
    encoder's bytes of ``render_image`` at its pose; ms per frame) and
    /stop; then ``cli --gui`` training 64 iterations of the stage-1 recipe
    (/state advances, a frame mid-run, ``latest_model.pkl`` at the end);
28. webapp: ``LaunchMonitor`` and ``make_server`` on loopback; POST /run of
    the SR launcher on a generation YAML at the srtex widths (32 steps, 2
    views a round, a refresh every 16); /status until the child exits 0;
    /artifact serves its turntable;
29. parallel: (a) ``parallel.launch.run_on_mesh`` forms a one-rank NCCL
    group on the card and trains bench's model (32,768 rays per data rank,
    the tuner off) 20 steps on the per-ray layout and 20 on the global
    layout at the tuner's slots for the live mean: K1, K2 forward and
    backward, K3, K4 forward and adjoint, K6, then K5 and K3c must launch;
    the group's size, backend and all-reduce count are printed. (b) Two
    processes share the one card over gloo (NCCL refuses two ranks on one
    device): the channel split M = 2 (K2 and K4 at 8 channels) and the ray
    split D = 2. Each run's first-step gradient, after the reductions, is
    held to one process's on the same draws, per group: 1e-4 relative L2
    with float32 planes and MLPs, 1e-3 with bench's bf16 ones (printed
    beside one process's own floor, a batch against the same batch
    reversed); its 50-step loss trajectory's tail (steps 10-49) to one
    process's (1e-3 relative, the JAX dry run's bound); ms/step beside one process's
    (not a scaling figure: the processes share the card); one captured M = 2
    step's K2 forward and backward and K4 forward and adjoint rows at 8
    channels; ``evaluate`` on the two ranks against one process's table
    (PSNR within 1e-4); the M = 2 checkpoint, written at full width by rank
    0, loaded into one process with the same params;
30. gan: ``init_gan_stack`` at ``GANConfig``'s defaults with seeded weights;
    ``gan_render`` at levels 0-2 from a 128^2 render of the cli phase's
    checkpoint (its RGB with seeded latent moments) to 512^2 (the ground
    truth a 512^2 render of the same view), timed; one generator and one
    discriminator step at that size; then gan_render and one G and one D
    step at level 2 on a 32^2 crop held to the CPU (float32, TF32 off, as
    the sr phase holds the x4 networks);
31. second-order: a create_graph=True first derivative through each kernel
    function (K2, K7, K10, K11, K4, K3, K3c) on the card, then a backward
    through it: through K11, K4, K3, K3c and the K2 backward taken in the
    planes alone it must raise torch's once_differentiable error, as the CPU
    tests' plain versions do; through the coordinate gradients of K2, K7
    and K10 it must launch K2x², K7x² and K10², and a backward through that
    second derivative must raise;
32. print the kernels line, then the device line last.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F

from trinerflet_tpu_torch import kernels
from trinerflet_tpu_torch.data.rays import (rays_for_pixels, rays_full_image, sample_ray_batch,
                                             sample_ray_batch_pregen)
from trinerflet_tpu_torch.data.synthetic import make_synthetic_scene, orbit_pose, synthetic_intrinsics
from trinerflet_tpu_torch.kernels import _build
from trinerflet_tpu_torch.models import gridencoder as GE
from trinerflet_tpu_torch.models import registry as REG
from trinerflet_tpu_torch.models.encodings import grid_config
from trinerflet_tpu_torch.models.nerf import NeRFConfig
from trinerflet_tpu_torch.models.triplane import TriplaneConfig
from trinerflet_tpu_torch.ops import grid_sample as GS
from trinerflet_tpu_torch.ops import raymarch as RM
from trinerflet_tpu_torch.ops import wavelets as W
from trinerflet_tpu_torch.render import renderer as R
from trinerflet_tpu_torch.render.renderer import RenderConfig, mark_untrained_grid
from trinerflet_tpu_torch.train import trainer as TR
from trinerflet_tpu_torch.train.trainer import TrainConfig, Trainer

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

VIEW_HW = 800
SEED = 0
DEVICE = "cuda"
SERVE_KERNELS = ("march", "grid_sample", "composite", "idwt")
TRAIN_KERNELS = ("march", "grid_sample", "grid_sample_bwd", "composite", "composite_bwd", "idwt",
                 "idwt_adjoint", "occupancy")
GLOBAL_KERNELS = ("march", "grid_sample", "grid_sample_bwd", "compact", "composite_compact",
                  "composite_compact_bwd", "idwt", "idwt_adjoint", "occupancy")
PROPOSAL_KERNELS = ("grid_encode", "grid_encode_bwd", "grid_sample", "grid_sample_bwd", "composite",
                    "composite_bwd", "idwt", "idwt_adjoint")
PROPOSAL_ABSENT = ("march", "march_flat", "compact", "occupancy")  # no occupancy grid on the path
HASHGRID_KERNELS = ("grid_encode", "grid_encode_bwd", "march", "composite", "composite_bwd",
                    "occupancy")
HASHGRID_ABSENT = ("grid_sample", "grid_sample_bwd", "idwt", "idwt_adjoint")  # no triplane
FLAT_KERNELS = ("march_flat", "grid_sample", "grid_sample_bwd", "idwt", "idwt_adjoint", "occupancy")
DENSE_KERNELS = ("grid_sample", "grid_sample_bwd", "composite", "composite_bwd", "idwt",
                 "idwt_adjoint")
DENSE_ABSENT = ("march", "march_flat", "compact", "occupancy")  # no occupancy grid on the path
VARIANTS_KERNELS = ("march", "grid_sample", "grid_sample_bwd_xyz", "idwt", "idwt_adjoint", "occupancy")
VARIANTS_ABSENT = ("march_flat", "grid_sample_bwd")  # every training sample is differentiated in its point
KPLANES_KERNELS = ("grid_sample", "grid_sample_bwd", "march", "occupancy")
KPLANES_ABSENT = ("grid_sample_bwd_xyz", "idwt", "idwt_adjoint", "march_flat")  # no wavelets, no learned transform
WARM_STEPS, WINDOW_STEPS, WINDOWS = 320, 50, 5  # bench.py's
PERRAY_WARM, PERRAY_WINDOWS = 64, 1            # the per-ray phase, cut
GLOBAL_WINDOWS = 2
FORCED_STEPS = 4                                # the flat phase's other layout
DENSE_WARM, DENSE_WINDOW = 16, 16              # the dense phase, cut
CHECK_RAYS = 4096
REF_ITERS = 5  # timed calls of a plain version or a library call (ref_ms)
# the 4,096-ray step check, kernels on the card vs plain versions on the CPU:
# both round to bf16 at the same points, but f32 sums run in other orders
# (cuBLAS vs CPU GEMMs, K2's float atomics, K4's tap order), so a bf16
# rounding may flip one ulp; near convergence the residual is small, so a
# flipped feature moves its coefficients' gradients by a visible fraction:
# loss within 1e-3 relative, each parameter group's gradient within 2e-2
# relative L2
CHECK_LOSS_TOL, CHECK_GRAD_TOL = 1e-3, 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call (warm L2). A device-side sleep longer
    than the call's whole host time is queued before the start event, so the
    host has issued the call before the device reaches it and the events
    bracket the call's kernels, not the host's work of issuing them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    cycles = int(2.0 * host_s * 2.0e9) + 100_000  # twice that, at a 2 GHz clock or less
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def ref_ms(fn) -> float:
    """``time_ms`` of a reference call (a kernel's plain version or the
    library call beside it): the median of REF_ITERS calls after one
    warm-up; a kernel's own time is the median of 20."""
    return time_ms(fn, iters=REF_ITERS, warmup=1)


def bound_ms(nbytes: float, flops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def k6_ops(cells: int, r: int, merge: bool) -> int:
    """The operations K6 needs: a compare a cell and the separable
    dilation's 3 x 2r ORs a cell (counted on bools: the kernel does them on
    bit-packed words, 32 at once); with ``merge`` also the decay's multiply,
    the max and the mean's add."""
    return cells * (1 + 6 * r + (3 if merge else 0))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


_FLOOR_MS = []


def launch_floor_ms() -> float:
    """The launch floor: ``time_ms`` of a one-element ``fill_``, the least a
    timed call of one launch takes on this card (measured once)."""
    if not _FLOOR_MS:
        z = torch.empty((1,), device=DEVICE)
        _FLOOR_MS.append(time_ms(lambda: z.fill_(1.0), iters=50))
    return _FLOOR_MS[0]


def with_floor(row):
    """A launch-bound row: its time beside the launch floor, in its note."""
    f = launch_floor_ms()
    row["note"] += f"; {row['ms']:.4f} ms is {row['ms'] / f:.2f}x the launch floor ({f:.4f} ms)"
    return row


def serve_setup():
    nerf_cfg = NeRFConfig(
        triplane=TriplaneConfig(channels=16, resolution=1024, wavelet_scale=16),
        bound=1.5, compute_dtype="bfloat16", plane_dtype="bfloat16")
    render_cfg = RenderConfig(bound=1.5, grid_size=128, density_thresh=10.0, max_steps=1024,
                              samples_per_ray_budget=20, dt_gamma=0.0)
    trainer = Trainer(nerf_cfg, render_cfg, TrainConfig(), device="cuda")
    gen = torch.Generator().manual_seed(SEED)
    params = trainer.init_params(gen)
    for v in params["encoder"]["wavelets"].values():
        v.copy_(0.01 * torch.randn(v.shape, generator=gen))
    intr = synthetic_intrinsics(VIEW_HW, VIEW_HW)
    poses = np.stack([orbit_pose(np.arccos(1 - 1.6 * (v + 0.5) / 8), (v * 2.399963) % (2 * np.pi), 2.0)
                      for v in range(8)])
    t0 = time.perf_counter()
    grid = mark_untrained_grid(poses, intr, render_cfg)
    occ = trainer.update_grid(params, trainer.init_occupancy(grid), generator=gen)
    torch.cuda.synchronize()
    log(f"# state: culling + one full density refresh {time.perf_counter() - t0:.2f} s; "
        f"occupied fraction {occ.occ.float().mean().item():.4f}, "
        f"mean density {occ.mean_density.item():.4f}, bbox {occ.bbox.tolist()}")
    return trainer, params, occ, poses, intr


def serve_phase(trainer, params, occ, poses, intr, card):
    kernels.reset_launches()
    views, ms = [], []
    for pose in poses[:2]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, dep = trainer.render_image(params, occ, pose, intr, VIEW_HW, VIEW_HW)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        views.append((img, dep))
    launches = dict(kernels.launches)
    log(f"# serve launches over two views: {launches}")
    for name in SERVE_KERNELS:
        if launches[name] == 0:
            raise RuntimeError(f"kernel {name} was not launched on the serve path")
    for img, dep in views:
        if img.shape != (VIEW_HW, VIEW_HW, 3) or dep.shape != (VIEW_HW, VIEW_HW):
            raise RuntimeError(f"bad render shapes {tuple(img.shape)} {tuple(dep.shape)}")
        if not (torch.isfinite(img).all() and torch.isfinite(dep).all()):
            raise RuntimeError("non-finite render")
        # image = sum(w rgb) + (1 - sum w) * bg with bg 0: in [0, 1]
        if img.min() < 0 or img.max() > 1.0 + 1e-5 or dep.min() < 0 or dep.max() <= 0:
            raise RuntimeError(f"render out of range: image [{img.min()}, {img.max()}], "
                               f"depth [{dep.min()}, {dep.max()}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.render_image(params, occ, poses[1], intr, VIEW_HW, VIEW_HW)
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) * 1e3
    log(f"# serve ms/view ({card}): first {ms[0]:.2f}, second {ms[1]:.2f}, "
        f"repeat of the second {steady:.2f}; image mean {views[0][0].mean().item():.4f} "
        f"std {views[0][0].std().item():.4f}")
    return launches, views, ms, steady


def profile_view(trainer, params, occ, poses, intr) -> None:
    """Where one view's time goes: device time by kernel over one render
    under torch.profiler, and the device's idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.render_image(params, occ, poses[1], intr, VIEW_HW, VIEW_HW)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    log(f"# profile of one view: {wall:.2f} ms wall under the profiler, device busy "
        f"{busy:.2f} ms, idle share {1.0 - busy / wall:.3f}, {sum(e.count for e in evs)} kernels")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:14]:
        log(f"#   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:100]}")


def plain_chunk_check(trainer, params, occ, poses, intr, views):
    """One eval chunk of view 0 through the plain versions on the CPU (planes,
    march, sampler, compositor) against the kernel render of the same rays."""
    N = trainer.eval_chunk
    ro, rd = rays_full_image(poses[0], intr, VIEW_HW, VIEW_HW)
    s = VIEW_HW * VIEW_HW // 2 - N // 2  # the middle rows: rays through the content
    ro, rd = torch.from_numpy(ro[s : s + N]), torch.from_numpy(rd[s : s + N])
    cpu = Trainer(trainer.nerf_cfg, trainer.render_cfg, trainer.cfg, device="cpu")
    p_cpu = _to_cpu(params)
    o_cpu = type(occ)(*[x.cpu() for x in occ])
    t0 = time.perf_counter()
    planes = cpu.field.build_planes(p_cpu)
    out = cpu._render_chunk_impl(p_cpu, planes, o_cpu, ro, rd, 0.0)
    secs = time.perf_counter() - t0
    ref = views[0][0].reshape(-1, 3)[s : s + N].cpu()
    err = (out["image"] - ref).abs()
    log(f"# plain-version chunk of {N} rays on the CPU ({secs:.1f} s): image max|diff| "
        f"{err.max().item():.3e}, mean {err.mean().item():.3e}")
    # bf16 field: the kernel IDWT sums its taps in another order than the
    # plain version, so a plane value may round one bf16 ulp apart, and a
    # bf16 MLP layer can round one sample differently (~2^-8 relative)
    if err.max().item() > 2e-2 or err.mean().item() > 1e-3:
        raise RuntimeError("kernel render disagrees with the plain versions")
    return err.max().item()


def k1_need(ro, rd, nears, fars, noise, occ_coarse, mkw):
    """What K1's inputs need in this run: the distinct cells of each grid
    that its probes read, and the number of probes. The probes are the plain
    version's: coarse midpoints (with a coarse stride cs, one group centre
    per cs segments) short of far, then the kept segments' fine candidates
    (with a fine stride s, one probe per s) short of far."""
    addr = dict(grid_size=mkw["grid_size"], cascades=mkw["cascades"], bound=mkw["bound"])
    fs, cs = mkw.get("occ_test_stride", 1), mkw.get("coarse_test_stride", 1)
    NC, Fc, dev = mkw["num_coarse"], mkw["fine_per_coarse"], ro.device
    dt_py = 2.0 * RM.SQRT3 / mkw["max_steps"]
    seg_py = dt_py * Fc
    dt, half = float(np.float32(dt_py)), float(np.float32(0.5 * seg_py))
    t0 = RM._fma(dt, noise, nears)

    def cells(t):  # (N, K) ray parameters -> (N, K) flat cell indices
        p = RM._fma(rd[:, None, :], t[..., None], ro[:, None, :]).clamp(-addr["bound"], addr["bound"])
        return RM.occupancy_index(p, torch.full_like(t, dt), **addr)

    kc = torch.arange(NC, dtype=torch.float32, device=dev)
    t_mid = RM._fma(seg_py, kc[None, :], t0[:, None]) + half
    keep_c = (t_mid - half) < fars[:, None]
    kp = torch.arange(-(-NC // cs), dtype=torch.float32, device=dev)
    t_pc = t_mid if cs == 1 else RM._fma(seg_py, cs * kp[None, :] + 0.5 * cs, t0[:, None])
    keep_pc = keep_c[:, ::cs]  # a group is probed when its first segment is short of far
    idx_c = cells(t_pc)
    occ_c = occ_coarse.reshape(-1)[idx_c].repeat_interleave(cs, dim=1)[:, :NC]
    seg_idx, seg_mask, _ = RM.first_k_valid(occ_c & keep_c, mkw["coarse_budget"], spread=True)
    t_seg0 = RM._fma(seg_py, seg_idx.float(), t0[:, None])[..., None]
    kf = torch.arange(Fc, dtype=torch.float32, device=dev)
    t_f = RM._fma(dt, kf[None, None, :], t_seg0)
    kq = torch.arange(-(-Fc // fs), dtype=torch.float32, device=dev)
    t_pf = t_f if fs == 1 else RM._fma(dt, fs * kq[None, None, :] + 0.5 * (fs - 1), t_seg0)
    keep_pf = (seg_mask[..., None] & (t_f < fars[:, None, None]))[..., ::fs].reshape(len(ro), -1)
    idx_f = cells(t_pf.reshape(len(ro), -1))
    return (torch.unique(idx_c[keep_pc]).numel(), torch.unique(idx_f[keep_pf]).numel(),
            int(keep_pc.sum() + keep_pf.sum()))


def k1f_need(args, kw):
    """What K1f's inputs need in this run: the distinct grid cells its
    probes read (the candidates short of far, up to each ray's max_steps-th
    valid one: the plain version's candidates) and the number of probes."""
    ro, rd, nears, fars, occ, noise = args
    cand = RM.march_candidates_plain(ro, rd, nears, fars, occ, noise, **kw)
    v = cand.valid.int()
    probed = (cand.ts < fars[:, None]) & (torch.cumsum(v, 1) - v < kw["max_steps"])
    p = RM._fma(rd[:, None, :], cand.ts[..., None], ro[:, None, :]).clamp(-kw["bound"], kw["bound"])
    idx = RM.occupancy_index(p, cand.dts, grid_size=kw["grid_size"], cascades=kw["cascades"],
                             bound=kw["bound"])
    return torch.unique(idx[probed]).numel(), int(probed.sum())


def k1f_uniform_check(ro, rd, nears, fars, occ, rcfg):
    """K1f at dt_gamma 0 on the serve state (bound 1.5, 1,536 candidates per
    ray) in both modes, held to the plain version bit for bit (a check, not
    a path: its launches are not counted in any row)."""
    kw = dict(num_steps=dataclasses.replace(rcfg, dt_gamma=0.0).num_candidates,
              max_steps=rcfg.max_steps, grid_size=rcfg.grid_size, cascades=rcfg.cascades,
              bound=rcfg.bound, dt_gamma=0.0)
    noise = torch.rand(nears.shape, generator=torch.Generator(device=nears.device).manual_seed(SEED),
                       device=nears.device)
    args = (ro, rd, nears, fars, occ, noise)
    B = rcfg.samples_per_ray_budget
    got, got_c = RM.march_flat(*args, budget=B, **kw), RM.march_flat_candidates(*args, **kw)
    ref, ref_c = RM.march_flat_plain(*args, budget=B, **kw), RM.march_candidates_plain(*args, **kw)
    torch.cuda.synchronize()
    for nm, a, b in zip(("t", "dt", "mask", "stride", "t0", "ts", "dts", "valid"),
                        list(got) + list(got_c), list(ref) + list(ref_c)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise RuntimeError(f"K1f (dt_gamma 0) {nm} differs from the plain version "
                               f"({int((a != b).sum())} entries)")
    ms = time_ms(lambda: RM.march_flat(*args, budget=B, **kw))
    ms_c = time_ms(lambda: RM.march_flat_candidates(*args, **kw))
    log(f"# K1f at dt_gamma 0 (serve state, N={ro.shape[0]} rays x Kc={kw['num_steps']}): per-ray "
        f"and candidate modes equal to the plain version bit for bit; {ms:.4f} ms per-ray, "
        f"{ms_c:.4f} ms candidates; {int(ref_c.valid.sum())} valid candidates, mean kept "
        f"samples/ray {ref[2].float().sum(1).mean().item():.3f}")


def k1f_rank_past_count_check(calls, B=13):
    """K1f's per-ray mode at budget B = 13 on a captured step's rays, held to
    the plain version bit for bit, where ceil(b * count * (1/B)) in float32
    runs past some rays' counts (14, 15, 26-31, ...): those rays' last slot
    takes the last candidate, mask 1 (a check, not a path: its launches are
    not counted in any row)."""
    (args, kw), = calls["_march_flat_cuda"][:1]
    mkw = {k: v for k, v in kw.items() if k != "budget"}
    got = RM.march_flat(*args, budget=B, **mkw)
    ref = RM.march_flat_plain(*args, budget=B, **mkw)
    torch.cuda.synchronize()
    for a, b, nm in zip(got, ref, ("t", "dt", "mask", "stride", "t0")):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise RuntimeError(f"K1f (B={B}) {nm} differs from the plain version "
                               f"({int((a != b).sum())} entries)")
    count = RM.march_candidates_plain(*args, **mkw).valid.sum(1)
    b1 = torch.arange(1, B + 1, device=count.device, dtype=torch.float32)
    past = (count > B) & (torch.ceil(b1[None, :] * count[:, None].float() * RM._inv(B))
                          > count[:, None]).any(1)
    if not past.any():
        raise RuntimeError(f"K1f (B={B}): no ray's spread rank runs past its count")
    log(f"# K1f per-ray at B={B} on the captured step's {count.numel()} rays: equal to the plain "
        f"version bit for bit; {int(past.sum())} rays' spread rank past their count")


def _to_cpu(tree):
    return {k: _to_cpu(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.cpu()


def kernel_phase(trainer, params, occ, poses, intr):
    """Each kernel on the serve path's inputs vs its plain version."""
    rows = []
    rcfg = trainer.eval_render_cfg
    N = trainer.eval_chunk
    ro, rd = rays_full_image(poses[0], intr, VIEW_HW, VIEW_HW)
    s = VIEW_HW * VIEW_HW // 2 - N // 2
    ro = torch.from_numpy(ro[s : s + N]).cuda()
    rd = torch.from_numpy(rd[s : s + N]).cuda()

    # ---- K1: march
    nears, fars = RM.near_far_from_aabb(ro, rd, occ.bbox, rcfg.min_near)
    hit = nears < 1e30
    nears_c, fars_c = torch.where(hit, nears, 0.0), torch.where(hit, fars, 0.0)
    noise = torch.zeros((N,), device="cuda")
    num_coarse = int(np.ceil(rcfg.bound * rcfg.max_steps / rcfg.fine_per_coarse))
    mkw = dict(num_coarse=num_coarse, fine_per_coarse=rcfg.fine_per_coarse,
               coarse_budget=rcfg.coarse_budget, budget=rcfg.samples_per_ray_budget,
               max_steps=rcfg.max_steps, grid_size=rcfg.grid_size, cascades=rcfg.cascades,
               bound=rcfg.bound)
    margs = (ro, rd, nears_c, fars_c, occ.occ, occ.occ_coarse, noise)
    got = RM.march_hierarchical(*margs, **mkw)
    ref = RM.march_hierarchical_plain(*margs, **mkw)
    torch.cuda.synchronize()
    for a, b, nm in zip(got, ref, ("t", "dt", "mask", "stride", "seg_lastocc")):
        if not torch.equal(a, b):
            raise RuntimeError(f"K1 {nm} differs from the plain version "
                               f"({int((a != b).sum())} entries)")
    t, dt_s, mask, stride, _ = got
    # inputs need: the rays, one byte per distinct grid cell the probes read;
    # 20 f32 flops per probe (its t, the point's 3 fma, per axis a divide,
    # an add and two multiplies); outputs written once
    cells_c, cells_f, probes = k1_need(ro, rd, nears_c, fars_c, noise, occ.occ_coarse, mkw)
    k1_bytes = nbytes(ro, rd, nears_c, fars_c, noise) + cells_c + cells_f + nbytes(*got)
    b, by = bound_ms(k1_bytes, 20.0 * probes)
    rows.append(dict(name="K1 march_hierarchical", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/march.cu",
                     replaces="trinerflet_tpu/ops/raymarch.py:604",
                     max_abs_err=0.0, tol="mask, t, stride, seg_lastocc equal",
                     ms=time_ms(lambda: RM.march_hierarchical(*margs, **mkw)),
                     plain_ms=ref_ms(lambda: RM.march_hierarchical_plain(*margs, **mkw)),
                     bound_ms=b, bound_by=by, library_ms=None,
                     note=f"N={N} rays, mean kept samples/ray {mask.float().sum(1).mean().item():.2f}; "
                          f"{probes} probes read {cells_c} coarse and {cells_f} fine grid cells "
                          f"of {occ.occ.numel()} each"))

    k1f_uniform_check(ro, rd, nears_c, fars_c, occ.occ, rcfg)

    # ---- K2: sampler, on the march's sample points
    planes = trainer.field.build_planes(params)["full"]
    B = rcfg.samples_per_ray_budget
    xyz = (ro[:, None, :] + rd[:, None, :] * t[..., None]).clamp(-rcfg.bound, rcfg.bound).reshape(-1, 3)
    lb = trainer.nerf_cfg.bound
    got = GS.sample_points(planes, xyz, lb)
    ref = GS.sample_points_plain(planes, xyz, lb)
    err2 = (got - ref).abs().max().item()
    if err2 > 1e-4:
        raise RuntimeError(f"K2 max|err| {err2} > 1e-4")
    _, H, Wd, C = planes.shape
    # texels the bilinear reads touch (what this run's data needs)
    c2 = GS.project_to_planes(xyz, lb)
    touched = _touched_texels(c2, H, Wd)
    k2_bytes = touched * C * planes.element_size() + nbytes(xyz, got)
    b, by = bound_ms(k2_bytes, xyz.shape[0] * 3 * C * 8)
    # F.grid_sample on the planes as K2 reads them (bf16; it takes a grid of
    # the input's dtype), and on f32 copies for reference
    gs = dict(mode="bilinear", padding_mode="border", align_corners=True)
    planes_nchw = planes.permute(0, 3, 1, 2).contiguous()
    grid = c2[:, :, None, :].to(planes.dtype).contiguous()
    planes_f32, grid_f32 = planes_nchw.float(), c2[:, :, None, :].contiguous()
    lib_err = (F.grid_sample(planes_f32, grid_f32, **gs)[..., 0].permute(2, 0, 1) - got).abs().max().item()
    lib_f32_ms = ref_ms(lambda: F.grid_sample(planes_f32, grid_f32, **gs))
    rows.append(dict(name="K2 sample_planes", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/grid_sample.cu",
                     replaces="trinerflet_tpu/ops/grid_sample.py:131",
                     max_abs_err=err2, tol=1e-4,
                     ms=time_ms(lambda: GS.sample_points(planes, xyz, lb)),
                     plain_ms=ref_ms(lambda: GS.sample_points_plain(planes, xyz, lb)),
                     bound_ms=b, bound_by=by,
                     library_ms=ref_ms(lambda: F.grid_sample(planes_nchw, grid, **gs)),
                     note=f"M={xyz.shape[0]} points, {touched} touched texels; library_ms is "
                          f"F.grid_sample on the {planes.dtype} planes; on f32 copies it takes "
                          f"{lib_f32_ms:.4f} ms and differs from the kernel by {lib_err:.2e}"))

    # ---- K3: compositor, on the field's outputs at those points
    dirs = rd[:, None, :].expand(N, B, 3).reshape(-1, 3)
    sig, rgb = trainer.field(params, {"full": planes}, xyz, dirs)
    sig = (rcfg.density_scale * sig).reshape(N, B)
    rgb = rgb.reshape(N, B, 3)
    dt = torch.where(mask, dt_s * stride[:, None], 0.0)
    t0 = nears_c + dt_s * noise
    ts_rel = torch.where(mask, t + dt - t0[:, None], 0.0)
    cargs = (sig, rgb, dt, ts_rel, mask)
    got = RM.composite_dense(*cargs, t_thresh=rcfg.t_thresh)
    ref = RM.composite_dense_plain(*cargs, t_thresh=rcfg.t_thresh)
    err3 = max((a - b_).abs().max().item() for a, b_ in zip(got, ref))
    if err3 > 1e-5:
        raise RuntimeError(f"K3 max|err| {err3} > 1e-5")
    _same_bits("K3", got, RM.composite_dense(*cargs, t_thresh=rcfg.t_thresh))
    b, by = bound_ms(nbytes(*cargs) + nbytes(*got), sig.numel() * 12)
    rows.append(with_floor(dict(name="K3 composite_dense", route="cuda",
                                source="trinerflet_tpu_torch/kernels/csrc/composite.cu",
                                replaces="trinerflet_tpu/ops/raymarch.py:805",
                                max_abs_err=err3, tol=1e-5,
                                ms=time_ms(lambda: RM.composite_dense(*cargs, t_thresh=rcfg.t_thresh)),
                                plain_ms=ref_ms(lambda: RM.composite_dense_plain(*cargs, t_thresh=rcfg.t_thresh)),
                                bound_ms=b, bound_by=by, library_ms=None, note=f"N={N} rays x {B} samples")))

    # ---- K4: the four IDWT levels of the plane build
    tcfg = trainer.nerf_cfg.triplane
    pad = W.idwt_pad(tcfg.wavelet_type)
    x = params["encoder"]["base"].to(torch.bfloat16)
    levels = []
    for i in range(tcfg.levels):
        yh = params["encoder"]["wavelets"][f"level_{i}"].to(torch.bfloat16)
        yl, yh = F.pad(2.0 * x, (pad,) * 4), F.pad(yh, (pad,) * 4)
        x, lvl = _k4_level(yl, yh, tcfg.wavelet_type)
        levels.append(lvl)
    rows.append(_k4_row(levels, "K4 idwt2d", f"sum over the {len(levels)} levels "))
    return rows


def _k4_level(yl, yh, name):
    """K4 forward on one level's (yl, yh), held to its plain version (2^-6 of
    the level's largest value) and timed beside its bound and one grouped
    transposed convolution that computes the same level."""
    got = W.idwt2d(yl, yh, name)
    ref = W.idwt2d_plain(yl, yh, name)
    e = (got.float() - ref.float()).abs().max().item()
    tol4 = 2.0**-6 * ref.float().abs().max().item()
    if e > tol4:
        raise RuntimeError(f"K4 {tuple(yl.shape)}: max|err| {e} > {tol4}")
    g0, g1 = W.synthesis_taps(name, yl.dtype)
    L = len(g0)
    pl, _ = W.synthesis_pads(name)
    P, n = yl.shape[0] * yl.shape[1], yl.shape[-1]
    Ho = got.shape[-1]
    bm, by = bound_ms(nbytes(yl, yh, got),
                      P * n * Ho * 4 * (L // 2) * 2 + P * Ho * Ho * 2 * (L // 2) * 2)
    w2 = torch.stack([torch.outer(torch.tensor(a), torch.tensor(c)) for a, c in
                      ((g0, g0), (g0, g1), (g1, g0), (g1, g1))])  # yl, lh, hl, hh
    wt = w2.repeat(P, 1, 1).reshape(4 * P, 1, L, L).to(yl.device, yl.dtype)
    inp = torch.stack([yl.reshape(P, n, n), yh[:, :, 1].reshape(P, n, n),
                       yh[:, :, 0].reshape(P, n, n), yh[:, :, 2].reshape(P, n, n)], 1)
    inp = inp.reshape(1, 4 * P, n, n).contiguous()
    st = L - 1 - pl
    lib = F.conv_transpose2d(inp, wt, stride=2, groups=P)[0, :, st : st + Ho, st : st + Ho]
    lib_err = (lib.float() - got.reshape(P, Ho, Ho).float()).abs().max().item()
    return got, dict(err=e, ms=time_ms(lambda: W.idwt2d(yl, yh, name)),
                     plain_ms=ref_ms(lambda: W.idwt2d_plain(yl, yh, name)),
                     library_ms=ref_ms(lambda: F.conv_transpose2d(inp, wt, stride=2, groups=P)),
                     bound_ms=bm, bound_by=by,
                     size=f"{n}->{Ho} (conv_transpose2d max|diff| {lib_err:.2e})")


def _k4_row(levels, name, note):
    """One K4 forward row summing the levels' times."""
    return dict(name=name, key="idwt", route="cuda", source="trinerflet_tpu_torch/kernels/csrc/idwt.cu",
                replaces="trinerflet_tpu/ops/wavelets.py:510",
                max_abs_err=max(lv["err"] for lv in levels), tol="2^-6 x max|level|",
                ms=sum(lv["ms"] for lv in levels), plain_ms=sum(lv["plain_ms"] for lv in levels),
                bound_ms=sum(lv["bound_ms"] for lv in levels),
                bound_by=max((lv["bound_ms"], lv["bound_by"]) for lv in levels)[1],
                library_ms=sum(lv["library_ms"] for lv in levels),
                note=note + ", ".join(lv["size"] for lv in levels))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def bench_configs(num_rays: int = 32768, budget_autotune: bool = True):
    """``bench.py``'s training configuration (its tuner on by default)."""
    nerf_cfg = NeRFConfig(
        triplane=TriplaneConfig(channels=16, resolution=1024, wavelet_scale=16),
        bound=1.5, compute_dtype="bfloat16", plane_dtype="bfloat16")
    render_cfg = RenderConfig(bound=1.5, grid_size=128, density_thresh=10.0, max_steps=1024,
                              samples_per_ray_budget=20, dt_gamma=0.0)
    train_cfg = TrainConfig(lr=1e-2, iters=10000, num_rays=num_rays, wavelet_regularization=0.4,
                            renderer="occgrid", update_extra_interval=16,
                            budget_autotune=budget_autotune)
    return nerf_cfg, render_cfg, train_cfg


def train_setup(budget_autotune: bool, scene=None):
    trainer = Trainer(*bench_configs(budget_autotune=budget_autotune), device=DEVICE)
    t0 = time.perf_counter()
    if scene is None:
        scene = make_synthetic_scene(num_views=8, H=256, W=256, num_steps=128)
    t1 = time.perf_counter()
    grid = mark_untrained_grid(scene.poses, scene.intrinsics, trainer.render_cfg)
    state = trainer.init_state(density_grid=grid)
    data = trainer.scene_to_device(scene)
    torch.cuda.synchronize()
    log(f"# train set-up: synthetic scene (8 views of 256^2, numpy) {t1 - t0:.2f} s, culling + "
        f"init_state + upload {time.perf_counter() - t1:.2f} s; occ_test_stride "
        f"{trainer.render_cfg.resolved_occ_test_stride()}, coarse_test_stride "
        f"{trainer.render_cfg.resolved_coarse_test_stride()}, dilation radius "
        f"{trainer.render_cfg.coarse_dilation_radius}")
    return trainer, state, data, scene


def _refresh(trainer, state, full):
    return state._replace(occ=trainer.update_grid(state.params, state.occ, generator=state.rng,
                                                  full=full))


def train_phase(trainer, state, data, card, warm=WARM_STEPS, n_windows=WINDOWS,
                required=TRAIN_KERNELS, what="train", absent=(), window_steps=WINDOW_STEPS,
                step=None, refresh=True):
    """bench.py's cadence: warm-up (refreshes and the retune on the last
    step's aux, on the occgrid renderer with ``refresh``), then timed windows
    (median); counters zeroed just before and read just after. Every
    ``required`` kernel must have launched and no ``absent`` one; the loss
    (and on the proposal renderer the interlevel loss) must fall over the
    warm-up: the mean of its last refresh interval (or half, when shorter)
    below that of its first. ``step(state, with_stats) -> (state, aux)``
    (default the trainer's step on ``data``) is one step; its aux holds the
    loss and, on the occgrid renderer, the kept samples."""
    interval = trainer.cfg.update_extra_interval
    span = min(interval, warm // 2)
    N = trainer.cfg.num_rays
    occgrid = trainer.cfg.renderer == "occgrid"
    refresh = refresh and occgrid
    if step is None:
        def step(state, with_stats):
            return trainer.train_step(state, data, with_stats=with_stats)
    kernels.reset_launches()
    losses, inter, aux, trail = [], [], None, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warm):
        if refresh and i % interval == 0:
            state = _refresh(trainer, state, full=int(state.occ.iter_density) < 16)
            trainer._maybe_retune_march(state, aux)
            if aux is not None and trainer.cfg.budget_autotune:  # what the retune read (it synced)
                rc = trainer.render_cfg
                trail.append((i, round(float(aux["num_samples"]) / N, 2), rc.samples_per_ray_budget,
                              rc.num_coarse_override, rc.compaction, rc.global_slots_per_ray))
        state, aux = step(state, (i + 1) % interval == 0)
        losses.append(aux["loss"])
        if "interlevel" in aux:
            inter.append(aux["interlevel"])
    losses = torch.stack(losses).cpu()
    warm_s = time.perf_counter() - t0
    if trail:
        log(f"# {what} retunes (step, kept samples/ray read, then B, num_coarse, layout, slots): "
            f"{trail}")
    windows = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for i in range(window_steps):
            if refresh and i % interval == 0:
                state = _refresh(trainer, state, full=False)
            state, aux = step(state, (i + 1) % interval == 0)
        final_loss = float(aux["loss"])  # host copy: waits for the window's last step
        windows.append((time.perf_counter() - t0) / window_steps * 1e3)
    launches = dict(kernels.launches)
    steps = warm + n_windows * window_steps
    ms = float(np.median(windows))
    first, last = losses[:span].mean().item(), losses[-span:].mean().item()
    if occgrid:
        samples = float(aux["num_samples"]) / N
    elif trainer.prop_cfg is not None:
        samples = float(trainer.prop_cfg.num_final_samples)
    else:
        samples = float(trainer.render_cfg.num_steps + trainer.render_cfg.upsample_steps)
    rc = trainer.render_cfg
    log(f"# {what} ({card}): {warm} warm-up steps in {warm_s:.2f} s; windows of "
        f"{window_steps} steps {[round(w, 3) for w in windows]} ms/step; median {ms:.3f} ms/step "
        f"= {N / ms * 1e3:.1f} rays/s; num_coarse {trainer.render_cfg.num_coarse_override}; "
        f"mean kept samples/ray {samples:.3f} (last step); loss first step "
        f"{losses[0].item():.5f}, last warm-up step {losses[-1].item():.5f}, mean of the first "
        f"{span} {first:.5f}, of the last {span} {last:.5f}, after the windows "
        f"{final_loss:.5f}; occupied fraction {state.occ.occ.float().mean().item():.4f}, "
        f"bbox {[round(x, 4) for x in state.occ.bbox.tolist()]}")
    if inter:
        inter = torch.stack(inter).cpu()
        i_first, i_last = inter[:span].mean().item(), inter[-span:].mean().item()
        log(f"# {what} interlevel loss: mean of the first {span} steps {i_first:.6f}, of the "
            f"last {span} {i_last:.6f}; after the windows {float(aux['interlevel']):.6f}")
        if not (np.isfinite(inter.numpy()).all() and i_last < i_first):
            raise RuntimeError(f"the interlevel loss did not fall: {i_first} -> {i_last}")
    if occgrid:  # bench.py's summary fields
        log(f"# {what} summary: budget {rc.samples_per_ray_budget}/{trainer._budget_max}; layout "
            f"{rc.compaction}(x{rc.global_slots_per_ray}); num_coarse {rc.num_coarse_override}; "
            f"occ_stride {rc.resolved_occ_test_stride()}; samples/step {float(aux['num_samples']):,.0f} "
            f"({samples:.1f}/ray); loss {losses[-1].item():.5f}->{final_loss:.5f}; "
            f"retunes march {trainer._march_retunes}, budget {trainer._budget_retunes}, "
            f"global {trainer._global_retunes}")
    log(f"# {what} launches over {steps} steps: {launches} (per step: "
        f"{ {k: round(v / steps, 3) for k, v in launches.items()} })")
    for name in required:
        if launches[name] == 0:
            raise RuntimeError(f"kernel {name} was not launched on the {what} path")
    for name in absent:
        if launches[name] != 0:
            raise RuntimeError(f"kernel {name} launched on the {what} path, which has none")
    if not (np.isfinite(losses.numpy()).all() and np.isfinite(final_loss)):
        raise RuntimeError("non-finite training loss")
    if not last < first:
        raise RuntimeError(f"the loss did not fall over the warm-up: {first} -> {last}")
    stats = dict(ms_per_step=ms, windows=windows, rays_per_s=N / ms * 1e3, samples_per_ray=samples,
                 loss_first=first, loss_last=last, steps=steps, aux=aux)
    return state, launches, stats


PROFILED = {}  # what -> (wall ms, device busy ms) of the last profiled step


def profile_step(trainer, state, data, what="train", step=None):
    """Device time by kernel over one train step (``step(state)``, default
    the trainer's), and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state) if step else trainer.train_step(state, data, with_stats=False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    PROFILED[what] = (wall, busy)
    log(f"# profile of one {what} step: {wall:.2f} ms wall under the profiler, device busy "
        f"{busy:.2f} ms, idle share {1.0 - busy / wall:.3f}, {sum(e.count for e in evs)} kernels")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:16]:
        log(f"#   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:100]}")
    return state


class Capture:
    """Records the arguments the main path hands each kernel wrapper (the
    wrappers are looked up by module globals at call time)."""

    TARGETS = ((RM, "_march_cuda"), (RM, "_march_flat_cuda"), (GS, "_sample_points_cuda"),
               (GS, "_sample_points_backward_cuda"), (GS, "_sample_points_backward_xyz_cuda"),
               (RM, "_composite_cuda"),
               (RM, "_composite_backward_cuda"), (W, "_idwt2d_cuda"), (W, "_idwt2d_adjoint_cuda"),
               (R, "_occupancy_upkeep_cuda"), (RM, "_compact_cuda"),
               (RM, "_composite_compact_cuda"), (RM, "_composite_compact_backward_cuda"),
               (GE, "_grid_encode_cuda"), (GE, "_grid_encode_backward_cuda"),
               (GE, "_grid_encode_backward_x_cuda"), (REG, "_sample_volume_grid_cuda"),
               (REG, "_sample_volume_grid_backward_cuda"), (REG, "_background_textured_cuda"),
               (REG, "_background_textured_backward_cuda"), (GS, "_sample_points_backward_xyz_backward_cuda"),
               (GE, "_grid_encode_backward_x_backward_cuda"),
               (REG, "_sample_volume_grid_backward_x_backward_cuda"))

    def __init__(self):
        self.calls = defaultdict(list)
        self._orig = {}

    def __enter__(self):
        for mod, name in self.TARGETS:
            orig = getattr(mod, name)
            self._orig[(mod, name)] = orig

            def wrap(*a, _orig=orig, _name=name, **k):
                self.calls[_name].append((a, k))
                return _orig(*a, **k)

            setattr(mod, name, wrap)
        return self

    def __exit__(self, *exc):
        for (mod, name), orig in self._orig.items():
            setattr(mod, name, orig)


def _batch(trainer, n, V, HW, seed):
    """A step's draws: (view, pixel) indices and the ray noise, and on the
    proposal renderer the ladder jitter and the final-level uniforms, on the
    dense one the depth jitter and the upsampling uniforms."""
    g = torch.Generator().manual_seed(seed)
    batch = {"img_idx": torch.randint(0, V, (n,), generator=g),
             "pix_idx": torch.randint(0, HW, (n,), generator=g), "noise": torch.rand((n,), generator=g)}
    if trainer.prop_cfg is not None:
        P, F = trainer.prop_cfg.num_proposal_samples, trainer.prop_cfg.num_final_samples
        batch["prop_jitter"] = torch.rand((n, P + 1), generator=g)
        batch["prop_u"] = torch.rand((n, F), generator=g)
    if trainer.cfg.renderer == "dense":
        rc = trainer.render_cfg
        batch["dense_jitter"] = torch.rand((n, rc.num_steps), generator=g)
        batch["dense_u"] = torch.rand((n, rc.upsample_steps), generator=g)
    return batch


def capture_step(trainer, state, data):
    """One step (and on the occgrid renderer one partial refresh) with every
    kernel wrapper's arguments recorded."""
    V, H, Wd = data["images"].shape[:3]
    with Capture() as cap:
        state, _ = trainer.train_step(state, data, with_stats=False,
                                      batch=_batch(trainer, trainer.cfg.num_rays, V, H * Wd, SEED + 1))
        if trainer.cfg.renderer == "occgrid":
            state = _refresh(trainer, state, full=False)
    torch.cuda.synchronize()
    return state, cap.calls


def _rel(a, b):
    return (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)


def path_kernel_rows(trainer, calls, launches, what, only=None):
    """Each kernel that one step of a train path launched (``calls``, from
    ``capture_step`` right after the path ran), held to its plain version on
    the arguments the step handed it and timed (``only``: these wrappers'
    kernels alone); each row takes its launches from that path's run and is
    named for it."""
    makers = (("_march_cuda", _march_rows), ("_march_flat_cuda", _march_flat_rows),
              ("_sample_points_cuda", _sample_rows),
              ("_idwt2d_adjoint_cuda", _adjoint_rows), ("_occupancy_upkeep_cuda", _upkeep_rows),
              ("_composite_cuda", _dense_composite_rows), ("_compact_cuda", _compact_rows),
              ("_grid_encode_cuda", _grid_encode_rows))
    rows = []
    for target, make in makers:
        if calls[target] and (only is None or target in only):
            rows += make(trainer, calls)
    return label_rows(rows, launches, what)


def label_rows(rows, launches, what):
    """Each row takes its kernel's launches from the path's run (which must
    have launched it) and the path's name."""
    for r in rows:
        r["launches"] = launches[r.pop("key")]
        if r["launches"] == 0:
            raise RuntimeError(f"{r['name']} ran in the capture step but not on the {what} path")
        r["name"] += f" ({what})"
        r["path"] = what
    return rows


def _march_rows(trainer, calls):
    """K1 with the training stride."""
    rows = []
    (args, kw), = calls["_march_cuda"][:1]
    got, ref = RM._march_cuda(*args, **kw), RM.march_hierarchical_plain(*args, **kw)
    torch.cuda.synchronize()
    for a, b, nm in zip(got, ref, ("t", "dt", "mask", "stride", "seg_lastocc")):
        if not torch.equal(a, b):
            raise RuntimeError(f"K1 (train) {nm} differs from the plain version "
                               f"({int((a != b).sum())} entries)")
    ro, rd, nears, fars, occ, occ_c, noise = args
    cells_c, cells_f, probes = k1_need(ro, rd, nears, fars, noise, occ_c, kw)
    b, by = bound_ms(nbytes(ro, rd, nears, fars, noise) + cells_c + cells_f + nbytes(*got),
                     20.0 * probes)
    rows.append(dict(name="K1 march_hierarchical, strided", key="march", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/march.cu",
                     replaces="trinerflet_tpu/ops/raymarch.py:604", max_abs_err=0.0,
                     tol="mask, t, stride, seg_lastocc equal",
                     ms=time_ms(lambda: RM._march_cuda(*args, **kw)),
                     plain_ms=ref_ms(lambda: RM.march_hierarchical_plain(*args, **kw)),
                     bound_ms=b, bound_by=by, library_ms=None,
                     note=f"N={ro.shape[0]} rays, occ_test_stride {kw['occ_test_stride']}, "
                          f"num_coarse {kw['num_coarse']}, mean kept samples/ray "
                          f"{got[2].float().sum(1).mean().item():.3f}; {probes} probes read "
                          f"{cells_c} coarse and {cells_f} fine cells"))
    return rows


def _march_flat_rows(trainer, calls):
    """K1f in the mode the step ran (per-ray selection, or every candidate
    for the exact global compaction), bit for bit."""
    (args, kw), = calls["_march_flat_cuda"][:1]
    B = kw["budget"]
    mkw = {k: v for k, v in kw.items() if k != "budget"}
    got = RM._march_flat_cuda(*args, **kw)
    ref = (RM.march_flat_plain(*args, budget=B, **mkw) if B > 0
           else RM.march_candidates_plain(*args, **mkw))
    again = RM._march_flat_cuda(*args, **kw)
    torch.cuda.synchronize()
    names = ("t", "dt", "mask", "stride", "t0") if B > 0 else ("ts", "dts", "valid")
    for a, b, nm in zip(got, ref, names):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise RuntimeError(f"K1f {nm} differs from the plain version ({int((a != b).sum())} "
                               f"entries)")
    _same_bits("K1f", got, again)
    ro, rd, nears, fars, occ, noise = args
    cells, probes = k1f_need(args, mkw)
    # the rays in, one byte per distinct grid cell its probes read, the
    # outputs written once; per probe K1's 20 f32 operations plus ~10 for the
    # ladder (its exp, the step's clamp and frexp)
    b, by = bound_ms(nbytes(ro, rd, nears, fars, noise) + cells + nbytes(*got), 30.0 * probes)
    mode = f"per-ray, B={B}" if B > 0 else "candidates"
    plain = ((lambda: RM.march_flat_plain(*args, budget=B, **mkw)) if B > 0
             else (lambda: RM.march_candidates_plain(*args, **mkw)))
    kept = (f"mean kept samples/ray {got[2].float().sum(1).mean().item():.3f}" if B > 0
            else f"{int(got.valid.sum())} valid candidates")
    return [dict(name=f"K1f march_flat ({mode})", key="march_flat", route="cuda",
                 source="trinerflet_tpu_torch/kernels/csrc/march_flat.cu",
                 replaces="trinerflet_tpu/ops/raymarch.py:290", max_abs_err=0.0,
                 tol="every output equal, a second call too",
                 ms=time_ms(lambda: RM._march_flat_cuda(*args, **kw)),
                 plain_ms=ref_ms(plain), bound_ms=b, bound_by=by, library_ms=None,
                 note=f"N={ro.shape[0]} rays x Kc={kw['num_steps']} candidates, dt_gamma "
                      f"{kw['dt_gamma']}, {kw['cascades']} cascades; {kept}; {probes} probes read "
                      f"{cells} grid cells of {occ.numel()}; no library call computes it")]


def _sample_rows(trainer, calls):
    """K2 forward at the step's points and its backward on the step's cotangent."""
    (planes, xyz, lb), _ = calls["_sample_points_cuda"][0]
    return _sample_fwd_rows(planes, xyz, lb) + _sample_bwd_rows(calls)


def _sample_fwd_rows(planes, xyz, lb, label=""):
    """K2 forward on one call's arguments."""
    got, ref = GS._sample_points_cuda(planes, xyz, lb), GS.sample_points_plain(planes, xyz, lb)
    err = (got - ref).abs().max().item()
    if err > 1e-4:
        raise RuntimeError(f"K2 (train) max|err| {err} > 1e-4")
    _, H, Wd, C = planes.shape
    c2 = GS.project_to_planes(xyz, lb)
    gs = dict(mode="bilinear", padding_mode="border", align_corners=True)
    planes_nchw = planes.permute(0, 3, 1, 2).contiguous()
    grid = c2[:, :, None, :].to(planes.dtype).contiguous()
    touched = _touched_texels(c2, H, Wd)
    b, by = bound_ms(touched * C * planes.element_size() + nbytes(xyz, got), xyz.shape[0] * 3 * C * 8)
    return [dict(name="K2 sample_planes" + label, key="grid_sample", route="cuda",
                 source="trinerflet_tpu_torch/kernels/csrc/grid_sample.cu",
                 replaces="trinerflet_tpu/ops/grid_sample.py:131", max_abs_err=err, tol=1e-4,
                 ms=time_ms(lambda: GS._sample_points_cuda(planes, xyz, lb)),
                 plain_ms=ref_ms(lambda: GS.sample_points_plain(planes, xyz, lb)),
                 bound_ms=b, bound_by=by,
                 library_ms=ref_ms(lambda: F.grid_sample(planes_nchw, grid, **gs)),
                 note=f"M={xyz.shape[0]} points on {tuple(planes.shape)} {planes.dtype} planes, "
                      f"{touched} touched texels")]


def _sample_bwd_rows(calls, i=0, label=""):
    """K2 backward: the plane gradient of the step's ``i``-th backward call
    (its planes, for the library call, from the forward call of that shape)."""
    rows = []
    (g, xyz, lb, shape, dtype), _ = calls["_sample_points_backward_cuda"][i]
    planes = next(a[0] for a, _ in calls["_sample_points_cuda"] if tuple(a[0].shape) == tuple(shape))
    C = planes.shape[-1]
    c2 = GS.project_to_planes(xyz, lb)
    planes_nchw = planes.permute(0, 3, 1, 2).contiguous()
    grid = c2[:, :, None, :].to(planes.dtype).contiguous()
    got = GS._sample_points_backward_cuda(g, xyz, lb, shape, dtype)
    ref = GS.sample_points_backward_plain(g, xyz, lb, shape, dtype)
    err = _rel(got, ref)
    if err > 2.0**-7:  # sums in another order; one bf16 ulp of the largest texel
        raise RuntimeError(f"K2 backward rel err {err} > 2^-7")
    if not torch.equal(got, GS._sample_points_backward_cuda(g, xyz, lb, shape, dtype)):
        raise RuntimeError("K2 backward differs between two calls on the same inputs")
    live = int((g != 0).any(dim=-1).sum())  # (sample, plane) rows with a cotangent
    out_bytes = int(np.prod(shape)) * torch.tensor([], dtype=dtype).element_size()
    b, by = bound_ms(nbytes(g, xyz) + out_bytes, live * 4 * C * 2)
    go = g.permute(1, 2, 0)[..., None].to(dtype).contiguous()  # (3, C, M, 1)
    lib = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
        go, planes_nchw, grid, 0, 1, True, [True, False])
    lib_err = _rel(lib()[0].permute(0, 2, 3, 1), got)
    lib_f32 = torch.ops.aten.grid_sampler_2d_backward(  # f32 copies, unrounded coordinates
        go.float(), planes_nchw.float(), c2[:, :, None, :].contiguous(), 0, 1, True, [True, False])[0]
    lib_f32_err = _rel(lib_f32.permute(0, 2, 3, 1), got)
    rows.append(dict(name="K2 sample_planes backward" + label, key="grid_sample_bwd", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/grid_sample.cu",
                     replaces="trinerflet_tpu/ops/grid_sample.py:151", max_abs_err=(got.float() - ref.float()).abs().max().item(),
                     tol="2^-7 x max|grad|",
                     ms=time_ms(lambda: GS._sample_points_backward_cuda(g, xyz, lb, shape, dtype)),
                     plain_ms=ref_ms(lambda: GS.sample_points_backward_plain(g, xyz, lb, shape, dtype)),
                     bound_ms=b, bound_by=by, library_ms=ref_ms(lib),
                     note=f"{live} of {3 * xyz.shape[0]} (sample, plane) rows carry a cotangent; "
                          f"binned by tile, summed per tile in shared memory ({GS.K2_BWD_LAUNCHES} launches per "
                          f"call, the same bits on a second call); "
                          f"library is aten.grid_sampler_2d_backward on the {dtype} planes and "
                          f"coordinates (rel diff {lib_err:.2e}); on f32 copies {lib_f32_err:.2e}"))
    return rows


def _sample_xyz_rows(calls, label_of):
    """K2x on each of the step's calls (``label_of(planes)`` names the plane
    stack), as the call asked (with or without the plane gradient): dL/dxyz
    against the plain version on the CPU (which divides xyz / lbound truly,
    as the kernel and, since the division is by a tensor, the plain version
    on the card do), the plane gradient against the plain version on the
    card; timed beside the bound and one aten.grid_sampler_2d_backward
    with the same gradients over the three planes (channel-first)."""
    rows = []
    for (g, planes, xyz, lb), kw in calls["_sample_points_backward_xyz_cuda"]:
        pg, xg = GS._sample_points_backward_xyz_cuda(g, planes, xyz, lb, **kw)
        with_planes = pg is not None
        rxg = GS.sample_points_backward_xyz_plain(g.cpu(), planes.cpu(), xyz.cpu(), lb, planes_grad=False)[1]
        ep = _rel(pg, GS.sample_points_backward_plain(g, xyz, lb, tuple(planes.shape), planes.dtype)
                  ) if with_planes else 0.0
        ex = _rel(xg.cpu(), rxg)
        if ep > 2.0**-7 or ex > 1e-5 or with_planes != kw.get("planes_grad", True):
            raise RuntimeError(f"K2x rel err: planes {ep} > 2^-7 or points {ex} > 1e-5")
        # its plane gradient is the K2 backward's passes on the same rows
        if with_planes and not torch.equal(
                pg, GS._sample_points_backward_cuda(g, xyz, lb, tuple(planes.shape), planes.dtype)):
            raise RuntimeError(f"K2x plane gradient{label_of(planes)} differs from the K2 backward's")
        per_call = 1 + (GS.K2_BWD_LAUNCHES if with_planes else 0)
        _, H, Wd, C = planes.shape
        live = (g != 0).any(dim=-1).T  # (3, M): (plane, point) rows with a cotangent
        c2 = GS.project_to_planes(xyz, lb)
        touched = _touched_texels(c2, H, Wd, live)
        n_live = int(live.sum())
        # the cotangent and the points in, the live rows' corner texels read,
        # the plane gradient (when asked) and dL/dxyz written once; per live
        # row ~18 C + 20 f32 operations (weights, the two channel sums, the
        # plane gradient's products)
        b, by = bound_ms(nbytes(g, xyz, xg) + touched * C * planes.element_size()
                         + (nbytes(pg) if with_planes else 0), n_live * (18 * C + 20))
        planes_nchw = planes.permute(0, 3, 1, 2).contiguous()
        grid = c2[:, :, None, :].to(planes.dtype).contiguous()
        go = g.permute(1, 2, 0)[..., None].to(planes.dtype).contiguous()  # (3, C, M, 1)
        mask = [with_planes, True]
        lib = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
            go, planes_nchw, grid, 0, 1, True, mask)
        # the same call on f32 copies and unrounded coordinates, for its
        # agreement (bf16 coordinates move a point by up to 2 texels at 1024^2)
        d_planes, d_grid = torch.ops.aten.grid_sampler_2d_backward(
            go.float(), planes_nchw.float(), c2[:, :, None, :].contiguous(), 0, 1, True, mask)
        dg = d_grid[:, :, 0, :]  # (3, M, 2) in the planes' (u, v)
        lib_xyz = torch.stack([dg[0, :, 0] + dg[1, :, 0], dg[1, :, 1] + dg[2, :, 0],
                               dg[0, :, 1] + dg[2, :, 1]], -1) / lb
        lib_planes = f"{_rel(d_planes.permute(0, 2, 3, 1), pg):.2e} (planes), " if with_planes else ""
        rows.append(dict(
            name=f"K2x sample_planes coordinate gradient{label_of(planes)}", key="grid_sample_bwd_xyz",
            route="cuda", source="trinerflet_tpu_torch/kernels/csrc/grid_sample.cu",
            replaces="trinerflet_tpu/ops/grid_sample.py:23 (autodiff of grid_sample_2d in the "
                     "coordinates, via models/triplane.py:310-321)",
            max_abs_err=(xg.cpu() - rxg).abs().max().item(),
            tol="points 1e-5 x max|dL/dxyz|" + (", planes 2^-7 x max|grad|" if with_planes else ""),
            ms=time_ms(lambda: GS._sample_points_backward_xyz_cuda(g, planes, xyz, lb, **kw)),
            plain_ms=ref_ms(lambda: GS.sample_points_backward_xyz_plain(g, planes, xyz, lb, **kw)),
            bound_ms=b, bound_by=by, library_ms=ref_ms(lib),
            note=f"M={xyz.shape[0]} points on {tuple(planes.shape)} {planes.dtype} planes, "
                 f"{'with' if with_planes else 'without'} the plane gradient"
                 f"{' (bit for bit the K2 backward on the same rows)' if with_planes else ''}, "
                 f"{per_call} launches per call, {n_live} of "
                 f"{3 * xyz.shape[0]} (plane, point) rows carry a cotangent, {touched} touched "
                 f"texels; rel err planes {ep:.2e}, points {ex:.2e}; library is "
                 f"aten.grid_sampler_2d_backward(output_mask={mask}) on the {planes.dtype} "
                 f"planes and coordinates; on f32 copies it differs from the kernel by "
                 f"{lib_planes}{_rel(lib_xyz, xg):.2e} (points; torch's clamp gives the border 1, "
                 f"not JAX's 0.5)"))
    return rows


def _adjoint_rows(trainer, calls, sel=slice(None), label=""):
    """The K4 adjoint: every level of the step's ladder (``sel`` of its
    calls, in the order the backward ran them)."""
    tcfg = trainer.nerf_cfg.triplane
    pl, pr = W.synthesis_pads(tcfg.wavelet_type)
    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    err4, sizes, level_by = 0.0, [], []
    for (ga, _) in calls["_idwt2d_adjoint_cuda"][sel]:
        G, name = ga
        g0, g1 = W.synthesis_taps(tcfg.wavelet_type, G.dtype)  # the planes' dtype (bf16 or f32)
        L = len(g0)
        got, ref = W._idwt2d_adjoint_cuda(G, name), W.idwt2d_adjoint_plain(G, name)
        e = max(_rel(a, b_) for a, b_ in zip(got, ref))
        if e > 2.0**-6:
            raise RuntimeError(f"K4 adjoint {tuple(G.shape)}: rel err {e} > 2^-6")
        err4 = max(err4, max((a.float() - b_.float()).abs().max().item() for a, b_ in zip(got, ref)))
        Bp, Cc, Ho, Wo = G.shape
        P, n = Bp * Cc, got[0].shape[-1]
        bm, lvl_by = bound_ms(nbytes(G, *got), P * n * Ho * 4 * (L // 2) * 2 + P * Ho * Ho * 2 * (L // 2) * 2)
        level_by.append((bm, lvl_by))
        w2 = torch.stack([torch.outer(torch.tensor(a), torch.tensor(c)) for a, c in
                          ((g0, g0), (g0, g1), (g1, g0), (g1, g1))])  # yl, lh, hl, hh
        wt = w2.repeat(P, 1, 1).reshape(4 * P, 1, L, L).to(G.device, G.dtype)
        st = L - 1 - pl
        Gp = F.pad(G.reshape(1, P, Ho, Wo), (st, 2 * n + L - 2 - st - Wo, st, 2 * n + L - 2 - st - Ho))
        lib = lambda: F.conv2d(Gp, wt, stride=2, groups=P)  # noqa: E731
        lo = lib().reshape(P, 4, n, n)
        lib_err = _rel(lo[:, 0], got[0].reshape(P, n, n))
        tot["ms"] += time_ms(lambda: W._idwt2d_adjoint_cuda(G, name))
        tot["plain_ms"] += ref_ms(lambda: W.idwt2d_adjoint_plain(G, name))
        tot["library_ms"] += ref_ms(lib)
        tot["bound_ms"] += bm
        sizes.append(f"{Ho}->{n} (conv2d rel diff {lib_err:.2e})")
    rows.append(dict(name="K4 idwt2d adjoint" + label, key="idwt_adjoint", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/idwt.cu",
                     replaces="trinerflet_tpu/ops/wavelets.py:510", max_abs_err=err4,
                     tol="2^-6 x max|level grad|", ms=tot["ms"], plain_ms=tot["plain_ms"],
                     bound_ms=tot["bound_ms"], bound_by=max(level_by)[1],
                     library_ms=tot["library_ms"],
                     note=f"sum over the {len(sizes)} levels " + ", ".join(sizes)
                          + f"; library is a strided grouped F.conv2d ({G.dtype})"))
    return rows


def _upkeep_check(oargs, what):
    """K6 on one call's arguments: the merged grid, occupancy, dilation and
    bbox equal to the plain version's (thresholded at the kernel's own
    mean), the mean within 1e-5 relative, a second call the same bits.
    Returns the kernel's outputs and the mean's relative error."""
    grid_old, tmp, off, rcfg, decay = oargs
    got = R._occupancy_upkeep_cuda(*oargs)
    again = R._occupancy_upkeep_cuda(*oargs)
    ref = R.occupancy_upkeep_plain(*oargs)
    if not torch.equal(got[0], ref[0]):
        raise RuntimeError(f"K6 merged density grid differs from the plain version ({what})")
    mean_err = abs(got[3].item() - ref[3].item()) / max(ref[3].item(), 1e-30)
    if mean_err > 1e-5:
        raise RuntimeError(f"K6 mean density rel err {mean_err} > 1e-5 ({what})")
    thresh = torch.clamp_max(got[3], rcfg.density_thresh) * rcfg.occ_thresh_scale
    occ = (ref[0] > thresh).reshape(got[1].shape)
    r = rcfg.coarse_dilation_radius
    if not (torch.equal(got[1], occ) and torch.equal(got[2], R._dilate3(occ, r))
            and torch.equal(got[4], R._occupied_bbox(occ, rcfg))):
        raise RuntimeError(f"K6 occupancy, dilation or bbox differs from the plain version ({what})")
    _same_bits(f"K6 ({what})", got, again)
    return got, mean_err


def _upkeep_rows(trainer, calls):
    """K6: the partial refresh's upkeep, held to its plain version and
    timed; and a full refresh of the same grid (every cell queried: the
    merged grid's densities, 5% up, as the query) held to its plain
    version."""
    rows = []
    (oargs, _), = calls["_occupancy_upkeep_cuda"][:1]
    grid_old, tmp, off, rcfg, decay = oargs
    got, mean_err = _upkeep_check(oargs, f"refresh of {tmp.shape[1]} cells at {off}")
    full_args = (grid_old, 1.05 * got[0].clamp_min(0), 0, rcfg, decay)
    _, full_err = _upkeep_check(full_args, "full refresh")
    r = rcfg.coarse_dilation_radius
    occ_f = got[1].float().unsqueeze(1)
    Cn = grid_old.numel()
    b, by = bound_ms(nbytes(grid_old, tmp) + nbytes(got[0], got[1], got[2]), k6_ops(Cn, r, merge=True))
    rows.append(dict(name="K6 occupancy_upkeep", key="occupancy", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/occupancy.cu",
                     replaces="trinerflet_tpu/render/renderer.py:332",
                     max_abs_err=max(mean_err, full_err),
                     tol="grid, occ, occ_coarse, bbox equal; mean rel 1e-5; a second call the same bits",
                     ms=time_ms(lambda: R._occupancy_upkeep_cuda(*oargs)),
                     plain_ms=ref_ms(lambda: R.occupancy_upkeep_plain(*oargs)),
                     bound_ms=b, bound_by=by,
                     library_ms=ref_ms(lambda: F.max_pool3d(occ_f, 2 * r + 1, 1, r)),
                     note=f"{tuple(grid_old.shape)} grid, refreshed block of {tmp.shape[1]} cells at "
                          f"{off} (and a full refresh, held only), radius {r}; 2 launches (merge "
                          f"and mean; threshold, bit-packed separable dilation and bbox on tiles "
                          f"of z-rows); library is F.max_pool3d for the dilation alone; "
                          f"max_abs_err is the mean's relative error"))
    return rows


def _dense_composite_rows(trainer, calls):
    """K3 forward and backward: the per-ray (N, B) layout's compositor; on
    the proposal path one row per call (the proposal weights, T = P, and
    the final samples, T = F)."""
    rows = []
    for (cargs, _) in calls["_composite_cuda"]:
        rows += _composite_row(cargs, len(calls["_composite_cuda"]) > 1)
    for (bargs, _) in calls["_composite_backward_cuda"]:
        rows += _composite_backward_row(bargs, len(calls["_composite_backward_cuda"]) > 1)
    return rows


def _same_bits(what, got, again):
    """A kernel that sums in a fixed order gives the same bits on a second
    call."""
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError(f"{what} differs from itself on a second call")


def _composite_row(cargs, name_t):
    got, ref = RM._composite_cuda(*cargs), RM.composite_dense_plain(*cargs)
    err = max((a - b_).abs().max().item() for a, b_ in zip(got, ref))
    if err > 1e-5:
        raise RuntimeError(f"K3 (train) max|err| {err} > 1e-5")
    _same_bits("K3", got, RM._composite_cuda(*cargs))
    sig = cargs[0]
    b, by = bound_ms(nbytes(*cargs[:5]) + nbytes(*got), sig.numel() * 12)
    return [with_floor(dict(name="K3 composite_dense" + (f" T={sig.shape[1]}" if name_t else ""),
                 key="composite", route="cuda",
                 source="trinerflet_tpu_torch/kernels/csrc/composite.cu",
                 replaces="trinerflet_tpu/ops/raymarch.py:805", max_abs_err=err, tol=1e-5,
                 ms=time_ms(lambda: RM._composite_cuda(*cargs)),
                 plain_ms=ref_ms(lambda: RM.composite_dense_plain(*cargs)),
                 bound_ms=b, bound_by=by, library_ms=None,
                 note=f"N={sig.shape[0]} rays x {sig.shape[1]} samples"))]


def _composite_backward_row(bargs, name_t):
    sig = bargs[0]
    got = RM._composite_backward_cuda(*bargs)
    ref = RM.composite_dense_backward_plain(*bargs)
    err = max(_rel(a, b_) for a, b_ in zip(got, ref))
    if err > 1e-5:
        raise RuntimeError(f"K3 backward rel err {err} > 1e-5")
    _same_bits("K3 backward", got, RM._composite_backward_cuda(*bargs))
    b, by = bound_ms(nbytes(*bargs[:5]) + nbytes(*bargs[6:]) + nbytes(*got), sig.numel() * 40)
    return [with_floor(dict(name="K3 composite_dense backward" + (f" T={sig.shape[1]}" if name_t else ""),
                 key="composite_bwd",
                 route="cuda", source="trinerflet_tpu_torch/kernels/csrc/composite.cu",
                 replaces="trinerflet_tpu/ops/raymarch.py:805",
                 max_abs_err=max((a - b_).abs().max().item() for a, b_ in zip(got, ref)),
                 tol="1e-5 x max|grad|",
                 ms=time_ms(lambda: RM._composite_backward_cuda(*bargs)),
                 plain_ms=ref_ms(lambda: RM.composite_dense_backward_plain(*bargs)),
                 bound_ms=b, bound_by=by, library_ms=None,
                 note=f"N={sig.shape[0]} rays x {sig.shape[1]} samples; analytic reverse pass, "
                      "a lane group per ray; replaces autodiff of the cumprod"))]


def evaluate_phase(trainer, state, scene, card):
    """Trainer.evaluate on the training scene's views (EMA params)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.evaluate(state, scene)
    secs = time.perf_counter() - t0
    log(f"# evaluate ({card}): {scene.num_views} views of {scene.H}x{scene.W} in {secs:.2f} s; "
        f"PSNR {res['PSNR']:.4f} dB, SSIM {res['SSIM']:.5f}; per view "
        f"{[(r['view'], round(r['PSNR'], 3), round(r['SSIM'], 4)) for r in res['per_image']]}")
    if not (np.isfinite(res["PSNR"]) and np.isfinite(res["SSIM"])):
        raise RuntimeError("evaluate gave a non-finite PSNR or SSIM")
    return res


def global_phase(trainer, state, data, card, mean_samples):
    """The trained state continues on the global layout at full width: S from
    the tuner's rule on the live mean, 2 windows of 50 steps with refreshes."""
    slots = TR.global_slots_for(mean_samples)
    trainer.render_cfg = dataclasses.replace(trainer.render_cfg, compaction="global",
                                             global_slots_per_ray=slots)
    B = trainer.render_cfg.samples_per_ray_budget
    log(f"# global layout: live mean {mean_samples:.3f} kept samples/ray -> S = max(4, "
        f"ceil(1.5 mean / 2) 2) = {slots} slots per ray (the tuner engages at S <= 0.8 B = "
        f"{int(0.8 * B)}, B = {B}); buffer {trainer.cfg.num_rays * slots:,} slots")
    interval = trainer.cfg.update_extra_interval
    N = trainer.cfg.num_rays
    kernels.reset_launches()
    windows, losses, fills, valid = [], [], [], []
    for _ in range(GLOBAL_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(WINDOW_STEPS):
            if i % interval == 0:
                state = _refresh(trainer, state, full=False)
            state, aux = trainer.train_step(state, data, with_stats=(i + 1) % interval == 0)
            losses.append(aux["loss"])
            fills.append(aux["global_fill"])
            valid.append(aux["num_samples"])
        losses[-1].item()  # host copy: waits for the window's last step
        windows.append((time.perf_counter() - t0) / WINDOW_STEPS * 1e3)
    launches = dict(kernels.launches)
    losses, fills = torch.stack(losses).cpu(), torch.stack(fills).cpu()
    valid = torch.stack(valid).cpu().float()
    ms = float(np.median(windows))
    steps = GLOBAL_WINDOWS * WINDOW_STEPS
    log(f"# global layout train ({card}): windows {[round(w, 3) for w in windows]} ms/step; median "
        f"{ms:.3f} ms/step = {N / ms * 1e3:.1f} rays/s; global_fill mean {fills.mean().item():.4f} "
        f"(min {fills.min().item():.4f}, max {fills.max().item():.4f}); num_valid mean "
        f"{valid.mean().item():,.1f} ({valid.mean().item() / N:.3f}/ray); loss "
        f"{losses[0].item():.5f} -> {losses[-1].item():.5f}")
    log(f"# global layout launches over {steps} steps: {launches}")
    for name in GLOBAL_KERNELS:
        if launches[name] == 0:
            raise RuntimeError(f"kernel {name} was not launched on the global-layout path")
    if not np.isfinite(losses.numpy()).all():
        raise RuntimeError("non-finite loss on the global layout")
    stats = dict(ms_per_step=ms, windows=windows, rays_per_s=N / ms * 1e3, slots=slots,
                 fill=fills.mean().item(), num_valid=valid.mean().item(),
                 loss_first=losses[0].item(), loss_last=losses[-1].item())
    return state, launches, stats


def _compact_rows(trainer, calls):
    """K5 and K3c forward and backward: the global layout's compaction and
    compositor."""
    rows = []
    # ---- K5: the compaction, bit for bit
    (kargs, _), = calls["_compact_cuda"][:1]
    ro, rd, t, dt, mask, t0, M, bound = kargs
    got = RM._compact_cuda(*kargs)
    ref = RM.compact_global_dense_plain(ro, rd, t, dt, mask, t0, m_budget=M, bound=bound)
    again = RM._compact_cuda(*kargs)
    torch.cuda.synchronize()
    for f, a, b in zip(ref._fields, got, ref):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise RuntimeError(f"K5 {f} differs from the plain version ({int((a != b).sum())} entries)")
    _same_bits("K5", got, again)
    N, B = t.shape
    nv = int(got.num_valid)
    rays_in = int((got.counts > 0).sum())
    # what this run's data needs: the whole mask; t and dt of the candidates
    # that land in the buffer; o, d and t0 of the rays that own them; the
    # whole buffer (padding included) and the per-ray fields written once;
    # integer work only (a rank and a copy per kept sample)
    b5, by5 = bound_ms(nbytes(mask) + 8 * nv + 28 * rays_in + nbytes(*got), 0.0)
    odt0 = torch.cat([ro, rd, t0[:, None]], -1)
    table = torch.cat([odt0[:, None, :].expand(N, B, 7).reshape(N * B, 7), t.reshape(-1, 1),
                       dt.reshape(-1, 1)], -1).contiguous()
    lib = lambda: table.index_select(0, mask.reshape(-1).nonzero().squeeze(1)[:M])  # noqa: E731
    kept = int(mask.sum())
    rows.append(dict(name="K5 compact_global_dense", key="compact", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/compact.cu",
                     replaces="trinerflet_tpu/ops/raymarch.py:422", max_abs_err=0.0,
                     tol="every field equal, a second call too",
                     ms=time_ms(lambda: RM._compact_cuda(*kargs)),
                     plain_ms=ref_ms(lambda: RM.compact_global_dense_plain(
                         ro, rd, t, dt, mask, t0, m_budget=M, bound=bound)),
                     bound_ms=b5, bound_by=by5, library_ms=ref_ms(lib),
                     note=f"N={N} rays x B={B} slots -> M={M} buffer slots, {kept} kept samples "
                          f"({nv} in the buffer, from {rays_in} rays); 2 launches (the tiles: "
                          f"count, look-back scan; the copy and padding); library_ms is a two-call "
                          f"yardstick: "
                          f"mask.nonzero() (with its host sync) + index_select of the 9-wide table"))

    # ---- K3c forward
    (cargs, _), = calls["_composite_compact_cuda"][:1]
    sig, rgb, dts, ts, rid, offs, cnts, n_rays, thr = cargs
    got = RM._composite_compact_cuda(*cargs)
    ref = RM.composite_compact_plain(*cargs)
    err = max(_rel(a, b_) for a, b_ in zip(got, ref))
    if err > 1e-5:
        raise RuntimeError(f"K3c forward rel err {err} > 1e-5")
    _same_bits("K3c forward", got, RM._composite_compact_cuda(*cargs))
    Mc = sig.shape[0]
    seg = int(cnts.sum())  # slots inside the rays' segments, the only ones read
    # per slot in a segment sigma, dt, t (4 B each) and rgb (12 B), about 16
    # flops; per ray its offset and count, and its four sums written once
    b, by = bound_ms(24 * seg + nbytes(offs, cnts) + nbytes(*got), seg * 16)
    rows.append(with_floor(dict(name="K3c composite_compact", key="composite_compact", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/compact.cu",
                     replaces="trinerflet_tpu/ops/raymarch.py:754",
                     max_abs_err=max((a - b_).abs().max().item() for a, b_ in zip(got, ref)),
                     tol="1e-5 x max|output|", ms=time_ms(lambda: RM._composite_compact_cuda(*cargs)),
                     plain_ms=ref_ms(lambda: RM.composite_compact_plain(*cargs)),
                     bound_ms=b, bound_by=by, library_ms=None,
                     note=f"M={Mc} slots ({seg} in segments, at most {int(cnts.max())} a ray), "
                          f"N={n_rays} rays; a lane group per ray (8, 16 or 32 lanes by M/N), "
                          f"float64 scans and sums")))
    # ---- K3c backward
    (bargs, _), = calls["_composite_compact_backward_cuda"][:1]
    got = RM._composite_compact_backward_cuda(*bargs)
    ref = RM.composite_compact_backward_plain(*bargs)
    err = max(_rel(a, b_) for a, b_ in zip(got, ref))
    if err > 1e-5:
        raise RuntimeError(f"K3c backward rel err {err} > 1e-5")
    _same_bits("K3c backward", got, RM._composite_compact_backward_cuda(*bargs))
    seg = int(bargs[6].sum())
    # per slot in a segment sigma, dt, t, ray_id (4 B each) and rgb (12 B),
    # about 30 flops; per ray offset, count and the 6 cotangent words; dsigma
    # and drgb written over all M slots (zeros on padding)
    b, by = bound_ms(28 * seg + nbytes(bargs[5], bargs[6], *bargs[9:]) + nbytes(*got), seg * 30)
    rows.append(with_floor(dict(name="K3c composite_compact backward", key="composite_compact_bwd",
                     route="cuda", source="trinerflet_tpu_torch/kernels/csrc/compact.cu",
                     replaces="trinerflet_tpu/ops/raymarch.py:754",
                     max_abs_err=max((a - b_).abs().max().item() for a, b_ in zip(got, ref)),
                     tol="1e-5 x max|grad|",
                     ms=time_ms(lambda: RM._composite_compact_backward_cuda(*bargs)),
                     plain_ms=ref_ms(lambda: RM.composite_compact_backward_plain(*bargs)),
                     bound_ms=b, bound_by=by, library_ms=None,
                     note="analytic backward, a lane group per ray: two forward walks (the "
                          "ray's total of a*w, then its inclusive scan; the suffix is their "
                          "difference); replaces autodiff of the global cumsums")))
    return rows


def _touched_rows(x, cfg, bound) -> int:
    """Distinct table rows K7's corners read at these points, over all
    levels (what this run's data needs)."""
    return sum(torch.unique(GE._corners_plain(x, cfg, bound, l)[1]).numel()
               for l in range(cfg.num_levels))


def _k7_flops(n_points, cfg) -> float:
    """f32 operations of K7 per call: per (point, level) about 18 for the
    coordinates, 16 for the 8 corner weights and 2 C per corner for the sum."""
    return n_points * cfg.num_levels * (18 + 16 + 16 * cfg.level_dim)


def _grid_encode_rows(trainer, calls):
    """K7 forward and backward on the captured step."""
    return _grid_encode_fwd_rows(calls) + _grid_encode_bwd_rows(calls)


def _grid_encode_fwd_rows(calls):
    """K7 forward: every captured forward call (the field's or the proposal
    density's, a refresh's sweep, an analytic normal's) held to the plain
    version bit for bit, and a second call to the first; the first timed."""
    rows = []
    err = 0.0
    for (fargs, _) in calls["_grid_encode_cuda"]:
        got, ref = GE._grid_encode_cuda(*fargs), GE.grid_encode_plain(*fargs)
        err = max(err, (got - ref).abs().max().item())
        if err > 1e-6:
            raise RuntimeError(f"K7 max|err| {err} > 1e-6")
        if not torch.equal(got, ref):
            raise RuntimeError(f"K7 forward off its plain version's bits (max|err| {err})")
        _same_bits("K7 forward", [got], [GE._grid_encode_cuda(*fargs)])
    (fargs, _) = calls["_grid_encode_cuda"][0]
    tables, x, cfg, bound = fargs
    N, L, C = x.shape[0], cfg.num_levels, cfg.level_dim
    total = sum(cfg.level_size(l) for l in range(L))
    touched = _touched_rows(x, cfg, bound)
    b, by = bound_ms(nbytes(x) + 4 * N * L * C + 4 * C * touched, _k7_flops(N, cfg))
    rows.append(dict(name="K7 grid_encode", key="grid_encode", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/gridencoder.cu",
                     replaces="trinerflet_tpu/models/gridencoder.py:115", max_abs_err=err, tol=0.0,
                     ms=time_ms(lambda: GE._grid_encode_cuda(*fargs)),
                     plain_ms=ref_ms(lambda: GE.grid_encode_plain(*fargs)),
                     bound_ms=b, bound_by=by, library_ms=None,
                     note=f"N={N} points x {L} levels of C={C}; {touched} of {total} table rows "
                          f"touched; {len(calls['_grid_encode_cuda'])} captured forward call(s) "
                          f"held to the plain version bit for bit, a second call the same bits; "
                          f"a warp on 32 consecutive points at one level, a block all levels of "
                          f"its 32 points, outputs staged in shared memory and written as one "
                          f"slab; no single library call computes it"))
    return rows


def _grid_encode_bwd_rows(calls):
    """K7 backward on the step's first backward call, held to a float64 sum."""
    rows = []
    (bargs, _) = calls["_grid_encode_backward_cuda"][0]
    g, xb, cfg, bound = bargs
    L, C = cfg.num_levels, cfg.level_dim
    total = sum(cfg.level_size(l) for l in range(L))
    got = GE._grid_encode_backward_cuda(*bargs)
    ref = GE.grid_encode_backward_plain(*bargs)
    # both sum with float atomics in an unspecified order: each is held to a
    # float64 sum of the same terms within n (eps sum|term| + tiny) per entry
    frac_k, frac_p = max(GE.grid_encode_backward_error(got, *bargs)), max(GE.grid_encode_backward_error(ref, *bargs))
    if frac_k > 1.0 or frac_p > 1.0:
        raise RuntimeError(f"K7 backward off its float64 sum: kernel {frac_k}, plain {frac_p} of "
                           f"the bound n (eps sum|term| + tiny)")
    N = xb.shape[0]
    live = int((g.reshape(N, L, C) != 0).any(-1).sum())  # (point, level) rows with a cotangent
    b, by = bound_ms(nbytes(g, xb) + 4 * C * total, _k7_flops(N, cfg) * live / max(N * L, 1))
    # the library yardstick computes less: the corner rows and w * g are
    # precomputed, only the scatter-add into one buffer of all tables is timed
    offs = np.cumsum([0] + [cfg.level_size(l) for l in range(L)])
    idx, vals = [], []
    for l in range(L):
        w, rws = GE._corners_plain(xb, cfg, bound, l)
        idx.append((rws + int(offs[l])).reshape(-1))
        vals.append((w[..., None] * g[:, l * C:(l + 1) * C].float()[None]).reshape(-1, C))
    idx, vals = torch.cat(idx), torch.cat(vals)
    buf = torch.zeros((total, C), device=xb.device)
    lib_err = _rel(buf.index_add_(0, idx, vals), torch.cat(got))
    rows.append(dict(name="K7 grid_encode backward", key="grid_encode_bwd", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/gridencoder.cu",
                     replaces="trinerflet_tpu/ops/scatter.py:326",
                     max_abs_err=max((a - b_).abs().max().item() for a, b_ in zip(got, ref)),
                     tol="n (eps sum|term| + tiny) per entry, against float64",
                     ms=time_ms(lambda: GE._grid_encode_backward_cuda(*bargs)),
                     plain_ms=ref_ms(lambda: GE.grid_encode_backward_plain(*bargs)),
                     bound_ms=b, bound_by=by,
                     library_ms=ref_ms(lambda: buf.index_add_(0, idx, vals)),
                     note=f"{live} of {N * L} (point, level) rows carry a cotangent; kernel "
                          f"{frac_k:.4f}, plain {frac_p:.4f} of the float64 bound; a warp on 32 "
                          f"consecutive points at one level, its runs of lanes on one row pair "
                          f"merged, vector float32 atomics into {total} zeroed rows; library is "
                          f"Tensor.index_add_ of the "
                          f"precomputed (row, w g) pairs, which computes less (rel diff "
                          f"{lib_err:.2e}); replaces the sort + one-hot scatter"))
    del idx, vals, buf
    return rows


def _touched_texels(c2, H, Wd, live=None):
    """Distinct texels the bilinear corners of (3, M, 2) plane coordinates
    read (of the (plane, point) rows ``live`` (3, M) holds, when given)."""
    x0 = torch.clamp(torch.floor(torch.clamp((c2[..., 0] + 1) * 0.5 * (Wd - 1), 0, Wd - 1)), 0, Wd - 2).long()
    y0 = torch.clamp(torch.floor(torch.clamp((c2[..., 1] + 1) * 0.5 * (H - 1), 0, H - 1)), 0, H - 2).long()
    base = (torch.arange(3, device=c2.device)[:, None] * H + y0) * Wd + x0
    if live is not None:
        base = base[live]
    return torch.unique(torch.cat([base, base + 1, base + Wd, base + Wd + 1]).reshape(-1)).numel()


def proposal_configs(num_rays: int = 32768):
    """bench.py's model on the proposal renderer (ProposalConfig defaults:
    64 + 32 samples, a 5-level grid 16 -> 128 of 2^17 rows)."""
    nerf_cfg, render_cfg, train_cfg = bench_configs(num_rays)
    return nerf_cfg, render_cfg, dataclasses.replace(train_cfg, renderer="proposal")


def hashgrid_configs(num_rays: int = 32768):
    """The hash-grid field at the JAX package's default grid (16 levels of
    2 features, 16 -> 2048, 2^19 rows; 49 MB of tables), bound 1.5, bf16
    MLPs, on bench.py's occupancy-grid RenderConfig with the tuner on; no
    wavelet regularisation (the field has no wavelets)."""
    _, render_cfg, train_cfg = bench_configs(num_rays)
    nerf_cfg = NeRFConfig(encoding="hashgrid", bound=1.5, compute_dtype="bfloat16",
                          plane_dtype="bfloat16")
    return nerf_cfg, render_cfg, dataclasses.replace(train_cfg, wavelet_regularization=0.0)


def view_phase(trainer, state, card, what, render=None, required=(), absent=()):
    """One 800x800 view of the trained state (EMA params), twice (the second
    is the steady ms/view; the counters are zeroed before it and read after
    it: every ``required`` kernel must have launched and no ``absent`` one),
    from the serve phase's first camera. ``render(pose, intr) -> (image,
    depth)`` renders the view (default the trainer's ``render_image``)."""
    intr = synthetic_intrinsics(VIEW_HW, VIEW_HW)
    pose = orbit_pose(np.arccos(1 - 1.6 * 0.5 / 8), 0.0, 2.0)
    if render is None:
        def render(pose, intr):
            return trainer.render_image(state.ema_params, state.occ, pose, intr, VIEW_HW, VIEW_HW)
    ms = []
    for rep in range(2):
        if rep == 1:
            kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, dep = render(pose, intr)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.launches)
    if img.shape != (VIEW_HW, VIEW_HW, 3) or not (torch.isfinite(img).all() and torch.isfinite(dep).all()):
        raise RuntimeError(f"{what} view: bad or non-finite render {tuple(img.shape)}")
    if img.min() < 0 or img.max() > 1.0 + 1e-5:
        raise RuntimeError(f"{what} view out of range: [{img.min()}, {img.max()}]")
    log(f"# {what} view ({card}): {VIEW_HW}x{VIEW_HW} ms/view first {ms[0]:.2f}, repeat {ms[1]:.2f}; "
        f"image mean {img.mean().item():.4f} std {img.std().item():.4f}"
        + (f"; launches {launches}" if required or absent else ""))
    for name in required:
        if launches[name] == 0:
            raise RuntimeError(f"kernel {name} was not launched on the {what} view")
    for name in absent:
        if launches[name] != 0:
            raise RuntimeError(f"kernel {name} launched on the {what} view, which has none")
    return ms


def proposal_phases(scene, card):
    """The proposal renderer: bench.py's model trained 64 + 50 steps (no
    refresh, no retune), one step under the profiler, evaluate, one 800^2
    view, one captured step's kernels held to their plain versions, the
    4,096-ray step check. The trained field sits on the black plateau, as
    the JAX package's does (``scripts/torch_proposal_plateau.py``): the
    interlevel loss is near zero there and ``sample_pdf`` places samples by
    near-empty CDFs, so the proposal grid's gradient differs between card
    and CPU from run to run (from 2e-4 to 2.4e-2 of its norm in repeated
    runs of the same code); the step check runs on the initial parameters,
    as the dense and k-planes ones."""
    trainer = Trainer(*proposal_configs(), device=DEVICE)
    state = trainer.init_state()
    initial = _snapshot(state)
    data = trainer.scene_to_device(scene)
    state, launches, stats = train_phase(
        trainer, state, data, card, warm=PERRAY_WARM, n_windows=PERRAY_WINDOWS,
        required=PROPOSAL_KERNELS, absent=PROPOSAL_ABSENT, what="proposal train")
    state = profile_step(trainer, state, data, "proposal train")
    res = evaluate_phase(trainer, state, scene, card)
    view_ms = view_phase(trainer, state, card, "proposal")
    state, calls = capture_step(trainer, state, data)
    rows = path_kernel_rows(trainer, calls, launches, "proposal train")
    del calls
    step_check(trainer, initial, data, "proposal (initial field)")
    return rows, dict(stats, launches=launches, view_ms=view_ms, psnr=res["PSNR"], ssim=res["SSIM"])


def hashgrid_phases(scene, card):
    """The hash-grid field on the occgrid renderer: 64 + 50 steps on the
    refresh cadence, one step under the profiler, one 800^2 view, one
    captured step's kernels held to their plain versions, the 4,096-ray
    step check."""
    trainer = Trainer(*hashgrid_configs(), device=DEVICE)
    state = trainer.init_state(density_grid=mark_untrained_grid(scene.poses, scene.intrinsics,
                                                                trainer.render_cfg))
    data = trainer.scene_to_device(scene)
    state, launches, stats = train_phase(
        trainer, state, data, card, warm=PERRAY_WARM, n_windows=PERRAY_WINDOWS,
        required=HASHGRID_KERNELS, absent=HASHGRID_ABSENT, what="hashgrid train")
    state = profile_step(trainer, state, data, "hashgrid train")
    view_ms = view_phase(trainer, state, card, "hashgrid")
    state, calls = capture_step(trainer, state, data)
    rows = path_kernel_rows(trainer, calls, launches, "hashgrid train")
    del calls
    step_check(trainer, state, data, "hashgrid")
    return rows, dict(stats, launches=launches, view_ms=view_ms, params=state.ema_params, occ=state.occ)


FLAT_BOUND = 4.0


def flat_configs(num_rays: int = 32768):
    """``scripts/bench_dtgamma_march.py``'s LLFF-like configuration as the
    CLI runs it: bench's triplane and bf16 MLPs at bound 4 (3 cascades), a
    128^3 grid, max_steps 1024, B 20, dt_gamma 1/128 with ``march`` left at
    its default (so render_occgrid takes the flat branch and the retune
    runs), 32,768 rays, wavelet L1 0.4, refresh every 16 steps, the tuner
    on, 2,000 iterations of schedule."""
    nerf_cfg = NeRFConfig(
        triplane=TriplaneConfig(channels=16, resolution=1024, wavelet_scale=16),
        bound=FLAT_BOUND, compute_dtype="bfloat16", plane_dtype="bfloat16")
    render_cfg = RenderConfig(bound=FLAT_BOUND, grid_size=128, density_thresh=10.0, max_steps=1024,
                              samples_per_ray_budget=20, dt_gamma=1.0 / 128)
    train_cfg = TrainConfig(lr=1e-2, iters=2000, num_rays=num_rays, wavelet_regularization=0.4,
                            renderer="occgrid", update_extra_interval=16, budget_autotune=True)
    return nerf_cfg, render_cfg, train_cfg


def flat_phases(scene, card):
    """The flat march at full width: 64 + 50 steps on the refresh cadence
    with the retune, one profiled step, evaluate, one 800^2 view, a captured
    step's rows (and K1f's per-ray mode at B = 13 on its rays, where spread
    ranks run past the count) and the step check on the layout the tuner
    left; then the
    other layout forced for FORCED_STEPS steps (one refresh) and its own
    captured step's layout kernels (K1f's other mode; K5 and K3c, or K3).
    ``scene`` is bench's (cameras at radius 2): seen from radius 2 bound =
    8, the synthetic spheres cover 0.6% of the pixels (the ground truth
    marches [0.8, 3.2] from the camera) and the field collapses to zero
    density within 64 steps, leaving the step check no gradient to hold."""
    trainer = Trainer(*flat_configs(), device=DEVICE)
    rc = trainer.render_cfg
    log(f"# flat set-up: {rc.cascades} cascades, {rc.num_candidates} candidates per ray, dt_gamma "
        f"{rc.dt_gamma}, cameras at radius 2 inside the bound-{rc.bound} box")
    state = trainer.init_state(density_grid=mark_untrained_grid(scene.poses, scene.intrinsics, rc))
    data = trainer.scene_to_device(scene)
    state, launches, stats = train_phase(
        trainer, state, data, card, warm=PERRAY_WARM, n_windows=PERRAY_WINDOWS,
        required=FLAT_KERNELS, absent=("march",), what="flat train")
    _check_layout(launches, "flat")
    state = profile_step(trainer, state, data, "flat train")
    res = evaluate_phase(trainer, state, scene, card)
    view_ms = view_phase(trainer, state, card, "flat")
    state, calls = capture_step(trainer, state, data)
    rows = path_kernel_rows(trainer, calls, launches, "flat train")
    k1f_rank_past_count_check(calls)
    del calls
    step_check(trainer, state, data, "flat")
    tuned = trainer.render_cfg
    other = "per_ray" if tuned.compaction == "global" else "global"
    trainer.render_cfg = dataclasses.replace(tuned, compaction=other, global_slots_per_ray=0)
    kernels.reset_launches()
    state = _refresh(trainer, state, full=False)
    for _ in range(FORCED_STEPS):
        state, aux = trainer.train_step(state, data, with_stats=False)
    forced = dict(kernels.launches)
    log(f"# flat {other} layout forced for {FORCED_STEPS} steps and one refresh: loss "
        f"{float(aux['loss']):.5f}, num_samples {int(aux['num_samples'])}; launches {forced}")
    state, calls = capture_step(trainer, state, data)
    rows += path_kernel_rows(trainer, calls, forced, f"flat {other} check",
                             only=("_march_flat_cuda", "_compact_cuda", "_composite_cuda"))
    del calls
    trainer.render_cfg = tuned
    return rows, dict(stats, launches=launches, forced=forced, layout=tuned.compaction,
                      budget=tuned.samples_per_ray_budget, view_ms=view_ms, psnr=res["PSNR"],
                      ssim=res["SSIM"])


def dense_configs(num_rays: int = 4096):
    """bench.py's model on the dense renderer at the CLI's defaults: 512
    uniform samples per ray and 64 importance samples (the importance
    estimator's floor), 4,096 rays."""
    nerf_cfg, render_cfg, train_cfg = bench_configs(num_rays)
    return (nerf_cfg, dataclasses.replace(render_cfg, num_steps=512, upsample_steps=64),
            dataclasses.replace(train_cfg, renderer="dense"))


def dense_phases(scene, card):
    """The dense renderer: 16 + 16 steps (no refresh, no retune), one
    profiled step, one 800^2 view, a captured step's rows, the step check
    (on 1,024 rays: the CPU side evaluates the full-width field at 576
    samples per ray). The trained field sits on the black plateau, as the
    JAX package's does (``scripts/torch_proposal_plateau.py --config
    dense``), where the planes' gradients cancel to a small rest whose
    relative difference between card and CPU moves from run to run (from
    1e-2 to 3e-2 of a plane group's norm in repeated runs of the same
    code): the step check runs on the initial parameters, as the k-planes
    one."""
    trainer = Trainer(*dense_configs(), device=DEVICE)
    state = trainer.init_state()
    initial = _snapshot(state)
    data = trainer.scene_to_device(scene)
    state, launches, stats = train_phase(
        trainer, state, data, card, warm=DENSE_WARM, n_windows=1, window_steps=DENSE_WINDOW,
        required=DENSE_KERNELS, absent=DENSE_ABSENT, what="dense train")
    state = profile_step(trainer, state, data, "dense train")
    view_ms = view_phase(trainer, state, card, "dense")
    state, calls = capture_step(trainer, state, data)
    rows = path_kernel_rows(trainer, calls, launches, "dense train")
    del calls
    step_check(trainer, initial, data, "dense (initial field)", n_rays=1024)
    return rows, dict(stats, launches=launches, view_ms=view_ms)


def _snapshot(state):
    """The state with its parameters copied (a train step updates them in
    place)."""
    return state._replace(params=TR._map(lambda t: t.detach().clone(), state.params))


BG_RADIUS = 4.0  # the background sphere holds bench's cameras (radius 2)


def variants_configs(num_rays: int = 32768):
    """bench.py's model and step (the tuner on) with the triplane's variants as
    ``--triplane_rotation --lbound_auto_scale --upscale_ratio_bound 0.5`` runs
    them (two zoom-in levels, each one more IDWT level on a 512^2 centre
    crop), the background network (bg_radius 4) and SH degree 8."""
    nerf_cfg, render_cfg, train_cfg = bench_configs(num_rays)
    tri = dataclasses.replace(nerf_cfg.triplane, learned_rotation=True, lbound_auto_scale=True,
                              upscale_ratio_bound=0.5, upscale_levels=2)
    return (dataclasses.replace(nerf_cfg, triplane=tri, bg_radius=BG_RADIUS, sh_degree=8),
            dataclasses.replace(render_cfg, bg_radius=BG_RADIUS), train_cfg)


def _variant_rows(trainer, calls):
    """The variants step's own rows: K2 forward on ``full`` and on each
    zoom-in plane, K2x on each, K4 forward and adjoint on the zoom-in crops
    (the step's ladder builds 4 levels, then one per crop; its backward runs
    the crops' adjoints first)."""
    tcfg = trainer.nerf_cfg.triplane
    fwd = calls["_sample_points_cuda"][: 1 + tcfg.upscale_levels]  # the step's field forward
    names = {a[0].data_ptr(): nm for (a, _), nm in
             zip(fwd, ["full"] + [f"upscale_{i}" for i in range(tcfg.upscale_levels)])}
    rows = []
    for (planes, xyz, lb), _ in fwd:
        rows += _sample_fwd_rows(planes, xyz, lb, f" ({names[planes.data_ptr()]})")
    rows += _sample_xyz_rows(calls, lambda planes: f" ({names.get(planes.data_ptr(), '?')})")
    crops = calls["_idwt2d_cuda"][tcfg.levels : tcfg.levels + tcfg.upscale_levels]
    levels = [_k4_level(yl, yh, name)[1] for (yl, yh, name), _ in crops]
    rows.append(_k4_row(levels, "K4 idwt2d (zoom-in crops)", "one level per crop: "))
    rows += _adjoint_rows(trainer, calls, slice(0, tcfg.upscale_levels), " (zoom-in crops)")
    return rows


def bg_chunk_check(trainer, state):
    """One direct render_occgrid chunk (4,096 rays of a view's middle rows)
    with ``bg_fn=field.background``, which the trainer never passes: the
    card's kernels against the plain versions on the CPU."""
    intr = synthetic_intrinsics(VIEW_HW, VIEW_HW)
    ro, rd = rays_full_image(orbit_pose(np.arccos(1 - 1.6 * 0.5 / 8), 0.0, 2.0), intr, VIEW_HW, VIEW_HW)
    s = VIEW_HW * VIEW_HW // 2 - CHECK_RAYS // 2
    out = {}
    for dev in (DEVICE, "cpu"):
        params = TR._map(lambda t: t.detach().to(dev), state.ema_params)
        occ = type(state.occ)(*[x.to(dev) for x in state.occ])
        field = trainer.field
        planes = field.build_planes(params)
        with torch.no_grad():
            out[dev] = R.render_occgrid(
                lambda x, d: field(params, planes, x, d), torch.from_numpy(ro[s : s + CHECK_RAYS]).to(dev),
                torch.from_numpy(rd[s : s + CHECK_RAYS]).to(dev), occ.occ, trainer.eval_render_cfg,
                bg_fn=lambda sph, d: field.background(params, sph, d), occ_coarse=occ.occ_coarse,
                occ_bbox=occ.bbox)
    img, ref = out[DEVICE]["image"].cpu(), out["cpu"]["image"]
    err = (img - ref).abs()
    open_sky = float((1.0 - out["cpu"]["weights_sum"]).mean())
    log(f"# variants bg_fn chunk ({CHECK_RAYS} rays): image max|diff| card vs CPU plain "
        f"{err.max().item():.3e}, mean {err.mean().item():.3e}; mean 1 - weights_sum {open_sky:.4f}; "
        f"image mean {img.mean().item():.4f}")
    # as plain_chunk_check: bf16 planes and MLPs may round one value apart
    if err.max().item() > 2e-2 or err.mean().item() > 1e-3 or not torch.isfinite(img).all():
        raise RuntimeError("the render with the background net disagrees with the plain versions")
    if open_sky <= 0.0:
        raise RuntimeError("no ray reached the background in the bg_fn chunk")


def variants_phases(scene, card):
    """The triplane's variants at full width: 64 + 50 steps on the refresh
    cadence with the tuner (K2x, not K2's plane-only backward, must launch:
    every training sample is differentiated through its point), the
    quaternion and lbound_scale must move, one profiled step, evaluate, one
    800^2 view, a captured step's rows (K2 forward on each plane stack, K2x,
    K4 on the crops, and the path's march, layout, adjoint and upkeep), the
    4,096-ray step check and one direct render_occgrid chunk with bg_fn."""
    trainer = Trainer(*variants_configs(), device=DEVICE)
    state = trainer.init_state(density_grid=mark_untrained_grid(scene.poses, scene.intrinsics,
                                                                trainer.render_cfg))
    q0 = state.params["encoder"]["rotation"].detach().clone()
    s0 = state.params["encoder"]["lbound_scale"].detach().clone()
    data = trainer.scene_to_device(scene)
    state, launches, stats = train_phase(
        trainer, state, data, card, warm=PERRAY_WARM, n_windows=PERRAY_WINDOWS,
        required=VARIANTS_KERNELS, absent=VARIANTS_ABSENT, what="variants train")
    _check_layout(launches, "variants")
    q = state.params["encoder"]["rotation"].detach().clone()  # the steps below update it in place
    sc = state.params["encoder"]["lbound_scale"].detach().clone()
    log(f"# variants learned transform after {stats['steps']} steps: quaternion {q.tolist()} (from "
        f"{q0.tolist()}), lbound_scale {sc.item():.6f} (from {s0.item():.1f})")
    if torch.equal(q, q0) or torch.equal(sc, s0):
        raise RuntimeError("the learned rotation or lbound zoom did not move")
    state = profile_step(trainer, state, data, "variants train")
    res = evaluate_phase(trainer, state, scene, card)
    view_ms = view_phase(trainer, state, card, "variants")
    state, calls = capture_step(trainer, state, data)
    rows = path_kernel_rows(trainer, calls, launches, "variants train",
                            only=("_march_cuda", "_occupancy_upkeep_cuda", "_composite_cuda",
                                  "_compact_cuda"))
    rows += label_rows(_variant_rows(trainer, calls), launches, "variants train")
    del calls
    step_check(trainer, state, data, "variants", unused=("bg_net",))
    bg_chunk_check(trainer, state)
    return rows, dict(stats, launches=launches, view_ms=view_ms, psnr=res["PSNR"], ssim=res["SSIM"],
                      rotation=q.tolist(), lbound_scale=sc.item())


def kplanes_configs(num_rays: int = 32768):
    """The multiscale k-planes field with the product combine at the JAX
    package's default (three scales 64, 128, 256 of 16 f32 channels) on
    bench.py's occupancy-grid configuration (bf16 MLPs, the tuner on), no
    wavelet regularisation."""
    _, render_cfg, train_cfg = bench_configs(num_rays)
    nerf_cfg = NeRFConfig(encoding="multiscale_k_planes_mul", bound=1.5, compute_dtype="bfloat16")
    return nerf_cfg, render_cfg, dataclasses.replace(train_cfg, wavelet_regularization=0.0)


def kplanes_phases(scene, card):
    """k-planes: 64 + 50 steps on the refresh cadence (K2 forward and its
    plane-only backward launch; K4 and K2x not), one 800^2 view, a captured
    step's rows, the step check. The trained field sits on the black
    plateau, as the JAX package's does (``scripts/torch_proposal_plateau.py
    --config kplanes``): no ray carries weight, so the colour net's gradient
    is within rounding of zero and a relative comparison of it measures
    noise. The step check therefore runs on the initial parameters after
    one full refresh, where every group's gradient carries the field."""
    trainer = Trainer(*kplanes_configs(), device=DEVICE)
    state = trainer.init_state(density_grid=mark_untrained_grid(scene.poses, scene.intrinsics,
                                                                trainer.render_cfg))
    initial = _snapshot(state)
    data = trainer.scene_to_device(scene)
    state, launches, stats = train_phase(
        trainer, state, data, card, warm=PERRAY_WARM, n_windows=PERRAY_WINDOWS,
        required=KPLANES_KERNELS, absent=KPLANES_ABSENT, what="k-planes train")
    _check_layout(launches, "k-planes")
    view_ms = view_phase(trainer, state, card, "k-planes")
    state, calls = capture_step(trainer, state, data)
    rows = path_kernel_rows(trainer, calls, launches, "k-planes train")
    del calls
    step_check(trainer, _refresh(trainer, initial, full=True), data, "k-planes (initial field)")
    return rows, dict(stats, launches=launches, view_ms=view_ms)


# ---------------------------------------------------------------------------
# The model registry: the voxel grid (K10), the textured background (K11),
# the SDF, the diffuse material and analytic normals (K2x, K7x)
# ---------------------------------------------------------------------------

REG_GRID_KERNELS = ("volume_grid", "volume_grid_bwd", "textured_bg", "textured_bg_bwd", "march",
                    "composite", "composite_bwd")
REG_GRID_ABSENT = ("grid_sample", "grid_sample_bwd", "idwt", "idwt_adjoint", "occupancy",
                   "grid_encode")  # no triplane, and the full grid needs no refresh
REG_SDF_KERNELS = ("grid_sample", "grid_sample_bwd", "idwt", "idwt_adjoint", "march", "composite",
                   "composite_bwd")
REG_SDF_ABSENT = ("grid_sample_bwd_xyz", "volume_grid", "textured_bg", "occupancy")  # FD normals
REG_SDF_VIEW_KERNELS = ("grid_sample", "grid_sample_bwd_xyz", "idwt", "march", "composite")
REG_HASH_VIEW_KERNELS = ("grid_encode", "grid_encode_bwd_x", "march", "composite")
REG_GRID_VIEW_KERNELS = ("volume_grid", "textured_bg", "march", "composite")
REG_VIEW_ABSENT = ("grid_sample_bwd", "grid_encode_bwd", "idwt_adjoint", "composite_bwd",
                   "volume_grid_bwd", "textured_bg_bwd", "grid_sample_bwd_xyz_bwd", "grid_encode_bwd_x_bwd",
                   "volume_grid_bwd_x_bwd")  # serving: no parameter gradient, no second derivative
REG_CHUNK = 16384
SDF_BF16_BATCHES = 1  # batches of the bf16 SDF step check (read, not held; cut from 3, ~10 s each on the CPU)
REG_COS_POINTS = 65536


def registry_configs(num_rays: int = 32768):
    """bench.py's model, rays and render configuration (bf16 MLPs, bound 1.5,
    128^3 grid, budget 20) for a registry field, with the background sphere
    of radius 4 behind ``bg_fn`` and no wavelet regularisation (the
    registry tests' loss is the image MSE alone)."""
    nerf_cfg, render_cfg, train_cfg = bench_configs(num_rays, budget_autotune=False)
    return (nerf_cfg, dataclasses.replace(render_cfg, bg_radius=BG_RADIUS),
            dataclasses.replace(train_cfg, wavelet_regularization=0.0))


def full_occupancy(render_cfg):
    """Every cell occupied, as the JAX package's registry tests render."""
    H, C = render_cfg.grid_size, render_cfg.cascades
    ones = torch.ones((C, H, H, H), dtype=torch.bool, device=DEVICE)
    return R.OccupancyState(density_grid=torch.ones((C, H**3), device=DEVICE), occ=ones,
                            occ_coarse=ones.clone(), mean_density=torch.ones((), device=DEVICE),
                            iter_density=torch.zeros((), dtype=torch.int32, device=DEVICE),
                            bbox=torch.tensor(render_cfg.aabb, dtype=torch.float32, device=DEVICE))


def registry_state(init_fn, occ):
    """A fresh training state for a registry field's parameters: zero Adam
    moments, the EMA equal to the parameters."""
    params = TR._map(lambda t: t.requires_grad_(True), init_fn(torch.Generator().manual_seed(SEED), DEVICE))
    return TR.TrainState(params=params, opt_state={"count": 0, "mu": TR._map(torch.zeros_like, params),
                                                   "nu": TR._map(torch.zeros_like, params)},
                         ema_params=TR._map(lambda t: t.detach().clone(), params), ema_count=0, occ=occ,
                         step=0, rng=torch.Generator(device=DEVICE).manual_seed(SEED))


def registry_loss(trainer, field, params, occ, data, batch, generator):
    """The registry tests' loss on bench's rays: ``render_occgrid`` over the
    occupancy state, the field's background behind ``bg_fn``, the MSE
    against the pixels composited over black."""
    N = batch["img_idx"].shape[0] if "img_idx" in batch else trainer.cfg.num_rays
    if "rays_o" in data:  # a step check's rays, the same on both devices
        rays_o, rays_d, pixels = sample_ray_batch_pregen(data["images"], data["rays_o"], data["rays_d"], N,
                                                         generator, batch.get("img_idx"), batch.get("pix_idx"))
    else:
        rays_o, rays_d, pixels = sample_ray_batch(data["images"], data["poses"], data["intrinsics"], N,
                                                  generator, batch.get("img_idx"), batch.get("pix_idx"))
    gt = pixels[..., :3] * pixels[..., 3:] if pixels.shape[-1] == 4 else pixels
    noise = batch.get("noise")
    if noise is None:
        noise = torch.rand((N,), generator=generator, device=generator.device)
    planes = field.build_planes(params)
    out = R.render_occgrid(lambda x, d: field(params, planes, x, d), rays_o, rays_d, occ.occ,
                           trainer.render_cfg, noise=noise.to(rays_o.device, torch.float32),
                           bg_fn=lambda sph, d: field.background(params, d), occ_coarse=occ.occ_coarse,
                           occ_bbox=occ.bbox, with_stats=False)
    return ((out["image"] - gt) ** 2).mean(), out


def registry_step(trainer, field, data):
    """The registry path's step, as ``train_phase`` takes one: the loss, its
    gradients, the trainer's Adam and EMA (``batch`` injects the draws)."""
    def step(state, with_stats=False, batch=None):
        named = TR._leaves(state.params)
        leaves = [p.requires_grad_(True) for _, p in named]
        loss, out = registry_loss(trainer, field, state.params, state.occ, data, batch or {}, state.rng)
        state = trainer._apply_grads(state, named, leaves, loss)
        return state, {"loss": loss.detach(), "num_samples": out["num_samples"]}

    return step


def registry_loss_fn(field):
    """``registry_loss`` as ``step_check`` takes a loss."""
    def loss_fn(tr, params, occ, data, batch, generator):
        return registry_loss(tr, field, params, occ, data, batch, generator)

    return loss_fn


def registry_train(trainer, field, state, data, card, what, required, absent):
    """``train_phase`` on the registry path: 64 warm-up steps and one timed
    window of 50 on the full grid, which needs no refresh."""
    return train_phase(trainer, state, data, card, warm=PERRAY_WARM, n_windows=PERRAY_WINDOWS,
                       required=required, what=what, absent=absent,
                       step=registry_step(trainer, field, data), refresh=False)


def registry_view(trainer, field, params, occ, card, what, required, absent=REG_VIEW_ABSENT):
    """``view_phase``'s view of a registry field under ``torch.no_grad()``,
    in chunks of 16,384 rays with the field's background. Returns (ms,
    launches, the counted render's sample positions strictly inside the box,
    at most REG_COS_POINTS of them, spread over the view)."""
    rc, b = trainer.eval_render_cfg, trainer.render_cfg.bound
    n_chunks = -(-VIEW_HW * VIEW_HW // REG_CHUNK)
    seen = []

    def render(pose, intr):
        ro, rd = (torch.from_numpy(t).to(DEVICE) for t in rays_full_image(pose, intr, VIEW_HW, VIEW_HW))
        seen.clear()

        def field_fn(x, d):
            inside = x[(x.abs().amax(-1) < b - 1e-3)]
            seen.append(inside[:: max(1, inside.shape[0] * n_chunks // REG_COS_POINTS)])
            return field(params, planes, x, d)

        with torch.no_grad():
            planes = field.build_planes(params)
            outs = [R.render_occgrid(field_fn, ro[s : s + REG_CHUNK], rd[s : s + REG_CHUNK], occ.occ, rc,
                                     bg_fn=lambda sph, d: field.background(params, d),
                                     occ_coarse=occ.occ_coarse, occ_bbox=occ.bbox)
                    for s in range(0, ro.shape[0], REG_CHUNK)]
        return (torch.cat([o["image"] for o in outs]).reshape(VIEW_HW, VIEW_HW, 3),
                torch.cat([o["depth"] for o in outs]).reshape(VIEW_HW, VIEW_HW))

    ms = view_phase(trainer, None, card, what, render, required, absent)
    return ms, dict(kernels.launches), torch.cat(seen)[:REG_COS_POINTS]


def normal_checks(field, params, planes, x, cell, what):
    """The analytic normals at the view's samples: on the card against the
    plain versions on the CPU (4,096 samples; every cosine must exceed
    0.999: a flipped bf16 rounding in the MLPs tilts a normal by far less);
    and cos(analytic, finite-difference normal), as
    tests/test_registry.py:132-157 measures it: on float32-MLP copies of the
    field (a bf16 MLP's rounding over eps swamps a finite difference), with
    eps = 0.05 of the finest cell, median and 10th percentile (the median
    must exceed 0.9)."""
    xs = x[:CHECK_RAYS]
    with torch.no_grad():
        n_card = field.normal(params, planes, xs).cpu()
        n_cpu = field.normal(_to_cpu(params), _to_cpu(planes), xs.cpu())
    cos_dev = (n_card * n_cpu).sum(-1)
    f32 = dataclasses.replace(field.cfg, compute_dtype="float32")
    names = (field.geometry, field.material, field.bg_kind)
    an = REG.RegistryField(f32, *names, normal_type="analytic")
    fd = REG.RegistryField(f32, *names, normal_type="finite_difference", fd_normal_eps=0.05 * cell)
    with torch.no_grad():
        cos = torch.cat([(fd.normal(params, planes, x[s : s + REG_CHUNK])
                          * an.normal(params, planes, x[s : s + REG_CHUNK])).sum(-1)
                         for s in range(0, x.shape[0], REG_CHUNK)]).cpu()
    med, p10 = cos.median().item(), cos.quantile(0.1).item()
    log(f"# {what}: analytic normals card vs CPU plain over {xs.shape[0]} view samples: cos median "
        f"{cos_dev.median().item():.6f}, min {cos_dev.min().item():.6f}; cos(analytic, FD eps "
        f"{fd.fd_normal_eps:.3g}) with float32 MLPs over {x.shape[0]} view samples: median {med:.4f}, "
        f"10th percentile {p10:.4f}, min {cos.min().item():.4f}")
    if not (torch.isfinite(cos).all() and torch.isfinite(cos_dev).all()):
        raise RuntimeError(f"{what}: non-finite normals")
    if not cos_dev.min().item() > 0.999:
        raise RuntimeError(f"{what}: the card's analytic normals disagree with the plain versions "
                           f"(min cos {cos_dev.min().item()})")
    if not med > 0.9:
        raise RuntimeError(f"{what}: analytic normals disagree with finite differences (median cos {med})")
    return med, p10


def _capture_registry_step(trainer, field, state, data):
    """One registry step with every kernel wrapper's arguments recorded."""
    V, H, Wd = data["images"].shape[:3]
    with Capture() as cap:
        state, _ = registry_step(trainer, field, data)(
            state, batch=_batch(trainer, trainer.cfg.num_rays, V, H * Wd, SEED + 1))
    torch.cuda.synchronize()
    return state, cap.calls


def _voxel_rows(x, R_, bound):
    """The 8 corner rows of each point, (N, 8)."""
    _, q0, f = REG._voxel_cell(x, R_, bound)
    return torch.stack([REG._voxel_corner(q0, f, R_, c)[0] for c in REG._CORNERS_3D], -1)


def _voxel_rows_touched(x, R_, bound):
    return torch.unique(_voxel_rows(x, R_, bound)).numel()


def _corner_sharing(x, g, R_, bound):
    """Of the consecutive point pairs that both carry a cotangent, the share
    in one cell (every corner row the same: the runs K10's backward sums
    before its atomics) and the share with any corner row in common."""
    rows, live = _voxel_rows(x, R_, bound), (g != 0).any(-1)
    pair = live[1:] & live[:-1]
    same = ((rows[1:] == rows[:-1]).all(-1) & pair).sum().item()
    common = (torch.stack([(rows[1:] == rows[:-1, k : k + 1]).any(-1) for k in range(8)], -1).any(-1)
              & pair).sum().item()
    n = max(int(pair.sum()), 1)
    return same / n, common / n


def _volume_grid_lib(grid, x, R_, bound):
    """F.grid_sample's layout of the grid (1, CH, R, R, R) and the points
    (1, N, 1, 1, 3) in (z, y, x) order, for the library calls."""
    N, CH = x.shape[0], grid.shape[1]
    vol = grid.view(R_, R_, R_, CH).permute(3, 0, 1, 2).contiguous()[None]
    return vol, (x[:, [2, 1, 0]] / bound).reshape(1, N, 1, 1, 3).contiguous()


def _volume_grid_rows(calls):
    """K10 forward and backward on the captured step's arguments, held to
    the plain versions on the CPU (where x / bound is a true division, as in
    the kernel; torch on the card divides by a CPU scalar as a multiply by
    its reciprocal) and timed beside the plain versions on the card and
    F.grid_sample (5-D, border, align_corners) and its backward."""
    (grid, x, R_, bound), _ = calls["_sample_volume_grid_cuda"][0]
    N, CH = x.shape[0], grid.shape[1]
    got = REG._sample_volume_grid_cuda(grid, x, R_, bound)
    ref = REG.sample_volume_grid_plain(grid.cpu(), x.cpu(), R_, bound)
    err = (got.cpu() - ref).abs().max().item()
    if not torch.equal(got.cpu(), ref):
        raise RuntimeError(f"K10 differs from its plain version's bits (max|err| {err})")
    touched = _voxel_rows_touched(x, R_, bound)
    vol, coords = _volume_grid_lib(grid, x, R_, bound)

    def lib():
        return F.grid_sample(vol, coords, mode="bilinear", padding_mode="border", align_corners=True)

    lib_err = _rel(lib()[0, :, :, 0, 0].T, got)
    b, by = bound_ms(nbytes(x, got) + 4 * CH * touched, N * (40 + 16 * CH))
    rows = [dict(name="K10 sample_volume_grid", key="volume_grid", route="cuda",
                 source="trinerflet_tpu_torch/kernels/csrc/volume_grid.cu",
                 replaces="trinerflet_tpu/models/registry.py:68", max_abs_err=err,
                 tol="equal bit for bit to the plain version on the CPU",
                 ms=time_ms(lambda: REG._sample_volume_grid_cuda(grid, x, R_, bound)),
                 plain_ms=ref_ms(lambda: REG.sample_volume_grid_plain(grid, x, R_, bound)),
                 bound_ms=b, bound_by=by, library_ms=ref_ms(lib),
                 note=f"N={N} points, R={R_}, 1+F={CH} f32; {touched} of {R_ ** 3} rows touched; equal "
                      f"to the plain version on the CPU bit for bit; library F.grid_sample 5-D border "
                      f"align_corners (rel diff {lib_err:.2e})")]
    (g, grid, x, R_, bound, need_grid, need_x), _ = calls["_sample_volume_grid_backward_cuda"][0]
    gg, gx = REG._sample_volume_grid_backward_cuda(g, grid, x, R_, bound, True, True)
    rg, rx = REG.sample_volume_grid_backward_plain(g.cpu(), grid.cpu(), x.cpu(), R_, bound)
    err_g, err_x = _rel(gg.cpu(), rg), _rel(gx.cpu(), rx)
    if err_g > 1e-5 or err_x > 1e-5:
        raise RuntimeError(f"K10 backward off its plain version: grid {err_g}, x {err_x} (rel, tol 1e-5)")
    live = int((g != 0).any(-1).sum())
    same, common = _corner_sharing(x, g, R_, bound)
    b, by = bound_ms(nbytes(g, x) + 4 * R_ ** 3 * CH + (4 * CH * touched + 12 * N if need_x else 0),
                     live * 16 * CH * (2 if need_x else 1))
    g5 = g.float().T.reshape(1, CH, N, 1, 1).contiguous()

    def lib_bwd():
        return torch.ops.aten.grid_sampler_3d_backward(g5, vol, coords, 0, 1, True, [True, need_x])

    rows.append(dict(name="K10 sample_volume_grid backward", key="volume_grid_bwd", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/volume_grid.cu",
                     replaces="trinerflet_tpu/models/registry.py:68", max_abs_err=max(err_g, err_x),
                     tol="1e-5 of the largest gradient, against the plain version on the CPU",
                     ms=time_ms(lambda: REG._sample_volume_grid_backward_cuda(g, grid, x, R_, bound, need_grid,
                                                                              need_x)),
                     plain_ms=ref_ms(lambda: REG.sample_volume_grid_backward_plain(g, grid, x, R_, bound,
                                                                                    need_grid, need_x)),
                     bound_ms=b, bound_by=by, library_ms=ref_ms(lib_bwd),
                     note=f"the path's call (grid gradient {need_grid}, point gradient {need_x}); both "
                          f"outputs held (rel {err_g:.2e}, {err_x:.2e}); {live} of {N} points carry a "
                          f"cotangent; of consecutive pairs of them {same:.4f} share a cell and {common:.4f} "
                          f"a corner row (runs in one cell merged in a lane group's walk of 8 points); float4 "
                          f"atomics into {R_ ** 3} zeroed rows; "
                          f"library aten.grid_sampler_3d_backward"))
    return rows


def _volume_grid_x_rows(calls, xcalls):
    """K10's coordinate gradient alone (the analytic normal's call on a voxel
    grid): every call of the normal chunk ``xcalls`` held to the plain
    version on the CPU, then the call on the captured step's points and
    cotangents (``calls``) held the same way, equal to the point gradient of
    the both-outputs call, and timed beside the plain version and
    aten.grid_sampler_3d_backward with output mask [False, True]."""
    err = 0.0
    for (g, grid, x, R_, bound, need_grid, need_x), _ in xcalls["_sample_volume_grid_backward_cuda"]:
        if need_grid or not need_x:
            raise RuntimeError("the analytic normal's K10 backward asked for the grid gradient")
        got = REG._sample_volume_grid_backward_cuda(g, grid, x, R_, bound, False, True)[1]
        ref = REG.sample_volume_grid_backward_plain(g.cpu(), grid.cpu(), x.cpu(), R_, bound, False, True)[1]
        err = max(err, _rel(got.cpu(), ref))
    (g, grid, x, R_, bound, _, _), _ = calls["_sample_volume_grid_backward_cuda"][0]
    N, CH = x.shape[0], grid.shape[1]
    gx = REG._sample_volume_grid_backward_cuda(g, grid, x, R_, bound, False, True)[1]
    err = max(err, _rel(gx.cpu(), REG.sample_volume_grid_backward_plain(g.cpu(), grid.cpu(), x.cpu(), R_, bound,
                                                                        False, True)[1]))
    if err > 1e-5:
        raise RuntimeError(f"K10 coordinate gradient off its plain version: {err} (rel, tol 1e-5)")
    if not torch.equal(gx, REG._sample_volume_grid_backward_cuda(g, grid, x, R_, bound, True, True)[1]):
        raise RuntimeError("K10's point gradient alone differs from the both-outputs call's")
    live = (g != 0).any(-1)
    touched = _voxel_rows_touched(x[live], R_, bound)
    b, by = bound_ms(nbytes(g, x) + 4 * CH * touched + 12 * N, int(live.sum()) * 16 * CH)
    vol, coords = _volume_grid_lib(grid, x, R_, bound)
    g5 = g.float().T.reshape(1, CH, N, 1, 1).contiguous()

    def lib():
        return torch.ops.aten.grid_sampler_3d_backward(g5, vol, coords, 0, 1, True, [False, True])

    n_calls = len(xcalls["_sample_volume_grid_backward_cuda"])
    return [dict(name="K10 sample_volume_grid coordinate gradient", key="volume_grid_bwd", route="cuda",
                 source="trinerflet_tpu_torch/kernels/csrc/volume_grid.cu",
                 replaces="trinerflet_tpu/models/registry.py:68", max_abs_err=err,
                 tol="1e-5 of the largest entry, against the plain version on the CPU",
                 ms=time_ms(lambda: REG._sample_volume_grid_backward_cuda(g, grid, x, R_, bound, False, True)),
                 plain_ms=ref_ms(lambda: REG.sample_volume_grid_backward_plain(g, grid, x, R_, bound, False,
                                                                                True)),
                 bound_ms=b, bound_by=by, library_ms=ref_ms(lib),
                 note=f"dL/dx alone (no atomic), timed on the registry-grid step's N={N} points and "
                      f"cotangents ({int(live.sum())} live, {touched} rows touched); {n_calls} call(s) of "
                      f"an analytic-normal view chunk on the trained grid held too; equal to the "
                      f"both-outputs call's dL/dx; library aten.grid_sampler_3d_backward [False, True]")]


def _grid_normal_chunk(trainer, nerf_cfg, params, occ):
    """One 16,384-ray chunk of a view of the trained voxel grid under the
    diffuse material with analytic normals (K10's backward for dL/dx alone),
    the counts zeroed before it and read after it. Returns (launches,
    calls)."""
    an = REG.RegistryField(nerf_cfg, "volume-grid", "diffuse-with-point-light-material", "textured-background",
                           normal_type="analytic")
    kernels.reset_launches()
    calls = _capture_view_chunk(trainer, an, params, occ)
    launches = dict(kernels.launches)
    log(f"# registry-grid analytic-normal chunk: launches {launches}")
    return launches, calls


def _k11_errors(got, tex, d):
    """K11 against its plain version on the CPU: the largest error off the
    seam and the poles, at the poles (|d_y| / |d| > 0.999: acos's slope
    magnifies an ulp), and on the seam (phi within 1e-5 of 0 = 2 pi, either
    side's value); and the seam and pole masks (on the CPU)."""
    dc = d.cpu()
    ref = REG.background_textured_plain(tex.cpu(), dc)
    other = REG.background_textured_plain(tex.cpu(), dc * torch.tensor([-1.0, 1.0, 1.0]))
    phi = torch.atan2(dc[:, 0].double(), dc[:, 2].double()) + np.pi
    seam = (torch.minimum(phi, 2 * np.pi - phi) < 1e-5) & (dc[:, 2] < 0)
    pole = (dc[:, 1] / dc.norm(dim=-1)).abs() > 0.999
    err = (got.cpu() - ref).abs().amax(-1)
    err_seam = torch.minimum(err, (got.cpu() - other).abs().amax(-1))

    def mx(t, m):
        return t[m].max().item() if m.any() else 0.0

    return mx(err, ~seam & ~pole), mx(err, pole & ~seam), mx(err_seam, seam), seam, pole


def _texel_sharing(d, H, W, live=None):
    """How far K11's backward merges a warp's taps (32 consecutive rays, the
    4 taps apart): the share of the live rays' taps whose add another live
    lane of the warp makes for them (the same texel row at the same tap:
    1 - groups / taps), the (warp, tap, row) groups, each one float2 and one
    scalar atomic, and the taps."""
    warp = torch.arange(d.shape[0], device=d.device) // 32
    live = torch.ones(d.shape[0], dtype=torch.bool, device=d.device) if live is None else live
    groups = taps = 0
    for rows, _ in REG._texel_taps(d, H, W):
        key = (warp * (H * W) + rows)[live]
        groups += torch.unique(key).numel()
        taps += key.numel()
    return 1.0 - groups / max(taps, 1), groups, taps


def _k11_fwd_row(tex, d, name, what):
    """K11 forward on (tex, d) held to its plain version on the CPU and timed
    beside the plain version and a 2-D F.grid_sample of the texture at the
    same texel coordinates, which computes less (no direction arithmetic,
    no sigmoid)."""
    H, W = tex.shape[:2]
    N = d.shape[0]
    got = REG._background_textured_cuda(tex, d)
    e_main, e_pole, e_seam, seam, pole = _k11_errors(got, tex, d)
    if e_main > 1e-4 or e_pole > 1e-3 or e_seam > 1e-4:
        raise RuntimeError(f"K11 off its plain version ({what}): {e_main} (tol 1e-4), poles {e_pole} "
                           f"(1e-3), seam {e_seam} (1e-4)")
    taps = REG._texel_taps(d, H, W)
    touched = torch.unique(torch.cat([r for r, _ in taps])).numel()
    dn = d / d.norm(dim=-1, keepdim=True)
    v = torch.clamp(torch.acos(torch.clamp(dn[:, 1], -1, 1)) / np.pi * (H - 1), 0, H - 1)
    u = torch.clamp((torch.atan2(dn[:, 0], dn[:, 2]) + np.pi) / (2 * np.pi) * (W - 1), 0, W - 1)
    coords = torch.stack([u / (W - 1) * 2 - 1, v / (H - 1) * 2 - 1], -1).reshape(1, N, 1, 2).contiguous()
    img = tex.permute(2, 0, 1).contiguous()[None]

    def lib():
        return F.grid_sample(img, coords, mode="bilinear", padding_mode="border", align_corners=True)

    b, by = bound_ms(nbytes(d, got) + 12 * touched, N * 80)
    row = with_floor(dict(name=name, key="textured_bg", route="cuda",
                          source="trinerflet_tpu_torch/kernels/csrc/textured_bg.cu",
                          replaces="trinerflet_tpu/models/registry.py:204", max_abs_err=max(e_main, e_seam),
                          tol="1e-4 (acosf/atan2f ulps times the texel slope; 1e-3 within 2.6 degrees of "
                              "a pole; either side of the seam)",
                          ms=time_ms(lambda: REG._background_textured_cuda(tex, d)),
                          plain_ms=ref_ms(lambda: REG.background_textured_plain(tex, d)),
                          bound_ms=b, bound_by=by, library_ms=ref_ms(lib),
                          note=f"{what}: N={N} rays, {H}x{W} texture ({touched} texels touched); "
                               f"{int(seam.sum())} rays on the seam, {int(pole.sum())} near a pole "
                               f"(max|err| {e_pole:.2e}); a thread per ray; library "
                               f"F.grid_sample 2-D at precomputed texel coordinates, no sigmoid"))
    return row, got, seam, pole, (img, coords)


def _textured_bg_rows(calls):
    """K11 forward and backward on the captured step's arguments, held to the
    plain versions on the CPU and timed beside the plain versions on the
    card and a 2-D F.grid_sample of the texture (and its backward)."""
    (tex, d), _ = calls["_background_textured_cuda"][0]
    N = d.shape[0]
    row, got, seam, pole, (img, coords) = _k11_fwd_row(tex, d, "K11 background_textured", "the step's rays")
    rows = [row]
    (g, s, d, H, W), _ = calls["_background_textured_backward_cuda"][0]
    gz = torch.where((seam | pole).to(g.device)[:, None], 0.0, g)  # rays whose taps may differ
    gt = REG._background_textured_backward_cuda(gz, s, d, H, W)
    err = _rel(gt.cpu(), REG.background_textured_backward_plain(gz.cpu(), s.cpu(), d.cpu(), H, W))
    if err > 1e-5:
        raise RuntimeError(f"K11 backward off its plain version: {err} (rel, tol 1e-5)")
    gpre = (g * (s * (1 - s))).T.reshape(1, 3, N, 1).contiguous()

    def lib_bwd():
        return torch.ops.aten.grid_sampler_2d_backward(gpre, img, coords, 0, 1, True, [True, False])

    live = ((g * (s * (1 - s))) != 0).any(-1)
    share, groups, taps = _texel_sharing(d, H, W, live)
    b, by = bound_ms(nbytes(g, s, d) + 12 * H * W, N * 90)
    rows.append(with_floor(dict(
        name="K11 background_textured backward", key="textured_bg_bwd", route="cuda",
        source="trinerflet_tpu_torch/kernels/csrc/textured_bg.cu",
        replaces="trinerflet_tpu/models/registry.py:204", max_abs_err=err,
        tol="1e-5 of the largest gradient (seam and pole rays without cotangent)",
        ms=time_ms(lambda: REG._background_textured_backward_cuda(g, s, d, H, W)),
        plain_ms=ref_ms(lambda: REG.background_textured_backward_plain(g, s, d, H, W)),
        bound_ms=b, bound_by=by, library_ms=ref_ms(lib_bwd),
        note=f"one cooperative launch: the {H}x{W}x3 gradient zeroed, one grid.sync, then each "
             f"warp's taps merged by texel row and added with a float2 and a scalar atomic; "
             f"{int(live.sum())} of {N} rays live, {share:.4f} of their {taps} taps merged into "
             f"another lane's add of the same row ({groups} adds); library aten.grid_sampler_2d_backward "
             f"of the precomputed sigmoid cotangent")))
    return rows


def _textured_bg_view_rows(xcalls):
    """K11 forward on one camera's 16,384 rays (the analytic-normal chunk's
    background call), held and timed as on the step; its note gives the
    share of a warp's taps merged into another lane's add on those rays."""
    (tex, d), _ = xcalls["_background_textured_cuda"][0]
    H, W = tex.shape[:2]
    row = _k11_fwd_row(tex, d, "K11 background_textured (view chunk)", "one camera's view chunk")[0]
    share, groups, taps = _texel_sharing(d, H, W)
    row["note"] += (f"; in a backward on these rays {share:.4f} of the {taps} taps would merge into "
                    f"another lane's add of the same row ({groups} adds)")
    return [row]


def _k7x_rows(calls, k7_ms=None):
    """K7x on the first captured chunk's arguments: every captured call held
    to its plain version on the card (bit for bit at C <= 2, where the
    channel sum has one order; else within 1e-5 of the largest entry), the
    first timed beside the K7 forward's time on the same chunk."""
    err, equal = 0.0, True
    for (args, _) in calls["_grid_encode_backward_x_cuda"]:
        got, ref = GE._grid_encode_backward_x_cuda(*args), GE.grid_encode_backward_x_plain(*args)
        err = max(err, _rel(got, ref))
        equal = equal and torch.equal(got, ref)
    (g, tables, x, cfg, bound), _ = calls["_grid_encode_backward_x_cuda"][0]
    if err > 1e-5:
        raise RuntimeError(f"K7x off its plain version: {err} (rel, tol 1e-5)")
    if cfg.level_dim <= 2 and not equal:
        raise RuntimeError(f"K7x off its plain version's bits at C={cfg.level_dim} (rel {err})")
    N, L, C = x.shape[0], cfg.num_levels, cfg.level_dim
    touched = _touched_rows(x, cfg, bound)
    b, by = bound_ms(nbytes(g, x) + 12 * N + 4 * C * touched, N * L * (30 + 8 * (2 * C + 8)))
    k7 = f"; the K7 forward on the same chunk {k7_ms:.4f} ms" if k7_ms is not None else ""
    return [dict(name="K7x grid_encode coordinate gradient", key="grid_encode_bwd_x", route="cuda",
                 source="trinerflet_tpu_torch/kernels/csrc/gridencoder.cu",
                 replaces="trinerflet_tpu/models/gridencoder.py:115", max_abs_err=err,
                 tol="the plain version's bits at C <= 2, else 1e-5 of the largest entry",
                 ms=time_ms(lambda: GE._grid_encode_backward_x_cuda(g, tables, x, cfg, bound)),
                 plain_ms=ref_ms(lambda: GE.grid_encode_backward_x_plain(g, tables, x, cfg, bound)),
                 bound_ms=b, bound_by=by, library_ms=None,
                 note=f"N={N} points x {L} levels of C={C}; {touched} table rows touched; "
                      f"{len(calls['_grid_encode_backward_x_cuda'])} call(s) of one view chunk held "
                      f"({'bit for bit' if equal else 'within 1e-5'}); a thread per point over the "
                      f"levels{k7}; library: none (no single call)")]


def _capture_view_chunk(trainer, field, params, occ):
    """The first chunk of the view with every kernel wrapper's arguments
    recorded."""
    intr = synthetic_intrinsics(VIEW_HW, VIEW_HW)
    ro, rd = rays_full_image(orbit_pose(np.arccos(1 - 1.6 * 0.5 / 8), 0.0, 2.0), intr, VIEW_HW, VIEW_HW)
    s = VIEW_HW * VIEW_HW // 2 - REG_CHUNK // 2
    ro, rd = torch.from_numpy(ro[s : s + REG_CHUNK]).to(DEVICE), torch.from_numpy(rd[s : s + REG_CHUNK]).to(DEVICE)
    with Capture() as cap, torch.no_grad():
        planes = field.build_planes(params)
        R.render_occgrid(lambda x, d: field(params, planes, x, d), ro, rd, occ.occ, trainer.eval_render_cfg,
                         bg_fn=lambda sph, d: field.background(params, d), occ_coarse=occ.occ_coarse,
                         occ_bbox=occ.bbox)
    torch.cuda.synchronize()
    return cap.calls


def registry_grid_phase(scene, card):
    """volume-grid (JAX's default VolumeGridConfig: R = 64, F = 15),
    neural-radiance-material and textured-background (64 x 128) behind
    bg_fn: 64 + 50 steps on a full grid, one 800^2 view, a captured step's
    rows (K10, K11, and the path's march and compositor), the step check."""
    nerf_cfg, render_cfg, train_cfg = registry_configs()
    trainer = Trainer(nerf_cfg, render_cfg, train_cfg, device=DEVICE)
    init_fn, field = REG.make_field(nerf_cfg, "volume-grid", "neural-radiance-material", "textured-background")
    state = registry_state(init_fn, full_occupancy(render_cfg))
    log(f"# registry-grid: voxel grid {tuple(state.params['encoder']['grid'].shape)} f32 "
        f"({nbytes(state.params['encoder']['grid']) / 1e6:.1f} MB), texture "
        f"{tuple(state.params['bg_texture'].shape)}; params {sorted(state.params)}")
    data = trainer.scene_to_device(scene)
    what = "registry-grid train"
    state, launches, stats = registry_train(trainer, field, state, data, card, what, REG_GRID_KERNELS,
                                            REG_GRID_ABSENT)
    ms, _, _ = registry_view(trainer, field, state.ema_params, state.occ, card, "registry-grid",
                             REG_GRID_VIEW_KERNELS)
    state = profile_step(trainer, state, data, "registry-grid train", step=registry_step(trainer, field, data))
    state, calls = _capture_registry_step(trainer, field, state, data)
    rows = (label_rows(_volume_grid_rows(calls) + _textured_bg_rows(calls), launches, what)
            + path_kernel_rows(trainer, calls, launches, what))
    xlaunches, xcalls = _grid_normal_chunk(trainer, nerf_cfg, state.ema_params, state.occ)
    rows += label_rows(_volume_grid_x_rows(calls, xcalls) + _textured_bg_view_rows(xcalls), xlaunches,
                       "registry-grid analytic-normal chunk")
    del calls, xcalls
    step_check(trainer, state, data, "registry-grid", loss_fn=registry_loss_fn(field))
    return rows, dict(stats, launches=launches, view_ms=ms)


def _sdf_rows(trainer, calls, launches, what):
    """The registry-sdf step's rows: K2 forward and backward at the field's
    points and at the finite-difference stencil's (three points per sample),
    K4 forward over the step's ladder, and the path's march, adjoint and
    compositor (``path_kernel_rows``)."""
    first = {}  # one K2 call of each size: the field's points, the stencil
    for i, ((planes, xyz, lb), _) in enumerate(calls["_sample_points_cuda"]):
        first.setdefault(xyz.shape[0], i)
    M = min(first)
    rows = []
    for m, i in sorted(first.items()):
        planes, xyz, lb = calls["_sample_points_cuda"][i][0]
        rows += _sample_fwd_rows(planes, xyz, lb, " (FD stencil)" if m > M else " (field points)")
    bwd = {}
    for i, ((g, xyz, *_), _) in enumerate(calls["_sample_points_backward_cuda"]):
        bwd.setdefault(xyz.shape[0], i)
    for m, i in sorted(bwd.items()):
        rows += _sample_bwd_rows(calls, i, " (FD stencil)" if m > M else " (field points)")
    tcfg = trainer.nerf_cfg.triplane
    levels = [_k4_level(yl, yh, name)[1] for (yl, yh, name), _ in calls["_idwt2d_cuda"][: tcfg.levels]]
    rows.append(_k4_row(levels, "K4 idwt2d", f"the step's ladder, sum over the {len(levels)} levels "))
    return label_rows(rows, launches, what) + path_kernel_rows(
        trainer, calls, launches, what, only=("_march_cuda", "_idwt2d_adjoint_cuda", "_composite_cuda"))


def registry_sdf_phase(scene, card):
    """implicit-sdf on bench's triplane, diffuse-with-point-light-material
    with finite-difference normals, the env-map background: 64 + 50 steps
    on a full grid, a captured step's rows, the step check on the initial
    parameters (held with float32 MLPs, read with bf16 ones); then one 800^2
    view with analytic normals under no_grad (K2x without a plane
    gradient), the K2x row of a captured chunk, and the normals' checks."""
    nerf_cfg, render_cfg, train_cfg = registry_configs()
    trainer = Trainer(nerf_cfg, render_cfg, train_cfg, device=DEVICE)
    names = ("implicit-sdf", "diffuse-with-point-light-material", "neural-environment-map-background")
    init_fn, field = REG.make_field(nerf_cfg, *names, normal_type="finite_difference")
    state = registry_state(init_fn, full_occupancy(render_cfg))
    initial = _snapshot(state)
    data = trainer.scene_to_device(scene)
    what = "registry-sdf train"
    state, launches, stats = registry_train(trainer, field, state, data, card, what, REG_SDF_KERNELS,
                                            REG_SDF_ABSENT)
    state, calls = _capture_registry_step(trainer, field, state, data)
    rows = _sdf_rows(trainer, calls, launches, what)
    del calls
    # the check is held with the MLPs in float32: the finite-difference
    # normal divides the bf16 MLPs' rounding, which the card and the CPU may
    # flip, by eps; the bf16 field's readings on SDF_BF16_BATCHES batches are logged
    # beside it; diffuse shading reads no colour net (its gradient is 0)
    f32 = dataclasses.replace(nerf_cfg, compute_dtype="float32")
    step_check(Trainer(f32, render_cfg, train_cfg, device=DEVICE), initial, data,
               "registry-sdf (initial field, float32 MLPs)", unused=("color_net",),
               loss_fn=registry_loss_fn(REG.RegistryField(f32, *names, normal_type="finite_difference")))
    bf16 = [step_check(trainer, initial, data, f"registry-sdf (initial field, bf16 MLPs, batch {k})",
                       unused=("color_net",), loss_fn=registry_loss_fn(field), seed=SEED + 2 + k, hold=False)
            for k in range(SDF_BF16_BATCHES)]
    log(f"# registry-sdf bf16 step check readings (not held): largest gradient rel L2 per batch "
        f"{[float(f'{max(e.values()):.3e}') for _, e in bf16]}, loss rel {[float(f'{l:.2e}') for l, _ in bf16]}")
    an = REG.RegistryField(nerf_cfg, *names, normal_type="analytic")
    vwhat = "registry-sdf analytic view"
    ms, vlaunches, x = registry_view(trainer, an, state.params, state.occ, card, "registry-sdf analytic",
                                     REG_SDF_VIEW_KERNELS)
    calls = _capture_view_chunk(trainer, an, state.params, state.occ)
    rows += label_rows(_sample_xyz_rows(calls, lambda planes: " (analytic normals)"), vlaunches, vwhat)
    del calls
    with torch.no_grad():
        planes = an.build_planes(state.params)
    cell = 2 * nerf_cfg.bound / (nerf_cfg.triplane.resolution - 1)
    med, p10 = normal_checks(an, state.params, planes, x, cell, "registry-sdf normals")
    return rows, dict(stats, launches=launches, view_ms=ms, view_launches=vlaunches, cos_median=med,
                      cos_p10=p10)


def registry_hash_phase(card, hash_stats):
    """The hash-grid phase's trained field (its EMA parameters and
    occupancy) under diffuse-with-point-light-material with analytic
    normals: one 800^2 view under no_grad (K7 and K7x), the K7 and K7x rows
    of a captured chunk, the cosine of analytic and FD normals."""
    nerf_cfg, render_cfg, train_cfg = hashgrid_configs()
    trainer = Trainer(nerf_cfg, render_cfg, train_cfg, device=DEVICE)
    names = ("implicit-volume", "diffuse-with-point-light-material", "solid-color-background")
    an = REG.RegistryField(nerf_cfg, *names, normal_type="analytic")
    params, occ = hash_stats["params"], hash_stats["occ"]
    params = TR._map(lambda t: t.requires_grad_(True), params)  # as a training state holds them
    ms, launches, x = registry_view(trainer, an, params, occ, card, "registry-hash-normals",
                                    REG_HASH_VIEW_KERNELS)
    calls = _capture_view_chunk(trainer, an, params, occ)
    fwd = _grid_encode_fwd_rows(calls)
    rows = label_rows(fwd + _k7x_rows(calls, fwd[0]["ms"]), launches, "registry-hash-normals view")
    del calls
    grid = grid_config(nerf_cfg.encoding, grid_cfg=nerf_cfg.grid)
    cell = 2 * nerf_cfg.bound / grid.level_resolution(grid.num_levels - 1)
    med, p10 = normal_checks(an, params, {}, x, cell, "registry-hash-normals")
    return rows, dict(view_ms=ms, launches=launches, cos_median=med, cos_p10=p10)


# ---------------------------------------------------------------------------
# Training through analytic normals: the samplers' second derivatives K2x²
# (the SDF on bench's triplane), K7x² (the hash grid) and K10² (the voxel
# grid), each field trained with the loss differentiated through its normal
# ---------------------------------------------------------------------------

ANALYTIC_WARM, ANALYTIC_WINDOW = 32, 32  # 32 warm-up steps, one timed window of 32
ANALYTIC_CHECK_RAYS = 1024               # the step checks' rays (the CPU side runs every plain version)
REG_SDF_AN_KERNELS = ("grid_sample", "grid_sample_bwd", "grid_sample_bwd_xyz", "grid_sample_bwd_xyz_bwd", "idwt",
                      "idwt_adjoint", "march", "composite", "composite_bwd")
REG_HASH_AN_KERNELS = ("grid_encode", "grid_encode_bwd", "grid_encode_bwd_x", "grid_encode_bwd_x_bwd", "march",
                       "composite", "composite_bwd")
REG_GRID_AN_KERNELS = ("volume_grid", "volume_grid_bwd", "volume_grid_bwd_x_bwd", "march", "composite",
                       "composite_bwd")
REG_AN_ABSENT = ("occupancy", "march_flat")  # the full grid needs no refresh


def _cpu(args):
    """The arguments with every tensor (also in a list) copied to the CPU."""
    def one(a):
        if torch.is_tensor(a):
            return a.cpu()
        if isinstance(a, list):
            return [one(t) for t in a]
        return a
    return [one(a) for a in args]


def _second_order_err(got, ref):
    """The largest error of each output (None where neither has one), as a
    fraction of the plain version's largest entry; tensors or lists of
    them."""
    errs = []
    for a, b in zip(got, ref):
        if (a is None) != (b is None):
            raise RuntimeError("a second-order kernel and its plain version returned different outputs")
        if a is None:
            continue
        if isinstance(a, list):
            a, b = torch.cat([t.reshape(-1) for t in a]), torch.cat([t.reshape(-1) for t in b])
        errs.append(_rel(a.cpu(), b.cpu()))
    return errs


def _k2xx_library(planes, xyz, g, gg, lb):
    """``autograd.grad`` twice through ``F.grid_sample`` (bilinear, border,
    align_corners) on the same planes in NCHW and the same points: the
    first-order gradient in the points with ``create_graph=True``, then its
    gradient along gg in (planes, points, cotangent). Returns (a function
    that runs both, its dL/dg in the port's (M, 3, C) layout)."""
    p_nchw = planes.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    g_nchw = g.permute(1, 2, 0)[..., None].to(planes.dtype).contiguous().requires_grad_(True)  # (3, C, M, 1)

    def run():
        x = xyz.detach().requires_grad_(True)
        grid = GS.project_to_planes(x, lb)[:, :, None, :].to(planes.dtype)
        out = F.grid_sample(p_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)
        (gx,) = torch.autograd.grad(out, x, g_nchw, create_graph=True)
        return torch.autograd.grad(gx, [p_nchw, x, g_nchw], gg)

    return run, run()[2][..., 0].permute(2, 0, 1)


def _k2xx_rows(calls):
    """K2x² on the captured step's call, as the step asked it (the normal's
    planes are built from the parameters, its points are not): every output
    held to the plain version on the CPU (dL/dg and dL/dxyz within 1e-5 of
    their largest entries, the plane gradient as the K2 backward's: 1e-5 in
    f32, one bf16 ulp, 2^-7, in bf16), the plane gradient the same bits on a
    second call; timed beside its bound, the plain version on the card and
    the library's double backward."""
    args, _ = calls["_sample_points_backward_xyz_backward_cuda"][0]
    gg, ggp, planes, xyz, g, lb, wants = args
    got = GS._sample_points_backward_xyz_backward_cuda(*args)
    again = GS._sample_points_backward_xyz_backward_cuda(*args)
    ref = GS.sample_points_backward_xyz_backward_plain(*_cpu(args))
    errs = _second_order_err(got, ref)
    tol_p = 1e-5 if planes.dtype == torch.float32 else 2.0**-7
    dp = got[0]
    if dp is not None and (not torch.equal(dp, again[0]) or errs[0] > tol_p):
        raise RuntimeError(f"K2x² plane gradient off its plain version ({errs[0]}) or not the same bits twice")
    if max(errs[1 if dp is not None else 0 :], default=0.0) > 1e-5:
        raise RuntimeError(f"K2x² off its plain version: {errs} (rel, tol 1e-5)")
    _, H, Wd, C = planes.shape
    M = xyz.shape[0]
    # the (plane, point) rows gg reaches: gg has a component along the
    # plane's axes, (x, z), (x, y) and (y, z); no other row needs g or a
    # corner (its derivative weights are zero)
    nz = gg != 0
    live = torch.stack([nz[:, 0] | nz[:, 2], nz[:, 0] | nz[:, 1], nz[:, 1] | nz[:, 2]])  # (3, M)
    n_live, n_pts = int(live.sum()), int(live.any(0).sum())
    touched = _touched_texels(GS.project_to_planes(xyz, lb), H, Wd, live)
    # in: gg, the live points, g and the corner texels of the live rows (and
    # gg_P where given); out: dL/dg, dL/dxyz when asked, the plane gradient
    # once; per live row ~26 C + 40 f32 operations (dL/dg 8 C, h 4 C, the
    # four weighted corner terms 8 C ...)
    out_bytes = sum(nbytes(t) for t in got if t is not None)
    in_bytes = (nbytes(gg) + n_pts * 3 * xyz.element_size() + n_live * C * g.element_size()
                + touched * C * planes.element_size() + (nbytes(ggp) if ggp is not None else 0))
    b, by = bound_ms(in_bytes + out_bytes, n_live * (26 * C + 40))
    note_lib = ""
    try:
        lib, lgr = _k2xx_library(planes, xyz, g, gg, lb)
        lib_ms = ref_ms(lib)
        note_lib = (f"library autograd.grad twice through F.grid_sample (NCHW {planes.dtype}, its first-order "
                    f"pass with create_graph included; coordinates rounded to {planes.dtype}): rel diff "
                    f"{_rel(lgr.float(), got[2]):.2e} (dL/dg)")
    except RuntimeError as e:  # a torch without grid_sampler's double backward
        lib_ms, note_lib = None, f"library: none ({str(e).splitlines()[0][:120]})"
    return [dict(name="K2x² sample_planes second derivative", key="grid_sample_bwd_xyz_bwd", route="cuda",
                 source="trinerflet_tpu_torch/kernels/csrc/grid_sample.cu",
                 replaces="trinerflet_tpu/ops/grid_sample.py:23 (autodiff of grid_sample_2d twice, via "
                          "models/registry.py:443 under jax.value_and_grad)",
                 max_abs_err=max(errs), tol="dL/dg, dL/dxyz 1e-5 x max; planes 2^-7 (bf16) or 1e-5 (f32) x max",
                 ms=time_ms(lambda: GS._sample_points_backward_xyz_backward_cuda(*args)),
                 plain_ms=ref_ms(lambda: GS.sample_points_backward_xyz_backward_plain(*args)),
                 bound_ms=b, bound_by=by, library_ms=lib_ms,
                 note=f"M={M} points on {tuple(planes.shape)} {planes.dtype} planes; asked for (planes, points, "
                      f"cotangent) {tuple(wants)}; gg reaches {n_live} of {3 * M} (plane, point) rows of {n_pts} "
                      f"points ({int((g != 0).any(-1).sum())} rows carry a g), {touched} touched texels; rel err {[float(f'{e:.2e}') for e in errs]}; a first pass "
                      f"for dL/dg (and dL/dxyz) that bins the rows gg reaches, then the K2 backward's other five "
                      f"passes with the weights' derivatives for the plane gradient (the same bits on a second "
                      f"call); {note_lib}")]


def _k7xx_rows(calls):
    """K7x² on the captured step's call: every output held to the plain
    version on the card (which rounds the cell coordinate as the kernel does,
    as K7's rows hold it; dL/dg and dL/dx within 1e-5 of their largest
    entries, the table gradient, float atomics in an unspecified order,
    likewise) and timed beside its bound and the plain version; no single
    library call computes it."""
    args, _ = calls["_grid_encode_backward_x_backward_cuda"][0]
    gg, ggt, x, g, tables, cfg, bound, wants = args
    got = GE._grid_encode_backward_x_backward_cuda(*args)
    ref = GE.grid_encode_backward_x_backward_plain(*args)
    errs = _second_order_err(got, ref)
    if max(errs) > 1e-5:
        raise RuntimeError(f"K7x² off its plain version: {errs} (rel, tol 1e-5)")
    N, L, C = x.shape[0], cfg.num_levels, cfg.level_dim
    # the points gg reaches (A = gg clip'(u) not zero); no other point needs
    # g or a table row
    mask = ((gg * GE._clip_grad(GE._unit_coord(x, bound), 1.0)) != 0).any(-1)
    live, n_pts = int(mask.sum()), int((gg != 0).any(-1).sum())
    touched = _touched_rows(x[mask], cfg, bound)
    out_bytes = sum(nbytes(*t) if isinstance(t, list) else nbytes(t) for t in got if t is not None)
    in_bytes = nbytes(gg) + n_pts * 3 * x.element_size() + live * L * C * g.element_size() + 4 * C * touched
    b, by = bound_ms(in_bytes + out_bytes, live * L * 8 * (40 + 8 * C))
    return [dict(name="K7x² grid_encode second derivative", key="grid_encode_bwd_x_bwd", route="cuda",
                 source="trinerflet_tpu_torch/kernels/csrc/gridencoder.cu",
                 replaces="trinerflet_tpu/models/gridencoder.py:115-147 (autodiff of grid_encode twice, via "
                          "models/registry.py:443 under jax.value_and_grad)",
                 max_abs_err=max(errs), tol="1e-5 of each output's largest entry, against the plain version",
                 ms=time_ms(lambda: GE._grid_encode_backward_x_backward_cuda(*args)),
                 plain_ms=ref_ms(lambda: GE.grid_encode_backward_x_backward_plain(*args)),
                 bound_ms=b, bound_by=by, library_ms=None,
                 note=f"N={N} points x {L} levels of C={C} ({cfg.interpolation}); asked for (points, "
                      f"cotangent, tables) {tuple(wants)}; gg reaches {live} points ({n_pts} with gg != 0); "
                      f"{touched} table rows touched there; rel err {[float(f'{e:.2e}') for e in errs]}; a block per 128 points, "
                      f"their live points in tiles of 32, a warp a level, the table gradient merged across the "
                      f"warp and added by float2 / float4 atomics; library: none (no single PyTorch call "
                      f"computes a hash grid's second derivative)")]


def _k10xx_rows(calls):
    """K10² on the captured step's call: every output held to the plain
    version on the CPU (where x / bound is a true division, as in the
    kernel; dL/dg and dL/dx within 1e-5 of their largest entries, the grid
    gradient likewise) and timed beside its bound, the plain version and
    F.grid_sample 5-D differentiated twice."""
    args, _ = calls["_sample_volume_grid_backward_x_backward_cuda"][0]
    gg, ggg, grid, x, g, R_, bound, wants = args
    got = REG._sample_volume_grid_backward_x_backward_cuda(*args)
    ref = REG.sample_volume_grid_backward_x_backward_plain(*_cpu(args))
    errs = _second_order_err(got, ref)
    if max(errs) > 1e-5:
        raise RuntimeError(f"K10² off its plain version: {errs} (rel, tol 1e-5)")
    N, CH = x.shape[0], grid.shape[1]
    live = (gg != 0).any(-1)
    touched = _voxel_rows_touched(x[live], R_, bound)
    out_bytes = sum(nbytes(t) for t in got if t is not None)
    in_bytes = nbytes(gg, x[live], g[live]) + 4 * CH * touched  # x and g of the points gg reaches
    b, by = bound_ms(in_bytes + out_bytes, int(live.sum()) * 8 * (8 * CH + 20))
    vol, coords = _volume_grid_lib(grid, x, R_, bound)
    g5 = g.float().T.reshape(1, CH, N, 1, 1).contiguous()
    gg5 = (gg[:, [2, 1, 0]] * (1.0 / bound)).reshape(1, N, 1, 1, 3)  # along the library's (z, y, x) / bound

    def lib():
        v = vol.detach().requires_grad_(True)
        c = coords.detach().requires_grad_(True)
        gv = g5.detach().requires_grad_(True)
        out = F.grid_sample(v, c, mode="bilinear", padding_mode="border", align_corners=True)
        (gc,) = torch.autograd.grad(out, c, gv, create_graph=True)
        return torch.autograd.grad(gc, [v, c, gv], gg5)

    try:
        lib()
        lib_ms, note_lib = ref_ms(lib), ("library F.grid_sample 5-D border align_corners, autograd.grad twice "
                                        "(its first-order pass with create_graph included)")
    except RuntimeError as e:
        lib_ms, note_lib = None, f"library: none ({str(e).splitlines()[0][:120]})"
    return [dict(name="K10² sample_volume_grid second derivative", key="volume_grid_bwd_x_bwd", route="cuda",
                 source="trinerflet_tpu_torch/kernels/csrc/volume_grid.cu",
                 replaces="trinerflet_tpu/models/registry.py:68 (autodiff of sample_volume_grid twice, via "
                          ":443 under jax.value_and_grad)",
                 max_abs_err=max(errs), tol="1e-5 of each output's largest entry, against the plain version on "
                                            "the CPU",
                 ms=time_ms(lambda: REG._sample_volume_grid_backward_x_backward_cuda(*args)),
                 plain_ms=ref_ms(lambda: REG.sample_volume_grid_backward_x_backward_plain(*args)),
                 bound_ms=b, bound_by=by, library_ms=lib_ms,
                 note=f"N={N} points, R={R_}, 1+F={CH} f32; asked for (grid, points, cotangent) {tuple(wants)}; "
                      f"{int(live.sum())} points carry a cotangent, {touched} rows touched; rel err "
                      f"{[float(f'{e:.2e}') for e in errs]}; a block per span of 192 points, the points gg "
                      f"reaches compacted in order, a lane group a live point, then a lane group a run of them in "
                      f"one cell summing it before its float4 atomics, the dead points' zeros written as coalesced "
                      f"slabs; the grid gradient zeroed by a torch.zeros_like launch; {note_lib}")]


def _no_inner_param_pass(calls, what, kind):
    """The normal's inner gradient (in the points alone) ran no plane, table
    or grid gradient: on the SDF every K2x call asked for none; on the hash
    grid the step's K7 table-gradient calls are as many as its K7 forward
    calls (one per sampling the loss reaches, none from the normal's
    gradient); on the voxel grid every K10 backward asked for one output."""
    if kind == "k2x":
        bad = [kw for _, kw in calls["_sample_points_backward_xyz_cuda"] if kw.get("planes_grad", True)]
        ok = calls["_sample_points_backward_xyz_cuda"] and not bad
    elif kind == "k7x":
        ok = len(calls["_grid_encode_backward_cuda"]) == len(calls["_grid_encode_cuda"])
    else:
        ok = all(not (a[5] and a[6]) for a, _ in calls["_sample_volume_grid_backward_cuda"])
    if not ok:
        raise RuntimeError(f"{what}: the analytic normal's inner gradient ran a parameter-gradient pass")
    log(f"# {what}: the captured step's sampler calls "
        f"{ {k: len(v) for k, v in calls.items() if v} }; the normal's inner gradient ran no parameter-gradient "
        f"pass")


def analytic_phase(scene, card, what, configs, names, required, rows_fn, inner, field_kw=None):
    """One field trained through its analytic normals: ``train_phase`` with
    ``registry_step`` (32 warm-up steps, one window of 32; the loss must
    fall), ``required`` launched; one step under the profiler; a captured
    step's second-order row (``rows_fn``) and the check that the normal's
    inner gradient ran no parameter-gradient pass (``inner``, as
    ``_no_inner_param_pass`` takes it); the step check on the initial
    parameters with float32 MLPs."""
    field_kw = field_kw or {}
    nerf_cfg, render_cfg, train_cfg = configs
    trainer = Trainer(nerf_cfg, render_cfg, train_cfg, device=DEVICE)
    init_fn, field = REG.make_field(nerf_cfg, *names, normal_type="analytic", **field_kw)
    state = registry_state(init_fn, full_occupancy(render_cfg))
    initial = _snapshot(state)
    data = trainer.scene_to_device(scene)
    step = registry_step(trainer, field, data)
    twhat = f"{what} train"
    state, launches, stats = train_phase(trainer, state, data, card, warm=ANALYTIC_WARM, n_windows=1,
                                         window_steps=ANALYTIC_WINDOW, required=required, what=twhat,
                                         absent=REG_AN_ABSENT, step=step, refresh=False)
    state = profile_step(trainer, state, data, twhat, step=step)
    state, calls = _capture_registry_step(trainer, field, state, data)
    _no_inner_param_pass(calls, twhat, inner)
    rows = label_rows(rows_fn(calls), launches, twhat)
    del calls
    f32 = dataclasses.replace(nerf_cfg, compute_dtype="float32")
    t0 = time.perf_counter()
    _, errs = step_check(Trainer(f32, render_cfg, train_cfg, device=DEVICE), initial, data,
                         f"{what} (initial field, float32 MLPs)", n_rays=ANALYTIC_CHECK_RAYS, unused=("color_net",),
                         loss_fn=registry_loss_fn(REG.RegistryField(f32, *names, normal_type="analytic", **field_kw)))
    return rows, dict(stats, launches=launches, check_s=time.perf_counter() - t0, check_err=max(errs.values()))


def registry_sdf_analytic_phase(scene, card):
    """implicit-sdf on bench's triplane (1024^2 x 16 bf16), the diffuse
    material with analytic normals and the env map, trained through the
    normals: K2x² (its plane gradient the K2 backward's binned passes)."""
    return analytic_phase(scene, card, "registry-sdf-analytic", registry_configs(),
                          ("implicit-sdf", "diffuse-with-point-light-material", "neural-environment-map-background"),
                          REG_SDF_AN_KERNELS, _k2xx_rows, "k2x")


def registry_hash_analytic_phase(scene, card):
    """The hash-grid field (the JAX default grid: 16 levels x 2, 2^19 rows)
    under the diffuse material with analytic normals, trained through them
    on a full grid: K7x²."""
    _, render_cfg, train_cfg = registry_configs()
    return analytic_phase(scene, card, "registry-hash-analytic", (hashgrid_configs()[0], render_cfg, train_cfg),
                          ("implicit-volume", "diffuse-with-point-light-material", "solid-color-background"),
                          REG_HASH_AN_KERNELS, _k7xx_rows, "k7x")


def registry_grid_analytic_phase(scene, card):
    """Phase 16's voxel grid (R 64 x 16 f32) and textured background under
    the diffuse material with analytic normals, trained through them: K10²."""
    return analytic_phase(scene, card, "registry-grid-analytic", registry_configs(),
                          ("volume-grid", "diffuse-with-point-light-material", "textured-background"),
                          REG_GRID_AN_KERNELS, _k10xx_rows, "k10x")


# ---------------------------------------------------------------------------
# The CLI: the README's two-stage recipe through trinerflet_tpu_torch.cli,
# checkpoints, stage growth, --test (evaluation, mesh, video) and the planes
# ---------------------------------------------------------------------------

# the README's recipe at its widths, the step counts cut to 256 + 256: after
# fewer steps the field's density stays near or below the mesh export's
# threshold of 10 and mesh.obj comes out empty or nearly so (the cli log line
# prints the density's quantiles and its share above 10); --scale 1.0 as the
# README runs the synthetic scene (its cameras orbit at radius 2); an
# evaluation and a rotating checkpoint every 128 steps, two a stage (the
# script's share of its time limit holds the later phases too)
CLI_ARGS = ["-O", "--triplane_wavelet", "--bound", "1.5", "--dt_gamma", "0", "--scale", "1.0",
            "--triplane_resolution", "512", "1024", "--triplane_wavelet_levels", "8", "16",
            "--triplane_channels", "16", "--num_rays", "20000", "60000",
            "--wavelet_regularization", "0.2", "--iters", "256", "256",
            "--eval_interval_stages", "128", "--max_keep_ckpt", "2"]
CLI_SCENE = dict(num_views=30, num_test_views=8, H=400, W=400)
CLI_KERNELS = ("march", "grid_sample", "grid_sample_bwd", "idwt", "idwt_adjoint", "occupancy")
CLI_TEST_KERNELS = ("march", "grid_sample", "composite", "idwt", "occupancy")
CLI_FILES = ("latest_model.pkl", "best_model.pkl", "stage_0.pkl", "stage_1.pkl",
             "results_stage0.json", "results_stage1.json")


class _Timed:
    """Device-synchronised wall time of the trainer's fit, evaluate,
    checkpoint and mesh calls while the CLI runs (patched on the class);
    ``fit_rows`` holds each fit's (seconds, seconds of the evaluations and
    checkpoints inside it, steps)."""

    NAMES = ("fit", "evaluate", "save_checkpoint", "load_checkpoint", "save_mesh")

    def __init__(self):
        self.secs = defaultdict(list)
        self.fit_rows = []
        self._inner = None
        self._orig = {}

    def __enter__(self):
        for name in self.NAMES:
            orig = getattr(Trainer, name)
            self._orig[name] = orig

            def wrap(tr, *a, _orig=orig, _name=name, **k):
                if _name == "fit":
                    self._inner = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _orig(tr, *a, **k)
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
                self.secs[_name].append(s)
                if _name == "fit":
                    self.fit_rows.append((s, self._inner, tr.cfg.iters + max(tr.cfg.warmup_steps, 0)))
                    self._inner = None
                elif self._inner is not None:
                    self._inner += s
                return out

            setattr(Trainer, name, wrap)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(Trainer, name, orig)


def _psnr_black(scene) -> float:
    """Mean PSNR of an all-black render against the views over background 0."""
    gt = scene.images[..., :3] * scene.images[..., 3:] if scene.images.shape[-1] == 4 else scene.images
    mse = (gt.astype(np.float64) ** 2).reshape(len(gt), -1).mean(1)
    return float(np.mean(-10.0 * np.log10(mse)))


def _rebuild_row(trainer, state, launches):
    """K6's rebuild (a checkpoint's occupancy from its stored grid and mean)
    held to its plain version on the CLI state's grid and timed."""
    grid, mean, rcfg = state.occ.density_grid, float(state.occ.mean_density), trainer.render_cfg
    got = R._occupancy_rebuild_cuda(grid, mean, rcfg)
    again = R._occupancy_rebuild_cuda(grid, mean, rcfg)
    ref = R.occupancy_rebuild_plain(grid, mean, rcfg)
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise RuntimeError("K6 rebuild differs from its plain version")
    _same_bits("K6 rebuild", got, again)
    r = rcfg.coarse_dilation_radius
    occ_f = got[0].float().unsqueeze(1)
    b, by = bound_ms(nbytes(grid) + nbytes(*got), k6_ops(grid.numel(), r, merge=False))
    return dict(name="K6 occupancy_rebuild (cli --test)", route="cuda",
                source="trinerflet_tpu_torch/kernels/csrc/occupancy.cu",
                replaces="trinerflet_tpu/train/trainer.py:884", launches=launches["occupancy"],
                path="cli --test", max_abs_err=0.0, tol="occ, occ_coarse, bbox equal; a second call "
                                                         "the same bits",
                ms=time_ms(lambda: R._occupancy_rebuild_cuda(grid, mean, rcfg)),
                plain_ms=ref_ms(lambda: R.occupancy_rebuild_plain(grid, mean, rcfg)),
                bound_ms=b, bound_by=by,
                library_ms=ref_ms(lambda: F.max_pool3d(occ_f, 2 * r + 1, 1, r)),
                note=f"{tuple(grid.shape)} stored grid at its stored mean, radius {r}; 2 launches "
                     f"(the reset; threshold, dilation and bbox: K6's second launch); library is "
                     f"F.max_pool3d for the dilation alone")


@torch.no_grad()
def _density_quantiles(trainer, state) -> str:
    """The trained field's density on a 96^3 sweep of the box: its max,
    quantiles and share above the mesh export's threshold of 10."""
    planes = trainer.field.build_planes(state.params)
    b = trainer.nerf_cfg.bound
    ax = torch.linspace(-b, b, 96, device=DEVICE)
    pts = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    sig = torch.cat([trainer.field.density(state.params, planes, pts[k:k + 262144])[0].float()
                     for k in range(0, len(pts), 262144)])
    q = torch.quantile(sig[:1_000_000], torch.tensor([0.5, 0.99, 0.999], device=DEVICE))
    return (f"max {sig.max().item():.4f}, quantiles 0.5 / 0.99 / 0.999 {[round(x, 4) for x in q.tolist()]}, "
            f"share above 10 {(sig > 10).float().mean().item():.6f}")


def _round_trip(trainer, state, data, path):
    """save_checkpoint and load_checkpoint on the card: params, EMA, Adam
    moments, occ, occ_coarse, bbox, one rendered view and one step on the
    same batch must come back bit for bit. Returns (save s, load s, the
    live state after its step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save_checkpoint(state, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = trainer.load_checkpoint(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    pairs = [("params", state.params, loaded.params), ("ema", state.ema_params, loaded.ema_params),
             ("adam mu", state.opt_state["mu"], loaded.opt_state["mu"]),
             ("adam nu", state.opt_state["nu"], loaded.opt_state["nu"])]
    for what, a, b in pairs:
        la, lb = TR._leaves(a), TR._leaves(b)
        if [n for n, _ in la] != [n for n, _ in lb] or not all(
                torch.equal(x.detach(), y.detach()) for (_, x), (_, y) in zip(la, lb)):
            raise RuntimeError(f"checkpoint round trip: {what} differ")
    if (loaded.step, loaded.ema_count, loaded.opt_state["count"]) != (
            state.step, state.ema_count, state.opt_state["count"]):
        raise RuntimeError("checkpoint round trip: counts differ")
    for f in ("occ", "occ_coarse", "bbox", "density_grid", "mean_density"):
        if not torch.equal(getattr(state.occ, f), getattr(loaded.occ, f)):
            raise RuntimeError(f"checkpoint round trip: the rebuilt {f} differs from the live one")
    intr = synthetic_intrinsics(CLI_SCENE["H"], CLI_SCENE["W"])
    pose = orbit_pose(np.arccos(1 - 1.6 * 0.5 / 8), 0.0, 2.0)
    views = [trainer.render_image(s.ema_params, s.occ, pose, intr, CLI_SCENE["H"], CLI_SCENE["W"])[0]
             for s in (state, loaded)]
    if not torch.equal(*views):
        raise RuntimeError("checkpoint round trip: the rendered view differs")
    V, H, Wd = data["images"].shape[:3]
    batch = _batch(trainer, trainer.cfg.num_rays, V, H * Wd, SEED + 3)
    loaded, aux_l = trainer.train_step(loaded, data, with_stats=False, batch=batch)
    state, aux_s = trainer.train_step(state, data, with_stats=False, batch=batch)
    la, ls = TR._leaves(loaded.params), TR._leaves(state.params)
    if not (torch.equal(aux_l["loss"], aux_s["loss"])
            and all(torch.equal(x.detach(), y.detach()) for (_, x), (_, y) in zip(la, ls))):
        raise RuntimeError("checkpoint round trip: one step on the same batch differs")
    log(f"# cli checkpoint round trip ({path}, {os.path.getsize(path) / 2**20:.1f} MiB): params, EMA, "
        f"Adam moments, occ, occ_coarse, bbox, one {H}x{Wd} view and one step (loss "
        f"{float(aux_s['loss']):.6f}) bit for bit; save {save_s:.3f} s, load {load_s:.3f} s")
    del loaded
    return save_s, load_s, state


def cli_phase(card, root):
    """The CLI on the README's two-stage recipe at its widths (the step
    counts cut) on a synthetic scene written under ``root``, then its
    checkpoints, the stage-2 step check, the round trip, ``--test
    --test_with_ema`` and ``--test --save_planes``. The scene and the
    workspace stay (the clip and gui phases read them). Returns (kernel
    rows, stats)."""
    from trinerflet_tpu_torch import cli, native
    from trinerflet_tpu_torch.data.images import read_images
    from trinerflet_tpu_torch.data.synthetic import write_synthetic_scene

    t0 = time.perf_counter()
    native.load()  # built here, so that the decode's time below is the decode's
    log(f"# host library (PNG decode, marching tetrahedra, JPEG encode) built in {time.perf_counter() - t0:.2f} s "
        f"into {native.BUILD_DIR}")
    scene_dir, ws = os.path.join(root, "scene"), os.path.join(root, "ws")
    t0 = time.perf_counter()
    write_synthetic_scene(scene_dir, seed=SEED, backend="torch", device=DEVICE, **CLI_SCENE)
    paths = [os.path.join(scene_dir, "train", f"r_{v}.png") for v in range(CLI_SCENE["num_views"])]
    t1 = time.perf_counter()
    read_images(paths)
    decode_ms = (time.perf_counter() - t1) / len(paths) * 1e3
    log(f"# cli scene: {CLI_SCENE} rendered on the card (torch; on the host's threads, numpy took 52-81 s) "
        f"and "
        f"written in {t1 - t0:.2f} s; PNG decode (host library, "
        f"{os.cpu_count()} host cores) {decode_ms:.3f} ms per {CLI_SCENE['H']}x{CLI_SCENE['W']} RGBA "
        f"view; free disk {shutil.disk_usage(root).free / 2**30:.1f} GiB")
    args = ["--path", scene_dir, "--workspace", ws] + CLI_ARGS
    kernels.reset_launches()
    with _Timed() as timed:
        trainer, state = cli.main(args, device=DEVICE)
    launches = dict(kernels.launches)
    stage_ms = [(s - inner) / steps * 1e3 for s, inner, steps in timed.fit_rows]
    log(f"# cli train ({card}): ms/step by stage {[round(m, 3) for m in stage_ms]} (fit's wall "
        f"time less its evaluations and checkpoints, refreshes included); fit, evaluate, "
        f"save_checkpoint seconds {dict((k, [round(s, 3) for s in v]) for k, v in timed.secs.items())}; "
        f"launches {launches}")
    for name in CLI_KERNELS:
        if launches[name] == 0:
            raise RuntimeError(f"kernel {name} was not launched on the cli path")
    if not (launches["composite"] or launches["composite_compact"]) or not (
            launches["composite_bwd"] or launches["composite_compact_bwd"]):
        raise RuntimeError("neither K3 nor K3c (forward and backward) launched on the cli path")
    present = sorted(os.listdir(ws))
    ckpts = [f for f in present if f.startswith("ckpt_")]
    missing = [f for f in CLI_FILES if f not in present]
    if missing or not 1 <= len(ckpts) <= 2:
        raise RuntimeError(f"cli workspace: missing {missing}, rotating checkpoints {ckpts}")
    with open(os.path.join(ws, "results_stage1.json")) as f:
        val = json.load(f)
    log(f"# cli workspace: {present}; stage 1 val PSNR {val['PSNR']:.4f} SSIM {val['SSIM']:.5f}")
    log(f"# cli density (96^3 sweep of the box): {_density_quantiles(trainer, state)}")

    opt = cli.get_params(args)
    opt.downscale = 1
    data = trainer.scene_to_device(cli.load_scene(opt, "train"))
    save_s, load_s, state = _round_trip(trainer, state, data, os.path.join(root, "round_trip.pkl"))
    step_check(trainer, state, data, "cli stage 2")
    state = profile_step(trainer, state, data, "cli stage 2")
    state, calls = capture_step(trainer, state, data)
    rows = path_kernel_rows(trainer, calls, launches, "cli stage 2")
    del calls, trainer, state, data

    kernels.reset_launches()
    with _Timed() as timed:
        trainer, state = cli.main(args + ["--test", "--test_with_ema"], device=DEVICE)
    test_launches = dict(kernels.launches)
    for name in CLI_TEST_KERNELS:
        if test_launches[name] == 0:
            raise RuntimeError(f"kernel {name} was not launched on the cli --test path")
    with open(os.path.join(ws, "results.json")) as f:
        res = json.load(f)
    black = _psnr_black(cli.load_scene(opt, "test"))
    if not (np.isfinite(res["PSNR"]) and np.isfinite(res["SSIM"]) and res["PSNR"] > black):
        raise RuntimeError(f"cli --test: PSNR {res['PSNR']} (a black render: {black})")
    n_test = CLI_SCENE["num_test_views"]
    pngs = [os.path.join(ws, "test_renders", f"results_{v:03d}.png") for v in range(n_test)]
    frames = os.path.join(ws, "test_video_frames")
    video = os.path.join(ws, "test_video.mp4")
    with open(os.path.join(ws, "mesh.obj")) as f:
        faces = sum(1 for line in f if line.startswith("f "))
    if not all(os.path.exists(p) for p in pngs) or faces == 0:
        raise RuntimeError(f"cli --test: test PNGs {[os.path.exists(p) for p in pngs]}, "
                           f"{faces} mesh faces")
    if os.path.isdir(frames):
        video_out = f"{len(os.listdir(frames))} PNG frames"
        if len(os.listdir(frames)) != n_test:
            raise RuntimeError(f"cli --test: {video_out}, {n_test} views")
    elif os.path.exists(video) and os.path.getsize(video) > 0:
        video_out = f"test_video.mp4 ({os.path.getsize(video)} bytes)"
    else:
        raise RuntimeError("cli --test wrote neither a video nor its frames")
    mesh_s = timed.secs["save_mesh"][0]
    log(f"# cli --test --test_with_ema ({card}): PSNR {res['PSNR']:.4f} dB, SSIM {res['SSIM']:.5f} "
        f"(a black render {black:.4f} dB); density grid max "
        f"{state.occ.density_grid.max().item():.3f}; mesh.obj {faces} faces at resolution 192, "
        f"extract_mesh + write {mesh_s:.3f} s; load_checkpoint {timed.secs['load_checkpoint'][0]:.3f} s; "
        f"{video_out}; launches {test_launches}")
    rows.append(_rebuild_row(trainer, state, test_launches))
    del trainer, state

    cli.main(args + ["--test", "--save_planes"], device=DEVICE)
    planes = sorted(os.listdir(os.path.join(ws, "planes")))
    want = [f"plane_{g}_{p}.png" for g in ("base", "level_0") for p in range(3)]
    if not set(want) <= set(planes):
        raise RuntimeError(f"cli --save_planes wrote {planes}")
    log(f"# cli --test --save_planes: {len(planes)} plane PNGs")
    stats = dict(stage_ms=stage_ms, save_s=save_s, load_s=load_s, mesh_s=mesh_s, decode_ms=decode_ms,
                 psnr=res["PSNR"], ssim=res["SSIM"], launches=launches, test_launches=test_launches,
                 scene_dir=scene_dir, ws=ws)
    return rows, stats


# ---------------------------------------------------------------------------
# The super-resolution app: the srtex recipe through sr.launch.build, fit and
# evaluate (the dual-resolution triplane), then the x4 upscaler's networks
# ---------------------------------------------------------------------------

SR_CONFIG = "configs/triplane-sr100_400-srtex.yaml"
# the recipe's step counts and view count cut (widths kept): 100 views,
# 16,000 steps with SR from 6,000, a refresh every 500 -> 8 views, 600 steps
# with SR from 400, a refresh every 100; the schedules that name steps
# (lambda_l1_hr, the guidance's anneal) scaled the same way
SR_CUTS = {"data.num_views": 8, "data.cache": "", "system.total_steps": 600,
           "system.sr_start_step": 400, "system.hr_fit_refresh_every": 100,
           "system.lambda_l1_hr": [400, 0.0, 1.0, 600], "guidance.sr_start_step": 400,
           "guidance.anneal_end_step": 600}
SR_KERNELS = ("march", "grid_sample", "grid_sample_bwd", "composite", "composite_bwd", "idwt",
              "idwt_adjoint", "occupancy")
SR_VIEW_KERNELS = ("march", "grid_sample", "composite", "idwt")
SR_VIEW_ABSENT = ("grid_sample_bwd", "composite_bwd", "idwt_adjoint")
SR_MIN_GAIN_DB = 3.0  # the fit's LR PSNR over a black render's
SR_UPSCALER_STEPS, SR_IGNORE_T = 4, 600  # DDIM 751, 501, 251, 1: one re-noise, three denoising steps
# the x4 networks on the card against the CPU, float32, TF32 off on the card:
# max|card - cpu| within this share of max|cpu| (the convolutions and matmuls
# sum in other orders over up to 2,048 x 9 terms)
SR_NET_TOL = 1e-4


def _sr_config():
    from trinerflet_tpu_torch.sr.config import load_yaml_config

    cfg = load_yaml_config(SR_CONFIG)
    for key, value in SR_CUTS.items():
        sec, name = key.split(".")
        log(f"# sr cut: {key} {cfg[sec].get(name)!r} -> {value!r}")
        cfg[sec][name] = value
    return cfg


def _sr_tensors(system, scene):
    """The LR data and HR ray grids as fit holds them."""
    from trinerflet_tpu_torch.sr.data import view_ray_grid

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=DEVICE)

    data = {"images": t(scene.lr.images[..., :3]), "poses": t(scene.lr.poses),
            "intrinsics": t([float(np.float32(x)) for x in scene.lr.intrinsics])}
    grids = [view_ray_grid(scene.hr, v) for v in range(scene.num_views)]
    return data, torch.stack([t(g[0]) for g in grids]), torch.stack([t(g[1]) for g in grids])


def _sr_crop(system, scene, data, hr_ro, hr_rd, pseudo, v=0):
    """The centre crop of view ``v`` as fit cuts one: rays, pseudo-GT, LR GT."""
    cl, s = system.cfg.crop_size_lr, scene.scale
    x0l = (scene.lr.H - cl) // 2
    x0, ch = x0l * s, cl * s
    return (hr_ro[v, x0 : x0 + ch, x0 : x0 + ch].reshape(-1, 3),
            hr_rd[v, x0 : x0 + ch, x0 : x0 + ch].reshape(-1, 3),
            pseudo[x0 : x0 + ch, x0 : x0 + ch], data["images"][v, x0l : x0l + cl, x0l : x0l + cl])


def _sr_weights(cfg, step, hr):
    from trinerflet_tpu_torch.sr.config import C

    if not hr:
        return {"lr": C(cfg.lambda_lr, step), "reg": C(cfg.wavelet_regularization, step)}
    return {"l2_hr": C(cfg.lambda_l2_hr, step), "l1_hr": C(cfg.lambda_l1_hr, step),
            "consistency": C(cfg.lambda_lr_consistency, step), "reg": C(cfg.wavelet_regularization, step),
            "percep": C(cfg.lambda_lr_consistency_perceptual, step), "sds": C(cfg.lambda_sds, step)}


def _k4_forward_rows(calls, label):
    """K4 forward on every level the captured build ran (to the snapshot
    or to the full plane), held to its plain version and timed."""
    levels = [_k4_level(*a)[1] for a, _ in calls["_idwt2d_cuda"]]
    return [_k4_row(levels, "K4 idwt2d" + label, f"sum over the {len(levels)} levels ")]


def sr_phase(card):
    """The srtex SR recipe at its widths (steps and views cut), through
    ``sr.launch.build``, ``SRSystem.fit`` and ``evaluate``; the launches,
    ms/step and device time of each phase; captured steps' kernel rows;
    then the x4 upscaler. Returns (kernel rows, stats)."""
    from trinerflet_tpu_torch.sr.launch import build
    from trinerflet_tpu_torch.train.metrics import psnr

    cfg = _sr_config()
    ws = tempfile.mkdtemp(prefix="chip_smoke_sr_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system, scene = build(cfg, ws, device=DEVICE)
        torch.cuda.synchronize()
        tri = system.nerf_cfg.triplane
        log(f"# sr scene: {scene.num_views} views of the srtex field, HR {scene.hr.H}^2 rendered on the card "
            f"({cfg['data']['backend']} backend: {384} steps a ray), LR {scene.lr.H}^2 box-filtered, in "
            f"{time.perf_counter() - t0:.2f} s; triplane {tri.resolution}^2 x {tri.channels} {tri.wavelet_type}, "
            f"{tri.levels} levels, low_res {tri.resolution // tri.low_res_scale}^2, planes "
            f"{system.nerf_cfg.plane_dtype}, MLPs {system.nerf_cfg.compute_dtype}, grid "
            f"{system.render_cfg.grid_size}^3; {system.cfg.num_rays_lr} LR rays a step, HR crops of "
            f"{system.cfg.crop_size_lr * scene.scale}^2 rays; guidance {cfg['guidance']['kind']}")
        grid = mark_untrained_grid(scene.lr.poses, scene.lr.intrinsics, system.render_cfg)
        state = system.init_state(density_grid=grid)

        # fit, the counters zeroed before it and read at the phase switch and
        # at its end; each pseudo-GT refresh timed
        real_view, refresh_s = system.render_view, []

        def timed_view(*a, deep=True, **k):
            if deep:
                return real_view(*a, deep=deep, **k)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_view(*a, deep=deep, **k)
            torch.cuda.synchronize()
            refresh_s.append(time.perf_counter() - t)
            return out

        marks = {}

        def at_step(st, aux):
            if st.step in (system.cfg.sr_start_step, system.cfg.total_steps):
                loss = float(aux["loss"])  # waits for the step
                marks[st.step] = (time.perf_counter(), dict(kernels.launches), loss)
                kernels.reset_launches()

        system.render_view = timed_view
        kernels.reset_launches()
        torch.cuda.synchronize()
        t_fit = time.perf_counter()
        state = system.fit(state, scene, log_every=100, callback=at_step)
        del system.render_view
        s1, s2 = system.cfg.sr_start_step, system.cfg.total_steps
        (t1, p1_launches, loss1), (t2, p2_launches, loss2) = marks[s1], marks[s2]
        p1_ms = (t1 - t_fit) / s1 * 1e3
        p2_ms = (t2 - t1) / (s2 - s1) * 1e3
        p2_ms_net = (t2 - t1 - sum(refresh_s)) / (s2 - s1) * 1e3
        for what, launches in (("sr phase 1", p1_launches), ("sr phase 2", p2_launches)):
            log(f"# {what} launches: {launches}")
            for name in SR_KERNELS:
                if launches[name] == 0:
                    raise RuntimeError(f"kernel {name} was not launched on the {what} path")
        if not (np.isfinite(loss1) and np.isfinite(loss2)):
            raise RuntimeError("non-finite SR loss")

        # one step of each phase under the profiler, then captured
        data, hr_ro, hr_rd = _sr_tensors(system, scene)
        view0 = system.render_view(state.params, state.occ, None, None, scene.hr.H, scene.hr.W,
                                   mode="high_res", rays=(hr_ro[0], hr_rd[0]), deep=False)
        pseudo = system.guidance.generate_sr(data["images"][0].permute(2, 0, 1)[None],
                                             view0.permute(2, 0, 1)[None])[0].permute(1, 2, 0)
        crop = _sr_crop(system, scene, data, hr_ro, hr_rd, pseudo)
        w1, w2 = _sr_weights(system.cfg, s2, False), _sr_weights(system.cfg, s2, True)

        def lr_step(st):
            return system._lr_step(st, data, w1)

        def hr_step(st):
            return system._hr_step(st, *crop, w2)

        state = profile_step(None, state, None, "sr phase 1", step=lr_step)
        state = profile_step(None, state, None, "sr phase 2", step=hr_step)
        busy = {what: PROFILED[f"sr {what}"][1] for what in ("phase 1", "phase 2")}
        with Capture() as cap_grid:
            state = system._update_grid(state)
        with Capture() as cap:
            state, _ = lr_step(state)
        torch.cuda.synchronize()
        cap.calls["_occupancy_upkeep_cuda"] = cap_grid.calls["_occupancy_upkeep_cuda"]
        rows = path_kernel_rows(system, cap.calls, p1_launches, "sr phase 1")
        rows += label_rows(_k4_forward_rows(cap.calls, ""), p1_launches, "sr phase 1")
        with Capture() as cap:
            state, _ = hr_step(state)
        torch.cuda.synchronize()
        rows += path_kernel_rows(system, cap.calls, p2_launches, "sr phase 2")
        rows += label_rows(_k4_forward_rows(cap.calls, ""), p2_launches, "sr phase 2")

        # one HR view at the training budget (the refresh's render), counted
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        system.render_view(state.params, state.occ, None, None, scene.hr.H, scene.hr.W, mode="high_res",
                           rays=(hr_ro[1], hr_rd[1]), deep=False)
        torch.cuda.synchronize()
        view_ms = (time.perf_counter() - t) * 1e3
        view_launches = dict(kernels.launches)
        log(f"# sr HR view ({scene.hr.H}^2 at the training budget, chunks of "
            f"{max(system.eval_chunk, system.cfg.eval_chunk)}): {view_ms:.2f} ms; launches {view_launches}")
        for name in SR_VIEW_KERNELS:
            if view_launches[name] == 0:
                raise RuntimeError(f"kernel {name} was not launched on the sr HR view")
        for name in SR_VIEW_ABSENT:
            if view_launches[name] != 0:
                raise RuntimeError(f"kernel {name} launched on the sr HR view, which has no backward")
        n = min(max(system.eval_chunk, system.cfg.eval_chunk), scene.hr.H * scene.hr.W)
        with Capture() as cap:
            system.render_view(state.params, state.occ, None, None, 1, n, mode="high_res",
                               rays=(hr_ro[1].reshape(-1, 3)[:n], hr_rd[1].reshape(-1, 3)[:n]), deep=False)
        torch.cuda.synchronize()
        vrows = path_kernel_rows(system, cap.calls, view_launches, "sr HR view",
                                 only=("_march_cuda", "_composite_cuda"))
        (planes, xyz, lb), _ = cap.calls["_sample_points_cuda"][0]
        vrows += label_rows(_sample_fwd_rows(planes, xyz, lb) + _k4_forward_rows(cap.calls, ""),
                            view_launches, "sr HR view")
        rows += vrows

        torch.cuda.synchronize()
        t = time.perf_counter()
        res = system.evaluate(state, scene)
        eval_s = time.perf_counter() - t
        black = float(np.mean([psnr(np.zeros_like(im[..., :3]), im[..., :3]) for im in scene.lr.images]))
        log(f"# sr evaluate ({card}): {scene.num_views} views in {eval_s:.2f} s; LR PSNR {res['PSNR_lr']:.4f} "
            f"dB, HR PSNR {res['PSNR_hr']:.4f} dB beside bilinear {res['PSNR_bilinear']:.4f} dB, HR SSIM "
            f"{res['SSIM_hr']:.5f}; a black LR render {black:.4f} dB; per view "
            f"{[(m['view'], round(m['PSNR_lr'], 3), round(m['PSNR_hr'], 3)) for m in res['per_frame']]}")
        if not all(np.isfinite(res[k]) for k in ("PSNR_lr", "PSNR_hr", "PSNR_bilinear", "SSIM_hr")):
            raise RuntimeError("sr evaluate gave a non-finite number")
        if not res["PSNR_lr"] > black + SR_MIN_GAIN_DB:
            raise RuntimeError(f"sr: LR PSNR {res['PSNR_lr']} is not {SR_MIN_GAIN_DB} dB above a black "
                               f"render's {black}")
        stats = dict(p1_ms=p1_ms, p2_ms=p2_ms, p2_ms_net=p2_ms_net, busy=busy,
                     refresh_s=float(np.mean(refresh_s)), n_refresh=len(refresh_s), loss1=loss1, loss2=loss2,
                     view_ms=view_ms, res=res, eval_s=eval_s, p1_launches=p1_launches,
                     p2_launches=p2_launches, view_launches=view_launches)
        log(f"# sr fit ({card}): phase 1 {p1_ms:.3f} ms/step over {s1} steps (device busy "
            f"{busy['phase 1']:.3f} ms for one step), phase 2 {p2_ms:.3f} ms/step over {s2 - s1} steps, "
            f"{p2_ms_net:.3f} without the refreshes (device busy {busy['phase 2']:.3f} ms for one step); "
            f"{len(refresh_s)} pseudo-GT refreshes, {stats['refresh_s']:.3f} s each; loss {loss1:.5f} at "
            f"the switch, {loss2:.5f} at the end")
        lr_view, hr_render = data["images"][0], view0
        del system, state, data, hr_ro, hr_rd, cap, cap_grid
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    stats["upscaler"] = upscaler_phase(card, lr_view, hr_render)
    return rows, stats


def _n_params(tree) -> int:
    return sum(t.numel() for _, t in TR._leaves(tree))


def upscaler_phase(card, lr_view, hr_render):
    """The x4 upscaler at its published widths with seeded random weights:
    one ``generate_sr`` on a 100^2 LR view and its 400^2 render (noise level
    20, text CFG 7.5, a fixed ignore_t, 4 DDIM steps), one ``text_encode``
    at ``TextConfig()`` widths; ms per UNet call, VAE encode / decode ms,
    peak memory; one UNet call and one VAE decode at a reduced size and the
    text encoder held to the same modules on the CPU (float32, TF32 off)."""
    from trinerflet_tpu_torch.sr import diffusion as D
    from trinerflet_tpu_torch.sr import text as X
    from trinerflet_tpu_torch.sr.guidance import GuidanceConfig, UpscalerGuidance

    g = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    ucfg, vcfg, tcfg = D.SD_X4_UPSCALER_UNET, D.SD_X4_UPSCALER_VAE, X.TextConfig()
    unet, vae = D.init_unet_params(ucfg, g, DEVICE), D.init_vae_params(vcfg, g, DEVICE)
    text = X.init_text_params(tcfg, g, DEVICE)
    torch.cuda.synchronize()
    log(f"# sr x4 upscaler: UNet {_n_params(unet) / 1e6:.1f} M, VAE {_n_params(vae) / 1e6:.1f} M, text "
        f"encoder {_n_params(text) / 1e6:.1f} M parameters ({tcfg.num_layers} layers of {tcfg.hidden_size}), "
        f"seeded random weights, made in {time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, tcfg.vocab_size, (2, tcfg.max_length), generator=g)
    with torch.no_grad():
        emb = X.text_encode(text, tcfg, tokens.to(DEVICE))
        text_ms = time_ms(lambda: X.text_encode(text, tcfg, tokens.to(DEVICE)), iters=5, warmup=1)
    cond, uncond = emb[:1], emb[1:]

    timings = defaultdict(list)

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            timings[name].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    def encode(x):
        with torch.no_grad():
            return D.vae_encode(vae, vcfg, 2.0 * x - 1.0)

    def decode(z):
        with torch.no_grad():
            return 0.5 * (D.vae_decode(vae, vcfg, z) + 1.0)

    gcfg = GuidanceConfig(num_inference_steps=SR_UPSCALER_STEPS, noise_level=20, guidance_scale=7.5)
    guide = UpscalerGuidance(gcfg, timed("unet", D.make_unet_denoiser(unet, ucfg, cond, uncond)),
                             encode=timed("encode", encode), decode=timed("decode", decode))
    lr = lr_view.permute(2, 0, 1)[None].contiguous()
    hr = hr_render.permute(2, 0, 1)[None].contiguous()
    guide.generate_sr(lr, hr, ignore_t=SR_IGNORE_T, generator=torch.Generator(device=DEVICE).manual_seed(1))
    timings.clear()  # the first call carried the one-time costs
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = guide.generate_sr(lr, hr, ignore_t=SR_IGNORE_T,
                            generator=torch.Generator(device=DEVICE).manual_seed(1))
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    if tuple(out.shape) != (1, 3, 4 * lr.shape[2], 4 * lr.shape[3]) or not torch.isfinite(out).all():
        raise RuntimeError(f"generate_sr gave {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    stats = dict(unet_ms=float(np.median(timings["unet"])), unet_calls=len(timings["unet"]),
                 encode_ms=timings["encode"][0], decode_ms=timings["decode"][0], gen_ms=gen_ms,
                 peak_gib=peak, text_ms=text_ms, latent=tuple(encode(hr).shape))
    log(f"# sr generate_sr ({card}, TF32 {'on' if torch.backends.cudnn.allow_tf32 else 'off'} for "
        f"convolutions, {'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'} for matmuls): "
        f"{lr.shape[2]}^2 LR and {hr.shape[2]}^2 render, latents {stats['latent']}, {SR_UPSCALER_STEPS} DDIM "
        f"steps with ignore_t {SR_IGNORE_T}: {gen_ms:.1f} ms; {stats['unet_calls']} UNet calls "
        f"{stats['unet_ms']:.2f} ms each (median), VAE encode {stats['encode_ms']:.2f} ms, decode "
        f"{stats['decode_ms']:.2f} ms; peak memory {peak:.2f} GiB; text_encode (2 x {tcfg.max_length} "
        f"tokens) {text_ms:.2f} ms")

    # the networks on the card against the CPU, float32 with TF32 off
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = lambda tree: TR._map(lambda x: x.cpu(), tree)  # noqa: E731
        x = torch.randn((1, 7, 16, 16), generator=g)
        z = 0.2 * torch.randn((1, 4, 16, 16), generator=g)
        checks = []
        with torch.no_grad():
            for name, card_fn, cpu_fn in (
                    ("UNet (16^2 latents, t 501, noise level 20)",
                     lambda: D.unet_apply(unet, ucfg, x.to(DEVICE), 501, cond, 20),
                     lambda: D.unet_apply(cpu(unet), ucfg, x, 501, cond.cpu(), 20)),
                    ("VAE decode (16^2 latents -> 64^2)", lambda: D.vae_decode(vae, vcfg, z.to(DEVICE)),
                     lambda: D.vae_decode(cpu(vae), vcfg, z)),
                    ("text_encode (2 x 77 tokens)", lambda: X.text_encode(text, tcfg, tokens.to(DEVICE)),
                     lambda: X.text_encode(cpu(text), tcfg, tokens))):
                a, b = card_fn().cpu(), cpu_fn()
                err = (a - b).abs().max().item()
                scale = b.abs().max().item()
                checks.append(f"{name} max|diff| {err:.3e} of max|cpu| {scale:.3e}")
                if not (torch.isfinite(a).all() and err <= SR_NET_TOL * scale):
                    raise RuntimeError(f"sr {name}: card vs CPU max|diff| {err} > {SR_NET_TOL} x {scale}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    log(f"# sr x4 networks, card vs CPU (float32, TF32 off, tolerance {SR_NET_TOL} x max|cpu|): "
        + "; ".join(checks))
    return stats


# ---------------------------------------------------------------------------
# Text-to-3D generation: sr.launch.build on a generation config at the srtex
# widths, TextTo3DSystem.fit, its kernel rows, a step check, the turntable
# ---------------------------------------------------------------------------

# TextTo3DConfig's defaults (128^2 views, 8 a round, 64^2 crops), the steps
# and the refresh period cut (widths kept)
GEN_CUTS = {"total_steps": (4000, 400), "refresh_every": (400, 100)}
GEN_KERNELS = ("march", "grid_sample", "grid_sample_bwd", "composite", "composite_bwd", "idwt",
               "idwt_adjoint", "occupancy")
GEN_VIEW_ABSENT = ("grid_sample_bwd", "composite_bwd", "idwt_adjoint")
GEN_TURNTABLE_FRAMES = 30


def gen_config(**system):
    """A generation config from the srtex recipe's model, triplane and
    renderer sections (its widths), the weights-free conditioning guidance
    (the full DDIM tail) and ``system`` over TextTo3DConfig's defaults."""
    from trinerflet_tpu_torch.sr.config import load_yaml_config

    src = load_yaml_config(SR_CONFIG)
    cfg = {k: dict(src[k]) for k in ("model", "triplane", "renderer")}
    cfg["system"] = dict(kind="generation", **system)
    cfg["guidance"] = {"kind": "cond"}
    return cfg


def _gen_loss(inner, params, occ, ro, rd, tgt, noise, w):
    """The HR step's loss (L2 to the crop's pseudo-GT and the wavelet L1, as
    the generation step weighs them) on given rays and noise."""
    out = inner._render(params, occ, ro, rd, "high_res", noise=noise)
    pred = out["image"].reshape(tgt.shape)
    return w["l2_hr"] * ((pred - tgt) ** 2).mean() + w["reg"] * inner._reg(params)


def gen_step_check(system, state, ro, rd, tgt, w, card):
    """One generation step's loss and per-group gradients at full width,
    kernels on the card against the plain versions on the CPU, on the same
    rays, crop and injected noise."""
    from trinerflet_tpu_torch.sr.system import SRSystem

    inner = system.inner
    noise = torch.rand((ro.shape[0],), generator=torch.Generator().manual_seed(SEED + 5))
    results = {}
    for dev in (DEVICE, "cpu"):
        sys_ = inner if dev == DEVICE else SRSystem(inner.nerf_cfg, inner.render_cfg, inner.cfg, None,
                                                    device="cpu")
        params = TR._map(lambda t: t.detach().to(dev).requires_grad_(True), state.params)
        occ = type(state.occ)(*[x.to(dev) for x in state.occ])
        t0 = time.perf_counter()
        loss = _gen_loss(sys_, params, occ, ro.to(dev), rd.to(dev), tgt.to(dev), noise.to(dev), w)
        named = TR._leaves(params)
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(named, grads)]
        if dev == DEVICE:
            torch.cuda.synchronize()
        results[dev] = (loss.item(), _groups(zip([n for n, _ in named], grads)), time.perf_counter() - t0)
    (lg, gg, tg), (lc, gc, tc) = results[DEVICE], results["cpu"]
    loss_err = abs(lg - lc) / abs(lc)
    errs = {k: (torch.linalg.norm(gg[k] - gc[k]) / torch.linalg.norm(gc[k])).item() for k in gc}
    log(f"# gen step check ({ro.shape[0]} rays, full width, {card}): loss card {lg:.7f} vs CPU plain "
        f"{lc:.7f} (rel {loss_err:.2e}, tol {CHECK_LOSS_TOL}); gradient rel L2 "
        f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } (tol {CHECK_GRAD_TOL}); {tg:.2f} s on the "
        f"card, {tc:.2f} s on the CPU")
    if loss_err > CHECK_LOSS_TOL or max(errs.values()) > CHECK_GRAD_TOL:
        raise RuntimeError("the gen kernel step disagrees with the plain versions")
    if min(torch.linalg.norm(gc[k]).item() for k in errs) == 0:
        raise RuntimeError("a gen parameter group got no gradient")


def gen_phase(card):
    """Text-to-3D generation at the srtex widths through ``sr.launch.build``
    (steps and refresh period cut), ``fit`` with its launches, ms/step and
    seconds per refresh, one profiled step, a captured step's and a refresh
    view's kernel rows, the step check and the turntable. Returns (kernel
    rows, stats)."""
    from trinerflet_tpu_torch.data.rays import rays_for_pixels as rays_px
    from trinerflet_tpu_torch.ops.resize import resize
    from trinerflet_tpu_torch.sr.launch import build
    from trinerflet_tpu_torch.sr.text_to_3d import TextTo3DConfig, _intrinsics, sample_orbit_cameras

    for key, (was, now) in GEN_CUTS.items():
        if getattr(TextTo3DConfig(), key) != was:
            raise RuntimeError(f"TextTo3DConfig.{key} is no longer {was}")
        log(f"# gen cut: system.{key} {was} -> {now}")
    cfg = gen_config(**{k: now for k, (_, now) in GEN_CUTS.items()})
    ws = tempfile.mkdtemp(prefix="chip_smoke_gen_")
    try:
        system, scene = build(cfg, ws, device=DEVICE)
        inner, gcfg = system.inner, system.cfg
        if scene is not None:
            raise RuntimeError("the generation build made a scene")
        tri = inner.nerf_cfg.triplane
        S, V = gcfg.render_size, gcfg.views_per_refresh
        log(f"# gen config: triplane {tri.resolution}^2 x {tri.channels} {tri.wavelet_type}, {tri.levels} "
            f"levels, low_res {tri.resolution // tri.low_res_scale}^2, MLPs {inner.nerf_cfg.compute_dtype}, "
            f"grid {inner.render_cfg.grid_size}^3; {S}^2 views, {V} a round, a refresh every "
            f"{gcfg.refresh_every} of {gcfg.total_steps} steps, {min(64, S)}^2 crops; guidance "
            f"{cfg['guidance']['kind']} ({type(system.guidance).__name__}, "
            f"{system.guidance.cfg.num_inference_steps} DDIM steps)")
        state = system.init_state()

        real_view, real_gen, refresh = inner.render_view, system.guidance.generate_sr, defaultdict(float)

        def timed(fn, key):
            def call(*a, **k):
                if key == "view" and k.get("deep", True):
                    return fn(*a, **k)
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                refresh[key] += time.perf_counter() - t
                return out
            return call

        inner.render_view = timed(real_view, "view")
        system.guidance.generate_sr = timed(real_gen, "guidance")
        losses = []
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = system.fit(state, log_every=100, callback=lambda s, a: losses.append(a["loss"]))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        del inner.render_view, system.guidance.generate_sr
        n_ref = gcfg.total_steps // gcfg.refresh_every
        refresh_s = (refresh["view"] + refresh["guidance"]) / n_ref
        ms_step = (fit_s - refresh["view"] - refresh["guidance"]) / gcfg.total_steps * 1e3
        loss = torch.stack(losses).float().cpu().numpy()
        log(f"# gen fit ({card}): {fit_s:.2f} s for {gcfg.total_steps} steps; {ms_step:.3f} ms/step without "
            f"the refreshes (the grid upkeep included); {n_ref} refreshes, {refresh_s:.3f} s each "
            f"({refresh['view'] / n_ref:.3f} s rendering {V} views, {refresh['guidance'] / n_ref:.3f} s of "
            f"guidance); loss {loss[0]:.5f} -> {loss[-1]:.5f}; launches {launches}")
        for name in GEN_KERNELS:
            if launches[name] == 0:
                raise RuntimeError(f"kernel {name} was not launched on the gen path")
        if not np.isfinite(loss).all():
            raise RuntimeError("non-finite gen loss")

        # a step as fit takes one: a crop of a refreshed view
        rng = np.random.default_rng(SEED + 9)
        poses = sample_orbit_cameras(rng, V)
        intr = _intrinsics(S, gcfg.fovy_deg)
        view = inner.render_view(state.params, state.occ, poses[0], intr, S, S, mode="full", deep=False)
        hr = view.permute(2, 0, 1)[None]
        pseudo = system.guidance.generate_sr(resize(hr, (1, 3, S // 4, S // 4)), hr, step=gcfg.total_steps,
                                             generator=torch.Generator(device=DEVICE).manual_seed(SEED))
        tgt_all = pseudo[0].permute(1, 2, 0)
        crop = min(64, S)
        x0, y0 = (S - crop) // 2, (S - crop) // 3
        dy, dx = torch.meshgrid(torch.arange(crop, device=DEVICE), torch.arange(crop, device=DEVICE),
                                indexing="ij")
        pix = ((x0 + dy) * S + (y0 + dx)).reshape(-1)
        intr_t = torch.tensor([float(np.float32(x)) for x in intr], device=DEVICE)
        ro, rd = rays_px(torch.from_numpy(poses).to(DEVICE), intr_t, S, torch.zeros_like(pix), pix)
        tgt = tgt_all[x0 : x0 + crop, y0 : y0 + crop]
        lr_tgt = resize(tgt, (crop // 4, crop // 4, 3))
        w = {"l2_hr": 1.0, "l1_hr": 0.0, "consistency": 0.0, "reg": float(gcfg.wavelet_regularization),
             "percep": 0.0, "sds": 0.0}

        def step(st):
            return inner._hr_step(st, ro, rd, tgt, lr_tgt, w)

        state = profile_step(None, state, None, "gen", step=step)
        with Capture() as cap_grid:
            state = inner._update_grid(state)
        with Capture() as cap:
            state, _ = step(state)
        torch.cuda.synchronize()
        cap.calls["_occupancy_upkeep_cuda"] = cap_grid.calls["_occupancy_upkeep_cuda"]
        rows = path_kernel_rows(inner, cap.calls, launches, "gen step")
        rows += label_rows(_k4_forward_rows(cap.calls, ""), launches, "gen step")
        gen_step_check(system, state, ro, rd, tgt, w, card)

        # one refresh view (the training budget, one chunk), counted
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with Capture() as cap:
            inner.render_view(state.params, state.occ, poses[1], intr, S, S, mode="full", deep=False)
        torch.cuda.synchronize()
        view_ms = (time.perf_counter() - t) * 1e3
        view_launches = dict(kernels.launches)
        for name in GEN_VIEW_ABSENT:
            if view_launches[name] != 0:
                raise RuntimeError(f"kernel {name} launched on the gen refresh view, which has no backward")
        vrows = path_kernel_rows(inner, cap.calls, view_launches, "gen refresh view",
                                 only=("_march_cuda", "_composite_cuda"))
        (planes, xyz, lb), _ = cap.calls["_sample_points_cuda"][0]
        vrows += label_rows(_sample_fwd_rows(planes, xyz, lb) + _k4_forward_rows(cap.calls, ""),
                            view_launches, "gen refresh view")
        rows += vrows
        log(f"# gen refresh view ({S}^2 at the training budget, {card}): {view_ms:.2f} ms with the capture; "
            f"launches {view_launches}")

        torch.cuda.synchronize()
        t = time.perf_counter()
        out = system.render_turntable(state, os.path.join(ws, "turntable.mp4"), frames=GEN_TURNTABLE_FRAMES)
        torch.cuda.synchronize()
        tt_ms = (time.perf_counter() - t) / GEN_TURNTABLE_FRAMES * 1e3
        if os.path.isdir(out):
            made = f"{len(os.listdir(out))} PNG frames in {os.path.basename(out)}/"
            if len(os.listdir(out)) != GEN_TURNTABLE_FRAMES:
                raise RuntimeError(f"gen turntable: {made}")
        elif os.path.getsize(out) > 0:
            made = f"{os.path.basename(out)} ({os.path.getsize(out)} bytes)"
        else:
            raise RuntimeError("gen turntable wrote an empty file")
        log(f"# gen turntable ({card}): {GEN_TURNTABLE_FRAMES} frames of {S}^2 at the test-time budget, "
            f"{tt_ms:.2f} ms a frame (render and encode); {made}")
        stats = dict(ms_step=ms_step, fit_s=fit_s, refresh_s=refresh_s, busy=PROFILED["gen"][1],
                     wall=PROFILED["gen"][0], loss_first=float(loss[0]), loss_last=float(loss[-1]),
                     turntable_ms=tt_ms, turntable=made, launches=launches, view_launches=view_launches)
        del system, state, cap, cap_grid
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    return rows, stats


# ---------------------------------------------------------------------------
# The text-to-image prior at Stable Diffusion 2.1-base's published widths
# ---------------------------------------------------------------------------

T2I_STEPS, T2I_IGNORE_T = 4, 600  # DDIM 751, 501, 251, 1: one re-noise, three denoising steps
T2I_VAE_SCALING = 0.18215


def t2i_phase(card):
    """One ``Text2ImgGuidance.generate_sr`` refresh of a 128^2 render with
    seeded random weights at SD 2.1-base's widths (the UNet: 4 -> 4,
    (320, 640, 1280, 1280), heads (5, 10, 20, 20), cross-attention 1024,
    linear projections, no class embedding; the VAE (128, 256, 512, 512),
    scaling 0.18215; 77 x 1024 prompt embeddings): ms per UNet call at 16^2
    latents, VAE encode / decode ms, peak memory; one UNet call at 8^2
    latents held to the CPU (float32, TF32 off)."""
    from trinerflet_tpu_torch.sr import diffusion as D
    from trinerflet_tpu_torch.sr.guidance import GuidanceConfig, Text2ImgGuidance

    g = torch.Generator().manual_seed(SEED + 11)
    ucfg = D.SD2_TEXT2IMG_UNET
    vcfg = D.VAEConfig(block_out_channels=(128, 256, 512, 512), scaling_factor=T2I_VAE_SCALING)
    t0 = time.perf_counter()
    unet, vae = D.init_unet_params(ucfg, g, DEVICE), D.init_vae_params(vcfg, g, DEVICE)
    cond = torch.randn((1, 77, ucfg.cross_attention_dim), generator=g).to(DEVICE)
    uncond = torch.randn((1, 77, ucfg.cross_attention_dim), generator=g).to(DEVICE)
    torch.cuda.synchronize()
    log(f"# t2i (SD 2.1-base widths, seeded random weights): UNet {_n_params(unet) / 1e6:.1f} M, VAE "
        f"{_n_params(vae) / 1e6:.1f} M parameters, 77 x {ucfg.cross_attention_dim} prompt embeddings; made in "
        f"{time.perf_counter() - t0:.2f} s")
    timings = defaultdict(list)

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            timings[name].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    def encode(x):
        with torch.no_grad():
            return D.vae_encode(vae, vcfg, 2.0 * x - 1.0)

    def decode(z):
        with torch.no_grad():
            return 0.5 * (D.vae_decode(vae, vcfg, z) + 1.0)

    guide = Text2ImgGuidance(GuidanceConfig(num_inference_steps=T2I_STEPS, guidance_scale=7.5),
                             timed("unet", D.make_text2img_denoiser(unet, ucfg, cond, uncond)),
                             encode=timed("encode", encode), decode=timed("decode", decode))
    render = torch.rand((1, 3, 128, 128), generator=g).to(DEVICE)
    lr = render[:, :, ::4, ::4]
    guide.generate_sr(lr, render, ignore_t=T2I_IGNORE_T, generator=torch.Generator(device=DEVICE).manual_seed(1))
    timings.clear()  # the first call carried the one-time costs
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = guide.generate_sr(lr, render, ignore_t=T2I_IGNORE_T,
                            generator=torch.Generator(device=DEVICE).manual_seed(1))
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    latent = tuple(encode(render).shape)
    if tuple(out.shape) != (1, 3, 128, 128) or not torch.isfinite(out).all() or latent != (1, 4, 16, 16):
        raise RuntimeError(f"t2i generate_sr gave {tuple(out.shape)} (latents {latent}), finite "
                           f"{bool(torch.isfinite(out).all())}")
    stats = dict(gen_ms=gen_ms, unet_ms=float(np.median(timings["unet"])), unet_calls=len(timings["unet"]),
                 encode_ms=timings["encode"][0], decode_ms=timings["decode"][0], peak_gib=peak)
    log(f"# t2i generate_sr ({card}, TF32 {'on' if torch.backends.cudnn.allow_tf32 else 'off'} for "
        f"convolutions, {'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'} for matmuls): a 128^2 "
        f"render, latents {latent}, {T2I_STEPS} DDIM steps with ignore_t {T2I_IGNORE_T}, text CFG 7.5: "
        f"{gen_ms:.1f} ms; {stats['unet_calls']} UNet calls {stats['unet_ms']:.2f} ms each (median, 16^2 "
        f"latents), VAE encode {stats['encode_ms']:.2f} ms, decode {stats['decode_ms']:.2f} ms; peak memory "
        f"{peak:.2f} GiB")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        x = torch.randn((1, 4, 8, 8), generator=g)
        with torch.no_grad():
            a = D.unet_apply(unet, ucfg, x.to(DEVICE), 501, cond).cpu()
            b = D.unet_apply(TR._map(lambda v: v.cpu(), unet), ucfg, x, 501, cond.cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    err, scale = (a - b).abs().max().item(), b.abs().max().item()
    log(f"# t2i UNet (8^2 latents, t 501), card vs CPU (float32, TF32 off, tolerance {SR_NET_TOL} x "
        f"max|cpu|): max|diff| {err:.3e} of max|cpu| {scale:.3e}")
    if not (torch.isfinite(a).all() and err <= SR_NET_TOL * scale):
        raise RuntimeError(f"t2i UNet: card vs CPU max|diff| {err} > {SR_NET_TOL} x {scale}")
    return stats


# ---------------------------------------------------------------------------
# CLIP-guided --rand_pose through the CLI, at ViT-B/16's published widths
# ---------------------------------------------------------------------------

# openai/clip-vit-base-patch16's config.json widths
CLIP_VISION = dict(image_size=224, patch_size=16, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                   intermediate_size=3072, hidden_act="quick_gelu")
CLIP_TEXT = dict(vocab_size=49408, hidden_size=512, num_hidden_layers=12, num_attention_heads=8,
                 intermediate_size=2048, max_position_embeddings=77, hidden_act="quick_gelu")
CLIP_PROJECTION = 512
CLIP_PROMPT = "a wooden chair"
# the README's stage-1 recipe at its widths, one stage, cut to 64 steps; a
# CLIP step after every 3 supervised ones (--rand_pose 3)
STAGE1_ARGS = ["-O", "--triplane_wavelet", "--bound", "1.5", "--dt_gamma", "0", "--scale", "1.0",
               "--triplane_resolution", "512", "--triplane_wavelet_levels", "8", "--triplane_channels", "16",
               "--num_rays", "20000", "--wavelet_regularization", "0.2"]
CLIP_ITERS, CLIP_K = 64, 3
CLIP_KERNELS = ("march", "grid_sample", "grid_sample_bwd", "composite", "composite_bwd", "idwt",
                "idwt_adjoint")


def write_clip_checkpoint(d):
    """A --clip_ckpt directory at ViT-B/16's widths: seeded random weights
    as ``pytorch_model.bin`` (torch.save of the state dict), ``config.json``
    and a character-level ``vocab.json`` / ``merges.txt`` that cover the
    prompt (BOS 49406, EOS 49407, the largest id)."""
    from trinerflet_tpu_torch.sr.text import TextConfig
    from trinerflet_tpu_torch.utils.clip_loss import VisionConfig, init_clip_params

    os.makedirs(d, exist_ok=True)
    config = {"projection_dim": CLIP_PROJECTION, "vision_config": CLIP_VISION, "text_config": CLIP_TEXT}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)
    vcfg = VisionConfig.from_json(os.path.join(d, "config.json"))
    tcfg = TextConfig(vocab_size=CLIP_TEXT["vocab_size"], hidden_size=CLIP_TEXT["hidden_size"],
                      num_layers=CLIP_TEXT["num_hidden_layers"], num_heads=CLIP_TEXT["num_attention_heads"],
                      intermediate_size=CLIP_TEXT["intermediate_size"],
                      max_length=CLIP_TEXT["max_position_embeddings"], hidden_act="quick_gelu")
    params = init_clip_params(vcfg, tcfg, torch.Generator().manual_seed(SEED + 13), "cpu")
    state = {n: t.contiguous() for n, t in TR._leaves(params)}
    torch.save(state, os.path.join(d, "pytorch_model.bin"))
    vocab = {"<|startoftext|>": 49406, "<|endoftext|>": 49407}
    for i, c in enumerate("abcdefghijklmnopqrstuvwxyz"):
        vocab[c], vocab[c + "</w>"] = i, 26 + i
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    return vcfg, tcfg, sum(t.numel() for t in state.values())


def clip_step_check(trainer, state, card):
    """One CLIP step's loss and per-group gradients at full width (the CLI's
    field and the CLIP loss at ViT-B/16's widths), kernels on the card
    against the plain versions on the CPU, on the same pose and noise."""
    from trinerflet_tpu_torch.utils.clip_loss import CLIPLoss

    H, W = trainer.clip_hw
    pose = TR.rand_poses(np.random.default_rng(SEED + 17), 1, radius=trainer.clip_radius)[0]
    f = 0.5 * W / np.tan(0.5 * np.radians(53.0))
    ro, rd = (torch.as_tensor(a) for a in rays_full_image(pose, (f, f, W / 2, H / 2), H, W))
    noise = torch.rand((H * W,), generator=torch.Generator().manual_seed(SEED + 19))
    cl = trainer.clip_loss
    results = {}
    for dev in (DEVICE, "cpu"):
        if dev == DEVICE:
            tr = trainer
        else:
            tr = Trainer(trainer.nerf_cfg, trainer.render_cfg, trainer.cfg, device="cpu")
            cpu = CLIPLoss(params=TR._map(lambda t: t.cpu(), cl.params), vision_cfg=cl.vision_cfg,
                           text_cfg=cl.text_cfg)
            cpu.text_zs = cl.text_zs.cpu()
            tr.set_clip_guidance(cpu, trainer.rand_pose_interval, radius=trainer.clip_radius)
        params = TR._map(lambda t: t.detach().to(dev).requires_grad_(True), state.params)
        occ = type(state.occ)(*[x.to(dev) for x in state.occ])
        t0 = time.perf_counter()
        loss = tr._clip_loss_fn(params, occ, ro.to(dev), rd.to(dev), None, noise=noise.to(dev))
        named = TR._leaves(params)
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(named, grads)]
        if dev == DEVICE:
            torch.cuda.synchronize()
        results[dev] = (loss.item(), _groups(zip([n for n, _ in named], grads)), time.perf_counter() - t0)
    (lg, gg, tg), (lc, gc, tc) = results[DEVICE], results["cpu"]
    loss_err = abs(lg - lc) / abs(lc)
    errs = {k: (torch.linalg.norm(gg[k] - gc[k]) / torch.linalg.norm(gc[k])).item() for k in gc
            if torch.linalg.norm(gc[k]) > 0}
    log(f"# clip step check ({H}^2 render, full width, ViT-B/16 widths, {card}): loss card {lg:.7f} vs CPU "
        f"plain {lc:.7f} (rel {loss_err:.2e}, tol {CHECK_LOSS_TOL}); gradient rel L2 "
        f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } (tol {CHECK_GRAD_TOL}); {tg:.2f} s on the card, "
        f"{tc:.2f} s on the CPU")
    if loss_err > CHECK_LOSS_TOL or not errs or max(errs.values()) > CHECK_GRAD_TOL:
        raise RuntimeError("the clip kernel step disagrees with the plain versions")


def clip_network_check(trainer, card):
    """``CLIPLoss`` at ViT-B/16's widths on the card against the CPU
    (float32, TF32 off): the loss and its image gradient on a 141^2 image
    (up to 224) and an 800^2 one (down to 224)."""
    from trinerflet_tpu_torch.utils.clip_loss import CLIPLoss

    cl = trainer.clip_loss
    cpu = CLIPLoss(params=TR._map(lambda t: t.cpu(), cl.params), vision_cfg=cl.vision_cfg, text_cfg=cl.text_cfg)
    cpu.text_zs = cl.text_zs.cpu()
    g = torch.Generator().manual_seed(SEED + 23)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    checks = []
    try:
        for side in (trainer.clip_hw[0], 800):
            x = torch.rand((1, side, side, 3), generator=g)
            out = {}
            for dev, fn in ((DEVICE, cl), ("cpu", cpu)):
                xi = x.to(dev).requires_grad_(True)
                v = fn(xi)
                (gx,) = torch.autograd.grad(v, [xi])
                out[dev] = (v.item(), gx.cpu())
            (vg, gg), (vc, gc) = out[DEVICE], out["cpu"]
            gerr = ((gg - gc).abs().max() / gc.abs().max()).item()
            checks.append(f"{side}^2: loss {vg:.7f} vs {vc:.7f} (rel {abs(vg - vc) / abs(vc):.2e}), image "
                          f"gradient max|diff| / max|cpu| {gerr:.2e}")
            if abs(vg - vc) > SR_NET_TOL * abs(vc) or gerr > SR_NET_TOL * 10:
                raise RuntimeError(f"CLIPLoss at {side}^2: card vs CPU {checks[-1]}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    log(f"# clip CLIPLoss at ViT-B/16 widths, card vs CPU (float32, TF32 off; loss within {SR_NET_TOL} "
        f"relative, gradient within {SR_NET_TOL * 10} of its largest entry, {card}): " + "; ".join(checks))


def clip_phase(card, scene_dir, root):
    """``trinerflet_tpu_torch.cli`` with ``--rand_pose 3 --clip_ckpt`` on the
    cli phase's scene at the README's stage-1 widths (64 steps): launches of
    the whole run and of its CLIP steps, ms per CLIP step beside ms per
    supervised step; a captured CLIP step's kernel rows; the step check on
    one CLIP step; ``CLIPLoss`` card vs CPU. Returns (kernel rows, stats)."""
    from trinerflet_tpu_torch import cli

    d = os.path.join(root, "clip_ckpt")
    t0 = time.perf_counter()
    vcfg, tcfg, n = write_clip_checkpoint(d)
    log(f"# clip checkpoint: ViT-B/16 widths (vision {vcfg.image_size}/{vcfg.patch_size}, {vcfg.hidden_size} "
        f"wide, {vcfg.num_layers} layers; text {tcfg.hidden_size} wide, {tcfg.num_layers} layers, vocab "
        f"{tcfg.vocab_size}; projection {vcfg.projection_dim}), {n / 1e6:.1f} M seeded random parameters "
        f"written as pytorch_model.bin ({os.path.getsize(os.path.join(d, 'pytorch_model.bin')) / 2**20:.0f} "
        f"MiB) in {time.perf_counter() - t0:.2f} s; prompt {CLIP_PROMPT!r}")
    ws = os.path.join(root, "ws_clip")
    args = (["--path", scene_dir, "--workspace", ws, "--clip_ckpt", d, "--clip_text", CLIP_PROMPT] + STAGE1_ARGS
            + ["--iters", str(CLIP_ITERS), "--rand_pose", str(CLIP_K)])
    secs, clip_launches = defaultdict(list), defaultdict(int)
    orig_clip, orig_step = Trainer.clip_guidance_step, Trainer.train_step

    def clip_step(tr, st):
        before = dict(kernels.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_clip(tr, st)
        torch.cuda.synchronize()
        secs["clip"].append(time.perf_counter() - t)
        for k, v in kernels.launches.items():
            clip_launches[k] += v - before.get(k, 0)
        return out

    def train_step(tr, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_step(tr, *a, **k)
        torch.cuda.synchronize()
        secs["step"].append(time.perf_counter() - t)
        return out

    Trainer.clip_guidance_step, Trainer.train_step = clip_step, train_step
    kernels.reset_launches()
    try:
        trainer, state = cli.main(args, device=DEVICE)
    finally:
        Trainer.clip_guidance_step, Trainer.train_step = orig_clip, orig_step
    launches, clip_launches = dict(kernels.launches), dict(clip_launches)
    n_clip, n_sup = len(secs["clip"]), len(secs["step"])
    if (n_clip, n_sup) != (CLIP_ITERS // (CLIP_K + 1), CLIP_ITERS) or state.step != n_clip + n_sup:
        raise RuntimeError(f"clip: {n_clip} CLIP and {n_sup} supervised steps, step {state.step}")
    clip_ms, sup_ms = (float(np.median(secs[k][2:])) * 1e3 for k in ("clip", "step"))
    log(f"# clip cli ({card}): {n_sup} supervised + {n_clip} CLIP steps on a {trainer.clip_hw[0]}^2 render, "
        f"{sup_ms:.3f} ms per supervised step, {clip_ms:.3f} ms per CLIP step (medians, host-synchronised); "
        f"launches {launches}; in the CLIP steps {clip_launches}")
    for name in CLIP_KERNELS:
        if launches[name] == 0 or clip_launches.get(name, 0) == 0:
            raise RuntimeError(f"kernel {name} was not launched on the clip path")
    state = profile_step(None, state, None, "clip", step=trainer.clip_guidance_step)
    with Capture() as cap:
        state, _ = trainer.clip_guidance_step(state)
    torch.cuda.synchronize()
    rows = path_kernel_rows(trainer, cap.calls, clip_launches, "clip step")
    rows += label_rows(_k4_forward_rows(cap.calls, ""), clip_launches, "clip step")
    del cap
    clip_step_check(trainer, state, card)
    clip_network_check(trainer, card)
    return rows, dict(clip_ms=clip_ms, sup_ms=sup_ms, launches=launches, clip_launches=clip_launches,
                      busy=PROFILED["clip"][1], wall=PROFILED["clip"][0])


# ---------------------------------------------------------------------------
# The HTTP viewer: --gui --test over the cli phase's checkpoint, then --gui
# training
# ---------------------------------------------------------------------------

GUI_FRAMES = [(1.2, 0.0), (1.0, 0.8), (1.4, 2.0), (0.8, 3.5), (1.6, 5.0)]  # (theta, phi) at radius 2
GUI_HW = 800
GUI_TRAIN_ITERS = 64


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url, timeout=300):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


class _SyncTimed:
    """Device-synchronised wall time of each call of the given (class,
    method name) pairs while inside (patched on the class), in ``secs``."""

    def __init__(self, *targets):
        self.targets = targets
        self.secs = defaultdict(list)
        self._orig = {}

    def __enter__(self):
        for cls, name in self.targets:
            orig = getattr(cls, name)
            self._orig[(cls, name)] = orig

            def wrap(obj, *a, _orig=orig, _name=name, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _orig(obj, *a, **k)
                torch.cuda.synchronize()
                self.secs[_name].append(time.perf_counter() - t)
                return out

            setattr(cls, name, wrap)
        return self

    def __exit__(self, *exc):
        for (cls, name), orig in self._orig.items():
            setattr(cls, name, orig)


def gui_phase(card, scene_dir, ws):
    """``cli --gui --test`` serving the cli phase's checkpoint: a loopback
    client fetches the page, /state, five 800^2 frames and /stop; each
    frame's bytes must be the encoder's bytes of ``render_image`` at the same
    orbit pose. Then ``cli --gui`` training: /state advances, a frame is
    served mid-run, the loop ends at its iterations and writes
    ``latest_model.pkl``. Returns stats."""
    import threading

    from trinerflet_tpu_torch import cli, native
    from trinerflet_tpu_torch.utils.gui import NeRFGUI, OrbitCamera

    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    got, errors = {}, []

    def client():
        try:
            for _ in range(600):  # the server comes up once the checkpoint has loaded
                try:
                    got["page"] = _http(base + "/", timeout=5)
                    break
                except OSError:
                    time.sleep(0.5)
            got["state"] = json.loads(_http(base + "/state"))
            got["frames"], got["ms"] = [], []
            for th, ph in GUI_FRAMES:
                t = time.perf_counter()
                got["frames"].append(_http(f"{base}/frame?theta={th}&phi={ph}&radius=2.0&w={GUI_HW}&h={GUI_HW}"))
                got["ms"].append((time.perf_counter() - t) * 1e3)
            got["stop"] = _http(base + "/stop")
        except Exception as e:  # reported below: the loop then ends at its deadline
            errors.append(repr(e))

    t = threading.Thread(target=client, daemon=True)
    t.start()
    args = ["--path", scene_dir, "--workspace", ws] + CLI_ARGS
    with _SyncTimed((NeRFGUI, "render_frame"), (Trainer, "render_image")) as timed:
        trainer, state = cli.main(args + ["--gui", "--test", "--gui_port", str(port), "--W", str(GUI_HW),
                                          "--H", str(GUI_HW)], device=DEVICE)
    t.join(timeout=60)
    if errors or got.get("stop") != b"ok" or len(got.get("frames", [])) != len(GUI_FRAMES):
        raise RuntimeError(f"gui --test client: {errors}, got {sorted(got)}")
    if b"/frame?theta=" not in got["page"] or got["state"]["training"] or got["state"]["step"] != state.step:
        raise RuntimeError(f"gui --test: page or state {got['state']}")
    cam = OrbitCamera(GUI_HW, GUI_HW, 2.0, 60.0)
    enc_ms = []
    for (th, ph), body in zip(GUI_FRAMES, got["frames"]):
        img, _ = trainer.render_image(state.ema_params, state.occ, cam.pose(th, ph, 2.0),
                                      cam.intrinsics(GUI_HW, GUI_HW), GUI_HW, GUI_HW)
        u8 = (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        t0 = time.perf_counter()
        want = native.encode_jpeg(u8, 90)
        enc_ms.append((time.perf_counter() - t0) * 1e3)
        if body != want:
            raise RuntimeError(f"gui frame ({th}, {ph}): {len(body)} bytes served, the encoder gives "
                               f"{len(want)} bytes of render_image's frame")
    log(f"# gui --test ({card}): page, /state {got['state']}, {len(GUI_FRAMES)} {GUI_HW}^2 frames "
        f"{[round(m, 1) for m in got['ms']]} ms each (request to last byte; render_frame "
        f"{[round(1e3 * x, 1) for x in timed.secs['render_frame']]} ms, of which render_image "
        f"{[round(1e3 * x, 1) for x in timed.secs['render_image']]}), {len(got['frames'][0])} bytes the "
        f"first; JPEG encode alone {float(np.median(enc_ms)):.2f} ms (median, {os.cpu_count()} host cores); "
        f"each frame's bytes the encoder's bytes of render_image at its pose; /stop ended the loop")
    del trainer, state

    # --gui training on the stage-1 recipe
    ws_gui = ws + "_gui"
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    seen, frame, errors = [], {}, []

    def poller():
        try:
            for _ in range(600):  # the server comes up once the scene has loaded
                try:
                    st = json.loads(_http(base + "/state", timeout=5))
                    break
                except OSError:
                    time.sleep(0.2)
            while True:
                seen.append((st["step"], st["training"], st["loss"]))
                if st["training"] and 0 < st["step"] < GUI_TRAIN_ITERS and "body" not in frame:
                    t = time.perf_counter()
                    frame["body"] = _http(f"{base}/frame?theta=1.2&phi=0.5&radius=2.0&w=400&h=400")
                    frame["ms"], frame["step"] = (time.perf_counter() - t) * 1e3, st["step"]
                st = json.loads(_http(base + "/state"))
        except OSError:
            pass  # the loop ended and closed its server
        except Exception as e:
            errors.append(repr(e))

    t = threading.Thread(target=poller, daemon=True)
    t.start()
    gui_args = (["--path", scene_dir, "--workspace", ws_gui] + STAGE1_ARGS
                + ["--iters", str(GUI_TRAIN_ITERS), "--gui", "--gui_port", str(port)])
    kernels.reset_launches()
    t0 = time.perf_counter()
    with _SyncTimed((NeRFGUI, "train_loop"), (NeRFGUI, "render_frame"), (Trainer, "train_step"),
                    (Trainer, "update_grid"), (Trainer, "save_checkpoint")) as timed:
        trainer, state = cli.main(gui_args, device=DEVICE)
    train_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    t.join(timeout=60)
    steps = [s for s, _, _ in seen]
    log(f"# gui train ({card}): {GUI_TRAIN_ITERS} iterations in {train_s:.2f} s (cli.main: the scene's load, "
        f"the trainer, the loop and the checkpoint); seconds in "
        f"{dict((k, round(sum(v), 3)) for k, v in timed.secs.items())} ({len(timed.secs['train_step'])} train "
        f"steps, {len(timed.secs['update_grid'])} refreshes); /state steps seen {steps}; a 400^2 frame at step "
        f"{frame.get('step')} in {frame.get('ms', float('nan')):.1f} ms; files {sorted(os.listdir(ws_gui))}; "
        f"launches {launches}")
    if errors or state.step != GUI_TRAIN_ITERS or not os.path.exists(os.path.join(ws_gui, "latest_model.pkl")):
        raise RuntimeError(f"gui train: {errors}, step {state.step}")
    if not (len(set(steps)) >= 2 and steps == sorted(steps) and "body" in frame
            and frame["body"][:2] == b"\xff\xd8"):
        raise RuntimeError(f"gui train: /state steps {steps}, a frame mid-run {sorted(frame)}")
    for name in CLI_KERNELS:
        if launches[name] == 0:
            raise RuntimeError(f"kernel {name} was not launched on the gui train path")
    return dict(frame_ms=float(np.median(got["ms"])), enc_ms=float(np.median(enc_ms)), train_s=train_s,
                steps=steps)


# ---------------------------------------------------------------------------
# The web launcher: LaunchMonitor and make_server on loopback, a generation
# run as its child
# ---------------------------------------------------------------------------

WEBAPP_GEN = dict(total_steps=32, views_per_refresh=2, refresh_every=16)
WEBAPP_EXTRA = ""  # the child's extra arguments (none: it runs on the card, its default)


def webapp_phase(card):
    """``webapp.LaunchMonitor`` and ``make_server`` on loopback: POST /run of
    the SR launcher on a generation YAML at the srtex widths (32 steps, 2
    views a round, a refresh every 16) written to a temporary configs
    directory; /status polled until the child exits with rc 0; /artifact
    must serve its turntable. Returns stats."""
    import threading
    import urllib.request

    import yaml

    from trinerflet_tpu_torch.webapp import LaunchMonitor, make_server

    root = tempfile.mkdtemp(prefix="chip_smoke_webapp_")
    try:
        cfgs = os.path.join(root, "configs")
        os.makedirs(cfgs)
        with open(os.path.join(cfgs, "gen.yaml"), "w") as f:
            yaml.safe_dump(gen_config(**WEBAPP_GEN), f)
        mon = LaunchMonitor(configs_dir=cfgs)
        srv = make_server(mon, port=0)
        port = srv.server_address[1]
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            if json.loads(_http(f"http://127.0.0.1:{port}/configs")) != ["gen.yaml"]:
                raise RuntimeError("webapp: /configs")
            ws = os.path.join(root, "ws")
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/run", method="POST", headers={"Content-Type": "application/json"},
                data=json.dumps({"app": "sr", "config": "gen.yaml", "workspace": ws, "extra": WEBAPP_EXTRA}).encode())
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=30) as r:
                started = json.loads(r.read())
            st = {}
            while time.perf_counter() - t0 < 300:
                st = json.loads(_http(f"http://127.0.0.1:{port}/status"))
                if not st["alive"]:
                    break
                time.sleep(1.0)
            run_s = time.perf_counter() - t0
            if st.get("alive") or st.get("returncode") != 0:
                mon.stop()
                raise RuntimeError(f"webapp child: {st.get('returncode')} after {run_s:.0f} s; log tail:\n"
                                   f"{st.get('log', '')}")
            art = _http(f"http://127.0.0.1:{port}/artifact")
            name = st["artifact"]
            if not (name == "turntable.mp4" or name.endswith(".png")) or len(art) == 0:
                raise RuntimeError(f"webapp /artifact: {name!r}, {len(art)} bytes")
            if not os.path.exists(os.path.join(ws, "sr_state.pkl")):
                raise RuntimeError(f"webapp child wrote {sorted(os.listdir(ws))}")
        finally:
            mon.stop()
            srv.shutdown()
            srv.server_close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"# webapp ({card}): POST /run started {started['cmd']!r}; the child ran {WEBAPP_GEN} at the srtex "
        f"widths and exited 0 after {run_s:.1f} s (its start, the kernels' load and the turntable included); "
        f"/artifact served {name} ({len(art)} bytes); log tail {st['log'][-160:]!r}")
    return dict(run_s=run_s, artifact=name)


def second_order_phase():
    """A create_graph=True first derivative through each kernel function on
    the card, then a backward through it: through K11, K4, K3, K3c and the
    K2 backward taken in the planes alone it must raise torch's
    once_differentiable error, as the CPU tests' plain versions do
    (``tests/test_torch_second_order.py``); through the coordinate gradients
    of K2, K7 and K10 it runs K2x², K7x² and K10², and a backward through
    that second derivative must raise."""
    g = torch.Generator().manual_seed(SEED)

    def rnd(*shape, lo=0.0, hi=1.0, grad=False):
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).to(DEVICE).requires_grad_(grad)

    def pts():
        return rnd(256, 3, lo=-0.9, hi=0.9, grad=True)

    cfg7 = GE.GridEncoderConfig(num_levels=4, level_dim=2, base_resolution=8, desired_resolution=64,
                                log2_hashmap_size=12)
    N, S = 8, 4
    comp = RM.CompactSamples(torch.zeros((N * S, 3), device=DEVICE), torch.zeros((N * S, 3), device=DEVICE),
                             torch.cumsum(rnd(N * S, lo=0.01, hi=0.1), 0), rnd(N * S, lo=0.01, hi=0.1),
                             torch.arange(N, dtype=torch.int32, device=DEVICE).repeat_interleave(S),
                             torch.arange(N, dtype=torch.int32, device=DEVICE) * S,
                             torch.full((N,), S, dtype=torch.int32, device=DEVICE),
                             torch.tensor(N * S, dtype=torch.int32, device=DEVICE))
    deltas = rnd(16, 8, lo=0.01, hi=0.1)
    cases = {
        "K2 sample_points": lambda x: GS.sample_points(rnd(3, 16, 16, 16, grad=True), x, 1.0),
        "K7 grid_encode": lambda x: GE.grid_encode(
            {k: v.requires_grad_(True) for k, v in GE.init_grid_params(cfg7, g, DEVICE, std=0.5).items()},
            x, cfg7, 1.0),
        "K10 sample_volume_grid": lambda x: REG.sample_volume_grid(
            {"grid": rnd(16, 16, 16, 4, lo=-1.0, grad=True)}, x, REG.VolumeGridConfig(16, 3), 1.0),
        "K2 backward (planes alone)": None,
        "K11 background_textured": None,
        "K4 idwt2d": None,
        "K3 composite_dense": None,
        "K3c composite_compact": None,
    }
    twice = ("K2 sample_points", "K7 grid_encode", "K10 sample_volume_grid")
    inputs = {"K2 backward (planes alone)": rnd(3, 16, 16, 16, grad=True),
              "K11 background_textured": rnd(64, 128, 3, lo=-1.0, grad=True),
              "K4 idwt2d": rnd(3, 4, 12, 12, grad=True), "K3 composite_dense": rnd(16, 8, hi=5.0, grad=True),
              "K3c composite_compact": rnd(N * S, hi=5.0, grad=True)}
    cases["K2 backward (planes alone)"] = lambda t: GS.sample_points(t, pts().detach(), 1.0)
    cases["K11 background_textured"] = lambda t: REG.background_textured({"bg_texture": t}, rnd(256, 3, lo=-1.0))
    cases["K4 idwt2d"] = lambda yl: W.idwt2d(yl, rnd(3, 4, 3, 12, 12, grad=True), "bior2.2")
    cases["K3 composite_dense"] = lambda s: RM.composite_dense(s, rnd(16, 8, 3, grad=True), deltas,
                                                               torch.cumsum(deltas, 1))[2]
    cases["K3c composite_compact"] = lambda s: RM.composite_compact(s, rnd(N * S, 3, grad=True), comp, N)[2]
    kernels.reset_launches()
    for name, fn in cases.items():
        x = inputs.get(name)
        x = pts() if x is None else x
        (gx,) = torch.autograd.grad(fn(x).sum(), [x], create_graph=True)
        if name in twice:  # differentiable twice: the second derivative runs, the third must raise
            (gx,) = torch.autograd.grad(gx.square().sum(), [x], create_graph=True)
            if not torch.isfinite(gx).all():
                raise RuntimeError(f"a non-finite second derivative through {name} on the card")
        try:
            gx.square().sum().backward()
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        if "differentiate twice" not in raised:
            raise RuntimeError(f"a {'third' if name in twice else 'second'} derivative through {name} on the "
                               f"card did not raise torch's once_differentiable error: {raised!r}")
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernels.launches.items() if v}
    log(f"# second-order: a backward through each create_graph=True first derivative raised on the card "
        f"({', '.join(n for n in cases if n not in twice)}); through {', '.join(twice)} the second derivative "
        f"ran and a third raised; launches {launched}")
    for name in ("grid_sample_bwd", "grid_sample_bwd_xyz", "grid_encode_bwd_x", "volume_grid_bwd",
                 "textured_bg_bwd", "idwt_adjoint", "composite_bwd", "composite_compact_bwd",
                 "grid_sample_bwd_xyz_bwd", "grid_encode_bwd_x_bwd", "volume_grid_bwd_x_bwd"):
        if launched.get(name, 0) == 0:
            raise RuntimeError(f"the second-order phase did not launch {name}")


def _check_layout(launches, what):
    """The occgrid path composited on the per-ray layout (K3) or the global
    one (K5 + K3c), whichever the tuner chose."""
    per_ray = launches["composite"] > 0 and launches["composite_bwd"] > 0
    global_ = all(launches[k] > 0 for k in ("compact", "composite_compact", "composite_compact_bwd"))
    if not (per_ray or global_):
        raise RuntimeError(f"the {what} path composited on neither layout")


def _groups(named):
    """Parameter groups of the step check: the base plane, each wavelet
    level, and each MLP as one vector."""
    out = defaultdict(list)
    for n, t in named:
        key = n if n.startswith("encoder.") else n.split(".")[0]
        out[key].append(t.detach().float().cpu().reshape(-1))
    return {k: torch.cat(v) for k, v in out.items()}


class _ZoomTerms:
    """Records, for every coordinate-gradient call (K2x, or its plain version
    on the CPU), the sum over points and axes of |c * dL/dc|: with the
    learned zoom c = p / (r lb) and lb = bound * lbound_scale, so
    dL/dlbound_scale = -sum(c * dL/dc) / lbound_scale, a sum of signed terms
    whose magnitudes these are."""

    def __enter__(self):
        self.signed, self.absolute = 0.0, 0.0
        self._orig = {n: getattr(GS, n) for n in ("_sample_points_backward_xyz_cuda",
                                                  "sample_points_backward_xyz_plain")}
        for n, fn in self._orig.items():
            def wrap(g, planes, xyz, lb, _fn=fn, **kw):
                out = _fn(g, planes, xyz, lb, **kw)
                t = (xyz.detach().double() * out[1].double())
                self.signed += t.sum().item()
                self.absolute += t.abs().sum().item()
                return out
            setattr(GS, n, wrap)
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(GS, n, fn)


def check_rays(data, what):
    """Ray generation, card vs CPU: the ray of every pixel of every view, by
    ``rays_for_pixels`` on each device. Logs how many rays differ and the
    first that does; returns the card's rays as (V, H, W, 3) origins and
    directions, which both sides of a step check then read, so that a
    difference in the march there is one on identical inputs."""
    V, H, Wd = data["images"].shape[:3]
    flat = torch.arange(V * H * Wd)
    img, pix = flat // (H * Wd), flat % (H * Wd)
    go, gd = rays_for_pixels(data["poses"], data["intrinsics"], Wd, img.to(DEVICE), pix.to(DEVICE))
    co, cd = rays_for_pixels(data["poses"].cpu(), torch.as_tensor(data["intrinsics"]).cpu(), Wd, img, pix)
    go, gd = go.cpu(), gd.cpu()
    differ = (go != co).any(-1) | (gd != cd).any(-1)
    first = ""
    if differ.any():
        i = int(differ.nonzero()[0])
        first = (f"; the first, ray {i} (view {int(img[i])}, pixel {int(pix[i])}): direction card "
                 f"{gd[i].tolist()} vs CPU {cd[i].tolist()}")
    log(f"# {what} ray generation card vs CPU: {int(differ.sum())} of {len(flat)} rays differ, max|diff| "
        f"{(gd - cd).abs().max().item():.3e} (direction), {(go - co).abs().max().item():.3e} (origin){first}; "
        f"the step check reads the card's rays on both devices")
    return go.reshape(V, H, Wd, 3), gd.reshape(V, H, Wd, 3)


def step_check(trainer, state, data, what, n_rays=CHECK_RAYS, unused=(), loss_fn=None, seed=SEED + 2,
               hold=True):
    """One step's loss and gradients at full width on ``n_rays`` rays with an
    injected batch and noise: kernels on the card vs plain versions on the CPU,
    on the trainer's current layout, both on the card's rays (``check_rays``). The groups in ``unused`` (the background
    net, which the trainer, as the JAX trainer, never renders) must get an
    exactly zero gradient on both; every other group a non-zero one.
    ``loss_fn(trainer, params, occ, data, batch, generator) -> (loss, aux)``
    is the step's loss (default the trainer's); ``seed`` draws the batch;
    without ``hold`` the check is read and logged, and nothing is held.

    A learned zoom's gradient is one scalar: the sum of every sample's
    -c dL/dc / lbound_scale (``_ZoomTerms``), whose signed terms cancel, so
    it is held to CHECK_GRAD_TOL of the sum of their magnitudes, not of its
    own value; and it must equal that sum of the recorded terms (1e-3 of
    their magnitudes: the K2x output is what reaches it)."""
    cfg = dataclasses.replace(trainer.cfg, num_rays=n_rays)
    V, H, Wd = data["images"].shape[:3]
    batch = _batch(trainer, n_rays, V, H * Wd, seed)
    if loss_fn is None:
        def loss_fn(tr, params, occ, d, batch, generator):
            return tr._loss_fn(params, occ, d, batch, False, generator)
    results = {}
    rays_o, rays_d = check_rays(data, what)
    for dev in (DEVICE, "cpu"):
        tr = Trainer(trainer.nerf_cfg, trainer.render_cfg, cfg, device=dev)
        params = TR._map(lambda t: t.detach().to(dev).requires_grad_(True), state.params)
        occ = type(state.occ)(*[x.to(dev) for x in state.occ])
        d = {"images": data["images"].to(dev), "rays_o": rays_o.to(dev), "rays_d": rays_d.to(dev)}
        t0 = time.perf_counter()
        with _ZoomTerms() as zoom:
            loss, aux = loss_fn(tr, params, occ, d, batch, torch.Generator(device=dev))
            named = TR._leaves(params)
            grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(named, grads)]
        if dev == DEVICE:
            torch.cuda.synchronize()
        results[dev] = (loss.item(), int(aux.get("num_samples", -1)),
                        _groups(zip([n for n, _ in named], grads)), time.perf_counter() - t0, zoom)
    (lg, ng, gg, tg, _), (lc, nc, gc, tc, zoom) = results[DEVICE], results["cpu"]
    loss_err = abs(lg - lc) / abs(lc)
    errs = {k: (torch.linalg.norm(gg[k] - gc[k]) / torch.linalg.norm(gc[k])).item() for k in gc
            if k not in unused}
    zkey = "encoder.lbound_scale"
    if zkey in gc:
        s = state.params["encoder"]["lbound_scale"].item()
        mag = zoom.absolute / abs(s)
        if abs(-zoom.signed / s - gc[zkey].item()) > 1e-3 * mag:
            raise RuntimeError(f"the zoom's gradient {gc[zkey].item()} is not the sum of its terms "
                               f"{-zoom.signed / s}")
        errs[zkey] = abs(gg[zkey].item() - gc[zkey].item()) / mag
        log(f"# {what} step check: lbound_scale gradient card {gg[zkey].item():.6e} vs CPU "
            f"{gc[zkey].item():.6e}, its terms' magnitudes sum to {mag:.6e} (cancellation "
            f"{mag / max(abs(gc[zkey].item()), 1e-30):.1f}x); held to their sum below")
    log(f"# {what} step check ({n_rays} rays, full width): loss card {lg:.7f} vs CPU plain {lc:.7f} "
        f"(rel {loss_err:.2e}, tol {CHECK_LOSS_TOL}); samples {ng} vs {nc}; gradient rel L2 "
        f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } (tol {CHECK_GRAD_TOL}); "
        f"{tg:.2f} s on the card, {tc:.2f} s on the CPU{'' if hold else '; read, not held'}")
    if not hold:
        return loss_err, errs
    if ng != nc:
        raise RuntimeError("the march kept different samples on the card and on the CPU")
    if loss_err > CHECK_LOSS_TOL or max(errs.values()) > CHECK_GRAD_TOL:
        raise RuntimeError(f"the {what} kernel step disagrees with the plain versions")
    if min(torch.linalg.norm(gc[k]).item() for k in errs) == 0:
        raise RuntimeError(f"a {what} parameter group got no gradient")
    if any(gg[k].abs().max() != 0 or gc[k].abs().max() != 0 for k in unused):
        raise RuntimeError(f"an unused group ({unused}) got a gradient")
    return loss_err, errs


# ---------------------------------------------------------------------------
# Multi-process training and evaluation (parallel/): a one-rank NCCL group,
# then two ranks sharing the one card over gloo, the channel split (M = 2)
# and the ray split (D = 2), each against one process on the same draws
# ---------------------------------------------------------------------------

PAR_RAYS = 32768                  # rays per data rank (bench.py:47 scales num_rays by the device count)
PAR_STEPS = 20                    # steps of each layout on the one-rank NCCL group
PAR_TRAJ = 50                     # the trajectory's steps (the JAX dry run's)
# the first step's gradient against one process's: 1e-4 relative L2 per
# group in float32; with bench's bf16 planes and MLPs a reordered float32
# sum (the model group's partial products, the K2 backward's per-texel sums
# at C / M channels, GEMMs of other shapes) can flip a bf16 rounding, which
# moved the M = 2 encoder gradient by 1.26e-4, so there the bound is the
# trajectory's 1e-3; one process's own reordering floor (the same batch in
# reverse order) is printed beside it
PAR_GRAD_TOL, PAR_GRAD_BF16_TOL, PAR_TRAJ_TOL = 1e-4, 1e-3, 1e-3
PAR_GLOBAL_KERNELS = ("compact", "composite_compact", "composite_compact_bwd")


def _par_scene():
    return make_synthetic_scene(num_views=8, H=256, W=256, num_steps=128)


def _par_trainer(cfgs, num_rays, mesh=None, slots=0, workspace=None):
    """A trainer of ``cfgs`` (bench's, the tuner off) at ``num_rays`` global
    rays, on the global layout at ``slots`` when given."""
    nerf_cfg, render_cfg, train_cfg = cfgs
    train_cfg = dataclasses.replace(train_cfg, num_rays=num_rays)
    if slots:
        render_cfg = dataclasses.replace(render_cfg, compaction="global", global_slots_per_ray=slots)
    return Trainer(nerf_cfg, render_cfg, train_cfg, device=DEVICE, mesh=mesh, workspace=workspace)


def _par_rank_setup(device):
    """A rank's module state: the device its tensors live on (a spawned
    rank imports this script afresh)."""
    global DEVICE
    DEVICE = device


def _par_state(trainer, scene):
    grid = mark_untrained_grid(scene.poses, scene.intrinsics, trainer.render_cfg)
    return trainer.init_state(density_grid=grid)


def _par_nccl_rank(mesh, scene, cfgs, device, rays):
    """The one-rank NCCL group: PAR_STEPS steps on the per-ray layout, then
    PAR_STEPS on the global layout at the slots the tuner's rule gives for
    the live mean; launches and collectives over both."""
    import torch.distributed as dist
    from trinerflet_tpu_torch.parallel import launch

    _par_rank_setup(device)
    tr = _par_trainer(cfgs, rays, mesh)
    data = tr.scene_to_device(scene)
    kernels.reset_launches()
    state, _, secs, aux = launch.trajectory(tr, _par_state(tr, scene), data, PAR_STEPS)
    per_ray = dict(kernels.launches)
    slots = TR.global_slots_for(float(aux["num_samples"]) / rays)
    trg = _par_trainer(cfgs, rays, mesh, slots)
    kernels.reset_launches()
    state, _, secs_g, auxg = launch.trajectory(trg, state, data, PAR_STEPS)
    return dict(backend=dist.get_backend(), world=dist.get_world_size(), shape=mesh.shape,
                staged=mesh.staged, per_ray=per_ray, global_=dict(kernels.launches), slots=slots,
                fill=float(auxg["global_fill"]), ms_per_ray=secs / PAR_STEPS * 1e3,
                ms_global=secs_g / PAR_STEPS * 1e3, loss=(float(aux["loss"]), float(auxg["loss"])),
                collectives=dict(mesh.counts))


def _par_draws(scene, n, seed, reverse=False):
    g = torch.Generator().manual_seed(seed)
    batch = {"img_idx": torch.randint(0, scene.num_views, (n,), generator=g),
             "pix_idx": torch.randint(0, scene.H * scene.W, (n,), generator=g),
             "noise": torch.rand((n,), generator=g)}
    return {k: v.flip(0) for k, v in batch.items()} if reverse else batch


def _par_precision(cfgs, prec):
    """``cfgs`` with float32 planes and MLPs (``prec`` "f32"), or as they
    are (bench's bf16)."""
    if prec == "bf16":
        return cfgs
    nerf_cfg, render_cfg, train_cfg = cfgs
    return (dataclasses.replace(nerf_cfg, compute_dtype="float32", plane_dtype="float32"),
            render_cfg, train_cfg)


def _par_gradient(cfgs, scene, N, mesh=None, reverse=False):
    """The first step's gradient (after the mesh's reductions) on the seeded
    draws, from the seeded state after one full refresh."""
    tr = _par_trainer(cfgs, N, mesh)
    state = _refresh(tr, _par_state(tr, scene), full=True)
    batch = _par_draws(scene, N, SEED + 5, reverse)
    return tr.gradients(state, tr.scene_to_device(scene), with_stats=False, batch=batch)[0]


def _grad_errors(grads, ref, mesh):
    """Relative L2 error of each parameter group's gradient (the triplane,
    each MLP) against one process's (``ref``, full width; its channel slice
    on a model rank)."""
    got = dict(TR._leaves(grads))
    want = dict(TR._leaves(ref))
    out = {}
    groups = {g: [n for n in want if n.split(".")[0] == g] for g in ("encoder", "sigma_net", "color_net")}
    for g, names in groups.items():
        num = den = 0.0
        for n in names:
            w = want[n].to(got[n].device)
            if got[n].shape != w.shape:  # a channel shard (``mesh`` not None)
                c = got[n].shape[1]
                w = w[:, mesh.model_index * c:(mesh.model_index + 1) * c]
            num += float(((got[n].float() - w.float()) ** 2).sum())
            den += float((w.float() ** 2).sum())
        out[g] = (num / max(den, 1e-30)) ** 0.5
    return out


def _fmt(errs):
    return {k: f"{v:.2e}" for k, v in errs.items()}


def _par_pair_rank(mesh, scene, root, cfgs, device, rays):
    """One of the two ranks sharing the card: the first step's gradient
    after the reductions against one process's (saved under ``root``),
    the PAR_TRAJ-step trajectory, and on the channel split (M = 2) one
    captured step's K2 and K4 rows at the shard's width, evaluate and a
    checkpoint; on the ray split (D = 2) evaluate beside one process's
    evaluate of the same params on rank 0."""
    from trinerflet_tpu_torch.parallel import launch

    _par_rank_setup(device)
    what = f"parallel M={mesh.model}" if mesh.model > 1 else f"parallel D={mesh.data}"
    N = rays * mesh.data
    ws = os.path.join(root, f"ws_{mesh.model}{mesh.data}")
    errs = {}
    for prec in ("f32", "bf16"):
        grads = _par_gradient(_par_precision(cfgs, prec), scene, N, mesh)
        ref = torch.load(os.path.join(root, f"grads_{prec}_{N}.pt"), map_location=DEVICE)
        errs[prec] = _grad_errors(grads, ref, mesh)
        del grads, ref
    tr = _par_trainer(cfgs, N, mesh, workspace=ws)
    data = tr.scene_to_device(scene)
    state = _par_state(tr, scene)
    kernels.reset_launches()
    state, losses, secs, _ = launch.trajectory(tr, state, data, PAR_TRAJ)
    launches = dict(kernels.launches)
    out = dict(shape=mesh.shape, rank=mesh.rank, staged=mesh.staged, grad_err=errs, losses=losses,
               ms=secs / PAR_TRAJ * 1e3, launches=launches)
    if mesh.model > 1:
        state, calls = capture_step(tr, state, data)
        rows = path_kernel_rows(tr, calls, launches, what, only=("_sample_points_cuda",
                                                                   "_idwt2d_adjoint_cuda"))
        rows += label_rows(_k4_forward_rows(calls, ""), launches, what)
        for r in rows:
            r["name"] = r["name"].replace(" (", f" at {tr.nerf_cfg.triplane.channels // mesh.model} "
                                                 "channels (", 1)
        out["rows"] = rows
        del calls
        tr.save_checkpoint(state, os.path.join(root, "grid_m2.pkl"), full=False)
        from trinerflet_tpu_torch.parallel.sharding import gather_params

        full = gather_params(mesh, state.params)
        out["param_sums"] = {n: float(t.double().sum()) for n, t in TR._leaves(full)}
        del full
    out["evaluate"] = tr.evaluate(state, scene)
    if mesh.data > 1 and mesh.rank == 0:  # the same (replicated) params in one process
        out["evaluate_one"] = _par_trainer(cfgs, N).evaluate(state, scene)
    out["collectives"] = dict(mesh.counts)
    return out


def _par_one_process(cfgs, scene, N, root):
    """One process on the same draws: the first step's gradient in float32
    and in bf16 (saved for the ranks), the bf16 gradient's reordering floor
    (the same batch in reverse order), and the PAR_TRAJ-step trajectory."""
    from trinerflet_tpu_torch.parallel import launch

    for prec in ("f32", "bf16"):
        grads = _par_gradient(_par_precision(cfgs, prec), scene, N)
        torch.save(TR._map(lambda t: t.detach(), grads), os.path.join(root, f"grads_{prec}_{N}.pt"))
    floor = _grad_errors(_par_gradient(cfgs, scene, N, reverse=True), grads, None)
    del grads
    tr = _par_trainer(cfgs, N)
    _, losses, secs, _ = launch.trajectory(tr, _par_state(tr, scene), tr.scene_to_device(scene), PAR_TRAJ)
    torch.cuda.synchronize()
    return losses, secs / PAR_TRAJ * 1e3, floor


PAR_BACKENDS = ("nccl", "gloo")  # the one-rank group's, the pair's (NCCL refuses two ranks on one card)


def parallel_phase(card, cfgs=None, scene=None):
    """(a) A one-rank NCCL group through ``parallel.launch.run_on_mesh``:
    per-ray and global-layout steps at bench's width; every kernel of each
    layout must launch. (b) Two ranks sharing the card over gloo, M = 2 and
    D = 2: the first step's gradient and the trajectory's tail against one
    process, the K2 / K4 rows at 8 channels, evaluate and a checkpoint.
    Returns (kernel rows, stats)."""
    from trinerflet_tpu_torch.parallel import launch
    from trinerflet_tpu_torch.train import checkpoint

    cfgs = cfgs or bench_configs(PAR_RAYS, budget_autotune=False)
    scene = _par_scene() if scene is None else scene
    t0 = time.perf_counter()
    r = launch.run_on_mesh(_par_nccl_rank, 1, 1, DEVICE, PAR_BACKENDS[0], timeout=600,
                           args=(scene, cfgs, DEVICE, PAR_RAYS))[0]
    log(f"# parallel (a): {r['backend'].upper()} formed a group of {r['world']} (mesh {r['shape']}) on "
        f"{card}; {r['collectives']['all_reduce']} all-reduces and {r['collectives']['all_gather']} "
        f"all-gathers ran over {2 * PAR_STEPS} steps; per-ray {r['ms_per_ray']:.3f} ms/step, global "
        f"layout (x{r['slots']}, fill {r['fill']:.4f}) {r['ms_global']:.3f} ms/step, losses {r['loss']}; "
        f"{time.perf_counter() - t0:.1f} s with the rank's start")
    log(f"# parallel (a) launches: per-ray {r['per_ray']}; global {r['global_']}")
    for name in TRAIN_KERNELS:
        if r["per_ray"][name] == 0:
            raise RuntimeError(f"kernel {name} was not launched on the one-rank NCCL per-ray run")
    for name in GLOBAL_KERNELS:
        if r["global_"][name] == 0:
            raise RuntimeError(f"kernel {name} was not launched on the one-rank NCCL global-layout run")
    if r["backend"] != PAR_BACKENDS[0] or r["world"] != 1 or r["collectives"]["all_reduce"] == 0:
        raise RuntimeError(f"the one-rank group is not an NCCL group that reduced: {r}")
    stats = {"nccl": r}

    root = tempfile.mkdtemp(prefix="chip_smoke_par_")
    rows = []
    try:
        for M, D in ((2, 1), (1, 2)):
            N = PAR_RAYS * D
            t0 = time.perf_counter()
            one_losses, one_ms, floor = _par_one_process(cfgs, scene, N, root)
            t1 = time.perf_counter()
            res = launch.run_on_mesh(_par_pair_rank, 2, M, DEVICE, PAR_BACKENDS[1], timeout=900,
                                     args=(scene, root, cfgs, DEVICE, PAR_RAYS))
            t2 = time.perf_counter()
            what = f"M={M}" if M > 1 else f"D={D}"
            r0 = res[0]
            gaps = [launch.tail_gap(x["losses"], one_losses) for x in res]
            log(f"# parallel (b) {what}: two processes sharing one card over gloo (mesh {r0['shape']}; "
                f"collectives staged through the host: {list(r0['staged']) or 'none, gloo took the CUDA tensors'}); "
                f"{N} rays a step; first-step gradient rel L2 vs one process per group, by rank, "
                f"float32 {[_fmt(x['grad_err']['f32']) for x in res]}, bf16 "
                f"{[_fmt(x['grad_err']['bf16']) for x in res]} (one process's bf16 reordering floor "
                f"{_fmt(floor)}); trajectory tail "
                f"(steps 10-{PAR_TRAJ - 1}) max rel gap by rank {[f'{g:.2e}' for g in gaps]}; losses "
                f"{r0['losses'][0]:.5f} -> {r0['losses'][-1]:.5f} (one process {one_losses[0]:.5f} -> "
                f"{one_losses[-1]:.5f}); {r0['ms']:.3f} ms/step per rank, one process {one_ms:.3f} ms/step "
                f"on {card}: two processes share one card, so this is not a scaling figure; "
                f"collectives of rank 0 {r0['collectives']}; one process {t1 - t0:.1f} s, the pair "
                f"{t2 - t1:.1f} s with the ranks' start")
            log(f"# parallel (b) {what} launches (rank 0, over the trajectory): {r0['launches']}")
            for x in res:
                bad = {k: v for k, v in x["grad_err"]["f32"].items() if not v <= PAR_GRAD_TOL}
                bad.update({f"{k} (bf16)": v for k, v in x["grad_err"]["bf16"].items()
                            if not v <= PAR_GRAD_BF16_TOL})
                if bad:
                    raise RuntimeError(f"parallel {what} rank {x['rank']}: first-step gradient {bad} "
                                       f"over {PAR_GRAD_TOL} relative L2 (float32) or "
                                       f"{PAR_GRAD_BF16_TOL} (bf16)")
            if not max(gaps) < PAR_TRAJ_TOL:
                raise RuntimeError(f"parallel {what}: trajectory tail gap {max(gaps)} >= {PAR_TRAJ_TOL}")
            for name in TRAIN_KERNELS:
                if r0["launches"][name] == 0:
                    raise RuntimeError(f"kernel {name} was not launched on the parallel {what} run")
            table = r0["evaluate"]["per_image"]
            if M > 1:
                one = _par_trainer(cfgs, N)
                loaded = one.load_checkpoint(os.path.join(root, "grid_m2.pkl"))
                sums = {n: float(t.double().sum()) for n, t in TR._leaves(loaded.params)}
                if sums != r0["param_sums"]:
                    raise RuntimeError("the M=2 checkpoint loaded into one process holds other params")
                payload = checkpoint.load(os.path.join(root, "grid_m2.pkl"))
                base = payload["params"]["encoder"]["base"]
                want = one.evaluate(loaded, scene)["per_image"]
                rows += r0["rows"]
                log(f"# parallel (b) M=2 checkpoint: written by rank 0 at full width (base {base.shape}), "
                    f"loaded into one process with the same params ({len(sums)} leaves, sums equal)")
            else:
                want = r0["evaluate_one"]["per_image"]
            diff = max(abs(a["PSNR"] - b["PSNR"]) for a, b in zip(table, want))
            if [a["view"] for a in table] != [b["view"] for b in want] or diff > 1e-4:
                raise RuntimeError(f"parallel {what} evaluate: views {[a['view'] for a in table]} vs "
                                   f"{[b['view'] for b in want]}, max PSNR diff {diff}")
            log(f"# parallel (b) {what} evaluate on 2 ranks: PSNR {r0['evaluate']['PSNR']:.4f} dB over "
                f"views {[a['view'] for a in table]}, one process's table within {diff:.2e} dB")
            stats[what] = dict(ms=r0["ms"], one_ms=one_ms, gaps=gaps, floor=floor,
                               grad_err=[x["grad_err"] for x in res], staged=r0["staged"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rows, stats


# ---------------------------------------------------------------------------
# The GAN stack (utils/gan.py) at GANConfig's defaults on a render of the
# cli phase's checkpoint
# ---------------------------------------------------------------------------

GAN_LR, GAN_CHECK_LR = 128, 32   # the low-res render's side, and the CPU check's
GAN_TOL = 1e-4                   # card vs CPU, float32 with TF32 off, of max|cpu|


def _gan_steps(params, cfg, lr, gt, level, noise2):
    """One generator step's loss and gradient (L1 to ``gt`` + 1e-3 x the
    generator loss through gan_render) and one discriminator step's (the
    hinge loss on ``gt`` against that render)."""
    from trinerflet_tpu_torch.utils import gan as G

    gen = TR._map(lambda t: t.detach().clone().requires_grad_(True), params["generator"])
    out = G.gan_render(dict(params, generator=gen), cfg, lr, gt_rgb=gt, generator_level=level,
                       noise_level2=noise2)
    g_loss = (out["comp_gan_rgb"] - gt).abs().mean() + 1e-3 * G.generator_loss(
        params["discriminator"], out["comp_gan_rgb"])
    g_grads = torch.autograd.grad(g_loss, [t for _, t in TR._leaves(gen)])
    disc = TR._map(lambda t: t.detach().clone().requires_grad_(True), params["discriminator"])
    d_loss = G.discriminator_loss(disc, gt, out["comp_gan_rgb"].detach())
    d_grads = torch.autograd.grad(d_loss, [t for _, t in TR._leaves(disc)])
    return out, g_loss.detach(), list(g_grads), d_loss.detach(), list(d_grads)


def gan_phase(card, scene_dir, ws):
    """``init_gan_stack`` at ``GANConfig``'s defaults (seeded weights) and
    ``gan_render`` at levels 0-2 on a 128^2 render of the cli phase's
    checkpoint (its RGB, with seeded latent moments) to 512^2, the ground
    truth a 512^2 render of the same view; one generator and one
    discriminator step at that size on the card (timed); then, held to the
    CPU (float32, TF32 off), gan_render and one G and one D step at level 2
    on a 32^2 crop of the input (128^2 out). Returns stats."""
    from trinerflet_tpu_torch import cli
    from trinerflet_tpu_torch.utils import gan as G

    opt = cli.get_params(["--path", scene_dir, "--workspace", ws] + CLI_ARGS)
    opt.fp16 = opt.cuda_ray = opt.preload = True  # -O, as cli.run sets it
    for k in cli.STAGE_KEYS:  # the last stage's widths, as --test reads them
        vars(opt)[k] = vars(opt)[k][-1]
    tr = Trainer(*cli.build_configs(opt), device=DEVICE)
    state = tr.load_checkpoint(os.path.join(ws, "latest_model.pkl"))
    test = cli.load_scene(opt, "test")
    fx, fy, cx, cy = test.intrinsics

    def view(side):
        s = side / test.W
        return tr.render_image(state.ema_params, state.occ, test.poses[0], (fx * s, fy * s, cx * s, cy * s),
                               side, side)[0]

    cfg = G.GANConfig()
    g = torch.Generator().manual_seed(SEED)
    rgb, gt = view(GAN_LR)[None], view(4 * GAN_LR)[None]
    moments = torch.cat([0.5 * torch.randn((1, GAN_LR, GAN_LR, cfg.z_channels), generator=g),
                         torch.rand((1, GAN_LR, GAN_LR, cfg.z_channels), generator=g) - 2.0], -1)
    lr = torch.cat([rgb, moments.to(DEVICE)], -1)
    t0 = time.perf_counter()
    params = G.init_gan_stack(torch.Generator().manual_seed(SEED), cfg, DEVICE)
    n_par = {k: _n_params(v) for k, v in params.items()}
    log(f"# gan stack: GANConfig() (ch {cfg.ch}, mult {cfg.ch_mult}, z {cfg.z_channels}), seeded "
        f"weights in {time.perf_counter() - t0:.2f} s: " + ", ".join(f"{k} {v / 1e6:.2f} M" for k, v in n_par.items()))
    noise2 = torch.randn((1, GAN_LR, GAN_LR, cfg.z_channels), generator=g).to(DEVICE)
    render_ms = {}
    with torch.no_grad():
        for level in (0, 1, 2):
            fn = lambda: G.gan_render(params, cfg, lr, gt_rgb=gt, generator_level=level,  # noqa: E731
                                      noise_level2=noise2)
            out = fn()
            if tuple(out["comp_gan_rgb"].shape) != (1, 4 * GAN_LR, 4 * GAN_LR, 3) or not all(
                    torch.isfinite(v).all() for v in out.values()):
                raise RuntimeError(f"gan_render level {level}: {tuple(out['comp_gan_rgb'].shape)}")
            render_ms[level] = time_ms(fn, iters=5, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, g_loss, g_grads, d_loss, d_grads = _gan_steps(params, cfg, lr, gt, 0, noise2)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    if not (torch.isfinite(g_loss) and torch.isfinite(d_loss)
            and all(torch.isfinite(x).all() for x in g_grads + d_grads)):
        raise RuntimeError("gan: non-finite G or D step")
    log(f"# gan ({card}): gan_render {GAN_LR}^2 -> {4 * GAN_LR}^2 ms by level {render_ms}; one G step and one "
        f"D step at that size {step_ms:.1f} ms (G loss {float(g_loss):.5f}, D loss {float(d_loss):.5f})")

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        c = GAN_CHECK_LR
        lr_c, gt_c, n2_c = lr[:, :c, :c].contiguous(), gt[:, :4 * c, :4 * c].contiguous(), noise2[:, :c, :c]
        card_out = _gan_steps(params, cfg, lr_c, gt_c, 2, n2_c)
        cpu = lambda tree: TR._map(lambda x: x.detach().cpu(), tree)  # noqa: E731
        cpu_out = _gan_steps(cpu(params), cfg, lr_c.cpu(), gt_c.cpu(), 2, n2_c.cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    checks = []
    for name, a, b in (("gan_render", card_out[0]["comp_gan_rgb"], cpu_out[0]["comp_gan_rgb"]),
                       ("G loss", card_out[1], cpu_out[1]), ("D loss", card_out[3], cpu_out[3]),
                       ("G grads", torch.cat([x.reshape(-1) for x in card_out[2]]),
                        torch.cat([x.reshape(-1) for x in cpu_out[2]])),
                       ("D grads", torch.cat([x.reshape(-1) for x in card_out[4]]),
                        torch.cat([x.reshape(-1) for x in cpu_out[4]]))):
        err = (a.detach().cpu() - b).abs().max().item()
        scale = b.abs().max().item()
        checks.append(f"{name} max|diff| {err:.3e} of max|cpu| {scale:.3e}")
        if not err <= GAN_TOL * scale:
            raise RuntimeError(f"gan {name}: card vs CPU max|diff| {err} > {GAN_TOL} x {scale}")
    log(f"# gan, card vs CPU at level 2 on a {c}^2 input ({4 * c}^2 out; float32, TF32 off, tolerance "
        f"{GAN_TOL} x max|cpu|): " + "; ".join(checks))
    return dict(render_ms=render_ms, step_ms=step_ms)


# each cut of an earlier phase's depth that made room for the text-to-3D,
# CLIP, viewer and web-launcher phases: (what, before, after), printed first
CUTS = (("cli: an evaluation and a rotating checkpoint every N steps", 64,
         int(CLI_ARGS[CLI_ARGS.index("--eval_interval_stages") + 1])),
        ("registry-sdf: batches of the bf16 step check's readings (not held)", 3, SDF_BF16_BATCHES),
        ("kernel rows: timed calls of each plain version and library call", "20 after 3 warm-ups",
         f"{REF_ITERS} after 1"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(card)
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"# kernels built in {time.perf_counter() - t0:.1f} s (per kernel {secs}) into {_build.BUILD_DIR}")
    log(f"# launch floor: {launch_floor_ms():.4f} ms (time_ms of a one-element fill_) on {card}")
    for what, was, now in CUTS:
        log(f"# cut: {what}: {was} -> {now}")

    torch.manual_seed(SEED)
    with torch.no_grad():
        trainer, params, occ, poses, intr = serve_setup()
        serve_launches, views, ms, steady = serve_phase(trainer, params, occ, poses, intr, card)
        profile_view(trainer, params, occ, poses, intr)
        plain_chunk_check(trainer, params, occ, poses, intr, views)
        rows = kernel_phase(trainer, params, occ, poses, intr)
    del trainer, params, occ, views
    key = {"K1": "march", "K2": "grid_sample", "K3": "composite", "K4": "idwt"}
    for r in rows:
        r["launches"] = serve_launches[key[r["name"][:2]]]
        r["path"] = "serve"
    log(f"# serve phases done at {time.perf_counter() - t_start:.1f} s")

    # per-ray layout, the tuner off (cut to 64 + 50 steps)
    trainer, state, data, scene = train_setup(budget_autotune=False)
    state, perray_launches, perray_stats = train_phase(
        trainer, state, data, card, warm=PERRAY_WARM, n_windows=PERRAY_WINDOWS, what="per-ray train",
        absent=("march_flat",))
    state, calls = capture_step(trainer, state, data)
    rows += path_kernel_rows(trainer, calls, perray_launches, "per-ray train")
    del calls
    step_check(trainer, state, data, "per-ray")
    del trainer, state
    log(f"# per-ray train phases done at {time.perf_counter() - t_start:.1f} s")

    # bench.py's step as bench.py runs it: the tuner on
    trainer, state, data, scene = train_setup(budget_autotune=True, scene=scene)
    state, auto_launches, stats = train_phase(trainer, state, data, card, what="autotune train",
                                              absent=("march_flat",))
    mean = float(stats["aux"]["num_samples"]) / trainer.cfg.num_rays
    state = profile_step(trainer, state, data, "autotune train")
    state, calls = capture_step(trainer, state, data)  # at the shapes the tuner chose
    rows += path_kernel_rows(trainer, calls, auto_launches, "autotune train")
    del calls
    eval_res = evaluate_phase(trainer, state, scene, card)
    state, global_launches, gstats = global_phase(trainer, state, data, card, mean)
    state = profile_step(trainer, state, data, "global-layout train")
    state, calls = capture_step(trainer, state, data)
    rows += path_kernel_rows(trainer, calls, global_launches, "global-layout train")
    del calls
    step_check(trainer, state, data, "global-layout")
    rc = trainer.render_cfg
    del trainer, state
    log(f"# occgrid triplane phases done at {time.perf_counter() - t_start:.1f} s")

    prop_rows, pstats = proposal_phases(scene, card)
    rows += prop_rows
    log(f"# proposal phases done at {time.perf_counter() - t_start:.1f} s")
    hash_rows, hstats = hashgrid_phases(scene, card)
    rows += hash_rows
    log(f"# hashgrid phases done at {time.perf_counter() - t_start:.1f} s")
    flat_rows, fstats = flat_phases(scene, card)
    rows += flat_rows
    log(f"# flat march phases done at {time.perf_counter() - t_start:.1f} s")
    dense_rows, dstats = dense_phases(scene, card)
    rows += dense_rows
    log(f"# dense phases done at {time.perf_counter() - t_start:.1f} s")
    var_rows, vstats = variants_phases(scene, card)
    rows += var_rows
    log(f"# variants phases done at {time.perf_counter() - t_start:.1f} s")
    kp_rows, kstats = kplanes_phases(scene, card)
    rows += kp_rows
    log(f"# k-planes phases done at {time.perf_counter() - t_start:.1f} s")
    rg_rows, rgstats = registry_grid_phase(scene, card)
    rows += rg_rows
    log(f"# registry-grid phases done at {time.perf_counter() - t_start:.1f} s")
    rs_rows, rsstats = registry_sdf_phase(scene, card)
    rows += rs_rows
    log(f"# registry-sdf phases done at {time.perf_counter() - t_start:.1f} s")
    rh_rows, rhstats = registry_hash_phase(card, hstats)
    rows += rh_rows
    del hstats["params"], hstats["occ"]
    log(f"# registry-hash-normals phase done at {time.perf_counter() - t_start:.1f} s")
    an_stats = {}
    for phase in (registry_sdf_analytic_phase, registry_hash_analytic_phase, registry_grid_analytic_phase):
        t_ph = time.perf_counter()
        an_rows, an_stats[phase] = phase(scene, card)
        rows += an_rows
        log(f"# {phase.__name__} done at {time.perf_counter() - t_start:.1f} s ({time.perf_counter() - t_ph:.1f} s)")
    cli_root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        cli_rows, cstats = cli_phase(card, cli_root)
        rows += cli_rows
        log(f"# cli phase done at {time.perf_counter() - t_start:.1f} s")
        t_sr = time.perf_counter()
        sr_rows, srstats = sr_phase(card)
        rows += sr_rows
        log(f"# sr phase done at {time.perf_counter() - t_start:.1f} s ({time.perf_counter() - t_sr:.1f} s)")
        t_ph = time.perf_counter()
        gen_rows, genstats = gen_phase(card)
        rows += gen_rows
        log(f"# gen phase done at {time.perf_counter() - t_start:.1f} s ({time.perf_counter() - t_ph:.1f} s)")
        t_ph = time.perf_counter()
        t2istats = t2i_phase(card)
        log(f"# t2i phase done at {time.perf_counter() - t_start:.1f} s ({time.perf_counter() - t_ph:.1f} s)")
        t_ph = time.perf_counter()
        clip_rows, clipstats = clip_phase(card, cstats["scene_dir"], cli_root)
        rows += clip_rows
        log(f"# clip phase done at {time.perf_counter() - t_start:.1f} s ({time.perf_counter() - t_ph:.1f} s)")
        t_ph = time.perf_counter()
        guistats = gui_phase(card, cstats["scene_dir"], cstats["ws"])
        log(f"# gui phase done at {time.perf_counter() - t_start:.1f} s ({time.perf_counter() - t_ph:.1f} s)")
        t_ph = time.perf_counter()
        webstats = webapp_phase(card)
        log(f"# webapp phase done at {time.perf_counter() - t_start:.1f} s ({time.perf_counter() - t_ph:.1f} s)")
        t_ph = time.perf_counter()
        par_rows, parstats = parallel_phase(card)
        rows += par_rows
        log(f"# parallel phase done at {time.perf_counter() - t_start:.1f} s ({time.perf_counter() - t_ph:.1f} s)")
        t_ph = time.perf_counter()
        ganstats = gan_phase(card, cstats["scene_dir"], cstats["ws"])
        log(f"# gan phase done at {time.perf_counter() - t_start:.1f} s ({time.perf_counter() - t_ph:.1f} s)")
    finally:
        shutil.rmtree(cli_root, ignore_errors=True)
    second_order_phase()

    for r in rows:
        log(f"# {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.6f} "
            f"by {r['bound_by']}, library {r['library_ms']}) max|err| {r['max_abs_err']:.3e} "
            f"(tol {r['tol']}); {r['launches']} launches on the {r['path']} path; {r['note']}")
    fields = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
              "bound_ms", "bound_by", "library_ms")
    log(f"# serve: {VIEW_HW}x{VIEW_HW} views, ms/view {ms} then {steady} on {card}")
    log(f"# per-ray train (budget_autotune=False): {perray_stats['ms_per_step']:.3f} ms/step, "
        f"{perray_stats['rays_per_s']:.1f} rays/s, {perray_stats['samples_per_ray']:.3f} kept "
        f"samples/ray on {card}; launches {perray_launches}")
    log(f"# autotune train: {stats['ms_per_step']:.3f} ms/step (median of {WINDOWS} windows of "
        f"{WINDOW_STEPS}), {stats['rays_per_s']:.1f} rays/s, {stats['samples_per_ray']:.3f} kept "
        f"samples/ray, loss {stats['loss_first']:.5f} -> {stats['loss_last']:.5f} on {card}")
    log(f"# global layout (x{gstats['slots']}): {gstats['ms_per_step']:.3f} ms/step, "
        f"{gstats['rays_per_s']:.1f} rays/s, global_fill {gstats['fill']:.4f}, num_valid "
        f"{gstats['num_valid']:,.1f} on {card}; final config budget {rc.samples_per_ray_budget}, "
        f"num_coarse {rc.num_coarse_override}")
    log(f"# evaluate: PSNR {eval_res['PSNR']:.4f} dB, SSIM {eval_res['SSIM']:.5f} on {card}")
    log(f"# proposal train: {pstats['ms_per_step']:.3f} ms/step, {pstats['rays_per_s']:.1f} rays/s, "
        f"loss {pstats['loss_first']:.5f} -> {pstats['loss_last']:.5f}; evaluate PSNR "
        f"{pstats['psnr']:.4f} dB, SSIM {pstats['ssim']:.5f}; ms/view {pstats['view_ms']} on {card}; "
        f"launches {pstats['launches']}")
    log(f"# hashgrid train: {hstats['ms_per_step']:.3f} ms/step, {hstats['rays_per_s']:.1f} rays/s, "
        f"{hstats['samples_per_ray']:.3f} kept samples/ray, loss {hstats['loss_first']:.5f} -> "
        f"{hstats['loss_last']:.5f}; ms/view {hstats['view_ms']} on {card}; launches "
        f"{hstats['launches']}")
    log(f"# flat train (bound 4, dt_gamma 1/128): {fstats['ms_per_step']:.3f} ms/step, "
        f"{fstats['rays_per_s']:.1f} rays/s, {fstats['samples_per_ray']:.3f} kept samples/ray, loss "
        f"{fstats['loss_first']:.5f} -> {fstats['loss_last']:.5f}; tuner's layout {fstats['layout']}, "
        f"B {fstats['budget']}; evaluate PSNR {fstats['psnr']:.4f} dB, SSIM {fstats['ssim']:.5f}; "
        f"ms/view {fstats['view_ms']} on {card}; launches {fstats['launches']}")
    log(f"# dense train (512 + 64 samples, 4096 rays): {dstats['ms_per_step']:.3f} ms/step, "
        f"{dstats['rays_per_s']:.1f} rays/s, loss {dstats['loss_first']:.5f} -> "
        f"{dstats['loss_last']:.5f}; ms/view {dstats['view_ms']} on {card}; launches "
        f"{dstats['launches']}")
    log(f"# variants train (rotation, lbound zoom, 2 zoom-in levels, bg net, SH 8): "
        f"{vstats['ms_per_step']:.3f} ms/step, {vstats['rays_per_s']:.1f} rays/s, "
        f"{vstats['samples_per_ray']:.3f} kept samples/ray, loss {vstats['loss_first']:.5f} -> "
        f"{vstats['loss_last']:.5f}; quaternion {vstats['rotation']}, lbound_scale "
        f"{vstats['lbound_scale']:.6f}; evaluate PSNR {vstats['psnr']:.4f} dB, SSIM {vstats['ssim']:.5f}; "
        f"ms/view {vstats['view_ms']} on {card}; launches {vstats['launches']}")
    log(f"# k-planes train (multiscale, product): {kstats['ms_per_step']:.3f} ms/step, "
        f"{kstats['rays_per_s']:.1f} rays/s, {kstats['samples_per_ray']:.3f} kept samples/ray, loss "
        f"{kstats['loss_first']:.5f} -> {kstats['loss_last']:.5f}; ms/view {kstats['view_ms']} on "
        f"{card}; launches {kstats['launches']}")
    log(f"# registry-grid train (volume grid R 64 x 16, radiance material, textured background): "
        f"{rgstats['ms_per_step']:.3f} ms/step, {rgstats['rays_per_s']:.1f} rays/s, "
        f"{rgstats['samples_per_ray']:.3f} kept samples/ray, loss {rgstats['loss_first']:.5f} -> "
        f"{rgstats['loss_last']:.5f}; ms/view {rgstats['view_ms']} on {card}; launches {rgstats['launches']}")
    log(f"# registry-sdf train (SDF on bench's triplane, diffuse material, FD normals, env map): "
        f"{rsstats['ms_per_step']:.3f} ms/step, {rsstats['rays_per_s']:.1f} rays/s, loss "
        f"{rsstats['loss_first']:.5f} -> {rsstats['loss_last']:.5f}; analytic view ms/view "
        f"{rsstats['view_ms']}; cos(analytic, FD) median {rsstats['cos_median']:.4f}, 10th percentile "
        f"{rsstats['cos_p10']:.4f} on {card}; launches {rsstats['launches']}, view {rsstats['view_launches']}")
    log(f"# registry-hash-normals view (hash grid, diffuse material, analytic normals): ms/view "
        f"{rhstats['view_ms']}; cos(analytic, FD) median {rhstats['cos_median']:.4f}, 10th percentile "
        f"{rhstats['cos_p10']:.4f} on {card}; launches {rhstats['launches']}")
    for phase, st in an_stats.items():
        log(f"# {phase.__name__[:-6].replace('_', '-')} (trained through analytic normals): "
            f"{st['ms_per_step']:.3f} ms/step, {st['rays_per_s']:.1f} rays/s, {st['samples_per_ray']:.3f} kept "
            f"samples/ray, loss {st['loss_first']:.5f} -> {st['loss_last']:.5f}; step check (float32 MLPs, "
            f"{ANALYTIC_CHECK_RAYS} rays) largest gradient rel L2 {st['check_err']:.3e} in {st['check_s']:.1f} s "
            f"on {card}; launches {st['launches']}")
    log(f"# cli (README recipe, 256 + 256 steps): ms/step by stage {cstats['stage_ms']}; save "
        f"{cstats['save_s']:.3f} s, load {cstats['load_s']:.3f} s, extract_mesh {cstats['mesh_s']:.3f} s; "
        f"PNG decode {cstats['decode_ms']:.3f} ms/view; test PSNR {cstats['psnr']:.4f} dB, SSIM "
        f"{cstats['ssim']:.5f} on {card}; launches {cstats['launches']}, --test "
        f"{cstats['test_launches']}")
    up, sres = srstats["upscaler"], srstats["res"]
    log(f"# sr (srtex recipe at its widths, 8 views, 400 + 200 steps): phase 1 {srstats['p1_ms']:.3f} "
        f"ms/step (one step's device busy {srstats['busy']['phase 1']:.3f} ms), phase 2 "
        f"{srstats['p2_ms']:.3f} ms/step with the refreshes, {srstats['p2_ms_net']:.3f} without (device busy "
        f"{srstats['busy']['phase 2']:.3f} ms), {srstats['refresh_s']:.3f} s per pseudo-GT refresh "
        f"({srstats['n_refresh']}); HR view {srstats['view_ms']:.2f} ms; LR PSNR {sres['PSNR_lr']:.4f}, HR "
        f"PSNR {sres['PSNR_hr']:.4f} (bilinear {sres['PSNR_bilinear']:.4f}) dB, HR SSIM {sres['SSIM_hr']:.5f}; "
        f"x4 upscaler: generate_sr {up['gen_ms']:.1f} ms, UNet {up['unet_ms']:.2f} ms/call, VAE encode "
        f"{up['encode_ms']:.2f} ms, decode {up['decode_ms']:.2f} ms, peak {up['peak_gib']:.2f} GiB, "
        f"text_encode {up['text_ms']:.2f} ms on {card}; launches phase 1 {srstats['p1_launches']}, "
        f"phase 2 {srstats['p2_launches']}, HR view {srstats['view_launches']}")
    log(f"# gen (text-to-3D at the srtex widths, 400 steps, a refresh of 8 views every 100): "
        f"{genstats['ms_step']:.3f} ms/step without the refreshes (one step's device busy "
        f"{genstats['busy']:.3f} ms of {genstats['wall']:.3f} ms under the profiler), {genstats['refresh_s']:.3f} s "
        f"per refresh, loss {genstats['loss_first']:.5f} -> {genstats['loss_last']:.5f}; turntable "
        f"{genstats['turntable_ms']:.2f} ms a frame ({genstats['turntable']}) on {card}; launches "
        f"{genstats['launches']}, refresh view {genstats['view_launches']}")
    log(f"# t2i (SD 2.1-base widths, random weights): generate_sr {t2istats['gen_ms']:.1f} ms, UNet "
        f"{t2istats['unet_ms']:.2f} ms/call at 16^2 latents ({t2istats['unet_calls']} calls), VAE encode "
        f"{t2istats['encode_ms']:.2f} ms, decode {t2istats['decode_ms']:.2f} ms, peak {t2istats['peak_gib']:.2f} "
        f"GiB on {card}")
    log(f"# clip (--rand_pose 3, ViT-B/16 widths, README stage-1 field): {clipstats['sup_ms']:.3f} ms per "
        f"supervised step, {clipstats['clip_ms']:.3f} ms per CLIP step (one's device busy "
        f"{clipstats['busy']:.3f} ms of {clipstats['wall']:.3f} ms under the profiler) on {card}; launches "
        f"{clipstats['launches']}, in the CLIP steps {clipstats['clip_launches']}")
    log(f"# gui: {GUI_HW}^2 frame {guistats['frame_ms']:.1f} ms (median, request to last byte), JPEG encode "
        f"{guistats['enc_ms']:.2f} ms; --gui training {GUI_TRAIN_ITERS} iterations in {guistats['train_s']:.2f} s "
        f"on {card}")
    log(f"# webapp: a generation child through POST /run exited 0 in {webstats['run_s']:.1f} s, artifact "
        f"{webstats['artifact']} on {card}")
    nc = parstats["nccl"]
    log(f"# parallel: a one-rank NCCL group, per-ray {nc['ms_per_ray']:.3f} ms/step, global layout "
        f"{nc['ms_global']:.3f} ms/step, {nc['collectives']['all_reduce']} all-reduces; two processes "
        f"sharing the card over gloo (not a scaling figure): M=2 {parstats['M=2']['ms']:.3f} ms/step (one "
        f"process {parstats['M=2']['one_ms']:.3f}), D=2 {parstats['D=2']['ms']:.3f} ms/step (one process "
        f"{parstats['D=2']['one_ms']:.3f}); trajectory tail gaps M=2 {max(parstats['M=2']['gaps']):.2e}, "
        f"D=2 {max(parstats['D=2']['gaps']):.2e} on {card}")
    log(f"# gan: gan_render {GAN_LR}^2 -> {4 * GAN_LR}^2 ms by level {ganstats['render_ms']}, one G + one D "
        f"step {ganstats['step_ms']:.1f} ms on {card}")
    log(f"# chip_smoke took {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{k: r[k] for k in fields} for r in rows]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
