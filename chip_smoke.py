"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
1. print the card (``nvidia-smi`` name and power limit);
2. build kernels K1-K4 and K6 from ``trinerflet_tpu_torch/kernels/csrc`` with
   nvcc, one process per source, in parallel;
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
   computes the same function, that call's time;
5. train: ``bench.py``'s step (32,768 rays, the same model, wavelet L1 0.4,
   Adam + EMA, refresh every 16 steps) with ``budget_autotune=False`` on the
   synthetic scene (8 views of 256^2): counters zeroed, 320 warm-up steps on
   the bench cadence (full refreshes while iter_density < 16, then the
   rotating quarter; the bbox retune), then 5 timed windows of 50 steps
   (median); counters read; the loss must fall over the warm-up; one step
   under ``torch.profiler``;
6. train kernels: one more step and one partial refresh record the
   arguments the main path hands each kernel wrapper; each kernel (K1 with
   the training stride, K2 forward and backward, K3 forward and backward,
   the K4 adjoint, K6) is held to its plain version on those arguments and
   timed beside its bound and library call;
7. step check: one step's loss and per-group gradients at full width on
   4,096 rays with an injected batch and noise, once on the card (kernels)
   and once on the CPU (plain versions);
8. print the kernels line, then the device line last.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F

from trinerflet_tpu_torch import kernels
from trinerflet_tpu_torch.data.rays import rays_full_image
from trinerflet_tpu_torch.data.synthetic import make_synthetic_scene, orbit_pose, synthetic_intrinsics
from trinerflet_tpu_torch.kernels import _build
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
WARM_STEPS, WINDOW_STEPS, WINDOWS = 320, 50, 5
CHECK_RAYS = 4096
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


def bound_ms(nbytes: float, flops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


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
                     plain_ms=time_ms(lambda: RM.march_hierarchical_plain(*margs, **mkw), iters=5),
                     bound_ms=b, bound_by=by, library_ms=None,
                     note=f"N={N} rays, mean kept samples/ray {mask.float().sum(1).mean().item():.2f}; "
                          f"{probes} probes read {cells_c} coarse and {cells_f} fine grid cells "
                          f"of {occ.occ.numel()} each"))

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
    lib_f32_ms = time_ms(lambda: F.grid_sample(planes_f32, grid_f32, **gs))
    rows.append(dict(name="K2 sample_planes", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/grid_sample.cu",
                     replaces="trinerflet_tpu/ops/grid_sample.py:131",
                     max_abs_err=err2, tol=1e-4,
                     ms=time_ms(lambda: GS.sample_points(planes, xyz, lb)),
                     plain_ms=time_ms(lambda: GS.sample_points_plain(planes, xyz, lb), iters=5),
                     bound_ms=b, bound_by=by,
                     library_ms=time_ms(lambda: F.grid_sample(planes_nchw, grid, **gs)),
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
    b, by = bound_ms(nbytes(*cargs) + nbytes(*got), sig.numel() * 12)
    rows.append(dict(name="K3 composite_dense", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/composite.cu",
                     replaces="trinerflet_tpu/ops/raymarch.py:805",
                     max_abs_err=err3, tol=1e-5,
                     ms=time_ms(lambda: RM.composite_dense(*cargs, t_thresh=rcfg.t_thresh)),
                     plain_ms=time_ms(lambda: RM.composite_dense_plain(*cargs, t_thresh=rcfg.t_thresh)),
                     bound_ms=b, bound_by=by, library_ms=None, note=f"N={N} rays x {B} samples"))

    # ---- K4: the four IDWT levels of the plane build
    tcfg = trainer.nerf_cfg.triplane
    pad = W.idwt_pad(tcfg.wavelet_type)
    x = params["encoder"]["base"].to(torch.bfloat16)
    g0, g1 = W.synthesis_taps(tcfg.wavelet_type, torch.bfloat16)
    L = len(g0)
    pl, _ = W.synthesis_pads(tcfg.wavelet_type)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    err4, sizes, level_bounds = 0.0, [], []
    for i in range(tcfg.levels):
        yh = params["encoder"]["wavelets"][f"level_{i}"].to(torch.bfloat16)
        yl = F.pad(2.0 * x, (pad,) * 4)
        yh = F.pad(yh, (pad,) * 4)
        got = W.idwt2d(yl, yh, tcfg.wavelet_type)
        ref = W.idwt2d_plain(yl, yh, tcfg.wavelet_type)
        e = (got.float() - ref.float()).abs().max().item()
        tol4 = 2.0**-6 * ref.float().abs().max().item()
        if e > tol4:
            raise RuntimeError(f"K4 level {i}: max|err| {e} > {tol4}")
        err4 = max(err4, e)
        P, n = yl.shape[0] * yl.shape[1], yl.shape[-1]
        Ho = got.shape[-1]
        lvl_bytes = nbytes(yl, yh, got)
        lvl_flops = P * n * Ho * 4 * (L // 2) * 2 + P * Ho * Ho * 2 * (L // 2) * 2
        bm, lvl_by = bound_ms(lvl_bytes, lvl_flops)
        level_bounds.append((bm, lvl_by))
        # one grouped transposed convolution computes the same level
        w2 = torch.stack([torch.outer(torch.tensor(a), torch.tensor(c)) for a, c in
                          ((g0, g0), (g0, g1), (g1, g0), (g1, g1))])  # yl, lh, hl, hh
        wt = w2.repeat(P, 1, 1).reshape(4 * P, 1, L, L).to("cuda", torch.bfloat16)
        inp = torch.stack([yl.reshape(P, n, n), yh[:, :, 1].reshape(P, n, n),
                           yh[:, :, 0].reshape(P, n, n), yh[:, :, 2].reshape(P, n, n)], 1)
        inp = inp.reshape(1, 4 * P, n, n).contiguous()
        st = L - 1 - pl
        lib = F.conv_transpose2d(inp, wt, stride=2, groups=P)[0, :, st : st + Ho, st : st + Ho]
        lib_err = (lib.float() - got.reshape(P, Ho, Ho).float()).abs().max().item()
        tot["ms"] += time_ms(lambda: W.idwt2d(yl, yh, tcfg.wavelet_type))
        tot["plain_ms"] += time_ms(lambda: W.idwt2d_plain(yl, yh, tcfg.wavelet_type), iters=5)
        tot["library_ms"] += time_ms(lambda: F.conv_transpose2d(inp, wt, stride=2, groups=P))
        tot["bound_ms"] += bm
        sizes.append(f"{n}->{Ho} (conv_transpose2d max|diff| {lib_err:.2e})")
        x = got
    rows.append(dict(name="K4 idwt2d", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/idwt.cu",
                     replaces="trinerflet_tpu/ops/wavelets.py:510",
                     max_abs_err=err4, tol="2^-6 x max|level|",
                     ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                     bound_by=max(level_bounds)[1], library_ms=tot["library_ms"],
                     note="sum over the 4 levels " + ", ".join(sizes)))
    return rows


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def bench_configs(num_rays: int = 32768):
    """``bench.py``'s training configuration with the budget tuner off."""
    nerf_cfg = NeRFConfig(
        triplane=TriplaneConfig(channels=16, resolution=1024, wavelet_scale=16),
        bound=1.5, compute_dtype="bfloat16", plane_dtype="bfloat16")
    render_cfg = RenderConfig(bound=1.5, grid_size=128, density_thresh=10.0, max_steps=1024,
                              samples_per_ray_budget=20, dt_gamma=0.0)
    train_cfg = TrainConfig(lr=1e-2, iters=10000, num_rays=num_rays, wavelet_regularization=0.4,
                            renderer="occgrid", update_extra_interval=16, budget_autotune=False)
    return nerf_cfg, render_cfg, train_cfg


def train_setup():
    trainer = Trainer(*bench_configs(), device=DEVICE)
    t0 = time.perf_counter()
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
    return trainer, state, data


def _refresh(trainer, state, full):
    return state._replace(occ=trainer.update_grid(state.params, state.occ, generator=state.rng,
                                                  full=full))


def train_phase(trainer, state, data, card):
    """bench.py's cadence: warm-up, then timed windows (median)."""
    interval = trainer.cfg.update_extra_interval
    N = trainer.cfg.num_rays
    kernels.reset_launches()
    losses, aux = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARM_STEPS):
        if i % interval == 0:
            state = _refresh(trainer, state, full=int(state.occ.iter_density) < 16)
            trainer._maybe_retune_march(state)
        state, aux = trainer.train_step(state, data, with_stats=(i + 1) % interval == 0)
        losses.append(aux["loss"])
    losses = torch.stack(losses).cpu()
    warm_s = time.perf_counter() - t0
    windows = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for i in range(WINDOW_STEPS):
            if i % interval == 0:
                state = _refresh(trainer, state, full=False)
            state, aux = trainer.train_step(state, data, with_stats=(i + 1) % interval == 0)
        final_loss = float(aux["loss"])  # host copy: waits for the window's last step
        windows.append((time.perf_counter() - t0) / WINDOW_STEPS * 1e3)
    launches = dict(kernels.launches)
    steps = WARM_STEPS + WINDOWS * WINDOW_STEPS
    ms = float(np.median(windows))
    first, last = losses[:interval].mean().item(), losses[-interval:].mean().item()
    samples = float(aux["num_samples"]) / N
    log(f"# train ({card}): {WARM_STEPS} warm-up steps in {warm_s:.2f} s; windows of "
        f"{WINDOW_STEPS} steps {[round(w, 3) for w in windows]} ms/step; median {ms:.3f} ms/step "
        f"= {N / ms * 1e3:.1f} rays/s; num_coarse {trainer.render_cfg.num_coarse_override}; "
        f"mean kept samples/ray {samples:.3f} (last step); loss first step "
        f"{losses[0].item():.5f}, last warm-up step {losses[-1].item():.5f}, mean of the first "
        f"{interval} {first:.5f}, of the last {interval} {last:.5f}, after the windows "
        f"{final_loss:.5f}; occupied fraction {state.occ.occ.float().mean().item():.4f}, "
        f"bbox {[round(x, 4) for x in state.occ.bbox.tolist()]}")
    log(f"# train launches over {steps} steps: {launches} (per step: "
        f"{ {k: round(v / steps, 3) for k, v in launches.items()} })")
    for name in TRAIN_KERNELS:
        if launches[name] == 0:
            raise RuntimeError(f"kernel {name} was not launched on the train path")
    if not (np.isfinite(losses.numpy()).all() and np.isfinite(final_loss)):
        raise RuntimeError("non-finite training loss")
    if not last < first:
        raise RuntimeError(f"the loss did not fall over the warm-up: {first} -> {last}")
    stats = dict(ms_per_step=ms, windows=windows, rays_per_s=N / ms * 1e3, samples_per_ray=samples,
                 loss_first=first, loss_last=last, steps=steps)
    return state, launches, stats


def profile_step(trainer, state, data):
    """Device time by kernel over one train step, and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = trainer.train_step(state, data, with_stats=False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    log(f"# profile of one train step: {wall:.2f} ms wall under the profiler, device busy "
        f"{busy:.2f} ms, idle share {1.0 - busy / wall:.3f}, {sum(e.count for e in evs)} kernels")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:16]:
        log(f"#   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:100]}")
    return state


class Capture:
    """Records the arguments the main path hands each kernel wrapper (the
    wrappers are looked up by module globals at call time)."""

    TARGETS = ((RM, "_march_cuda"), (GS, "_sample_points_cuda"),
               (GS, "_sample_points_backward_cuda"), (RM, "_composite_cuda"),
               (RM, "_composite_backward_cuda"), (W, "_idwt2d_cuda"), (W, "_idwt2d_adjoint_cuda"),
               (R, "_occupancy_upkeep_cuda"))

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


def _batch(n, V, HW, seed):
    g = torch.Generator().manual_seed(seed)
    return {"img_idx": torch.randint(0, V, (n,), generator=g),
            "pix_idx": torch.randint(0, HW, (n,), generator=g), "noise": torch.rand((n,), generator=g)}


def capture_step(trainer, state, data):
    V, H, Wd = data["images"].shape[:3]
    with Capture() as cap:
        state, _ = trainer.train_step(state, data, with_stats=False,
                                      batch=_batch(trainer.cfg.num_rays, V, H * Wd, SEED + 1))
        state = _refresh(trainer, state, full=False)
    torch.cuda.synchronize()
    return state, cap.calls


def _rel(a, b):
    return (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)


def train_kernel_phase(trainer, calls):
    """Each kernel of the train path on the arguments the step handed it."""
    rows = []
    # ---- K1 with the training stride
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
    rows.append(dict(name="K1 march_hierarchical (train, strided)", key="march", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/march.cu",
                     replaces="trinerflet_tpu/ops/raymarch.py:604", max_abs_err=0.0,
                     tol="mask, t, stride, seg_lastocc equal",
                     ms=time_ms(lambda: RM._march_cuda(*args, **kw)),
                     plain_ms=time_ms(lambda: RM.march_hierarchical_plain(*args, **kw), iters=5),
                     bound_ms=b, bound_by=by, library_ms=None,
                     note=f"N={ro.shape[0]} rays, occ_test_stride {kw['occ_test_stride']}, "
                          f"num_coarse {kw['num_coarse']}, mean kept samples/ray "
                          f"{got[2].float().sum(1).mean().item():.3f}; {probes} probes read "
                          f"{cells_c} coarse and {cells_f} fine cells"))

    # ---- K2 forward at the step's points
    (planes, xyz, lb), _ = calls["_sample_points_cuda"][0]
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
    rows.append(dict(name="K2 sample_planes (train)", key="grid_sample", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/grid_sample.cu",
                     replaces="trinerflet_tpu/ops/grid_sample.py:131", max_abs_err=err, tol=1e-4,
                     ms=time_ms(lambda: GS._sample_points_cuda(planes, xyz, lb)),
                     plain_ms=time_ms(lambda: GS.sample_points_plain(planes, xyz, lb), iters=5),
                     bound_ms=b, bound_by=by,
                     library_ms=time_ms(lambda: F.grid_sample(planes_nchw, grid, **gs)),
                     note=f"M={xyz.shape[0]} points, {touched} touched texels"))

    # ---- K2 backward: the plane gradient of the step's cotangent
    (g, xyz, lb, shape, dtype), _ = calls["_sample_points_backward_cuda"][0]
    got = GS._sample_points_backward_cuda(g, xyz, lb, shape, dtype)
    ref = GS.sample_points_backward_plain(g, xyz, lb, shape, dtype)
    err = _rel(got, ref)
    if err > 2.0**-7:  # float atomics in another order; one bf16 ulp of the largest texel
        raise RuntimeError(f"K2 backward rel err {err} > 2^-7")
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
    rows.append(dict(name="K2 sample_planes backward", key="grid_sample_bwd", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/grid_sample.cu",
                     replaces="trinerflet_tpu/ops/grid_sample.py:151", max_abs_err=(got.float() - ref.float()).abs().max().item(),
                     tol="2^-7 x max|grad|",
                     ms=time_ms(lambda: GS._sample_points_backward_cuda(g, xyz, lb, shape, dtype)),
                     plain_ms=time_ms(lambda: GS.sample_points_backward_plain(g, xyz, lb, shape, dtype),
                                      iters=5),
                     bound_ms=b, bound_by=by, library_ms=time_ms(lib),
                     note=f"{live} of {3 * xyz.shape[0]} (sample, plane) rows carry a cotangent; "
                          f"float32 atomics then a bf16 cast (2 launches); library is "
                          f"aten.grid_sampler_2d_backward on the bf16 planes and bf16-rounded "
                          f"coordinates (rel diff {lib_err:.2e}); on f32 copies {lib_f32_err:.2e}"))

    # ---- K3 forward and backward
    (cargs, _), = calls["_composite_cuda"][:1]
    got, ref = RM._composite_cuda(*cargs), RM.composite_dense_plain(*cargs)
    err = max((a - b_).abs().max().item() for a, b_ in zip(got, ref))
    if err > 1e-5:
        raise RuntimeError(f"K3 (train) max|err| {err} > 1e-5")
    sig = cargs[0]
    b, by = bound_ms(nbytes(*cargs[:5]) + nbytes(*got), sig.numel() * 12)
    rows.append(dict(name="K3 composite_dense (train)", key="composite", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/composite.cu",
                     replaces="trinerflet_tpu/ops/raymarch.py:805", max_abs_err=err, tol=1e-5,
                     ms=time_ms(lambda: RM._composite_cuda(*cargs)),
                     plain_ms=time_ms(lambda: RM.composite_dense_plain(*cargs)),
                     bound_ms=b, bound_by=by, library_ms=None,
                     note=f"N={sig.shape[0]} rays x {sig.shape[1]} samples"))
    (bargs, _), = calls["_composite_backward_cuda"][:1]
    got = RM._composite_backward_cuda(*bargs)
    ref = RM.composite_dense_backward_plain(*bargs)
    err = max(_rel(a, b_) for a, b_ in zip(got, ref))
    if err > 1e-5:
        raise RuntimeError(f"K3 backward rel err {err} > 1e-5")
    b, by = bound_ms(nbytes(*bargs[:5]) + nbytes(*bargs[6:]) + nbytes(*got), sig.numel() * 40)
    rows.append(dict(name="K3 composite_dense backward", key="composite_bwd", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/composite.cu",
                     replaces="trinerflet_tpu/ops/raymarch.py:805",
                     max_abs_err=max((a - b_).abs().max().item() for a, b_ in zip(got, ref)),
                     tol="1e-5 x max|grad|",
                     ms=time_ms(lambda: RM._composite_backward_cuda(*bargs)),
                     plain_ms=time_ms(lambda: RM.composite_dense_backward_plain(*bargs)),
                     bound_ms=b, bound_by=by, library_ms=None,
                     note="analytic reverse pass, one thread per ray; replaces autodiff of the cumprod"))

    # ---- K4 adjoint: every level of the step's ladder
    tcfg = trainer.nerf_cfg.triplane
    g0, g1 = W.synthesis_taps(tcfg.wavelet_type, torch.bfloat16)
    L = len(g0)
    pl, pr = W.synthesis_pads(tcfg.wavelet_type)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    err4, sizes, level_by = 0.0, [], []
    for (ga, _) in calls["_idwt2d_adjoint_cuda"]:
        G, name = ga
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
        wt = w2.repeat(P, 1, 1).reshape(4 * P, 1, L, L).to(G.device, torch.bfloat16)
        st = L - 1 - pl
        Gp = F.pad(G.reshape(1, P, Ho, Wo), (st, 2 * n + L - 2 - st - Wo, st, 2 * n + L - 2 - st - Ho))
        lib = lambda: F.conv2d(Gp, wt, stride=2, groups=P)  # noqa: E731
        lo = lib().reshape(P, 4, n, n)
        lib_err = _rel(lo[:, 0], got[0].reshape(P, n, n))
        tot["ms"] += time_ms(lambda: W._idwt2d_adjoint_cuda(G, name))
        tot["plain_ms"] += time_ms(lambda: W.idwt2d_adjoint_plain(G, name), iters=5)
        tot["library_ms"] += time_ms(lib)
        tot["bound_ms"] += bm
        sizes.append(f"{Ho}->{n} (conv2d rel diff {lib_err:.2e})")
    rows.append(dict(name="K4 idwt2d adjoint", key="idwt_adjoint", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/idwt.cu",
                     replaces="trinerflet_tpu/ops/wavelets.py:510", max_abs_err=err4,
                     tol="2^-6 x max|level grad|", ms=tot["ms"], plain_ms=tot["plain_ms"],
                     bound_ms=tot["bound_ms"], bound_by=max(level_by)[1],
                     library_ms=tot["library_ms"],
                     note="sum over the 4 levels " + ", ".join(sizes)
                          + "; library is a strided grouped F.conv2d (bf16)"))

    # ---- K6: the partial refresh's upkeep
    (oargs, _), = calls["_occupancy_upkeep_cuda"][:1]
    grid_old, tmp, off, rcfg, decay = oargs
    got = R._occupancy_upkeep_cuda(*oargs)
    ref = R.occupancy_upkeep_plain(*oargs)
    if not torch.equal(got[0], ref[0]):
        raise RuntimeError("K6 merged density grid differs from the plain version")
    mean_err = abs(got[3].item() - ref[3].item()) / max(ref[3].item(), 1e-30)
    if mean_err > 1e-5:
        raise RuntimeError(f"K6 mean density rel err {mean_err} > 1e-5")
    thresh = torch.clamp_max(got[3], rcfg.density_thresh) * rcfg.occ_thresh_scale
    occ = (ref[0] > thresh).reshape(got[1].shape)
    r = rcfg.coarse_dilation_radius
    if not (torch.equal(got[1], occ) and torch.equal(got[2], R._dilate3(occ, r))
            and torch.equal(got[4], R._occupied_bbox(occ, rcfg))):
        raise RuntimeError("K6 occupancy, dilation or bbox differs from the plain version")
    occ_f = got[1].float().unsqueeze(1)
    Cn = grid_old.numel()
    b, by = bound_ms(nbytes(grid_old, tmp) + nbytes(got[0], got[1], got[2]),
                     Cn * (2 + (2 * r + 1) ** 3))
    rows.append(dict(name="K6 occupancy_upkeep", key="occupancy", route="cuda",
                     source="trinerflet_tpu_torch/kernels/csrc/occupancy.cu",
                     replaces="trinerflet_tpu/render/renderer.py:332", max_abs_err=mean_err,
                     tol="grid, occ, occ_coarse, bbox equal; mean rel 1e-5",
                     ms=time_ms(lambda: R._occupancy_upkeep_cuda(*oargs)),
                     plain_ms=time_ms(lambda: R.occupancy_upkeep_plain(*oargs)),
                     bound_ms=b, bound_by=by,
                     library_ms=time_ms(lambda: F.max_pool3d(occ_f, 2 * r + 1, 1, r)),
                     note=f"{tuple(grid_old.shape)} grid, refreshed block of {tmp.shape[1]} cells at "
                          f"{off}, radius {r}; 4 launches (merge, mean, threshold + bbox, dilation); "
                          f"library is F.max_pool3d for the dilation alone; max_abs_err is the "
                          f"mean's relative error"))
    return rows


def _touched_texels(c2, H, Wd):
    x0 = torch.clamp(torch.floor(torch.clamp((c2[..., 0] + 1) * 0.5 * (Wd - 1), 0, Wd - 1)), 0, Wd - 2).long()
    y0 = torch.clamp(torch.floor(torch.clamp((c2[..., 1] + 1) * 0.5 * (H - 1), 0, H - 1)), 0, H - 2).long()
    base = (torch.arange(3, device=c2.device)[:, None] * H + y0) * Wd + x0
    return torch.unique(torch.cat([base, base + 1, base + Wd, base + Wd + 1]).reshape(-1)).numel()


def _groups(named):
    """Parameter groups of the step check: the base plane, each wavelet
    level, and each MLP as one vector."""
    out = defaultdict(list)
    for n, t in named:
        key = n if n.startswith("encoder.") else n.split(".")[0]
        out[key].append(t.detach().float().cpu().reshape(-1))
    return {k: torch.cat(v) for k, v in out.items()}


def step_check(trainer, state, data):
    """One step's loss and gradients at full width on CHECK_RAYS rays with an
    injected batch and noise: kernels on the card vs plain versions on the CPU."""
    cfg = dataclasses.replace(trainer.cfg, num_rays=CHECK_RAYS)
    V, H, Wd = data["images"].shape[:3]
    batch = _batch(CHECK_RAYS, V, H * Wd, SEED + 2)
    results = {}
    for dev in (DEVICE, "cpu"):
        tr = Trainer(trainer.nerf_cfg, trainer.render_cfg, cfg, device=dev)
        params = TR._map(lambda t: t.detach().to(dev).requires_grad_(True), state.params)
        occ = type(state.occ)(*[x.to(dev) for x in state.occ])
        d = {"images": data["images"].to(dev), "poses": data["poses"].to(dev),
             "intrinsics": data["intrinsics"]}
        t0 = time.perf_counter()
        loss, aux = tr._loss_fn(params, occ, d, batch, False, torch.Generator(device=dev))
        named = TR._leaves(params)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        if dev == DEVICE:
            torch.cuda.synchronize()
        results[dev] = (loss.item(), int(aux["num_samples"]),
                        _groups(zip([n for n, _ in named], grads)), time.perf_counter() - t0)
    (lg, ng, gg, tg), (lc, nc, gc, tc) = results[DEVICE], results["cpu"]
    loss_err = abs(lg - lc) / abs(lc)
    errs = {k: (torch.linalg.norm(gg[k] - gc[k]) / torch.linalg.norm(gc[k])).item() for k in gc}
    log(f"# step check ({CHECK_RAYS} rays, full width): loss card {lg:.7f} vs CPU plain {lc:.7f} "
        f"(rel {loss_err:.2e}, tol {CHECK_LOSS_TOL}); samples {ng} vs {nc}; gradient rel L2 "
        f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } (tol {CHECK_GRAD_TOL}); "
        f"{tg:.2f} s on the card, {tc:.2f} s on the CPU")
    if ng != nc:
        raise RuntimeError("the march kept different samples on the card and on the CPU")
    if loss_err > CHECK_LOSS_TOL or max(errs.values()) > CHECK_GRAD_TOL:
        raise RuntimeError("the kernel step disagrees with the plain versions")
    if min(torch.linalg.norm(v).item() for v in gc.values()) == 0:
        raise RuntimeError("a parameter group got no gradient")
    return loss_err, errs


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

    trainer, state, data = train_setup()
    state, train_launches, stats = train_phase(trainer, state, data, card)
    state = profile_step(trainer, state, data)
    state, calls = capture_step(trainer, state, data)
    train_rows = train_kernel_phase(trainer, calls)
    for r in train_rows:
        r["launches"] = train_launches[r.pop("key")]
        r["path"] = "train"
    del calls
    step_check(trainer, state, data)
    rows += train_rows

    for r in rows:
        log(f"# {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.6f} "
            f"by {r['bound_by']}, library {r['library_ms']}) max|err| {r['max_abs_err']:.3e} "
            f"(tol {r['tol']}); {r['launches']} launches on the {r['path']} path; {r['note']}")
    fields = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
              "bound_ms", "bound_by", "library_ms")
    log(f"# serve: {VIEW_HW}x{VIEW_HW} views, ms/view {ms} then {steady} on {card}")
    log(f"# train: {stats['ms_per_step']:.3f} ms/step (median of {WINDOWS} windows of "
        f"{WINDOW_STEPS}), {stats['rays_per_s']:.1f} rays/s, {stats['samples_per_ray']:.3f} kept "
        f"samples/ray, loss {stats['loss_first']:.5f} -> {stats['loss_last']:.5f} on {card}; "
        f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{k: r[k] for k in fields} for r in rows]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
