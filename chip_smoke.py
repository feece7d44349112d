"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
1. print the card (``nvidia-smi`` name and power limit);
2. build kernels K1-K4 from ``trinerflet_tpu_torch/kernels/csrc`` with nvcc;
3. serve: the full-width bench model (1024^2 x 16-channel bf16 wavelet
   triplane, bior6.8, 4 IDWT levels, bf16 MLPs, bound 1.5, 128^3 x 2-cascade
   occupancy grid, max_steps 1024, 20 samples per ray), seeded random weights
   with small non-zero wavelet levels; camera culling over 8 orbit cameras,
   one full density-grid refresh, then ``Trainer.render_image`` of two
   800x800 views with every launch counter zeroed just before and read just
   after; one full eval chunk (16,384 rays) of the first view is rendered
   again through the plain versions on the CPU (a wrapper runs its plain
   version only for CPU tensors) and compared;
4. kernels: each kernel on the serve path's own inputs against its plain
   PyTorch version on the card, with its time, the plain version's time, the
   least time the card could take (bound) and, where one PyTorch call
   computes the same function, that call's time;
5. print the kernels line, then the device line last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from trinerflet_tpu_torch import kernels
from trinerflet_tpu_torch.data.rays import rays_full_image
from trinerflet_tpu_torch.data.synthetic import orbit_pose, synthetic_intrinsics
from trinerflet_tpu_torch.kernels import _build
from trinerflet_tpu_torch.models.nerf import NeRFConfig
from trinerflet_tpu_torch.models.triplane import TriplaneConfig
from trinerflet_tpu_torch.ops import grid_sample as GS
from trinerflet_tpu_torch.ops import raymarch as RM
from trinerflet_tpu_torch.ops import wavelets as W
from trinerflet_tpu_torch.render.renderer import RenderConfig, mark_untrained_grid
from trinerflet_tpu_torch.train.trainer import TrainConfig, Trainer

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

VIEW_HW = 800
SEED = 0


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
    for name, n in launches.items():
        if n == 0:
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
    # bf16 field: the kernel IDWT keeps f32 between its passes where the
    # plain version rounds to bf16, so the planes differ by a few bf16 ulps
    # and a bf16 MLP layer can round one sample differently (~2^-8 relative)
    if err.max().item() > 2e-2 or err.mean().item() > 1e-3:
        raise RuntimeError("kernel render disagrees with the plain versions")
    return err.max().item()


def k1_need(ro, rd, nears, fars, noise, occ_coarse, mkw):
    """What K1's inputs need in this run: the distinct cells of each grid
    that its probes read, and the number of probes. The probes are the plain
    version's: coarse midpoints short of far, then the kept segments' fine
    candidates short of far."""
    addr = dict(grid_size=mkw["grid_size"], cascades=mkw["cascades"], bound=mkw["bound"])
    dt_py = 2.0 * RM.SQRT3 / mkw["max_steps"]
    seg_py = dt_py * mkw["fine_per_coarse"]
    dt, half = float(np.float32(dt_py)), float(np.float32(0.5 * seg_py))
    t0 = RM._fma(dt, noise, nears)

    def cells(t):  # (N, K) ray parameters -> (N, K) flat cell indices
        p = RM._fma(rd[:, None, :], t[..., None], ro[:, None, :]).clamp(-addr["bound"], addr["bound"])
        return RM.occupancy_index(p, torch.full_like(t, dt), **addr)

    kc = torch.arange(mkw["num_coarse"], dtype=torch.float32, device=ro.device)
    t_mid = RM._fma(seg_py, kc[None, :], t0[:, None]) + half
    keep_c = (t_mid - half) < fars[:, None]
    idx_c = cells(t_mid)
    valid_c = occ_coarse.reshape(-1)[idx_c] & keep_c
    seg_idx, seg_mask, _ = RM.first_k_valid(valid_c, mkw["coarse_budget"], spread=True)
    kf = torch.arange(mkw["fine_per_coarse"], dtype=torch.float32, device=ro.device)
    t_f = RM._fma(dt, kf[None, None, :], RM._fma(seg_py, seg_idx.float(), t0[:, None])[..., None])
    keep_f = (seg_mask[..., None] & (t_f < fars[:, None, None])).reshape(len(ro), -1)
    idx_f = cells(t_f.reshape(len(ro), -1))
    return (torch.unique(idx_c[keep_c]).numel(), torch.unique(idx_f[keep_f]).numel(),
            int(keep_c.sum() + keep_f.sum()))


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
    x0 = torch.clamp(torch.floor(torch.clamp((c2[..., 0] + 1) * 0.5 * (Wd - 1), 0, Wd - 1)), 0, Wd - 2).long()
    y0 = torch.clamp(torch.floor(torch.clamp((c2[..., 1] + 1) * 0.5 * (H - 1), 0, H - 1)), 0, H - 2).long()
    base = (torch.arange(3, device="cuda")[:, None] * H + y0) * Wd + x0
    touched = torch.unique(torch.cat([base, base + 1, base + Wd, base + Wd + 1]).reshape(-1)).numel()
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(card)
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"# kernels built in {time.perf_counter() - t0:.1f} s (per kernel {secs}) into {_build.BUILD_DIR}")

    torch.manual_seed(SEED)
    with torch.no_grad():
        trainer, params, occ, poses, intr = serve_setup()
        launches, views, ms, steady = serve_phase(trainer, params, occ, poses, intr, card)
        profile_view(trainer, params, occ, poses, intr)
        plain_chunk_check(trainer, params, occ, poses, intr, views)
        rows = kernel_phase(trainer, params, occ, poses, intr)
    key = {"K1": "march", "K2": "grid_sample", "K3": "composite", "K4": "idwt"}
    for r in rows:
        r["launches"] = launches[key[r["name"][:2]]]
        log(f"# {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
            f"by {r['bound_by']}, library {r['library_ms']}) max|err| {r['max_abs_err']:.3e} "
            f"(tol {r['tol']}); {r['launches']} launches on the serve path; {r['note']}")
    fields = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
              "bound_ms", "bound_by", "library_ms")
    log(f"# serve: {VIEW_HW}x{VIEW_HW} views, ms/view {ms} then {steady} on {card}")
    log(json.dumps({"kernels": [{k: r[k] for k in fields} for r in rows]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
