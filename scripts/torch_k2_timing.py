"""K2, the triplane sampler, forward and backward, and K2x, its coordinate
gradient, on the card, at the arguments the training paths hand them:
bench.py's step with the tuner off (``perray``) and on (``autotune``), the
dense renderer (``dense``), multiscale k-planes (``kplanes``: 64^2, 128^2
and 256^2 x 16 f32 planes) and the triplane's variants (``variants``:
chip_smoke's variants step, K2x on ``full`` and both zoom-in planes).

    python scripts/torch_k2_timing.py [--profile] [--sass] [--paths NAME ...]

For each path it trains chip_smoke's configuration on its synthetic scene
(the path's warm-up steps, with the refresh and the retune on their
cadence), records one more step's calls of the two wrappers, holds each
call's kernels to their plain versions (forward atol 1e-4, backward 2^-7 of
the largest gradient in bf16, 1e-5 in f32, as chip_smoke; the exit code is
1 where one disagrees) and prints one row per call: the kernels' device
time (median of 20 calls, each behind a device sleep, warm L2, as
chip_smoke times), the launches of one call, the bound
(bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s, whichever is
larger; chip_smoke's count), the plain version's time and one PyTorch call
(``F.grid_sample``, ``aten.grid_sampler_2d_backward``); on ``variants``
one row per K2x call (chip_smoke's K2x rows: dL/dxyz held to the plain
version at 1e-5 and the plane gradient at 2^-7 of its largest entry) with
whether its plane gradient is bit for bit the K2 backward's on the same
rows, its device time from events around 10 calls in a row, and the time of
the same call without the plane gradient (the dL/dxyz pass alone).
``--profile`` prints each CUDA kernel's device time over 10 calls of
every recorded backward and forward under ``torch.profiler`` (the K2
backward's passes; on ``variants`` each K2x call alone: its memset, float32
atomic kernel and bf16 cast before K2x took the K2 backward's passes, those
passes and the dL/dxyz kernel after), ``--sass`` each ``grid_sample``
kernel's registers and stack frame and its instructions by opcode
(``cuobjdump`` of the built library). Run from another checkout's root it
times that checkout's kernels (the script imports the package and
``chip_smoke.py`` of the working directory). Prints the card's name and
power limit first and needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, ".")
import chip_smoke as CS  # noqa: E402
from trinerflet_tpu_torch import kernels  # noqa: E402
from trinerflet_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from trinerflet_tpu_torch.kernels import _build  # noqa: E402
from trinerflet_tpu_torch.ops import grid_sample as GS  # noqa: E402
from trinerflet_tpu_torch.render.renderer import mark_untrained_grid  # noqa: E402
from trinerflet_tpu_torch.train.trainer import Trainer  # noqa: E402

# path -> (its configurations, warm-up steps)
PATHS = {
    "perray": (lambda: CS.bench_configs(budget_autotune=False), CS.PERRAY_WARM),
    "autotune": (lambda: CS.bench_configs(budget_autotune=True), CS.WARM_STEPS),
    "dense": (CS.dense_configs, CS.DENSE_WARM),
    "kplanes": (CS.kplanes_configs, CS.PERRAY_WARM),
    "variants": (CS.variants_configs, CS.PERRAY_WARM),
}


def captured_calls(name: str, scene, paths=PATHS):
    """One step's kernel calls on ``name``'s path of ``paths`` after its
    warm-up."""
    cfgs, warm = paths[name]
    trainer = Trainer(*cfgs(), device="cuda")
    state = trainer.init_state(density_grid=mark_untrained_grid(scene.poses, scene.intrinsics,
                                                                trainer.render_cfg))
    data = trainer.scene_to_device(scene)
    occgrid = trainer.cfg.renderer == "occgrid"
    interval, aux = trainer.cfg.update_extra_interval, None
    for i in range(warm):
        if occgrid and i % interval == 0:
            state = CS._refresh(trainer, state, full=int(state.occ.iter_density) < 16)
            trainer._maybe_retune_march(state, aux)
        state, aux = trainer.train_step(state, data, with_stats=(i + 1) % interval == 0)
    _, calls = CS.capture_step(trainer, state, data)
    return calls


def back_to_back_ms(fn, n: int = 10) -> float:
    """Device time of one call from CUDA events around ``n`` calls in a row
    (the host issues ahead of the device; a check on chip_smoke's timing)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _launches(key: str, fn) -> int:
    n0 = kernels.launches[key]
    fn()
    return kernels.launches[key] - n0


GS_ARGS = dict(mode="bilinear", padding_mode="border", align_corners=True)


def fwd_row(label: str, planes, xyz, lb):
    """The forward at one call's arguments, measured as chip_smoke's K2 rows."""
    got, ref = GS._sample_points_cuda(planes, xyz, lb), GS.sample_points_plain(planes, xyz, lb)
    _, H, Wd, C = planes.shape
    c2 = GS.project_to_planes(xyz, lb)
    touched = CS._touched_texels(c2, H, Wd)
    b, _ = CS.bound_ms(touched * C * planes.element_size() + CS.nbytes(xyz, got), xyz.shape[0] * 3 * C * 8)
    planes_nchw = planes.permute(0, 3, 1, 2).contiguous()
    grid = c2[:, :, None, :].to(planes.dtype).contiguous()
    err = (got - ref).abs().max().item()
    return dict(name=f"K2 fwd {label}", ok=err <= 1e-4, max_abs_err=err,
                launches=_launches("grid_sample", lambda: GS._sample_points_cuda(planes, xyz, lb)),
                ms=CS.time_ms(lambda: GS._sample_points_cuda(planes, xyz, lb)), bound_ms=b,
                plain_ms=CS.time_ms(lambda: GS.sample_points_plain(planes, xyz, lb), iters=5),
                library_ms=CS.time_ms(lambda: F.grid_sample(planes_nchw, grid, **GS_ARGS)))


def bwd_row(label: str, planes, g, xyz, lb, shape, dtype):
    """The backward at one call's arguments, measured as chip_smoke's rows."""
    got = GS._sample_points_backward_cuda(g, xyz, lb, shape, dtype)
    ref = GS.sample_points_backward_plain(g, xyz, lb, shape, dtype)
    rel = CS._rel(got, ref)
    live = int((g != 0).any(dim=-1).sum())
    out_bytes = got.numel() * got.element_size()
    b, _ = CS.bound_ms(CS.nbytes(g, xyz) + out_bytes, live * 4 * shape[-1] * 2)
    c2 = GS.project_to_planes(xyz, lb)
    go = g.permute(1, 2, 0)[..., None].to(dtype).contiguous()
    planes_nchw = planes.permute(0, 3, 1, 2).contiguous()
    grid = c2[:, :, None, :].to(planes.dtype).contiguous()
    lib = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
        go, planes_nchw, grid, 0, 1, True, [True, False])
    return dict(name=f"K2 bwd {label} live={live}", ok=rel <= (2.0**-7 if dtype == torch.bfloat16 else 1e-5),
                max_abs_err=(got.float() - ref.float()).abs().max().item(),
                launches=_launches("grid_sample_bwd",
                                   lambda: GS._sample_points_backward_cuda(g, xyz, lb, shape, dtype)),
                ms=CS.time_ms(lambda: GS._sample_points_backward_cuda(g, xyz, lb, shape, dtype)), bound_ms=b,
                plain_ms=CS.time_ms(lambda: GS.sample_points_backward_plain(g, xyz, lb, shape, dtype), iters=5),
                library_ms=CS.time_ms(lib))


def plane_names(calls):
    """The step's field forward calls' planes by name (``full``, then the
    zoom-in planes ``upscale_i``), by data pointer."""
    xyz_calls = calls["_sample_points_backward_xyz_cuda"]
    n = len(xyz_calls) or len(calls["_sample_points_backward_cuda"])
    fwd = calls["_sample_points_cuda"][:n]
    return {a[0].data_ptr(): nm for (a, _), nm in zip(fwd, ["full"] + [f"upscale_{i}" for i in range(n - 1)])}


def xyz_rows(name: str, calls):
    """K2x on each of the step's calls, measured as chip_smoke's K2x rows,
    with the launches of one call and whether its plane gradient is the K2
    backward's on the same rows."""
    names = plane_names(calls)
    rows = CS._sample_xyz_rows(calls, lambda planes: f" {name} {names.get(planes.data_ptr(), '?')}")
    for r, ((g, planes, xyz, lb), kw) in zip(rows, calls["_sample_points_backward_xyz_cuda"]):
        r["ok"] = True  # _sample_xyz_rows raises where a kernel disagrees
        call = lambda: GS._sample_points_backward_xyz_cuda(g, planes, xyz, lb, **kw)  # noqa: E731
        r["launches"] = _launches("grid_sample_bwd_xyz", call)
        r["back_to_back_ms"] = back_to_back_ms(call)
        r["xyz_only_ms"] = CS.time_ms(lambda: GS._sample_points_backward_xyz_cuda(g, planes, xyz, lb,
                                                                                 planes_grad=False))
        pg = GS._sample_points_backward_xyz_cuda(g, planes, xyz, lb, **kw)[0]
        if pg is not None:
            k2 = GS._sample_points_backward_cuda(g, xyz, lb, tuple(planes.shape), planes.dtype)
            r["name"] += f" planes==K2 bwd: {torch.equal(pg, k2)}"
    return rows


def rows_of(name: str, calls):
    fwd, bwd = calls["_sample_points_cuda"], calls["_sample_points_backward_cuda"]
    out = []
    n = len(bwd) or len(calls["_sample_points_backward_xyz_cuda"])
    for (planes, xyz, lb), _ in fwd[:n]:  # the step's field forward calls
        out.append(fwd_row(f"{name} {tuple(planes.shape)} {str(planes.dtype)[6:]} M={xyz.shape[0]}",
                           planes, xyz, lb))
    for (g, xyz, lb, shape, dtype), _ in bwd:
        planes = next(a[0] for a, _ in fwd if tuple(a[0].shape) == tuple(shape))
        out.append(bwd_row(f"{name} {tuple(shape)} {str(dtype)[6:]} M={xyz.shape[0]}",
                           planes, g, xyz, lb, shape, dtype))
    if calls["_sample_points_backward_xyz_cuda"]:
        out += xyz_rows(name, calls)
    return out


def _profile(what: str, fn, args, per: str) -> None:
    """Device time per CUDA kernel over 10 rounds of ``fn`` on each of
    ``args`` (positional, keywords)."""
    from torch.profiler import ProfilerActivity, profile
    for a, k in args:
        fn(*a, **k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            for a, k in args:
                fn(*a, **k)
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if dt > 0:
            total += dt
            print(f"profile {what} {e.key[:90]}: {e.count} launches, {dt / 1e3 / 10:.4f} ms per {per}")
    print(f"profile {what} total: {total / 1e3 / 10:.4f} ms per {per} ({len(args)} calls)")


def profile_calls(calls) -> None:
    """Device time per CUDA kernel over 10 calls of every recorded backward,
    then of every recorded forward; on the variants path each K2x call
    alone."""
    bwd = [(a, {}) for a, _ in calls["_sample_points_backward_cuda"]]
    xyz = calls["_sample_points_backward_xyz_cuda"]
    fwd = [(a, {}) for a, _ in calls["_sample_points_cuda"][: len(bwd) or len(xyz)]]
    if bwd:
        _profile("backward", GS._sample_points_backward_cuda, bwd, "step's calls")
    names = plane_names(calls)
    for a, k in xyz:
        _profile(f"K2x {names.get(a[1].data_ptr(), '?')}", GS._sample_points_backward_xyz_cuda,
                 [(a, k)], "call")
    _profile("forward", GS._sample_points_cuda, fwd, "step's calls")


SASS_OPS = ("LDG", "STG", "LDS", "STS", "ATOMS", "RED", "REDG", "ATOM", "ATOMG", "IMAD", "IMAD.WIDE",
            "IMAD.HI", "IADD3", "FFMA", "FMUL", "FADD", "MUFU", "SHFL", "VOTE", "MATCH", "POPC", "FLO",
            "BRA", "CALL")


def sass_summary(lib_name: str = "grid_sample", occupancy: bool = False) -> None:
    """Registers, stack frame and instruction counts of every kernel in the
    built ``lib_name`` library, from ``cuobjdump -res-usage`` and ``-sass``
    (an opcode with modifiers counts under its base name and, for IMAD.WIDE
    and IMAD.HI, under those too); with ``occupancy`` also the resident
    warps per SM its registers allow (65,536 registers an SM, allocated in
    blocks of 256 a warp, at most 64 warps)."""
    lib = str(_build._target(lib_name))
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    run = lambda flag: subprocess.run([tool, flag, lib], capture_output=True,  # noqa: E731
                                      text=True, check=True).stdout
    usage = dict(re.findall(r"Function (\S+):\s*\n\s*(REG:\d+ STACK:\d+)", run("-res-usage")))
    ops, name = {}, None
    for line in run("-sass").splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            ops[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)((?:\.[A-Z0-9_]+)*)", line)
        if m and name:
            base, mods = m.group(1), m.group(2)
            ops[name][base] += 1
            for full in ("IMAD.WIDE", "IMAD.HI"):
                if (base + mods).startswith(full):
                    ops[name][full] += 1
    for f, c in ops.items():
        occ = ""
        if occupancy and f in usage:
            regs = int(re.search(r"REG:(\d+)", usage[f]).group(1))
            per_warp = -(-max(regs, 1) * 32 // 256) * 256
            occ = f" warps/SM by registers {min(64, 65536 // per_warp)}"
        print(f"sass {f}: {usage.get(f, '?')}{occ} total {sum(v for k, v in c.items() if '.' not in k)} "
              + " ".join(f"{k}={c[k]}" for k in SASS_OPS if c[k]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--paths", nargs="+", choices=list(PATHS), default=list(PATHS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    scene = make_synthetic_scene(num_views=8, H=256, W=256, num_steps=128)
    keys = ("ms", "bound_ms", "plain_ms", "library_ms", "max_abs_err")
    failed = []
    for name in args.paths:
        t0 = time.perf_counter()
        calls = captured_calls(name, scene)
        rows = rows_of(name, calls)
        for r in rows:
            print(f"{r['name']}: launches={r['launches']} "
                  + " ".join(f"{k}={r[k]:.6g}" for k in keys + ("back_to_back_ms", "xyz_only_ms") if k in r)
                  + ("" if r["ok"] else " DISAGREES"), flush=True)
            if not r["ok"]:
                failed.append(r["name"])
        if args.profile:
            profile_calls(calls)
        print(f"# {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        del calls
        torch.cuda.empty_cache()
    if args.sass:
        sass_summary()
    if failed:
        print(f"kernels that disagree with their plain versions: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
