"""K10, the voxel-grid sampler, on the card, at the arguments the
registry-grid path hands it: chip_smoke's registry-grid configuration (JAX's
default 64^3 x 16 grid, bench.py's 32,768 rays and budget of 20 samples on
a fully occupied grid, the textured background) trained for chip_smoke's
64 + 50 steps, then profiled steps and one captured step.

    python scripts/torch_k10_timing.py [--profile] [--sass] [--sectors] [--profiled-steps 3]

The captured step's calls run through chip_smoke's own rows
(``_volume_grid_rows``): the forward held to its plain version on the CPU,
the backward's two outputs within 1e-5 relative, each timed (median of 20
calls, each behind a device sleep, warm L2) beside chip_smoke's bound, the
plain version's time and the library call. The coordinate gradient alone
(the analytic normal's call) is held and timed on the same points and
cotangents. Each profiled step prints its wall time, device busy ms and
idle share under ``torch.profiler``. ``--profile`` prints each launch's
device time over 10 calls; ``--sass`` the ``volume_grid`` library's
kernels' registers, stack frame, the occupancy the registers allow and
their instructions by opcode; ``--sectors`` what the forward's row loads
ask of the L2 (``row_sectors``). Run from another checkout's root it times
that checkout's kernels (the script imports the package and
``chip_smoke.py`` of the working directory), which is how parent and change
go in one call. Prints the card's name and power limit first and needs a
CUDA device; the exit code is 1 where a kernel differs from its plain
version.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as CS  # noqa: E402
import torch_k1f_timing as K1FT  # noqa: E402  (beside this script)
import torch_k2_timing as K2T  # noqa: E402
from trinerflet_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from trinerflet_tpu_torch.kernels import _build  # noqa: E402
from trinerflet_tpu_torch.models import registry as REG  # noqa: E402
from trinerflet_tpu_torch.train.trainer import Trainer  # noqa: E402


def profiled_step(step, state):
    """One step under the profiler: (state, wall ms, device busy ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
    print("  top: " + "; ".join(f"{e.self_device_time_total / 1e3:.4f} ms x{e.count} {e.key[:60]}" for e in top),
          flush=True)
    return state, wall, busy


def row_sectors(x, CH, R, bound):
    """The 32-byte sectors the forward's corner-row loads request from the
    L2 (a warp on 32 / LP consecutive points, one load instruction a corner
    and slice): distinct (warp, corner, sector) triples, what reaches the L2
    when no line survives in the L1 between instructions; distinct (warp,
    sector) pairs, when every line survives within the warp; and the
    distinct sectors of the call. CH % 8 == 0 (rows of whole sectors);
    returns bytes."""
    _, q0, f = REG._voxel_cell(x, R, bound)
    rows = torch.stack([REG._voxel_corner(q0, f, R, c)[0] for c in REG._CORNERS_3D], -1)  # (N, 8)
    per_row = 4 * CH // 32
    lp = 8 if CH > 16 else 4 if CH > 8 else 2
    warp = (torch.arange(x.shape[0], device=x.device) // (32 // lp))[:, None, None]
    sec = rows[:, :, None] * per_row + torch.arange(per_row, device=x.device)  # (N, 8, per_row)
    k = torch.arange(8, device=x.device)[None, :, None]
    n_sec = (R ** 3) * per_row
    by_instr = torch.unique(((warp * 8 + k) * n_sec + sec).flatten()).numel()
    by_warp = torch.unique((warp * n_sec + sec).flatten()).numel()
    return 32 * by_instr, 32 * by_warp, 32 * torch.unique(sec).numel()


def merged_atomics(calls, run=8):
    """The float4 atomics the grid gradient's walk issues on the captured
    step's call (a lane group walks ``run`` consecutive points and adds a
    run of live points in one cell once), against 8 a live point."""
    (g, grid, x, R, bound, _, _), _ = calls["_sample_volume_grid_backward_cuda"][0]
    _, q0, f = REG._voxel_cell(x, R, bound)
    key = REG._voxel_corner(q0, f, R, (0, 0, 0))[0][(g != 0).any(-1)]
    n = torch.nonzero((g != 0).any(-1))[:, 0]
    starts = torch.ones_like(key, dtype=torch.bool)
    starts[1:] = (key[1:] != key[:-1]) | (n[1:] // run != n[:-1] // run)
    return 8 * int(starts.sum()), 8 * key.numel()


def x_only(calls):
    """The coordinate gradient alone on the captured step's points and
    cotangents: held to the plain version on the CPU and to the
    both-outputs call, and timed."""
    (g, grid, x, R, bound, _, _), _ = calls["_sample_volume_grid_backward_cuda"][0]
    got = REG._sample_volume_grid_backward_cuda(g, grid, x, R, bound, False, True)[1]
    ref = REG.sample_volume_grid_backward_plain(g.cpu(), grid.cpu(), x.cpu(), R, bound, False, True)[1]
    err = CS._rel(got.cpu(), ref)
    same = torch.equal(got, REG._sample_volume_grid_backward_cuda(g, grid, x, R, bound, True, True)[1])
    fn = lambda: REG._sample_volume_grid_backward_cuda(g, grid, x, R, bound, False, True)  # noqa: E731
    ms = CS.time_ms(fn)
    print(f"K10 coordinate gradient alone (registry-grid step): ms={ms:.6g} rel_err={err:.3g} "
          f"equal to the both-outputs call's dL/dx: {same}", flush=True)
    return err <= 1e-5, fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--sectors", action="store_true")
    ap.add_argument("--profiled-steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; checkout {os.getcwd()}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    scene = make_synthetic_scene(num_views=8, H=256, W=256, num_steps=128)
    nerf_cfg, render_cfg, train_cfg = CS.registry_configs()
    trainer = Trainer(nerf_cfg, render_cfg, train_cfg, device="cuda")
    init_fn, field = REG.make_field(nerf_cfg, "volume-grid", "neural-radiance-material", "textured-background")
    state = CS.registry_state(init_fn, CS.full_occupancy(render_cfg))
    data = trainer.scene_to_device(scene)
    state, _, stats = CS.registry_train(trainer, field, state, data, "", "registry-grid train",
                                        CS.REG_GRID_KERNELS, CS.REG_GRID_ABSENT)
    step = CS.registry_step(trainer, field, data)
    for i in range(args.profiled_steps):
        state, wall, busy = profiled_step(step, state)
        print(f"profiled registry-grid step {i}: wall {wall:.3f} ms, device busy {busy:.4f} ms, idle share "
              f"{1.0 - busy / wall:.4f}", flush=True)
    state, calls = CS._capture_registry_step(trainer, field, state, data)
    ok = True
    try:
        rows = CS._volume_grid_rows(calls)
    except RuntimeError as e:  # a kernel that differs from its plain version
        print(f"K10: {e}", flush=True)
        rows, ok = [], False
    fns = {"volume_grid": lambda: REG._sample_volume_grid_cuda(*calls["_sample_volume_grid_cuda"][0][0]),
           "volume_grid_bwd": lambda: REG._sample_volume_grid_backward_cuda(
               *calls["_sample_volume_grid_backward_cuda"][0][0])}
    for r in rows:
        key = r["key"]
        print(f"{r['name']}: launches/call={K1FT.launches_of_one_call(key, fns[key])} ms={r['ms']:.6g} "
              f"bound_ms={r['bound_ms']:.6g} ({r['bound_by']}) plain_ms={r['plain_ms']:.6g} "
              f"library_ms={r['library_ms']:.6g} max_abs_err={r['max_abs_err']:.3g}; {r['note']}", flush=True)
    if args.sectors:
        grid, x, R, bound = calls["_sample_volume_grid_cuda"][0][0]
        b_i, b_w, b_c = row_sectors(x, grid.shape[1], R, bound)
        print(f"sectors: the forward's row loads request {b_i / 1e6:.1f} MB from the L2 with no L1 reuse "
              f"between instructions, {b_w / 1e6:.1f} MB with all reuse within a warp; the call's distinct "
              f"rows {b_c / 1e6:.1f} MB", flush=True)
    merged, unmerged = merged_atomics(calls)
    print(f"atomics: the grid gradient's walk of 8 points a lane group issues {merged} float4 atomics "
          f"({merged / unmerged:.4f} of 8 a live point, {unmerged})", flush=True)
    x_ok, x_fn = x_only(calls)
    ok = ok and x_ok
    if args.profile:
        for key, fn in fns.items():
            K1FT.profile_call(key, fn)
        K1FT.profile_call("volume_grid_bwd (dL/dx alone)", x_fn)
    if args.sass:
        K2T.sass_summary("volume_grid", occupancy=True)
    if not ok:
        print("K10 differs from its plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
