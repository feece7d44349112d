"""K7, the grid encoder (forward and table-gradient backward), on the card,
at the arguments the main paths hand it: the proposal renderer's step
(``proposal``: bench.py's model with ``renderer="proposal"``, the 5-level
proposal grid at 32,768 rays x 64 samples), the hash-grid field's step
(``hashgrid``: 16 levels, 49 MB of tables; the step's field call and the
partial refresh's sweep of the grid), and one 16,384-ray chunk of the
registry-hash-normals view (``rh``: the hash-grid path's trained field with
analytic normals, K7 forward under no_grad).

    python scripts/torch_k7_timing.py [--profile] [--sass] [--paths proposal hashgrid rh]

Each path trains chip_smoke's configuration on its synthetic scene
(chip_smoke's 64 + 50 steps, with the refresh on its cadence on the
occupancy-grid renderer) and records one more step (and on the hash grid
one partial refresh). Each call runs through chip_smoke's own rows
(``_grid_encode_fwd_rows``, ``_grid_encode_bwd_rows``): the forward held to
its plain version bit for bit with a second call the same bits, the
backward to a float64 sum of its terms, each timed (median of 20 calls,
each behind a device sleep, warm L2) beside chip_smoke's bound and the
plain version's time. A row prints the launches of one call. Each path
also prints its step's device time under the profiler. ``--profile``
prints each launch's device time over 10 calls under ``torch.profiler``
(the backward's zeroing and its kernel apart); ``--sass`` the
``gridencoder`` library's kernels' registers, stack frame, the occupancy
the registers allow and their instructions by opcode. Run from another
checkout's root it times that checkout's kernels (the script imports the
package and ``chip_smoke.py`` of the working directory), which is how
parent and change go in one call. Prints the card's name and power limit
first and needs a CUDA device; the exit code is 1 where a kernel differs
from its plain version.
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
from trinerflet_tpu_torch.models import gridencoder as GE  # noqa: E402
from trinerflet_tpu_torch.models import registry as REG  # noqa: E402
from trinerflet_tpu_torch.train import trainer as TR  # noqa: E402
from trinerflet_tpu_torch.train.trainer import Trainer  # noqa: E402

STEPS = CS.PERRAY_WARM + CS.WINDOW_STEPS * CS.PERRAY_WINDOWS


def trained(configs, scene):
    """chip_smoke's configuration trained for its steps; one profiled step,
    then one captured step (and partial refresh)."""
    trainer = Trainer(*configs(), device="cuda")
    if trainer.cfg.renderer == "occgrid":
        state, data, _ = K1FT._train(trainer, scene, STEPS)
    else:  # no occupancy grid, no refresh
        state, data = trainer.init_state(), trainer.scene_to_device(scene)
        for _ in range(STEPS):
            state, _ = trainer.train_step(state, data, with_stats=False)
    state = CS.profile_step(trainer, state, data, trainer.cfg.renderer)
    state, calls = CS.capture_step(trainer, state, data)
    return trainer, state, calls


def rh_calls(state):
    """The first 16,384-ray chunk of the registry-hash-normals view on the
    trained hash-grid field."""
    nerf_cfg, render_cfg, train_cfg = CS.hashgrid_configs()
    trainer = Trainer(nerf_cfg, render_cfg, train_cfg, device="cuda")
    names = ("implicit-volume", "diffuse-with-point-light-material", "solid-color-background")
    field = REG.RegistryField(nerf_cfg, *names, normal_type="analytic")
    params = TR._map(lambda t: t.requires_grad_(True), state.ema_params)
    return CS._capture_view_chunk(trainer, field, params, state.occ)


def forward_calls(calls, label):
    """Each distinct forward call of the step: (label, one-call dict)."""
    fwd = calls["_grid_encode_cuda"]
    out = [(f"{label} step", {"_grid_encode_cuda": fwd[:1]})]
    if len(fwd) > 1 and label == "hashgrid":
        out.append((f"{label} refresh sweep", {"_grid_encode_cuda": fwd[-1:]}))
    return out


def _distinct(warp, unit) -> int:
    """Distinct (warp, unit) pairs of one load instruction over all warps."""
    return int(torch.unique(warp * (1 << 36) + unit).numel())


def load_lines(x, cfg, bound):
    """What one K7 forward call's row loads ask of the L1 and the L2, by
    level: the L1 wavefronts (distinct 128-byte lines a warp's load
    instruction touches) and the 32-byte sectors those instructions request
    (distinct per instruction: what reaches the L2 when no line survives in
    the L1 between instructions), under two layouts of the work: ``parent``,
    a warp on 32 consecutive (point, level) items; ``tile``, a warp on 32
    consecutive points at one level (the design in the source). Each item
    loads its 8 corner rows, one instruction each; tables are taken as
    aligned to 128 bytes."""
    N, L, C = x.shape[0], cfg.num_levels, cfg.level_dim
    n = torch.arange(N, device=x.device)
    out = []
    for l in range(L):
        rows = GE._corners_plain(x, cfg, bound, l)[1]
        counts = [0, 0, 0, 0]  # parent lines, parent sectors, tile lines, tile sectors
        for k in range(8):
            byte = rows[k] * (4 * C) + (l << 30)  # tables apart
            for i, warp in enumerate(((n * L + l) // 32 * 8 + k, n // 32 * 8 + k)):
                counts[2 * i] += _distinct(warp, byte >> 7)
                counts[2 * i + 1] += _distinct(warp, byte >> 5)
        out.append(tuple(counts))
    return out


def print_lines(x, cfg, bound, label):
    per = load_lines(x, cfg, bound)
    tot = [sum(v[i] for v in per) for i in range(4)]
    print(f"lines {label}: N={x.shape[0]} L={cfg.num_levels}; row loads' L1 wavefronts parent "
          f"{tot[0]}, tile {tot[2]}; 32-byte sectors requested parent {tot[1]} ({tot[1] * 32 / 1e6:.1f} "
          f"MB), tile {tot[3]} ({tot[3] * 32 / 1e6:.1f} MB); by level (parent lines, sectors, tile "
          f"lines, sectors) {per}", flush=True)


def print_row(r, label, launches):
    print(f"{r['name']} ({label}): launches/call={launches} ms={r['ms']:.6g} "
          f"bound_ms={r['bound_ms']:.6g} ({r['bound_by']}) plain_ms={r['plain_ms']:.6g} "
          f"library_ms={r['library_ms']} max_abs_err={r['max_abs_err']:.3g}; {r['note']}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--lines", action="store_true",
                    help="the forward row loads' L1 wavefronts and sectors under two layouts "
                         "(load_lines)")
    ap.add_argument("--paths", nargs="*", default=["proposal", "hashgrid", "rh"],
                    help="proposal, hashgrid (the step and a refresh's sweep) and rh (a "
                         "registry-hash-normals view chunk; trains the hash grid)")
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
    paths = {}
    if "proposal" in args.paths:
        paths["proposal"] = trained(CS.proposal_configs, scene)[2]
    if "hashgrid" in args.paths or "rh" in args.paths:
        _, state, calls = trained(CS.hashgrid_configs, scene)
        if "hashgrid" in args.paths:
            paths["hashgrid"] = calls
        if "rh" in args.paths:
            paths["rh"] = rh_calls(state)
        del state
    failed = []
    for label, calls in paths.items():
        todo = [(name, CS._grid_encode_fwd_rows, c, "_grid_encode_cuda", "grid_encode")
                for name, c in forward_calls(calls, label)]
        if calls["_grid_encode_backward_cuda"]:
            todo.append((f"{label} step", CS._grid_encode_bwd_rows, calls,
                         "_grid_encode_backward_cuda", "grid_encode_bwd"))
        for name, make, c, wrapper, key in todo:
            try:
                rows = make(c)
            except RuntimeError as e:  # a kernel that differs from its plain version
                print(f"{name} {wrapper}: {e}", flush=True)
                failed.append(f"{name} {wrapper}")
                continue
            a, kw = c[wrapper][0]
            fn = lambda: getattr(GE, wrapper)(*a, **kw)  # noqa: E731
            for r in rows:
                print_row(r, name, K1FT.launches_of_one_call(key, fn))
            if args.profile:
                K1FT.profile_call(f"{name} {wrapper}", fn)
            if args.lines and key == "grid_encode":
                print_lines(a[1], a[2], a[3], name)
            if key == "grid_encode_bwd":
                g, cfg = a[0], a[2]
                live = (g.reshape(g.shape[0], cfg.num_levels, cfg.level_dim) != 0).any(-1).sum(0)
                print(f"live {name}: (point, level) rows with a cotangent by level {live.tolist()} "
                      f"of {g.shape[0]} points", flush=True)
    if args.sass:
        K2T.sass_summary("gridencoder", occupancy=True)
    if failed:
        print(f"differs from its plain version: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
