"""K1f, the flat march, and K5, the global compaction, on the card, at the
arguments the main paths hand them: the flat phase's step (chip_smoke's
configuration: bound 4, 3 cascades, dt_gamma 1/128, the tuner on) in the
layout the tuner left and in the other one forced (K1f per-ray and
candidate mode; K5 on the candidate rows), and bench.py's step with the
tuner on (``autotune``) and continued on the global layout (``global``),
whose K5 packs K1's per-ray rows.

    python scripts/torch_k1f_timing.py [--profile] [--sass] [--paths flat autotune]

Each path trains chip_smoke's configuration on its synthetic scene (its
steps, with the refresh and the retune on their cadence) and records one
more step's calls. Each call runs through chip_smoke's own rows
(``_march_flat_rows``, ``_compact_rows``): the kernel held to its plain
version bit for bit, timed (median of 20 calls, each behind a device
sleep, warm L2) beside chip_smoke's bound, the plain version's time and,
for K5, the two library calls (``nonzero`` + ``index_select``). A row
prints the launches of one call. ``--profile`` prints each kernel's device
time over 10 calls under ``torch.profiler`` (K5's launches one by one);
``--sass`` the ``march_flat`` and ``compact`` libraries' kernels'
registers, stack frame, the occupancy the registers allow and their
instructions by opcode. Run from another checkout's root it times that
checkout's kernels (the script imports the package and ``chip_smoke.py`` of
the working directory), which is how parent and change go in one call.
Prints the card's name and power limit first and needs a CUDA device; the
exit code is 1 where a kernel differs from its plain version.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as CS  # noqa: E402
import torch_k2_timing as K2T  # noqa: E402  (beside this script)
from trinerflet_tpu_torch import kernels  # noqa: E402
from trinerflet_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from trinerflet_tpu_torch.kernels import _build  # noqa: E402
from trinerflet_tpu_torch.ops import raymarch as RM  # noqa: E402
from trinerflet_tpu_torch.render.renderer import mark_untrained_grid  # noqa: E402
from trinerflet_tpu_torch.train import trainer as TR  # noqa: E402
from trinerflet_tpu_torch.train.trainer import Trainer  # noqa: E402


def _train(trainer, scene, steps):
    state = trainer.init_state(density_grid=mark_untrained_grid(scene.poses, scene.intrinsics,
                                                                trainer.render_cfg))
    data = trainer.scene_to_device(scene)
    interval, aux = trainer.cfg.update_extra_interval, None
    for i in range(steps):
        if i % interval == 0:
            state = CS._refresh(trainer, state, full=int(state.occ.iter_density) < 16)
            trainer._maybe_retune_march(state, aux)
        state, aux = trainer.train_step(state, data, with_stats=(i + 1) % interval == 0)
    return state, data, aux


def flat_calls(scene):
    """The flat phase's step after chip_smoke's 64 + 50 steps, in the
    tuner's layout and in the other one (set as chip_smoke forces it)."""
    trainer = Trainer(*CS.flat_configs(), device="cuda")
    state, data, _ = _train(trainer, scene, CS.PERRAY_WARM + CS.WINDOW_STEPS * CS.PERRAY_WINDOWS)
    tuned = trainer.render_cfg
    out = {}
    for layout in (tuned.compaction, "per_ray" if tuned.compaction == "global" else "global"):
        trainer.render_cfg = dataclasses.replace(tuned, compaction=layout,
                                                 global_slots_per_ray=tuned.global_slots_per_ray
                                                 if layout == tuned.compaction else 0)
        _, calls = CS.capture_step(trainer, state, data)
        out[f"flat {layout}"] = (trainer, calls)
    return out


def autotune_calls(scene):
    """bench.py's step after chip_smoke's 320 warm-up steps with the tuner,
    then continued on the global layout (S from the tuner's rule)."""
    trainer = Trainer(*CS.bench_configs(budget_autotune=True), device="cuda")
    state, data, aux = _train(trainer, scene, CS.WARM_STEPS)
    _, calls = CS.capture_step(trainer, state, data)
    out = {"autotune": (trainer, calls)}
    mean = float(aux["num_samples"]) / trainer.cfg.num_rays
    trainer.render_cfg = dataclasses.replace(trainer.render_cfg, compaction="global",
                                             global_slots_per_ray=TR.global_slots_for(mean))
    _, calls = CS.capture_step(trainer, state, data)
    out["global"] = (trainer, calls)
    return out


def launches_of_one_call(key, fn) -> int:
    n0 = kernels.launches[key]
    fn()
    torch.cuda.synchronize()
    return kernels.launches[key] - n0


def profile_call(label, fn) -> None:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if dt > 0:
            print(f"profile {label} {e.key[:90]}: {e.count} launches, {dt / 1e3 / 10:.4f} ms per call",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--paths", nargs="*", default=["flat", "autotune"],
                    help="flat (the flat phase, both layouts) and autotune (autotune and global)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; checkout {os.getcwd()}", flush=True)
    t0 = time.perf_counter()
    _build.build_all(["march_flat", "compact"])
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    scene = make_synthetic_scene(num_views=8, H=256, W=256, num_steps=128)
    calls = {}
    if "flat" in args.paths:
        calls.update(flat_calls(scene))
    if "autotune" in args.paths:
        calls.update(autotune_calls(scene))
    failed = []
    for label, (trainer, c) in calls.items():
        for wrapper, make, key in (("_march_flat_cuda", CS._march_flat_rows, "march_flat"),
                                   ("_compact_cuda", CS._compact_rows, "compact")):
            if not c[wrapper]:
                continue
            a, kw = c[wrapper][0]
            fn = lambda: getattr(RM, wrapper)(*a, **kw)  # noqa: E731
            try:
                rows = [r for r in make(trainer, c) if r["key"] == key]
            except RuntimeError as e:  # a kernel that differs from its plain version
                print(f"{label} {wrapper}: {e}", flush=True)
                failed.append(f"{label} {wrapper}")
                continue
            for r in rows:
                print(f"{r['name']} ({label}): launches/call={launches_of_one_call(key, fn)} "
                      f"ms={r['ms']:.6g} bound_ms={r['bound_ms']:.6g} ({r['bound_by']}) "
                      f"plain_ms={r['plain_ms']:.6g} library_ms={r['library_ms']}; {r['note']}",
                      flush=True)
            if args.profile:
                profile_call(f"{label} {wrapper}", fn)
    if args.sass:
        for lib in ("march_flat", "compact"):
            K2T.sass_summary(lib, occupancy=True)
    if failed:
        print(f"differs from its plain version: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
