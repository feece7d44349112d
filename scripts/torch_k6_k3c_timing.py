"""K6, the occupancy upkeep, and K3c, the compact compositor (forward and
backward), on the card, at the arguments the main paths hand them:
bench.py's step with the tuner off (``perray``: K6), with the tuner on
(``autotune``: K6, and K3c once the tuner engages the global layout) and
continued on the global layout (``global``: K6, K3c), and the flat phase's
step (chip_smoke's configuration: bound 4, 3 cascades, dt_gamma 1/128) in
the layout the tuner left (K6) and with the exact global layout forced
(K3c on the candidate rows).

    python scripts/torch_k6_k3c_timing.py [--profile] [--sass] [--paths perray autotune flat]

Each path trains chip_smoke's configuration on its synthetic scene (its
steps, with the refresh and the retune on their cadence) and records one
more step and partial refresh. Each call runs through chip_smoke's own rows
(``_upkeep_rows``, the K3c rows of ``_compact_rows``): the kernel held to
its plain version, timed (median of 20 calls, each behind a device sleep,
warm L2) beside chip_smoke's bound and the plain version's time. A row
prints the launches of one call. ``--profile`` prints each launch's device
time over 10 calls under ``torch.profiler`` (K6's launches one by one);
``--sass`` the ``occupancy`` and ``compact`` libraries' kernels' registers,
stack frame, the occupancy the registers allow and their instructions by
opcode. Run from another checkout's root it times that checkout's kernels
(the script imports the package and ``chip_smoke.py`` of the working
directory), which is how parent and change go in one call. Prints the
card's name and power limit first and needs a CUDA device; the exit code
is 1 where a kernel differs from its plain version.
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
from trinerflet_tpu_torch.ops import raymarch as RM  # noqa: E402
from trinerflet_tpu_torch.render import renderer as R  # noqa: E402
from trinerflet_tpu_torch.train.trainer import Trainer  # noqa: E402


def perray_calls(scene):
    """bench.py's step with the tuner off, after chip_smoke's 64 + 50 steps."""
    trainer = Trainer(*CS.bench_configs(budget_autotune=False), device="cuda")
    state, data, _ = K1FT._train(trainer, scene, CS.PERRAY_WARM + CS.WINDOW_STEPS * CS.PERRAY_WINDOWS)
    _, calls = CS.capture_step(trainer, state, data)
    return {"perray": (trainer, calls)}


# (wrapper of the recorded call, launch counter, module); the K3c rows come
# from chip_smoke's ``_compact_rows`` (after K5's)
KERNELS = (("_occupancy_upkeep_cuda", "occupancy", R),
           ("_composite_compact_cuda", "composite_compact", RM),
           ("_composite_compact_backward_cuda", "composite_compact_bwd", RM))


def rows_of(trainer, c, upkeep):
    """chip_smoke's rows for this path's K6 (with ``upkeep``) and K3c calls."""
    rows = []
    if upkeep and c["_occupancy_upkeep_cuda"]:
        rows += CS._upkeep_rows(trainer, c)
    if c["_compact_cuda"] and c["_composite_compact_cuda"]:
        rows += [r for r in CS._compact_rows(trainer, c) if r["key"] != "compact"]
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--paths", nargs="*", default=["perray", "autotune", "flat"],
                    help="perray, autotune (autotune and global) and flat (both layouts)")
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
    calls = {}
    if "perray" in args.paths:
        calls.update(perray_calls(scene))
    if "autotune" in args.paths:
        calls.update(K1FT.autotune_calls(scene))
    if "flat" in args.paths:
        calls.update(K1FT.flat_calls(scene))
    failed, flat_upkeep = [], False
    for label, (trainer, c) in calls.items():
        # K6 on the flat phase in the tuner's layout (the first) only: the
        # forced one refreshes alike
        upkeep = not (label.startswith("flat") and flat_upkeep)
        flat_upkeep |= label.startswith("flat")
        try:
            rows = rows_of(trainer, c, upkeep)
        except RuntimeError as e:  # a kernel that differs from its plain version
            print(f"{label}: {e}", flush=True)
            failed.append(label)
            continue
        for wrapper, key, mod in KERNELS:
            for r in (r for r in rows if r["key"] == key):
                a, kw = c[wrapper][0]
                fn = lambda: getattr(mod, wrapper)(*a, **kw)  # noqa: E731
                print(f"{r['name']} ({label}): launches/call={K1FT.launches_of_one_call(key, fn)} "
                      f"ms={r['ms']:.6g} bound_ms={r['bound_ms']:.6g} ({r['bound_by']}) "
                      f"plain_ms={r['plain_ms']:.6g} library_ms={r['library_ms']} "
                      f"max_abs_err={r['max_abs_err']:.3g}; {r['note']}", flush=True)
                if args.profile:
                    K1FT.profile_call(f"{label} {wrapper}", fn)
    if args.sass:
        for lib in ("occupancy", "compact"):
            K2T.sass_summary(lib, occupancy=True)
    if failed:
        print(f"differs from its plain version: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
