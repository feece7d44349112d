"""K3, the dense per-ray compositor, forward and backward, on the card, at
the arguments the main paths hand it: one serve chunk (the middle 16,384-ray
chunk of an 800^2 view on chip_smoke's serve state), and one training step's
calls on bench.py's step with the tuner off (``perray``: B = 20 samples a
ray), on the dense renderer (``dense``: T = 512 for the upsampling weights,
T = 576 for the composite) and on the proposal renderer (``proposal``: the
proposal weights at P = 64, the final samples at F = 32).

    python scripts/torch_k3_timing.py [--profile] [--sass] [--trail] [--paths [NAME ...]]

Each training path trains chip_smoke's configuration on its synthetic scene
(the path's warm-up steps, with the refresh and the retune on their cadence
on the occupancy-grid path) and records one more step's K3 calls. Every call
goes through chip_smoke's own K3 rows (``_composite_row``,
``_composite_backward_row``): held to the plain version (forward max|err|
<= 1e-5, backward 1e-5 of the largest gradient; an error raises) and timed
as chip_smoke times (median of 20 calls, each behind a device sleep, warm
L2), beside the bound (bytes over 3.35 TB/s or f32 operations over 67
TFLOP/s, whichever is larger) and the plain version's time. Each row also
says whether a second call gave the same bits (``torch.equal``; the exit
code is 1 where not) and whether the weights equal the plain version's bit
for bit. ``--profile`` prints the device time of each CUDA kernel per
launch over 10 calls under ``torch.profiler`` (which may keep fewer than 10
of them); ``--sass`` the ``composite`` library's kernels' registers, stack
frame, the occupancy the registers allow and their instructions by opcode
(``cuobjdump``); ``--trail`` runs chip_smoke's autotune phase (bench.py's
step, the tuner on, 320 + 5 x 50 steps) twice, with K3 and with K3's plain
versions in its place on the card, and prints each run's retune trail,
kept samples per ray and loss (``--paths`` with no name runs that alone).
Run from another checkout's root it times that checkout's kernels (the
script imports the package and ``chip_smoke.py`` of the working
directory), which is how parent and change go in one call. Prints the
card's name and power limit and torch's version first and needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as CS  # noqa: E402
import torch_k2_timing as K2T  # noqa: E402  (beside this script)
from trinerflet_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from trinerflet_tpu_torch.kernels import _build  # noqa: E402
from trinerflet_tpu_torch.ops import raymarch as RM  # noqa: E402

# path -> (its configurations, warm-up steps)
PATHS = {
    "perray": (lambda: CS.bench_configs(budget_autotune=False), CS.PERRAY_WARM),
    "dense": (CS.dense_configs, CS.DENSE_WARM),
    "proposal": (CS.proposal_configs, CS.PERRAY_WARM),
}
K3 = ("_composite_cuda", "_composite_backward_cuda")


def serve_calls():
    """The K3 call of the middle eval chunk of an 800^2 view on chip_smoke's
    serve state."""
    trainer, params, occ, poses, intr = CS.serve_setup()
    with CS.Capture() as cap:
        trainer.render_image(params, occ, poses[0], intr, CS.VIEW_HW, CS.VIEW_HW)
    torch.cuda.synchronize()
    fwd = cap.calls["_composite_cuda"]
    return {"_composite_cuda": [fwd[len(fwd) // 2]], "_composite_backward_cuda": []}


def train_calls(name: str, scene):
    """One step's K3 calls on ``name``'s path after its warm-up."""
    calls = K2T.captured_calls(name, scene, PATHS)
    return {k: calls[k] for k in K3}


def rows_of(label: str, calls):
    rows = []
    for cargs, _ in calls["_composite_cuda"]:
        r = CS._composite_row(cargs, True)[0]
        a, b = RM._composite_cuda(*cargs), RM._composite_cuda(*cargs)
        r.update(same_bits=all(torch.equal(x, y) for x, y in zip(a, b)),
                 weights_equal=torch.equal(a[3], RM.composite_dense_plain(*cargs)[3]),
                 launches=K2T._launches("composite", lambda: RM._composite_cuda(*cargs)))
        rows.append((r, "fwd", cargs))
    for bargs, _ in calls["_composite_backward_cuda"]:
        r = CS._composite_backward_row(bargs, True)[0]
        a, b = RM._composite_backward_cuda(*bargs), RM._composite_backward_cuda(*bargs)
        r.update(same_bits=all(torch.equal(x, y) for x, y in zip(a, b)),
                 launches=K2T._launches("composite_bwd",
                                        lambda: RM._composite_backward_cuda(*bargs)))
        rows.append((r, "bwd", bargs))
    for r, _, _ in rows:
        r["name"] += f" ({label})"
    return rows


def trail(scene, card: str, plain: bool) -> None:
    """chip_smoke's autotune phase (bench.py's step and cadence, the tuner
    on), with K3 or, with ``plain``, K3's plain versions in the kernels'
    place on the card; chip_smoke's log prints the retune trail (kept
    samples per ray the tuner read at each refresh, the layout it chose),
    the loss and the launches."""
    what = "autotune train, K3 " + ("plain version" if plain else "kernel")
    kernel = RM._composite_cuda, RM._composite_backward_cuda
    if plain:
        RM._composite_cuda, RM._composite_backward_cuda = (RM.composite_dense_plain,
                                                           RM.composite_dense_backward_plain)
    k3 = ("composite", "composite_bwd")
    try:
        trainer, state, data, _ = CS.train_setup(budget_autotune=True, scene=scene)
        CS.train_phase(trainer, state, data, card, what=what,
                       required=[k for k in CS.TRAIN_KERNELS if not (plain and k in k3)],
                       absent=("march_flat",) + (k3 if plain else ()))
    finally:
        RM._composite_cuda, RM._composite_backward_cuda = kernel
    del trainer, state, data
    torch.cuda.empty_cache()


def profile_rows(rows) -> None:
    from torch.profiler import ProfilerActivity, profile
    for r, kind, args in rows:
        fn = RM._composite_cuda if kind == "fwd" else RM._composite_backward_cuda
        fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn(*args)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            dt = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            if dt > 0:
                print(f"profile {r['name']} {e.key[:80]}: {e.count} launches kept of 10 calls, "
                      f"{dt / 1e3 / e.count:.4f} ms per launch", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--trail", action="store_true")
    ap.add_argument("--paths", nargs="*", choices=["serve"] + list(PATHS),
                    default=["serve"] + list(PATHS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    scene = make_synthetic_scene(num_views=8, H=256, W=256, num_steps=128)
    keys = ("ms", "bound_ms", "plain_ms", "max_abs_err")
    failed = []
    for name in args.paths:
        t0 = time.perf_counter()
        calls = serve_calls() if name == "serve" else train_calls(name, scene)
        rows = rows_of(name, calls)
        for r, _, _ in rows:
            print(f"{r['name']}: launches={r['launches']} "
                  + " ".join(f"{k}={r[k]:.6g}" for k in keys)
                  + f" x_bound={r['ms'] / r['bound_ms']:.3g} same_bits={r['same_bits']}"
                  + (f" weights_equal={r['weights_equal']}" if "weights_equal" in r else ""),
                  flush=True)
            if not r["same_bits"]:
                failed.append(r["name"])
        if args.profile:
            profile_rows(rows)
        print(f"# {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        del calls, rows
        torch.cuda.empty_cache()
    if args.trail:
        for plain in (False, True):
            torch.manual_seed(CS.SEED)
            trail(scene, card, plain)
    if args.sass:
        K2T.sass_summary("composite", occupancy=True)
    if failed:
        print(f"K3 calls that differ on a second call: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
