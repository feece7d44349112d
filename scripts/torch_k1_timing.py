"""K1, the hierarchical occupancy march, on the card, at the arguments the
main paths hand it: one serve chunk (``RenderConfig.for_eval()``, stride 1,
16,384 rays of an 800^2 view on chip_smoke's serve state), and one training
step's call on bench.py's step with the tuner off (``perray``), on
(``autotune``) and continued on the global layout (``global``).

    python scripts/torch_k1_timing.py [--profile] [--sass]

The training paths train chip_smoke's configuration on its synthetic scene
(the path's warm-up steps, with the refresh and the retune on their
cadence) and record one more step's march call. Each call's kernel is held
to its plain version bit for bit (every output; the exit code is 1 where
one differs) and one row printed: the kernel's device time (median of 20
calls, each behind a device sleep, warm L2, as chip_smoke times), the
launches of one call, the bound (chip_smoke's count: the rays in, one byte
per distinct grid cell the probes read and the outputs written, over 3.35
TB/s, or 20 f32 operations per probe over 67 TFLOP/s, whichever is larger),
the plain version's time, the probes and the mean kept samples per ray.
``--profile`` prints the kernel's device time over 10 calls under
``torch.profiler``; ``--sass`` the ``march`` library's kernels' registers
and stack frame, the occupancy the registers allow, and their instructions
by opcode (``cuobjdump`` of the built library). Run from another checkout's
root it times that checkout's kernel (the script imports the package and
``chip_smoke.py`` of the working directory), which is how parent and change
go in one call. Prints the card's name and power limit first and needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as CS  # noqa: E402
import torch_k2_timing as K2T  # noqa: E402  (beside this script)
from trinerflet_tpu_torch import kernels  # noqa: E402
from trinerflet_tpu_torch.data.rays import rays_full_image  # noqa: E402
from trinerflet_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from trinerflet_tpu_torch.kernels import _build  # noqa: E402
from trinerflet_tpu_torch.ops import raymarch as RM  # noqa: E402
from trinerflet_tpu_torch.render.renderer import mark_untrained_grid  # noqa: E402
from trinerflet_tpu_torch.train import trainer as TR  # noqa: E402
from trinerflet_tpu_torch.train.trainer import Trainer  # noqa: E402


def serve_call():
    """The march call of one serve chunk: the centre 16,384 rays of view 0
    on chip_smoke's serve state, as its kernel phase builds them."""
    trainer, _, occ, poses, intr = CS.serve_setup()
    rcfg, N = trainer.eval_render_cfg, trainer.eval_chunk
    ro, rd = rays_full_image(poses[0], intr, CS.VIEW_HW, CS.VIEW_HW)
    s = CS.VIEW_HW * CS.VIEW_HW // 2 - N // 2
    ro, rd = torch.from_numpy(ro[s : s + N]).cuda(), torch.from_numpy(rd[s : s + N]).cuda()
    nears, fars = RM.near_far_from_aabb(ro, rd, occ.bbox, rcfg.min_near)
    hit = nears < 1e30
    args = (ro, rd, torch.where(hit, nears, 0.0), torch.where(hit, fars, 0.0), occ.occ, occ.occ_coarse,
            torch.zeros((N,), device="cuda"))
    kw = dict(num_coarse=int(np.ceil(rcfg.bound * rcfg.max_steps / rcfg.fine_per_coarse)),
              fine_per_coarse=rcfg.fine_per_coarse, coarse_budget=rcfg.coarse_budget,
              budget=rcfg.samples_per_ray_budget, max_steps=rcfg.max_steps, grid_size=rcfg.grid_size,
              cascades=rcfg.cascades, bound=rcfg.bound, occ_test_stride=1, coarse_test_stride=1)
    return args, kw


def train_calls(scene, budget_autotune: bool):
    """One step's march call after the path's warm-up; with the tuner, a
    second one after the state continues on the global layout (S from the
    tuner's rule on the live mean, as chip_smoke's global phase)."""
    trainer = Trainer(*CS.bench_configs(budget_autotune=budget_autotune), device="cuda")
    state = trainer.init_state(density_grid=mark_untrained_grid(scene.poses, scene.intrinsics,
                                                                trainer.render_cfg))
    data = trainer.scene_to_device(scene)
    interval, aux = trainer.cfg.update_extra_interval, None
    for i in range(CS.WARM_STEPS if budget_autotune else CS.PERRAY_WARM):
        if i % interval == 0:
            state = CS._refresh(trainer, state, full=int(state.occ.iter_density) < 16)
            trainer._maybe_retune_march(state, aux)
        state, aux = trainer.train_step(state, data, with_stats=(i + 1) % interval == 0)
    state, calls = CS.capture_step(trainer, state, data)
    out = {"autotune" if budget_autotune else "perray": calls["_march_cuda"][0]}
    if budget_autotune:
        mean = float(aux["num_samples"]) / trainer.cfg.num_rays
        trainer.render_cfg = dataclasses.replace(trainer.render_cfg, compaction="global",
                                                 global_slots_per_ray=TR.global_slots_for(mean))
        _, calls = CS.capture_step(trainer, state, data)
        out["global"] = calls["_march_cuda"][0]
    return out


def row(label, args, kw):
    got, ref = RM._march_cuda(*args, **kw), RM.march_hierarchical_plain(*args, **kw)
    torch.cuda.synchronize()
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, ref))
    ro, rd, nears, fars, occ, occ_c, noise = args
    cells_c, cells_f, probes = CS.k1_need(ro, rd, nears, fars, noise, occ_c, kw)
    b, by = CS.bound_ms(CS.nbytes(ro, rd, nears, fars, noise) + cells_c + cells_f + CS.nbytes(*got),
                        20.0 * probes)
    n0 = kernels.launches["march"]
    RM._march_cuda(*args, **kw)
    return dict(name=f"K1 {label} N={ro.shape[0]} strides ({kw['occ_test_stride']}, "
                     f"{kw['coarse_test_stride']}) num_coarse {kw['num_coarse']} budget {kw['budget']}",
                ok=same, launches=kernels.launches["march"] - n0,
                ms=CS.time_ms(lambda: RM._march_cuda(*args, **kw)), bound_ms=b, bound_by=by,
                plain_ms=CS.time_ms(lambda: RM.march_hierarchical_plain(*args, **kw), iters=5),
                probes=probes,
                kept=got[2].float().sum(1).mean().item())


def profile_call(label, args, kw) -> None:
    from torch.profiler import ProfilerActivity, profile
    RM._march_cuda(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            RM._march_cuda(*args, **kw)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if dt > 0:
            print(f"profile {label} {e.key[:90]}: {e.count} launches, {dt / 1e3 / 10:.4f} ms per call")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    calls = {"serve": serve_call()}
    scene = make_synthetic_scene(num_views=8, H=256, W=256, num_steps=128)
    for tuner in (False, True):
        calls.update(train_calls(scene, tuner))
    failed = []
    for label, (a, kw) in calls.items():
        r = row(label, a, kw)
        print(f"{r['name']}: launches={r['launches']} ms={r['ms']:.6g} bound_ms={r['bound_ms']:.6g} "
              f"({r['bound_by']}) plain_ms={r['plain_ms']:.6g} "
              f"probes={r['probes']} kept/ray={r['kept']:.3f}" + ("" if r["ok"] else " DIFFERS"),
              flush=True)
        if not r["ok"]:
            failed.append(r["name"])
        if args.profile:
            profile_call(label, a, kw)
    if args.sass:
        K2T.sass_summary("march", occupancy=True)
    if failed:
        print(f"K1 differs from its plain version: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
