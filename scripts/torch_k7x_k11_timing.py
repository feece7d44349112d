"""K7x, the hash-grid coordinate gradient, and K11, the textured background
(forward and texture-gradient backward), on the card, at the arguments the
registry paths hand them:

- ``rh``: one 16,384-ray chunk of the registry-hash-normals view (the
  hash-grid path's field trained for chip_smoke's 64 + 50 steps, the
  diffuse material with analytic normals): K7 forward and K7x;
- ``rg``: chip_smoke's registry-grid configuration (JAX's default 64^3 x 16
  voxel grid, a 64 x 128 texture behind ``bg_fn``, bench.py's 32,768 rays)
  trained for chip_smoke's 64 + 50 steps, one captured step (K11 forward
  and backward) and one 16,384-ray chunk of one camera's view (the
  analytic-normal chunk: K11 forward, and the backward on its rays with a
  seeded cotangent, where neighbouring rays share texels).

    python scripts/torch_k7x_k11_timing.py [--profile] [--sass] [--two-launch] [--paths rh rg]

The calls run through chip_smoke's own rows (``_grid_encode_fwd_rows``,
``_k7x_rows``, ``_textured_bg_rows``): each held to its plain version and
timed (median of 20 calls, each behind a device sleep, warm L2) beside
chip_smoke's bound and the plain version's time; a row prints the launches
of one call. Printed besides: the launch floor (``time_ms`` of a one-element
``fill_``); the view chunk's K11 forward and backward, held the same way;
and, where the checkout's chip_smoke has ``_texel_sharing``, the share of a
warp's taps merged into another lane's add of the same texel row on the
step's and the view chunk's rays. ``--two-launch`` also builds a copy of
the checkout's ``textured_bg.cu`` into the build directory with the
backward's zero fill and ``grid.sync()`` cut out and an ordinary launch in
place of the cooperative one, and times ``torch.zeros`` plus that launch
(the two-launch form) against the one launch, both held to the plain
version.
``--profile`` prints each launch's device time over 10 calls under
``torch.profiler``; ``--sass`` the ``gridencoder`` and ``textured_bg``
libraries' kernels' registers, stack frame, the occupancy the registers
allow and their instructions by opcode. Run from another checkout's root it
times that checkout's kernels (the script imports the package and
``chip_smoke.py`` of the working directory), which is how parent and change
go in one call. Prints the card's name and power limit first and needs a
CUDA device; the exit code is 1 where a kernel differs from its plain
version.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as CS  # noqa: E402
import torch_k1f_timing as K1FT  # noqa: E402  (beside this script)
import torch_k2_timing as K2T  # noqa: E402
import torch_k7_timing as K7T  # noqa: E402
from trinerflet_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from trinerflet_tpu_torch.kernels import _build  # noqa: E402
from trinerflet_tpu_torch.models import gridencoder as GE  # noqa: E402
from trinerflet_tpu_torch.models import registry as REG  # noqa: E402
from trinerflet_tpu_torch.train.trainer import Trainer  # noqa: E402


def print_row(r, launches):
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.6g}"
    print(f"{r['name']}: launches/call={launches} ms={r['ms']:.6g} bound_ms={r['bound_ms']:.6g} "
          f"({r['bound_by']}) plain_ms={r['plain_ms']:.6g} library_ms={lib} "
          f"max_abs_err={r['max_abs_err']:.3g}; {r['note']}", flush=True)


def rh(scene, profile):
    """K7 forward and K7x on the registry-hash-normals view chunk."""
    _, state, _ = K7T.trained(CS.hashgrid_configs, scene)
    calls = K7T.rh_calls(state)
    fwd = CS._grid_encode_fwd_rows(calls)
    rows = CS._k7x_rows(calls)
    args = calls["_grid_encode_backward_x_cuda"][0][0]
    fargs = calls["_grid_encode_cuda"][0][0]
    fns = {"grid_encode": lambda: GE._grid_encode_cuda(*fargs),
           "grid_encode_bwd_x": lambda: GE._grid_encode_backward_x_cuda(*args)}
    print_row(fwd[0], K1FT.launches_of_one_call("grid_encode", fns["grid_encode"]))
    print_row(rows[0], K1FT.launches_of_one_call("grid_encode_bwd_x", fns["grid_encode_bwd_x"]))
    g, _, x, cfg, _ = args
    live = (g.reshape(g.shape[0], cfg.num_levels, cfg.level_dim) != 0).any(-1)
    print(f"rh K7x: {x.shape[0]} points x {cfg.num_levels} levels, live (point, level) share "
          f"{live.float().mean().item():.4f}; K7 forward / K7x {fwd[0]['ms']:.6g} / {rows[0]['ms']:.6g} ms",
          flush=True)
    if profile:
        for key, fn in fns.items():
            K1FT.profile_call(f"rh {key}", fn)


def _unsure(tex, d):
    """The rays on the seam or near a pole, whose taps may differ from the
    plain version's (chip_smoke's ``_k11_errors``)."""
    _, _, _, seam, pole = CS._k11_errors(REG._background_textured_cuda(tex, d), tex, d)
    return (seam | pole).to(d.device)


def _k11_backward_held(g, s, d, H, W, unsure, fn, what):
    """fn's texture gradient against the plain version on the CPU, the
    ``unsure`` rays without cotangent."""
    gz = torch.where(unsure[:, None], 0.0, g)
    err = CS._rel(fn(gz).cpu(), REG.background_textured_backward_plain(gz.cpu(), s.cpu(), d.cpu(), H, W))
    ok = err <= 1e-5
    print(f"{what}: rel_err={err:.3g} (tol 1e-5) {'held' if ok else 'OFF'}", flush=True)
    return ok


def _two_launch_function():
    """The K11 backward launcher of a copy of ``textured_bg.cu`` without the
    zero fill and its ``grid.sync()``, launched as an ordinary kernel into a
    gradient the caller has zeroed."""
    src = (_build._CSRC / "textured_bg.cu").read_text()
    cut = re.sub(r"\n  \{\n    const long long n = 3LL \* H \* W.*?cg::this_grid\(\)\.sync\(\);\n", "\n", src,
                 count=1, flags=re.S)
    cut = cut.replace("cudaLaunchCooperativeKernel(", "cudaLaunchKernel(")
    if cut.count("grid().sync()") or cut.count("cudaLaunchKernel(") != 1:
        raise RuntimeError("--two-launch: the backward's fill or launch is not where the cut expects it")
    out = _build.BUILD_DIR / "textured_bg_two_launch"
    out.mkdir(parents=True, exist_ok=True)
    (out / "textured_bg.cu").write_text(cut)
    subprocess.run([_build._nvcc()] + _build._flags("textured_bg") + ["-o", str(out / "lib.so"),
                                                                      str(out / "textured_bg.cu")], check=True)
    fn = ctypes.CDLL(str(out / "lib.so")).textured_bg_backward_launch
    fn.argtypes, fn.restype = REG._K11_BWD_ARGS, ctypes.c_int
    return fn


def rg(scene, profile, two):
    """K11 forward and backward on the registry-grid step, the forward and
    the backward on one camera's view chunk, and with ``two`` the
    two-launch backward."""
    nerf_cfg, render_cfg, train_cfg = CS.registry_configs()
    trainer = Trainer(nerf_cfg, render_cfg, train_cfg, device="cuda")
    init_fn, field = REG.make_field(nerf_cfg, "volume-grid", "neural-radiance-material", "textured-background")
    state = CS.registry_state(init_fn, CS.full_occupancy(render_cfg))
    data = trainer.scene_to_device(scene)
    state, _, _ = CS.registry_train(trainer, field, state, data, "", "registry-grid train",
                                    CS.REG_GRID_KERNELS, CS.REG_GRID_ABSENT)
    state, calls = CS._capture_registry_step(trainer, field, state, data)
    _, xcalls = CS._grid_normal_chunk(trainer, nerf_cfg, state.ema_params, state.occ)
    ok = True
    try:
        rows = CS._textured_bg_rows(calls)
    except RuntimeError as e:  # a kernel that differs from its plain version
        print(f"K11: {e}", flush=True)
        rows, ok = [], False
    fargs = calls["_background_textured_cuda"][0][0]
    bargs = calls["_background_textured_backward_cuda"][0][0]
    fns = {"textured_bg": lambda: REG._background_textured_cuda(*fargs),
           "textured_bg_bwd": lambda: REG._background_textured_backward_cuda(*bargs)}
    for r in rows:
        print_row(r, K1FT.launches_of_one_call(r["key"], fns[r["key"]]))
    # one camera's 16,384 rays: the forward, and the backward with a seeded cotangent
    tex, d = xcalls["_background_textured_cuda"][0][0]
    H, W = tex.shape[:2]
    s = REG._background_textured_cuda(tex, d)
    e_main, e_pole, e_seam, _, _ = CS._k11_errors(s, tex, d)
    ok = ok and e_main <= 1e-4 and e_pole <= 1e-3 and e_seam <= 1e-4
    g = torch.randn(d.shape, generator=torch.Generator().manual_seed(CS.SEED)).to(d.device)
    view = {"textured_bg (view chunk)": lambda: REG._background_textured_cuda(tex, d),
            "textured_bg_bwd (view chunk)": lambda: REG._background_textured_backward_cuda(g, s, d, H, W)}
    unsure = {"step": _unsure(fargs[0], bargs[2]), "view chunk": _unsure(tex, d)}
    ok = _k11_backward_held(g, s, d, H, W, unsure["view chunk"],
                            lambda gz: REG._background_textured_backward_cuda(gz, s, d, H, W),
                            "K11 backward (view chunk)") and ok
    print(f"K11 forward (view chunk): N={d.shape[0]} rays, {H}x{W}; max|err| {e_main:.3g} (tol 1e-4), poles "
          f"{e_pole:.3g}, seam {e_seam:.3g}; ms={CS.time_ms(view['textured_bg (view chunk)']):.6g}", flush=True)
    print(f"K11 backward (view chunk, seeded cotangent): "
          f"ms={CS.time_ms(view['textured_bg_bwd (view chunk)']):.6g}", flush=True)
    if hasattr(CS, "_texel_sharing"):
        gs = bargs[0] * (bargs[1] * (1 - bargs[1]))
        for what, (dd, live) in (("step", (bargs[2], (gs != 0).any(-1))), ("view chunk", (d, None))):
            share, groups, taps = CS._texel_sharing(dd, H, W, live)
            print(f"K11 texel sharing ({what}): {share:.4f} of {taps} live taps merged into another lane's "
                  f"add of the same row; {groups} adds", flush=True)
    if two:
        fn = _two_launch_function()

        def two_launch(g, s, d):
            acc = torch.zeros((H, W, 3), device=d.device)
            _build.check(fn(_build.ptr(d), _build.ptr(g), _build.ptr(s), d.shape[0], H, W, REG._clip_hi(H),
                            REG._clip_hi(W), _build.ptr(acc), _build.stream(d.device)), "two-launch")
            return acc

        for what, (gg, ss, dd) in (("step", bargs[:3]), ("view chunk", (g, s, d))):
            ok = _k11_backward_held(gg, ss, dd, H, W, unsure[what], lambda gz: two_launch(gz, ss, dd),
                                    f"K11 backward two-launch form ({what})") and ok
            one_ms = CS.time_ms(lambda: REG._background_textured_backward_cuda(gg, ss, dd, H, W))
            two_ms = CS.time_ms(lambda: two_launch(gg, ss, dd))
            print(f"K11 backward ({what}): one cooperative launch {one_ms:.6g} ms, torch.zeros + launch "
                  f"without the fill {two_ms:.6g} ms", flush=True)
            view[f"textured_bg_bwd two-launch ({what})"] = lambda gg=gg, ss=ss, dd=dd: two_launch(gg, ss, dd)
    if profile:
        for key, fn_ in list(fns.items()) + list(view.items()):
            K1FT.profile_call(f"rg {key}", fn_)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--two-launch", action="store_true",
                    help="also time torch.zeros + the K11 backward without its fill, built from a cut copy")
    ap.add_argument("--paths", nargs="*", default=["rh", "rg"],
                    help="rh (the registry-hash-normals view chunk: K7 forward, K7x) and rg (the "
                         "registry-grid step and view chunk: K11)")
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
    z = torch.empty((1,), device="cuda")
    print(f"launch floor: {CS.time_ms(lambda: z.fill_(1.0), iters=50):.6g} ms (a one-element fill_)", flush=True)
    scene = make_synthetic_scene(num_views=8, H=256, W=256, num_steps=128)
    ok = True
    if "rh" in args.paths:
        try:
            rh(scene, args.profile)
        except RuntimeError as e:  # a kernel that differs from its plain version
            print(f"rh: {e}", flush=True)
            ok = False
    if "rg" in args.paths:
        ok = rg(scene, args.profile, args.two_launch) and ok
    if args.sass:
        K2T.sass_summary("gridencoder", occupancy=True)
        K2T.sass_summary("textured_bg", occupancy=True)
    if not ok:
        print("a kernel differs from its plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
