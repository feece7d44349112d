"""The samplers' second derivatives on the card, at the arguments a step of
training through analytic normals hands them: K2x² on the registry-sdf-
analytic step (``sa``: the SDF on bench.py's 1024^2 x 16 bf16 triplane),
K7x² on the registry-hash-analytic step (``ha``: JAX's default hash grid,
16 levels x 2, 2^19 rows) and, for reference, K10² on the
registry-grid-analytic step (``ga``: the 64^3 x 16 voxel grid).

    python scripts/torch_second_order_timing.py [--profile] [--sass] [--cut-atomics]
        [--save PATH] [--compare PATH] [--paths sa ha ga]

Each path trains chip_smoke's configuration through its analytic normals
(chip_smoke's 32 + 32 steps on bench.py's rays over a full occupancy grid)
and records one more step. The step's second-order call runs through
chip_smoke's own row (``_k2xx_rows``, ``_k7xx_rows``, ``_k10xx_rows``):
every output held to its plain version and the call timed (median of 20
calls, each behind a device sleep, warm L2) beside chip_smoke's bound and
the plain version's time; a row prints the launches of one call.

``--profile`` prints each launch's device time over 10 calls under
``torch.profiler`` (K2x²: the dL/dg launch and the count, column scan,
scan, scatter, accumulate and reduce passes). ``--sass`` prints the
``gridencoder`` and ``grid_sample`` libraries' kernels' registers, stack
frame, the occupancy the registers allow and their instructions by opcode.
``--cut-atomics`` builds a copy of the checkout's ``gridencoder.cu`` into
the build directory with K7x²'s table-gradient adds cut out and times the
``ha`` call with it beside the whole kernel (its dL/dx and dL/dg must keep
their bits): the atomics' share of K7x²'s time.

``--save PATH`` writes, at the captured steps' arguments, the inputs and
outputs of the kernels the second derivatives sit beside: the K2 backward
and K2x with its plane gradient (``sa``), the K7 backward and K7x (``ha``);
besides, K2x²'s outputs and K7x²'s dL/dx and dL/dg (its table gradient is
a float-atomic sum). ``--compare PATH`` runs this checkout's kernels on a
saved file's inputs and checks them against its outputs: bit for bit for
the K2 backward, K2x, K7x and the second derivatives' saved outputs (their
sums run in an order fixed by the inputs), and for the K7 backward's
float-atomic tables each of the two within the float-summation bound of a
float64 sum of the same terms (``models/gridencoder.py
grid_encode_backward_error``). Both print each call's time. Run from another
checkout's root (``cd parent && python ../scripts/torch_second_order_timing.py``)
the script imports that checkout's package and ``chip_smoke.py``, which is
how parent and change are timed and compared in one call. Prints the
card's name and power limit first and needs a CUDA device; the exit code is
1 where a kernel differs from its plain version or from the saved outputs.
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
from trinerflet_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from trinerflet_tpu_torch.kernels import _build  # noqa: E402
from trinerflet_tpu_torch.models import gridencoder as GE  # noqa: E402
from trinerflet_tpu_torch.models import registry as REG  # noqa: E402
from trinerflet_tpu_torch.ops import grid_sample as GS  # noqa: E402
from trinerflet_tpu_torch.train.trainer import Trainer  # noqa: E402

# path -> (configurations, registry names, kernels that must launch, row maker, wrapper, launch key)
PATHS = {
    "sa": (CS.registry_configs, ("implicit-sdf", "diffuse-with-point-light-material",
                                 "neural-environment-map-background"),
           CS.REG_SDF_AN_KERNELS, CS._k2xx_rows, (GS, "_sample_points_backward_xyz_backward_cuda"),
           "grid_sample_bwd_xyz_bwd"),
    "ha": (lambda: (CS.hashgrid_configs()[0],) + CS.registry_configs()[1:],
           ("implicit-volume", "diffuse-with-point-light-material", "solid-color-background"),
           CS.REG_HASH_AN_KERNELS, CS._k7xx_rows, (GE, "_grid_encode_backward_x_backward_cuda"),
           "grid_encode_bwd_x_bwd"),
    "ga": (CS.registry_configs, ("volume-grid", "diffuse-with-point-light-material", "textured-background"),
           CS.REG_GRID_AN_KERNELS, CS._k10xx_rows, (REG, "_sample_volume_grid_backward_x_backward_cuda"),
           "volume_grid_bwd_x_bwd"),
}


def captured_step(name, scene):
    """chip_smoke's analytic phase up to its captured step: the field trained
    through its normals for 32 + 32 steps, one profiled step, then one step
    with every wrapper's arguments recorded."""
    configs, names, required, _, _, _ = PATHS[name]
    nerf_cfg, render_cfg, train_cfg = configs()
    trainer = Trainer(nerf_cfg, render_cfg, train_cfg, device="cuda")
    init_fn, field = REG.make_field(nerf_cfg, *names, normal_type="analytic")
    state = CS.registry_state(init_fn, CS.full_occupancy(render_cfg))
    data = trainer.scene_to_device(scene)
    step = CS.registry_step(trainer, field, data)
    what = f"{name} train"
    state, _, _ = CS.train_phase(trainer, state, data, "", warm=CS.ANALYTIC_WARM, n_windows=1,
                                 window_steps=CS.ANALYTIC_WINDOW, required=required, what=what,
                                 absent=CS.REG_AN_ABSENT, step=step, refresh=False)
    state = CS.profile_step(trainer, state, data, what, step=step)
    _, calls = CS._capture_registry_step(trainer, field, state, data)
    return calls


class _CutBuild:
    """``_build`` as the K7x² wrapper sees it, with its launcher taken from
    the cut library."""

    def __init__(self, fn):
        self._fn = fn

    def function(self, name, symbol, argtypes, restype=ctypes.c_int):
        if symbol == "grid_encode_backward_x_backward_launch":
            return self._fn
        return _build.function(name, symbol, argtypes, restype)

    def __getattr__(self, attr):
        return getattr(_build, attr)


def _cut_atomics_function():
    """The K7x² launcher of a copy of ``gridencoder.cu`` whose table-gradient
    adds are cut out (one thread's scalar atomicAdd per term, or the merged
    scatter of a tile's corners), built into the build directory."""
    src = (_build._CSRC / "gridencoder.cu").read_text()
    cut, n = re.subn(r"if \(t != 0\.0f\) atomicAdd\(grads\.table\[l\][^;]*;|"
                     r"scatter_corners<C>\(grads\.table\[l\][^;]*;", ";", src)
    if n != 1:
        raise RuntimeError(f"--cut-atomics: expected one table-gradient add in K7x², found {n}")
    out = _build.BUILD_DIR / "gridencoder_cut_atomics"
    out.mkdir(parents=True, exist_ok=True)
    (out / "gridencoder.cu").write_text(cut)
    subprocess.run([_build._nvcc()] + _build._flags("gridencoder") + ["-o", str(out / "lib.so"),
                                                                      str(out / "gridencoder.cu")], check=True)
    fn = ctypes.CDLL(str(out / "lib.so")).grid_encode_backward_x_backward_launch
    fn.argtypes, fn.restype = GE._K7XX_ARGS, ctypes.c_int
    return fn


def cut_atomics(args, full_ms):
    """The ``ha`` call with the cut kernel: dL/dx and dL/dg the whole
    kernel's bits, and its time beside the whole kernel's."""
    cut = _CutBuild(_cut_atomics_function())
    whole = GE._grid_encode_backward_x_backward_cuda(*args)

    def run():
        saved = GE._build
        GE._build = cut
        try:
            return GE._grid_encode_backward_x_backward_cuda(*args)
        finally:
            GE._build = saved

    got = run()
    same = all(torch.equal(a, b) for a, b in zip(got[:2], whole[:2]) if b is not None)
    ms = CS.time_ms(run)
    print(f"ha K7x² without its table-gradient adds: ms={ms:.6g} (whole kernel {full_ms:.6g}; the adds' "
          f"share {1 - ms / full_ms:.3f}); dL/dx and dL/dg the whole kernel's bits: {same}", flush=True)
    return same


def k2xx_tiles(args):
    """What the plane gradient's binned passes get from a K2x² call: the
    (plane, point) rows gg reaches and that carry a g, their entries in the
    32-texel-wide tiles their footprints touch, the tiles with an entry,
    the chunks (a tile's rows split past the cap, as the scan splits them)
    and the 256-row batches the accumulate pass stages."""
    gg, _, planes, xyz, g, lb, _ = args
    _, H, Wd, C = planes.shape
    TY = 16 if C == 32 else 32
    tx_n, ty_n = -(-Wd // 32), -(-H // TY)
    nz = gg != 0
    reached = torch.stack([nz[:, 0] | nz[:, 2], nz[:, 0] | nz[:, 1], nz[:, 1] | nz[:, 2]], 1)  # (M, 3)
    reached &= (g != 0).any(-1)
    c2 = GS.project_to_planes(xyz, lb)  # (3, M, 2)
    x0 = torch.clamp(torch.floor(torch.clamp((c2[..., 0] + 1) * 0.5 * (Wd - 1), 0, Wd - 1)), 0, Wd - 2).long()
    y0 = torch.clamp(torch.floor(torch.clamp((c2[..., 1] + 1) * 0.5 * (H - 1), 0, H - 1)), 0, H - 2).long()
    live = reached.T  # (3, M)
    p = torch.arange(3, device=xyz.device)[:, None].expand_as(x0)
    x0, y0, p = x0[live], y0[live], p[live]
    tiles = [(p * ty_n + y0 // TY) * tx_n + x0 // 32]
    right, below = x0 % 32 == 31, y0 % TY == TY - 1
    tiles += [tiles[0][right] + 1, tiles[0][below] + tx_n, tiles[0][right & below] + tx_n + 1]
    counts = torch.bincount(torch.cat(tiles), minlength=3 * tx_n * ty_n)
    E = int(counts.sum())
    cap = max(2048, -(-2 * E // 1024))
    chunks = torch.where(counts > cap, -(-counts // cap), torch.ones_like(counts))
    per_chunk = counts.float() / chunks
    batches = int((chunks * torch.ceil(per_chunk / 256)).sum())
    return (f"{int(live.sum())} rows reached with a g; {E} entries in {int((counts > 0).sum())} of "
            f"{counts.numel()} tiles (largest {int(counts.max())}); {int(chunks.sum())} chunks (cap {cap}), "
            f"{batches} batches of 256 rows")


def _cpu_args(args):
    return [a.detach().cpu() if torch.is_tensor(a) else ([t.detach().cpu() for t in a] if isinstance(a, list) else a)
            for a in args]


def _cuda_args(args):
    return [a.cuda() if torch.is_tensor(a) else ([t.cuda() for t in a] if isinstance(a, list) else a)
            for a in args]


# saved kernel -> (the captured wrapper whose first call's arguments it runs on, how it runs them)
SAVED = {
    "K2 backward": ("sa", "_sample_points_backward_cuda", lambda a, kw: [GS._sample_points_backward_cuda(*a, **kw)]),
    "K2x (plane gradient and dL/dxyz)": ("sa", "_sample_points_backward_xyz_cuda",
                                         lambda a, kw: list(GS._sample_points_backward_xyz_cuda(*a[:4],
                                                                                               planes_grad=True))),
    "K7 backward": ("ha", "_grid_encode_backward_cuda", lambda a, kw: list(GE._grid_encode_backward_cuda(*a, **kw))),
    "K7x": ("ha", "_grid_encode_backward_x_cuda", lambda a, kw: [GE._grid_encode_backward_x_cuda(*a, **kw)]),
    "K2x² (all three outputs)": ("sa", "_sample_points_backward_xyz_backward_cuda",
                                 lambda a, kw: [t for t in GS._sample_points_backward_xyz_backward_cuda(*a, **kw)
                                                if t is not None]),
    "K7x² (dL/dx, dL/dg)": ("ha", "_grid_encode_backward_x_backward_cuda",
                            lambda a, kw: [t for t in GE._grid_encode_backward_x_backward_cuda(*a, **kw)[:2]
                                           if t is not None]),
}


def save_outputs(captured, path):
    out = {}
    for kernel, (name, wrapper, run) in SAVED.items():
        if name not in captured:
            continue
        a, kw = captured[name][wrapper][0]
        out[kernel] = (_cpu_args(a), kw, [t.cpu() for t in run(a, kw)])
        print(f"save {kernel}: ms={CS.time_ms(lambda: run(a, kw)):.6g}", flush=True)
    torch.save(out, path)
    print(f"saved {sorted(out)} to {path}", flush=True)


def compare_outputs(path) -> bool:
    saved = torch.load(path, weights_only=False)
    ok = True
    for kernel, (a, kw, ref) in saved.items():
        a = _cuda_args(a)
        got = SAVED[kernel][2](a, kw)
        print(f"compare {kernel}: ms={CS.time_ms(lambda: SAVED[kernel][2](a, kw)):.6g} on the saved inputs",
              flush=True)
        if kernel == "K7 backward":
            g, x, cfg, bound = a[:4]
            e_got = max(GE.grid_encode_backward_error(got, g, x, cfg, bound))
            e_ref = max(GE.grid_encode_backward_error([t.cuda() for t in ref], g, x, cfg, bound))
            same = e_got <= 1.0 and e_ref <= 1.0
            print(f"compare {kernel}: this checkout {e_got:.3g}, saved {e_ref:.3g} of the float-summation "
                  f"bound (within: {same})", flush=True)
        else:
            same = all(torch.equal(t.cpu(), r) for t, r in zip(got, ref))
            print(f"compare {kernel}: bit for bit the saved outputs: {same}", flush=True)
        ok = ok and same
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--cut-atomics", action="store_true",
                    help="also time K7x² built without its table-gradient adds (ha)")
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    ap.add_argument("--paths", nargs="*", default=list(PATHS), choices=list(PATHS))
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
    ok = True
    captured = {}
    for name in args.paths:
        t0 = time.perf_counter()
        calls = captured[name] = captured_step(name, scene)
        _, _, _, make, (mod, wrapper), key = PATHS[name]
        a, kw = calls[wrapper][0]
        fn = lambda: getattr(mod, wrapper)(*a, **kw)  # noqa: E731
        try:
            rows = make(calls)
        except RuntimeError as e:  # a kernel that differs from its plain version
            print(f"{name} {wrapper}: {e}", flush=True)
            ok = False
            continue
        for r in rows:
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.6g}"
            print(f"{r['name']} ({name}): launches/call={K1FT.launches_of_one_call(key, fn)} ms={r['ms']:.6g} "
                  f"bound_ms={r['bound_ms']:.6g} ({r['bound_by']}) time/bound={r['ms'] / r['bound_ms']:.2f} "
                  f"plain_ms={r['plain_ms']:.6g} library_ms={lib} max_abs_err={r['max_abs_err']:.3g}; "
                  f"{r['note']}", flush=True)
            if name == "sa":
                print(f"sa K2x² plane gradient: {k2xx_tiles(a)}", flush=True)
            if name == "ha" and args.cut_atomics:
                ok = cut_atomics(a, r["ms"]) and ok
        if args.profile:
            K1FT.profile_call(f"{name} {wrapper}", fn)
        print(f"# {name} done in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.save:
        save_outputs(captured, args.save)
    if args.compare:
        ok = compare_outputs(args.compare) and ok
    if args.sass:
        K2T.sass_summary("gridencoder", occupancy=True)
        K2T.sass_summary("grid_sample", occupancy=True)
    if not ok:
        print("a kernel differs from its plain version or from the saved outputs", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
