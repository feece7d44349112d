"""The samplers' second derivatives on the card, at the arguments a step of
training through analytic normals hands them: K2x² on the registry-sdf-
analytic step (``sa``: the SDF on bench.py's 1024^2 x 16 bf16 triplane),
K7x² on the registry-hash-analytic step (``ha``: JAX's default hash grid,
16 levels x 2, 2^19 rows) and K10² on the registry-grid-analytic step
(``ga``: the 64^3 x 16 voxel grid).

    python scripts/torch_second_order_timing.py [--profile] [--sass] [--cut-atomics]
        [--save PATH] [--compare PATH] [--paths sa ha ga]

Each path trains chip_smoke's configuration through its analytic normals
(chip_smoke's 32 + 32 steps on bench.py's rays over a full occupancy grid)
and records one more step. The step's second-order call runs through
chip_smoke's own row (``_k2xx_rows``, ``_k7xx_rows``, ``_k10xx_rows``):
every output held to its plain version and the call timed (median of 20
calls, each behind a device sleep, warm L2) beside chip_smoke's bound and
the plain version's time; a row prints the launches of one call. ``sa``
also prints what the plane gradient's binned passes get, ``ga`` what K10²
gets: the points gg reaches, the grid rows they touch, and how many
consecutive live points share a cell.

``--profile`` prints each launch's device time over 10 calls under
``torch.profiler`` (K2x²: the dL/dg launch and the count, column scan,
scan, scatter, accumulate and reduce passes; K10²: the grid gradient's
zero fill and the kernel). ``--sass`` prints the ``gridencoder``,
``grid_sample`` and ``volume_grid`` libraries' kernels' registers, stack
frame, the occupancy the registers allow and their instructions by opcode.
``--cut-atomics`` builds copies of the checkout's ``gridencoder.cu`` and
``volume_grid.cu`` into the build directory with K7x²'s table-gradient
adds, and K10²'s grid-gradient adds, cut out, and times the ``ha`` and
``ga`` calls with them beside the whole kernels (their dL/dx and dL/dg
must keep their bits): the atomics' share of each kernel's time.

``--save PATH`` writes, at the captured steps' arguments, the inputs and
outputs of the kernels the second derivatives sit beside: the K2 backward
and K2x with its plane gradient (``sa``), the K7 backward and K7x (``ha``),
the K10 forward, the K10 backward and K10x (``ga``); besides, K2x²'s
outputs, K7x²'s dL/dx and dL/dg, and K10²'s outputs, as the step asks
for them and with all three asked for.
``--compare PATH`` runs this checkout's kernels on a saved file's inputs
and checks them against its outputs: bit for bit for the K2 backward, K2x,
K7x, the K10 forward, K10x and the second derivatives' saved dL/dx and
dL/dg (their sums run in an order fixed by the inputs), and for the
float-atomic sums (the K7 backward's tables, the K10 backward's and K10²'s
grid gradients) each of the two within the float-summation bound of a
float64 sum of the same terms (``models/gridencoder.py
grid_encode_backward_error``, ``models/registry.py
sample_volume_grid_backward_error`` and
``sample_volume_grid_backward_x_backward_error``). Both print each call's
time. Run from another checkout's root (``cd parent && python
../scripts/torch_second_order_timing.py``) the script imports that
checkout's package and ``chip_smoke.py``, which is how parent and change
are timed and compared in one call. Prints the card's name and power limit
first and needs a CUDA device; the exit code is 1 where a kernel differs
from its plain version or from the saved outputs.
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


class _SwappedBuild:
    """``_build`` as a wrapper sees it, with the launcher ``symbol`` taken
    from another build of its source."""

    def __init__(self, symbol, fn):
        self._symbol, self._fn = symbol, fn

    def function(self, name, symbol, argtypes, restype=ctypes.c_int):
        if symbol == self._symbol:
            return self._fn
        return _build.function(name, symbol, argtypes, restype)

    def __getattr__(self, attr):
        return getattr(_build, attr)


# path -> (source, launcher, its argtypes, the kernel whose adds are cut, the adds' pattern in its body)
CUTS = {
    "ha": ("gridencoder", "grid_encode_backward_x_backward_launch", GE._K7XX_ARGS, None,
           r"if \(t != 0\.0f\) atomicAdd\(grads\.table\[l\][^;]*;|scatter_corners<C>\(grads\.table\[l\][^;]*;"),
    # every statement in K10²'s body (one a line) that calls a function on the grid gradient
    "ga": ("volume_grid", "volume_grid_backward_x_backward_launch", REG._K10XX_ARGS,
           r"\bvolume_grid_backward_x_backward_kernel\(\s*const",
           r"\b(?!if\b)[\w.]+(?:<[^<>();]*>)?\(ggrid\b[^\n]*;[ \t]*$"),
}


def _kernel_body(src, head):
    """(start, end) of the kernel whose definition ``head`` (a pattern)
    starts: to the closing brace at the start of a line."""
    start = re.search(head, src).start()
    return start, src.index("\n}\n", start) + 3


def _cut_atomics_build(name):
    """The second derivative's launcher of a copy of the path's source with
    its parameter-gradient adds cut out (K7x²: one thread's scalar atomicAdd
    per term, or the merged scatter of a tile's corners; K10²: every call
    that adds into the grid gradient)."""
    lib, symbol, argtypes, head, pattern = CUTS[name]
    src = (_build._CSRC / f"{lib}.cu").read_text()
    lo, hi = _kernel_body(src, head) if head else (0, len(src))
    body, n = re.subn(pattern, ";", src[lo:hi], flags=re.M)
    if n < 1 or (head is None and n != 1):
        raise RuntimeError(f"--cut-atomics: expected the parameter-gradient adds in {lib}.cu, found {n}")
    print(f"{name} --cut-atomics: {n} add(s) cut from {lib}.cu", flush=True)
    out = _build.BUILD_DIR / f"{lib}_cut_atomics"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{lib}.cu").write_text(src[:lo] + body + src[hi:])
    subprocess.run([_build._nvcc()] + _build._flags(lib) + ["-o", str(out / "lib.so"), str(out / f"{lib}.cu")],
                   check=True)
    fn = getattr(ctypes.CDLL(str(out / "lib.so")), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return _SwappedBuild(symbol, fn)


def _with_build(mod, build, call, args):
    saved = mod._build
    mod._build = build
    try:
        return call(*args)
    finally:
        mod._build = saved


def cut_atomics(name, mod, wrapper, args, full_ms):
    """The path's call with the cut kernel: dL/dx and dL/dg the whole
    kernel's bits, and its time beside the whole kernel's."""
    cut, call = _cut_atomics_build(name), getattr(mod, wrapper)
    whole = call(*args)
    run = lambda: _with_build(mod, cut, call, args)  # noqa: E731
    got = run()
    keep = slice(0, 2) if name == "ha" else slice(1, 3)  # (dL/dx, dL/dg) in each wrapper's outputs
    same = all(torch.equal(a, b) for a, b in zip(got[keep], whole[keep]) if b is not None)
    ms = CS.time_ms(run)
    print(f"{name} {wrapper} without its parameter-gradient adds: ms={ms:.6g} (whole kernel {full_ms:.6g}; the "
          f"adds' share {1 - ms / full_ms:.3f}); dL/dx and dL/dg the whole kernel's bits: {same}", flush=True)
    return same


def k10xx_runs(args):
    """What K10² gets from a call: the points gg reaches (A = gg q not
    zero), the grid rows their corners touch, and of consecutive live
    points (in point order, as a span's compact list holds them) the share
    in one cell and the mean run of live points in one cell."""
    gg, _, grid, x, g, R_, bound, _ = args
    qpre = REG._voxel_cell(x, R_, bound)[0]
    A = gg.float() * (REG._clip_grad(qpre, REG._clip_hi(R_)) * (R_ - 1) * 0.5 * REG._inv(bound))
    live = (A != 0).any(-1)
    n_live, n_gg = int(live.sum()), int((gg != 0).any(-1).sum())
    rows = CS._voxel_rows(x[live], R_, bound)
    touched = torch.unique(rows).numel()
    same = (rows[1:] == rows[:-1]).all(-1)
    runs = n_live - int(same.sum())
    span = torch.nonzero(live)[:, 0] // 256
    per_span = torch.unique(span[:, None] * R_**3 + rows).numel()
    return (f"{n_live} of {x.shape[0]} points live ({n_gg} with gg != 0), {touched} grid rows touched; of "
            f"consecutive live points {float(same.float().mean()) if n_live > 1 else 0.0:.4f} share a cell "
            f"({runs} runs, {n_live / max(runs, 1):.3f} live points a run: {8 * runs} row adds, "
            f"{8 * n_live} unmerged); {per_span} distinct rows summed over 256-point spans")


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


def _first(calls):
    return calls[0]


def _with_grid(calls):  # the K10 backward's call with the grid gradient (the loss's)
    return next(c for c in calls if c[0][5])


def _x_only(calls):  # K10x: dL/dx alone (the analytic normal's inner gradient)
    return next(c for c in calls if not c[0][5] and c[0][6])


def _present(ts):
    return [t for t in ts if t is not None]


def _k7_bwd_err(o, a):
    return [max(GE.grid_encode_backward_error(o, *a[:4]))], []


def _k10_bwd_err(o, a):  # (g, grid, x, R, bound, grid_grad, x_grad): the grid gradient first
    return [REG.sample_volume_grid_backward_error(o[0], a[0], a[2], a[3], a[4])], range(1, len(o))


def _k10xx_err(o, a):  # (gg_x, gg_grid, grid, x, g, R, bound, wants): the grid gradient first where asked
    if not a[7][0] or a[0] is None:
        return [], range(len(o))
    return [REG.sample_volume_grid_backward_x_backward_error(o[0], a[0], a[3], a[4], a[5], a[6])], range(1, len(o))


def _k10xx_all(a, kw):  # K10² at the step's arguments with all three outputs asked for
    return _present(REG._sample_volume_grid_backward_x_backward_cuda(*a[:7], (True, True, True)))


# saved kernel -> (path, the captured wrapper, which of its calls, how that call runs, the float-atomic
# outputs' errors against their float-summation bound and the outputs held bit for bit; None: all bit for bit)
SAVED = {
    "K2 backward": ("sa", "_sample_points_backward_cuda", _first,
                    lambda a, kw: [GS._sample_points_backward_cuda(*a, **kw)], None),
    "K2x (plane gradient and dL/dxyz)": ("sa", "_sample_points_backward_xyz_cuda", _first,
                                         lambda a, kw: list(GS._sample_points_backward_xyz_cuda(*a[:4],
                                                                                               planes_grad=True)),
                                         None),
    "K7 backward": ("ha", "_grid_encode_backward_cuda", _first,
                    lambda a, kw: list(GE._grid_encode_backward_cuda(*a, **kw)), _k7_bwd_err),
    "K7x": ("ha", "_grid_encode_backward_x_cuda", _first,
            lambda a, kw: [GE._grid_encode_backward_x_cuda(*a, **kw)], None),
    "K2x² (all three outputs)": ("sa", "_sample_points_backward_xyz_backward_cuda", _first,
                                 lambda a, kw: _present(GS._sample_points_backward_xyz_backward_cuda(*a, **kw)),
                                 None),
    "K7x² (dL/dx, dL/dg)": ("ha", "_grid_encode_backward_x_backward_cuda", _first,
                            lambda a, kw: _present(GE._grid_encode_backward_x_backward_cuda(*a, **kw)[:2]), None),
    "K10 forward": ("ga", "_sample_volume_grid_cuda", _first,
                    lambda a, kw: [REG._sample_volume_grid_cuda(*a, **kw)], None),
    "K10 backward (grid gradient)": ("ga", "_sample_volume_grid_backward_cuda", _with_grid,
                                     lambda a, kw: _present(REG._sample_volume_grid_backward_cuda(*a, **kw)),
                                     _k10_bwd_err),
    "K10x": ("ga", "_sample_volume_grid_backward_cuda", _x_only,
             lambda a, kw: _present(REG._sample_volume_grid_backward_cuda(*a, **kw)), None),
    "K10² (the step's outputs)": ("ga", "_sample_volume_grid_backward_x_backward_cuda", _first,
                                  lambda a, kw: _present(REG._sample_volume_grid_backward_x_backward_cuda(*a, **kw)),
                                  _k10xx_err),
    "K10² (all three outputs)": ("ga", "_sample_volume_grid_backward_x_backward_cuda", _first, _k10xx_all,
                                 lambda o, a: _k10xx_err(o, list(a[:7]) + [(True, True, True)])),
}


def save_outputs(captured, path):
    out = {}
    for kernel, (name, wrapper, pick, run, _) in SAVED.items():
        if name not in captured:
            continue
        a, kw = pick(captured[name][wrapper])
        out[kernel] = (_cpu_args(a), kw, [t.cpu() for t in run(a, kw)])
        print(f"save {kernel}: ms={CS.time_ms(lambda: run(a, kw)):.6g}", flush=True)
    torch.save(out, path)
    print(f"saved {sorted(out)} to {path}", flush=True)


def compare_outputs(path) -> bool:
    saved = torch.load(path, weights_only=False)
    ok = True
    for kernel, (a, kw, ref) in saved.items():
        a, run, err = _cuda_args(a), SAVED[kernel][3], SAVED[kernel][4]
        got = run(a, kw)
        print(f"compare {kernel}: ms={CS.time_ms(lambda: run(a, kw)):.6g} on the saved inputs", flush=True)
        ref = [t.cuda() for t in ref]
        exact = range(len(got))
        if err is not None:
            (e_got, exact), (e_ref, _) = err(got, a), err(ref, a)
            within = all(e <= 1.0 for e in e_got + e_ref)
            if e_got:
                print(f"compare {kernel}: this checkout {max(e_got):.3g}, saved {max(e_ref):.3g} of the "
                      f"float-summation bound (within: {within})", flush=True)
            ok = ok and within
        same = len(got) == len(ref) and all(torch.equal(got[i], ref[i]) for i in exact)
        if len(exact):
            print(f"compare {kernel}: bit for bit the saved outputs {list(exact)}: {same}", flush=True)
        ok = ok and same
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--cut-atomics", action="store_true",
                    help="also time K7x² (ha) and K10² (ga) built without their parameter-gradient adds")
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
            if name == "ga":
                print(f"ga K10²: {k10xx_runs(a)}", flush=True)
            if name in CUTS and args.cut_atomics:
                ok = cut_atomics(name, mod, wrapper, a, r["ms"]) and ok
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
        K2T.sass_summary("volume_grid", occupancy=True)
    if not ok:
        print("a kernel differs from its plain version or from the saved outputs", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
