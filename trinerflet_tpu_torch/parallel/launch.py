"""Start a (data, model) process grid and run the multi-process dry run
(the counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``
and ``_trajectory_equivalence``).

    python -m trinerflet_tpu_torch.parallel.launch --nproc 4 --model_parallel 2 \\
        --device cpu --backend gloo

``run_on_mesh(fn, nproc, model_parallel, device, backend)`` starts ``nproc``
processes with ``torch.multiprocessing`` (spawn), forms the default group
through a file store in a temporary directory (no TCP port to collide on),
lays it out with ``make_mesh`` and returns every rank's ``fn(mesh, *args)``
in rank order. A rank that raises makes the call raise with that rank's
traceback; a group that does not form, or a run that outlasts ``timeout``,
raises too (the ranks are killed). Under ``torchrun`` call
``torch.distributed.init_process_group`` and ``make_mesh`` yourself.

The dry run trains the JAX dry run's configuration: one step on the per-ray
layout and one on the global layout (``global_slots_per_ray=8``); a K2
backward on each rank's data shard, summed over the data group in float32,
against the backward of all points; and the 50-step loss trajectory of both
layouts against one process on the same draws, whose tail (steps 10-49) must
stay within 1e-3 relative, the JAX package's bound.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import shutil
import sys
import tempfile
import time
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .sharding import DATA_AXIS, make_mesh

__all__ = ["run_on_mesh", "trajectory", "dryrun_configs", "dryrun", "main"]

TRAJ_TOL = 1e-3  # the JAX dry run's bound on the tail's relative loss gap


def _rank_main(rank: int, nproc: int, model_parallel: int, device: str, backend: str, tmp: str,
               fn: Callable, args: Sequence, threads: Optional[int], group_timeout: float) -> None:
    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), nproc)
    dist.init_process_group(backend, store=store, rank=rank, world_size=nproc,
                            timeout=timedelta(seconds=group_timeout))
    try:
        mesh = make_mesh(model_parallel, device=dev)
        out = fn(mesh, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_on_mesh(fn: Callable, nproc: int, model_parallel: int = 1, device: str = "cpu",
                backend: Optional[str] = None, args: Sequence = (), timeout: float = 900.0,
                threads: Optional[int] = None, group_timeout: float = 120.0) -> List[Any]:
    """Every rank's ``fn(mesh, *args)`` (picklable, e.g. a module-level
    function) on an ``nproc``-process grid with ``model_parallel`` ranks on
    the model axis, in rank order. ``backend`` defaults to nccl on cuda and
    gloo on the CPU; ranks take cuda devices round-robin. ``threads`` sets
    each rank's torch threads. A group that has not formed within
    ``group_timeout`` seconds raises in its ranks."""
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    tmp = tempfile.mkdtemp(prefix="trinerflet_grid_")
    ctx = mp.start_processes(_rank_main, nprocs=nproc, join=False, start_method="spawn",
                             args=(nproc, model_parallel, device, backend, tmp, fn, tuple(args),
                                   threads, group_timeout))
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {nproc}-rank grid did not finish within {timeout:.0f} s")
        out = []
        for r in range(nproc):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    except mp.ProcessRaisedException as e:
        raise RuntimeError(f"rank {e.error_index} of the {nproc}-rank grid failed:\n{e}") from None
    except mp.ProcessExitedException as e:
        raise RuntimeError(f"rank {e.error_index} of the {nproc}-rank grid exited with code "
                           f"{e.exit_code}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------------ dry run


def dryrun_configs(resolution: int = 64, num_rays: int = 512, compaction: str = "per_ray",
                   iters: int = 10):
    """The JAX dry run's configuration: 8 channels, bound 1, 32-wide MLPs,
    a 32^3 grid, budget 16; the global layout at 8 slots per ray."""
    from ..models.nerf import NeRFConfig
    from ..models.triplane import TriplaneConfig
    from ..render.renderer import RenderConfig
    from ..train.trainer import TrainConfig

    nerf_cfg = NeRFConfig(triplane=TriplaneConfig(channels=8, resolution=resolution, wavelet_scale=4),
                          bound=1.0, hidden_dim=32, hidden_dim_color=32)
    render_cfg = RenderConfig(bound=1.0, grid_size=32, density_thresh=0.5, max_steps=128,
                              samples_per_ray_budget=16)
    if compaction == "global":
        render_cfg = dataclasses.replace(render_cfg, compaction="global", global_slots_per_ray=8)
    train_cfg = TrainConfig(lr=1e-2, iters=iters, num_rays=num_rays, renderer="occgrid",
                            update_extra_interval=16)
    return nerf_cfg, render_cfg, train_cfg


def trajectory(trainer, state, data, iters: int):
    """``iters`` steps on the JAX dry run's cadence (a density refresh every
    ``update_extra_interval`` steps, full while iter_density < 16). Returns
    (state, losses, seconds, the last step's aux)."""
    losses, aux = [], None
    t0 = time.perf_counter()
    for it in range(iters):
        if it % trainer.cfg.update_extra_interval == 0:
            occ = trainer.update_grid(state.params, state.occ, generator=state.rng,
                                      full=int(state.occ.iter_density) < 16)
            state = state._replace(occ=occ)
        state, aux = trainer.train_step(state, data)
        losses.append(float(aux["loss"]))
    return state, np.asarray(losses), time.perf_counter() - t0, aux


def _scene():
    from ..data.synthetic import make_synthetic_scene

    return make_synthetic_scene(num_views=2, H=32, W=32, num_steps=48)


def _dryrun_rank(mesh, device: str, iters: int):
    """One rank of the dry run (see the module docstring)."""
    from .. import kernels
    from ..ops.grid_sample import sample_points_backward_plain, sample_points_reduced
    from ..train.trainer import Trainer

    dev = mesh.device if torch.device(device).type == "cuda" else torch.device("cpu")
    scene = _scene()
    out = {"rank": mesh.rank, "shape": mesh.shape, "staged": mesh.staged}
    kernels.reset_launches()
    for name in ("per_ray", "global"):
        cfgs = dryrun_configs(64, 64 * mesh.data * mesh.model, name)
        tr = Trainer(*cfgs, device=dev, mesh=mesh)
        state = tr.init_state()
        state = state._replace(occ=tr.update_grid(state.params, state.occ, generator=state.rng))
        state, aux = tr.train_step(state, tr.scene_to_device(scene))
        out[f"loss_{name}"] = float(aux["loss"])
    # the K2 backward of each data shard, summed in float32 over the group
    g = torch.Generator().manual_seed(5)
    n = 4096
    xyz = (2.0 * torch.rand((n, 3), generator=g) - 1.0).to(dev)
    ct = torch.randn((n, 3, 8), generator=g).to(dev)
    planes = torch.randn((3, 64, 64, 8), generator=g).to(dev).requires_grad_(True)
    rows = slice(mesh.data_index * n // mesh.data, (mesh.data_index + 1) * n // mesh.data)
    feats = sample_points_reduced(planes, xyz[rows], 1.0, lambda t: mesh.all_reduce(t, DATA_AXIS))
    got, = torch.autograd.grad(feats, planes, ct[rows])
    ref = sample_points_backward_plain(ct.cpu(), xyz.cpu(), 1.0, (3, 64, 64, 8), torch.float32)
    out["k2_bwd_rel_err"] = float((got.cpu() - ref).norm() / ref.norm())
    for name in ("per_ray", "global"):
        cfgs = dryrun_configs(128, 2048, name, iters)
        tr = Trainer(*cfgs, device=dev, mesh=mesh)
        _, losses, secs, _ = trajectory(tr, tr.init_state(), tr.scene_to_device(scene), iters)
        out[f"traj_{name}"] = losses
        out[f"ms_per_step_{name}"] = 1e3 * secs / iters
    out["launches"] = dict(kernels.launches)
    out["collectives"] = dict(mesh.counts)
    return out


def reference_trajectory(name: str, device: str, iters: int) -> np.ndarray:
    """The one-process trajectory of the dry run's layout ``name``."""
    from ..train.trainer import Trainer

    tr = Trainer(*dryrun_configs(128, 2048, name, iters), device=device)
    return trajectory(tr, tr.init_state(), tr.scene_to_device(_scene()), iters)[1]


def tail_gap(mesh_losses: np.ndarray, one_losses: np.ndarray, start: int = 10) -> float:
    """max |l_mesh - l_one| / |l_one| over the steps from ``start`` (the
    first steps sit near the random start, where a small absolute gap is a
    large relative one)."""
    rel = np.abs(mesh_losses - one_losses) / np.maximum(np.abs(one_losses), 1e-8)
    return float(rel[start:].max())


def dryrun(nproc: int, model_parallel: int, device: str = "cpu", backend: Optional[str] = None,
           iters: int = 50, threads: Optional[int] = None) -> dict:
    """The dry run on an ``nproc``-rank grid against one process: returns
    rank 0's results with the trajectory gaps; raises when a check fails."""
    results = run_on_mesh(_dryrun_rank, nproc, model_parallel, device, backend,
                          args=(device, iters), threads=threads)
    r0 = results[0]
    for r in results:
        for k in ("loss_per_ray", "loss_global"):
            if not np.isfinite(r[k]):
                raise AssertionError(f"rank {r['rank']}: {k} = {r[k]}")
        if r["k2_bwd_rel_err"] > 1e-5:
            raise AssertionError(f"rank {r['rank']}: the data group's K2 backward is "
                                 f"{r['k2_bwd_rel_err']:.2e} from one process's")
    for name in ("per_ray", "global"):
        one = reference_trajectory(name, device, iters)
        r0[f"gap_{name}"] = tail_gap(r0[f"traj_{name}"], one)
        if not r0[f"gap_{name}"] < TRAJ_TOL:
            raise AssertionError(f"{name}: the grid's loss trajectory is {r0[f'gap_{name}']:.2e} "
                                 f"from one process's (bound {TRAJ_TOL})")
    return r0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--model_parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--threads", type=int, default=None)
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("launch: --device cuda and torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    r = dryrun(a.nproc, a.model_parallel, a.device, a.backend, a.iters, a.threads)
    print(f"dryrun({a.nproc}): mesh={r['shape']} backend={a.backend or 'default'} "
          f"loss={r['loss_per_ray']:.5f} loss_global={r['loss_global']:.5f} "
          f"k2_bwd_relerr={r['k2_bwd_rel_err']:.2e} traj_relerr per_ray={r['gap_per_ray']:.2e} "
          f"global={r['gap_global']:.2e} collectives={r['collectives']} OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
