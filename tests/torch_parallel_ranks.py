"""The ranks' side of ``tests/test_torch_parallel.py``: functions that
``parallel.launch.run_on_mesh`` runs in each spawned process. This module
imports no JAX, so the ranks start without it; the test module compares
their results with the JAX package and with one process."""

import os

import numpy as np
import torch

from trinerflet_tpu_torch.carry import train_state_from_jax
from trinerflet_tpu_torch.data import synthetic as PS
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.models import triplane as PT
from trinerflet_tpu_torch.parallel import (gather_params, make_mesh, multihost, process_view_slice,
                                           allgather_rows, is_primary)
from trinerflet_tpu_torch.render import renderer as PR
from trinerflet_tpu_torch.train import trainer as PTR

DIMS = dict(channels=8, resolution=64, wavelet_scale=4)
NERF = dict(bound=1.0, hidden_dim=32, hidden_dim_color=32)
RKW = dict(bound=1.0, grid_size=32, density_thresh=1.0, max_steps=128, samples_per_ray_budget=16)
GLOBAL = dict(compaction="global", global_slots_per_ray=8)
N_RAYS = 512


def configs(layout="per_ray", budget=16, **train):
    nerf = PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS), **NERF)
    render = PR.RenderConfig(**dict(RKW, samples_per_ray_budget=budget),
                             **(GLOBAL if layout == "global" else {}))
    cfg = PTR.TrainConfig(**dict(dict(lr=1e-2, iters=50, num_rays=N_RAYS, renderer="occgrid"), **train))
    return nerf, render, cfg


def scene():
    return PS.make_synthetic_scene(num_views=4, H=48, W=48, num_steps=96)


def batch(draws):
    img, pix, noise = draws
    return {"img_idx": torch.from_numpy(img), "pix_idx": torch.from_numpy(pix),
            "noise": torch.from_numpy(noise)}


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().cpu().numpy().copy()
    return out


def steps(mesh, state0, draws, layout, **train):
    """Steps on injected draws from a carried JAX state: the losses, the
    full-width params after the first step and after the last."""
    tr = PTR.Trainer(*configs(layout, **train), device="cpu", mesh=mesh)
    state = train_state_from_jax(state0, device="cpu", mesh=mesh)
    data = tr.scene_to_device(scene())
    losses, first = [], None
    for d in draws:
        state, aux = tr.train_step(state, data, with_stats=False, batch=batch(d))
        losses.append(float(aux["loss"]))
        if first is None:
            first = leaves(gather_params(mesh, state.params))
    return {"losses": losses, "first": first, "last": leaves(gather_params(mesh, state.params))}


RETUNE_BUDGET = 64  # a configured budget well above the live demand: the tuner cuts it


def retune(mesh, state0, draws):
    """One with-stats step on the per-ray layout at iter_density 6, then the
    retune: the configuration it picks, and the aux it read."""
    tr = PTR.Trainer(*configs("per_ray", RETUNE_BUDGET, budget_autotune=True), device="cpu",
                     mesh=mesh)
    state = train_state_from_jax(state0, device="cpu", mesh=mesh)
    state = state._replace(occ=state.occ._replace(iter_density=torch.tensor(6, dtype=torch.int32)))
    state, aux = tr.train_step(state, tr.scene_to_device(scene()), with_stats=True, batch=batch(draws))
    tr._maybe_retune_march(state, aux)
    rc = tr.render_cfg
    return {"cfg": (rc.samples_per_ray_budget, rc.compaction, rc.global_slots_per_ray,
                    rc.num_coarse_override),
            "aux": {k: float(v) for k, v in aux.items() if v.ndim == 0}}


def error_map_step(mesh, state0, draws):
    """One error-map step (injected view, cell and jitter draws and noise):
    the loss and the map every rank holds after it."""
    tr = PTR.Trainer(*configs("per_ray", error_map=True), device="cpu", mesh=mesh)
    sc = scene()
    state = train_state_from_jax(state0, device="cpu", mesh=mesh)
    emap = torch.from_numpy(np.random.default_rng(9).random((4, 48 * 48)).astype(np.float32) + 0.1)
    state = state._replace(error_map=emap)
    img, u, jx, jy, noise = (torch.from_numpy(a) for a in draws)
    state, aux = tr.train_step(state, tr.scene_to_device(sc), with_stats=False,
                               batch={"img_idx": img, "u": u, "jx": jx, "jy": jy, "noise": noise})
    return {"loss": float(aux["loss"]), "map": state.error_map.numpy().copy()}


def checkpoint_round_trip(mesh, state0, draws, root):
    """A step on the grid, its checkpoint (written by the primary rank),
    and the grid loading a one-process checkpoint: this rank's params after
    the load."""
    tr = PTR.Trainer(*configs(), device="cpu", mesh=mesh)
    state = train_state_from_jax(state0, device="cpu", mesh=mesh)
    data = tr.scene_to_device(scene())
    state, _ = tr.train_step(state, data, with_stats=False, batch=batch(draws))
    tr.save_checkpoint(state, os.path.join(root, "grid.pkl"))
    loaded = tr.load_checkpoint(os.path.join(root, "one.pkl"))
    return {"shard": leaves(loaded.params), "ema_shard": leaves(loaded.ema_params),
            "mu_shard": leaves(loaded.opt_state["mu"]), "index": mesh.model_index}


def grid_battery(mesh, state0, draws, retune_draws, emap_draws, root):
    """Everything the 4-rank tests need, on this (D = 2, M = 2) grid and on
    a (D = 4, M = 1) grid made from the same group."""
    out = {"shape": mesh.shape}
    for layout in ("per_ray", "global"):
        out[f"d2m2_{layout}"] = steps(mesh, state0, draws, layout)
    out["retune"] = retune(mesh, state0, retune_draws)
    out["error_map"] = error_map_step(mesh, state0, emap_draws)
    out["checkpoint"] = checkpoint_round_trip(mesh, state0, draws[0], root)
    out["evaluate"] = evaluate_grid(mesh, state0, root)
    d4 = make_mesh(1)
    out["d4_shape"] = d4.shape
    for layout in ("per_ray", "global"):
        out[f"d4m1_{layout}"] = steps(d4, state0, draws, layout)
    out["d4_retune"] = retune(d4, state0, retune_draws)
    out["collectives"] = dict(mesh.counts)
    return out


def multihost_rows(mesh, num_views):
    """The view split and the gathered metric table on the default group
    (no mesh) and on the mesh's data axis."""
    views = process_view_slice(num_views)
    rows = np.asarray([[v, 20.0 + v, 0.5 + 0.01 * v] for v in views], np.float32).reshape(-1, 3)
    return {"views": views, "mesh_views": process_view_slice(num_views, mesh),
            "table": allgather_rows(rows, num_views),
            "mesh_table": allgather_rows(rows, num_views, mesh),
            "primary": is_primary(), "mesh_primary": multihost.is_primary(mesh)}


def evaluate_grid(mesh, state0, root):
    """``evaluate`` on the grid (views split over the data index), with a
    workspace and PNGs."""
    tr = PTR.Trainer(*configs(), device="cpu", mesh=mesh, workspace=os.path.join(root, "ws"))
    state = train_state_from_jax(state0, device="cpu", mesh=mesh)
    sc = PS.make_synthetic_scene(num_views=3, H=24, W=24, num_steps=32)
    return tr.evaluate(state, sc, save_dir=os.path.join(root, "png"))


def fail_on_rank_1(mesh):
    """Rank 1 raises; rank 0 returns."""
    if mesh.rank == 1:
        raise ValueError("rank 1 gives up")
    return mesh.rank
