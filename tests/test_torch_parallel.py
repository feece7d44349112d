"""Multi-process training and evaluation (``parallel/``): the port's gloo
process grids against the JAX package's 8-device virtual mesh and against
one process (CPU).

Setup: ``tests/test_parallel.py``'s configuration (8 channels, 64^2 planes,
a 32^3 grid, 512 rays a step, budget 16) on both layouts (per-ray, and the
global layout at 8 slots a ray), with numpy-made params (small non-zero
detail levels, so that the channel-split regulariser moves) and a density
refresh with injected jitter. The batches' view and pixel indices and the
ray noise are made with numpy and handed to both packages
(``jax.random.randint`` / ``uniform`` patched inside the jitted JAX step).
The port's ranks run in spawned processes (``tests/torch_parallel_ranks.py``,
one torch thread each): one 4-rank group holds a (D = 2, M = 2) grid and a
(D = 4, M = 1) grid, and a 3-rank group the view split.

On the global layout the port's grids are held to the JAX (D = 4, M = 1)
mesh, which gives its single device's losses: the JAX package's (D = 2,
M = 2) mesh departs from its own single device there (0.7% at step 1 on
this configuration, whose 8-slot buffer fills; NaN at 16 slots), where the
port's (D = 2, M = 2) grid matches one device.

Tolerances: the 3-step losses within ``test_parallel.py``'s rtol 2e-3 of
the JAX mesh's (the same step up to the order of float sums); the params
after step 1 within the port's single-device bounds
(``test_torch_train.py``: 1e-5, except at most 0.01% of a group's entries by
up to 2 lr); the retune's configuration equal to one process's and its
statistics within 1e-6 relative; the error map and evaluate's table within
1e-6 (PSNR 1e-4); checkpoints bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as RK
from tests.test_parallel import _configs
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)
from trinerflet_tpu.data.synthetic import make_synthetic_scene as j_scene
from trinerflet_tpu.parallel import multihost as JMH
from trinerflet_tpu.parallel.sharding import make_mesh as j_make_mesh, param_shardings as j_shardings
from trinerflet_tpu.parallel.sharding import state_shardings as j_state_shardings
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu.train import trainer as JTR
from trinerflet_tpu_torch.carry import train_state_from_jax
from trinerflet_tpu_torch.parallel import launch, multihost as PMH
from trinerflet_tpu_torch.parallel.sharding import (MODEL_AXIS, REPLICATED, SHARDED, Mesh,
                                                    param_shardings, state_shardings)
from trinerflet_tpu_torch.train import trainer as PTR

LR = 1e-2
STEPS = 3


def _draws(seed, n=RK.N_RAYS, V=4, HW=48 * 48):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, n).astype(np.int32), rng.integers(0, HW, n).astype(np.int32),
            rng.random(n).astype(np.float32))


def _numpy_state(js):
    """A JAX TrainState as plain numpy trees (the ranks import no JAX)."""
    tree = lambda t: jax.tree.map(lambda a: np.asarray(a).copy(), t)  # noqa: E731
    adam = js.opt_state[0]
    occ = {k: np.asarray(getattr(js.occ, k)).copy()
           for k in ("density_grid", "occ", "occ_coarse", "mean_density", "iter_density", "bbox")}
    return {"params": tree(js.params), "ema_params": tree(js.ema_params),
            "opt_state": [{"count": np.asarray(adam.count), "mu": tree(adam.mu), "nu": tree(adam.nu)}],
            "ema_count": np.asarray(js.ema_count), "occ": occ, "step": np.asarray(js.step)}


@pytest.fixture(scope="module")
def setup():
    """The JAX single-device state after one full refresh (injected
    jitter), with numpy-made params, and the JAX scene's device arrays."""
    nerf_cfg, render_cfg, train_cfg = _configs()
    jtr = JTR.Trainer(nerf_cfg, render_cfg, train_cfg)
    rng = np.random.default_rng(0)
    tri = nerf_cfg.triplane
    b = tri.base_resolution

    def mlp(dims):
        return {f"w{i}": (rng.uniform(-1, 1, (dims[i], dims[i + 1])) / np.sqrt(dims[i])).astype(np.float32)
                for i in range(len(dims) - 1)}

    params = {"encoder": {"base": (0.5 * rng.standard_normal((3, 8, b, b))).astype(np.float32),
                          "wavelets": {f"level_{i}": (0.01 * rng.standard_normal((3, 8, 3, s, s))).astype(np.float32)
                                       for i, s in enumerate(tri.yh_sizes)}},
              "sigma_net": mlp([tri.feature_dim, 32, 16]), "color_net": mlp([16 + 15, 32, 32, 3])}
    jparams = jax.tree.map(jnp.asarray, params)
    js = jtr.init_state()._replace(params=jparams, opt_state=jtr.optimizer.init(jparams),
                                   ema_params=jax.tree.map(jnp.copy, jparams))
    H, C = render_cfg.grid_size, jtr.render_cfg.cascades
    jitter = [rng.uniform(-1, 1, (H**3, 3)).astype(np.float32) * np.float32(min(2**c, 1.0) / H)
              for c in range(C)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(jitter.pop(0)))
        js = jax.jit(lambda st: jtr._update_grid_impl(st, full=True))(js)
    scene = j_scene(num_views=4, H=48, W=48, num_steps=96)
    np.testing.assert_array_equal(RK.scene().images, scene.images)
    return js, jtr.scene_to_device(scene)


def _jax_mesh_run(js, jdata, mesh, layout, draws):
    """The JAX package's Trainer on ``mesh``: the jitted step with the
    batch's draws as arguments (as test_torch_variants_train.py runs it)."""
    import dataclasses

    nerf_cfg, render_cfg, train_cfg = _configs()
    if layout == "global":
        render_cfg = dataclasses.replace(render_cfg, **RK.GLOBAL)
    par = JTR.Trainer(nerf_cfg, render_cfg, train_cfg, mesh=mesh)
    state = jax.device_put(js, j_state_shardings(mesh, js))

    def step(state, data, img, pix, noise):
        ints, floats = [img, pix], [noise]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "randint",
                       lambda key, shape, minval, maxval, dtype=jnp.int32: ints.pop(0).astype(dtype))
            mp.setattr(jax.random, "uniform",
                       lambda key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0:
                       floats.pop(0).astype(dtype))
            return par._train_step_impl(state, data, with_stats=False)

    jstep = jax.jit(step)
    losses, first = [], None
    for d in draws:
        state, aux = jstep(state, jdata, *(jnp.asarray(a) for a in d))
        losses.append(float(aux["loss"]))
        if first is None:
            first = RK.leaves(jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), state.params))
    return losses, first


@pytest.fixture(scope="module")
def grid(setup, tmp_path_factory):
    """One 4-rank gloo group's results (rank 0's and every rank's), and one
    process's references on the same draws."""
    js, _ = setup
    state0 = _numpy_state(js)
    root = str(tmp_path_factory.mktemp("grid"))
    draws = [_draws(10 + s) for s in range(STEPS)]
    rng = np.random.default_rng(30)
    n = RK.N_RAYS
    emap_draws = (rng.integers(0, 4, n).astype(np.int32), rng.random(n).astype(np.float32),
                  rng.random(n).astype(np.float32), rng.random(n).astype(np.float32),
                  rng.random(n).astype(np.float32))
    # a one-process checkpoint for the grid to load
    one = PTR.Trainer(*RK.configs(), device="cpu")
    st = train_state_from_jax(state0, device="cpu")
    st, _ = one.train_step(st, one.scene_to_device(RK.scene()), with_stats=False,
                           batch=RK.batch(_draws(40)))
    one.save_checkpoint(st, os.path.join(root, "one.pkl"))
    results = launch.run_on_mesh(RK.grid_battery, 4, 2, "cpu", "gloo", threads=1, timeout=600,
                                 args=(state0, draws, _draws(20), emap_draws, root))
    return {"state0": state0, "draws": draws, "emap_draws": emap_draws, "root": root,
            "ranks": results, "one_ckpt": st}


def _params_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        d = np.abs(got[k] - want[k])
        assert (d > 1e-5).mean() <= 1e-4 and d.max() <= 2 * LR, (k, (d > 1e-5).sum(), d.max())


_JAX_RUNS = {}


def _jax_run(setup, grid, M, layout):
    if (M, layout) not in _JAX_RUNS:
        js, jdata = setup
        mesh = j_make_mesh(jax.devices()[:4], model_parallel=M)
        _JAX_RUNS[M, layout] = _jax_mesh_run(js, jdata, mesh, layout, grid["draws"])
    return _JAX_RUNS[M, layout]


@pytest.mark.parametrize("layout", ["per_ray", "global"])
@pytest.mark.parametrize("shape", ["d2m2", "d4m1"])
def test_grid_steps_match_the_jax_mesh(setup, grid, shape, layout):
    M = 2 if shape == "d2m2" and layout == "per_ray" else 1
    losses_j, first_j = _jax_run(setup, grid, M, layout)
    for r in grid["ranks"]:  # every rank reports the same global loss and params
        got = r[f"{shape}_{layout}"]
        np.testing.assert_allclose(got["losses"], losses_j, rtol=2e-3, atol=1e-5)
        _params_close(got["first"], first_j)
        for k, v in grid["ranks"][0][f"{shape}_{layout}"]["last"].items():
            np.testing.assert_array_equal(got["last"][k], v)
    assert grid["ranks"][0]["shape"] == {"data": 2, "model": 2}
    assert grid["ranks"][0]["d4_shape"] == {"data": 4, "model": 1}


def test_param_and_state_shardings_match_jax(setup):
    js, _ = setup
    mesh = Mesh(data=4, model=2, rank=0, data_group=None, model_group=None, backend="gloo",
                device=torch.device("cpu"))
    state = train_state_from_jax(_numpy_state(js), device="cpu")
    specs = param_shardings(mesh, state.params)
    jmesh = j_make_mesh(model_parallel=2)
    jspecs = j_shardings(jmesh, js.params)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
        return out

    want = {k: (SHARDED if tuple(s.spec) == (None, "model") else REPLICATED)
            for k, s in flat(jspecs).items()}
    assert flat(specs) == want
    assert specs["encoder"]["base"] == (None, MODEL_AXIS) and specs["sigma_net"]["w0"] == ()
    ss = state_shardings(mesh, state)
    assert flat(ss.opt_state["mu"]) == want and flat(ss.ema_params) == want
    assert ss.occ == ss.step == ss.rng == REPLICATED


def test_retune_on_the_grid_picks_one_process_budget_and_slots(grid):
    tr = PTR.Trainer(*RK.configs("per_ray", RK.RETUNE_BUDGET, budget_autotune=True), device="cpu")
    st = train_state_from_jax(grid["state0"], device="cpu")
    st = st._replace(occ=st.occ._replace(iter_density=torch.tensor(6, dtype=torch.int32)))
    st, aux = tr.train_step(st, tr.scene_to_device(RK.scene()), with_stats=True,
                            batch=RK.batch(_draws(20)))
    tr._maybe_retune_march(st, aux)
    rc = tr.render_cfg
    want = (rc.samples_per_ray_budget, rc.compaction, rc.global_slots_per_ray, rc.num_coarse_override)
    assert want[:3] != (RK.RETUNE_BUDGET, "per_ray", 0), "the tuner must move on this path"
    for key in ("retune", "d4_retune"):
        for r in grid["ranks"]:
            assert r[key]["cfg"] == want, (key, r[key]["cfg"], want)
            for k in ("num_samples", "samples_p99", "span_p99", "needed_seg_p99", "overflow_frac",
                      "samples_mean", "trunc_T", "span_trunc_T"):
                np.testing.assert_allclose(r[key]["aux"][k], float(aux[k]), rtol=1e-6, atol=1e-7,
                                           err_msg=k)


def test_error_map_step_on_the_grid_matches_one_process(grid):
    tr = PTR.Trainer(*RK.configs("per_ray", error_map=True), device="cpu")
    st = train_state_from_jax(grid["state0"], device="cpu")
    emap = torch.from_numpy(np.random.default_rng(9).random((4, 48 * 48)).astype(np.float32) + 0.1)
    st = st._replace(error_map=emap)
    img, u, jx, jy, noise = (torch.from_numpy(a) for a in grid["emap_draws"])
    st, aux = tr.train_step(st, tr.scene_to_device(RK.scene()), with_stats=False,
                            batch={"img_idx": img, "u": u, "jx": jx, "jy": jy, "noise": noise})
    changed = (st.error_map != emap).sum().item()
    assert changed > 100
    for r in grid["ranks"]:
        np.testing.assert_allclose(r["error_map"]["map"], st.error_map.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["error_map"]["loss"], float(aux["loss"]), rtol=1e-5)


def test_checkpoint_round_trip_between_the_grid_and_one_process(grid):
    from trinerflet_tpu_torch.train import checkpoint

    saved = checkpoint.load(os.path.join(grid["root"], "grid.pkl"))
    first = grid["ranks"][0]["d2m2_per_ray"]["first"]
    flat = RK.leaves(jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), saved["params"]))
    assert flat.keys() == first.keys()
    for k in first:  # the file holds the full-width params, as one process writes them
        np.testing.assert_array_equal(flat[k], first[k])
    tr = PTR.Trainer(*RK.configs(), device="cpu")
    loaded = tr.load_checkpoint(os.path.join(grid["root"], "grid.pkl"))
    assert loaded.step == 1 and loaded.opt_state["count"] == 1
    one = RK.leaves(grid["one_ckpt"].params)
    one_mu = RK.leaves(grid["one_ckpt"].opt_state["mu"])
    for r in grid["ranks"]:  # the grid loading one process's file keeps its slice
        m = r["checkpoint"]["index"]
        for k, v in one.items():
            want = v[:, 4 * m:4 * (m + 1)] if k.startswith("encoder.") else v
            np.testing.assert_array_equal(r["checkpoint"]["shard"][k], want)
            mu = one_mu[k][:, 4 * m:4 * (m + 1)] if k.startswith("encoder.") else one_mu[k]
            np.testing.assert_array_equal(r["checkpoint"]["mu_shard"][k], mu)


def test_evaluate_on_the_grid_matches_one_process(grid):
    tr = PTR.Trainer(*RK.configs(), device="cpu")
    st = train_state_from_jax(grid["state0"], device="cpu")
    from trinerflet_tpu_torch.data import synthetic as PS

    want = tr.evaluate(st, PS.make_synthetic_scene(num_views=3, H=24, W=24, num_steps=32))
    for r in grid["ranks"]:
        got = r["evaluate"]
        assert [p["view"] for p in got["per_image"]] == [0, 1, 2]
        for a, b in zip(got["per_image"], want["per_image"]):
            assert abs(a["PSNR"] - b["PSNR"]) <= 1e-4 and abs(a["SSIM"] - b["SSIM"]) <= 1e-6
    root = grid["root"]
    assert os.path.exists(os.path.join(root, "ws", "results.json"))
    pngs = sorted(os.listdir(os.path.join(root, "png")))
    assert pngs == [f"results_{v:03d}{s}.png" for v in range(3) for s in ("", "_depth")]


def test_view_split_and_row_gather_on_one_process_match_jax():
    assert PMH.is_primary() == JMH.is_primary()
    for n in (1, 5, 8):
        assert PMH.process_view_slice(n) == JMH.process_view_slice(n)
    rows = np.asarray([[2, 30.0, 0.9], [0, 28.0, 0.8], [1, 29.0, 0.85]], np.float32)
    np.testing.assert_array_equal(PMH.allgather_rows(rows, 3), JMH.allgather_rows(rows, 3))


def test_view_split_and_row_gather_on_three_processes():
    """Round-robin views and the documented table: every process's rows,
    NaN padding dropped, sorted by view id; the same on a mesh's data axis."""
    res = launch.run_on_mesh(RK.multihost_rows, 3, 1, "cpu", "gloo", threads=1, timeout=300,
                             args=(7,))
    table = np.asarray([[v, 20.0 + v, 0.5 + 0.01 * v] for v in range(7)], np.float32)
    for r, out in enumerate(res):
        assert out["views"] == out["mesh_views"] == list(range(r, 7, 3))
        np.testing.assert_array_equal(out["table"], table)
        np.testing.assert_array_equal(out["mesh_table"], table)
        assert out["primary"] == out["mesh_primary"] == (r == 0)


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 of the 2-rank grid failed"):
        launch.run_on_mesh(RK.fail_on_rank_1, 2, 1, "cpu", "gloo", threads=1, timeout=120)


def test_mesh_checks_on_the_trainer():
    mesh = Mesh(data=3, model=1, rank=0, data_group=None, model_group=None, backend="gloo",
                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not split into 3 data shards"):
        PTR.Trainer(*RK.configs(), device="cpu", mesh=mesh)
    mesh = Mesh(data=1, model=3, rank=0, data_group=None, model_group=None, backend="gloo",
                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="C % M must be 0"):
        PTR.Trainer(*RK.configs(), device="cpu", mesh=mesh)
    from trinerflet_tpu_torch.parallel.sharding import check_channels

    with pytest.raises(ValueError, match="no K2 instantiation"):
        check_channels(16, 8, "cuda")  # a 2-channel shard
    check_channels(16, 2, "cuda")
