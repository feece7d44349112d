"""Checkpoints shared by both packages (``train/checkpoint.py``, the port's
``Trainer.save_checkpoint`` / ``load_checkpoint`` / ``load_model_for_stage``).

Setup: ``tests/test_torch_train.py``'s float32 BENCH_SMOKE shapes (a 64^2 x
16 triplane, a 32^3 x 2 grid, 512 rays) with numpy-made parameters, one
full refresh and two injected steps in JAX, so the Adam moments, the EMA
and the counts are non-trivial.

* JAX -> port: the JAX checkpoint loads in a subprocess in which importing
  ``jax``, ``optax``, ``ml_dtypes`` and the JAX package fails, and its next
  injected step equals JAX's (loss rtol 1e-4; parameters within 1e-5 but
  for at most 0.01% of a group's entries, as the trajectory test states).
* port -> JAX, with and without ``mlp_weight_decay`` (the chain with and
  without its masked weight decay): the port's checkpoint loads in JAX's
  ``load_checkpoint`` as real optax states and takes an optax step that
  equals the port's (the same tolerances).
* The rebuilt occ, occ_coarse and bbox equal JAX's; the stored arrays and
  counts come back bit for bit; ``load_model_for_stage`` carries every
  shared leaf over exactly.
"""

import json
import os
import pickle
import pickletools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu.train import trainer as JTR
from trinerflet_tpu_torch.carry import train_state_from_jax
from trinerflet_tpu_torch.data import synthetic as PS
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.models import triplane as PT
from trinerflet_tpu_torch.render import renderer as PR
from trinerflet_tpu_torch.train import checkpoint as CK
from trinerflet_tpu_torch.train import trainer as PTR

from .test_torch_train import (DIMS, N_RAYS, RKW, TKW, _batch, _Draws, _IntDraws, _leaves,
                               _port_batch, _scene, one_torch_thread)  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _configs(weight_decay):
    kw = dict(bound=1.5, compute_dtype="float32", plane_dtype="float32")
    tkw = dict(TKW, mlp_weight_decay=0.01 if weight_decay else -1.0)
    return ((JN.NeRFConfig(triplane=JT.TriplaneConfig(**DIMS), **kw), JR.RenderConfig(**RKW),
             JTR.TrainConfig(**tkw)),
            (PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS), **kw), PR.RenderConfig(**RKW),
             PTR.TrainConfig(**tkw)))


def _jax_step(jtr, jstate, jdata, draws):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", _IntDraws(draws[:2]))
        mp.setattr(jax.random, "uniform", _Draws(draws[2:]))
        return jtr._train_step_impl(jstate, jdata, with_stats=False)


_STATES = {}


def _jax_state(weight_decay):
    """The JAX trainer and its state after one full refresh and two steps."""
    if weight_decay in _STATES:
        return _STATES[weight_decay]
    jcfg, _ = _configs(weight_decay)
    jtr = JTR.Trainer(*jcfg)
    rng = np.random.default_rng(0)
    tri, b = jcfg[0].triplane, jcfg[0].triplane.base_resolution

    def mlp(dims):
        return {f"w{i}": rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(np.float32) / np.sqrt(dims[i])
                for i in range(len(dims) - 1)}

    params = {"encoder": {"base": (0.5 * rng.standard_normal((3, 16, b, b))).astype(np.float32),
                          "wavelets": {f"level_{i}": np.zeros((3, 16, 3, s, s), np.float32)
                                       for i, s in enumerate(tri.yh_sizes)}},
              "sigma_net": mlp([tri.feature_dim, 64, 16]), "color_net": mlp([16 + 15, 64, 64, 3])}
    scene = _scene()
    grid = JR.mark_untrained_grid(scene.poses, scene.intrinsics, jtr.render_cfg)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtr.init_state(density_grid=grid)._replace(
        params=jparams, opt_state=jtr.optimizer.init(jparams), ema_params=jax.tree.map(jnp.copy, jparams))
    H, C = RKW["grid_size"], jtr.render_cfg.cascades
    jitter = np.stack([rng.uniform(-1, 1, (H**3, 3)).astype(np.float32) * np.float32(min(2**c, 1.5) / H)
                       for c in range(C)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _Draws(jitter))
        jstate = jtr._update_grid_impl(jstate, full=True)
    jdata = jtr.scene_to_device(scene)
    for s in range(2):
        jstate, _ = _jax_step(jtr, jstate, jdata, _batch(20 + s, 2, 64 * 64))
    _STATES[weight_decay] = (jtr, jstate, jdata)
    return _STATES[weight_decay]


def _close_params(tree_p, tree_j):
    lp, lj = _leaves(tree_p), _leaves(jax.tree.map(np.asarray, tree_j))
    assert sorted(lp) == sorted(lj)
    for n in lj:
        d = np.abs(lp[n] - lj[n])
        assert (d > 1e-5).mean() <= 1e-4 and d.max() <= 2 * TKW["lr"], (n, (d > 1e-5).sum())


def _globals_named(path):
    """(module, name) of every global a pickle file names."""
    found = []

    class Log(pickle.Unpickler):
        def find_class(self, module, name):
            found.append((module, name))
            return super().find_class(module, name)

    with open(path, "rb") as f:
        Log(f).load()
    return found


_CHILD = r"""
import importlib.abc, json, sys
BLOCKED = ("jax", "jaxlib", "optax", "ml_dtypes", "trinerflet_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this process")
        return None
sys.meta_path.insert(0, Block())
for m in BLOCKED:
    try:
        importlib.import_module(m)
        sys.exit(f"{m} imported")
    except ImportError:
        pass
import numpy as np, torch
torch.set_num_threads(1)
from trinerflet_tpu_torch.data.synthetic import make_synthetic_scene
from trinerflet_tpu_torch.models.nerf import NeRFConfig
from trinerflet_tpu_torch.models.triplane import TriplaneConfig
from trinerflet_tpu_torch.render.renderer import RenderConfig
from trinerflet_tpu_torch.train.trainer import TrainConfig, Trainer, _leaves
a = json.loads(sys.argv[1])
tr = Trainer(NeRFConfig(triplane=TriplaneConfig(**a["dims"]), bound=1.5), RenderConfig(**a["rkw"]),
             TrainConfig(**a["tkw"]), device="cpu")
state = tr.load_checkpoint(a["ckpt"])
draws = np.load(a["draws"])
data = tr.scene_to_device(make_synthetic_scene(num_views=2, H=64, W=64, num_steps=32))
batch = {"img_idx": torch.from_numpy(draws["img"]), "pix_idx": torch.from_numpy(draws["pix"]),
         "noise": torch.from_numpy(draws["noise"])}
state, aux = tr.train_step(state, data, with_stats=False, batch=batch)
out = {"params." + k: v.detach().numpy() for k, v in _leaves(state.params)}
out["loss"] = np.asarray(float(aux["loss"]))
out["counts"] = np.asarray([state.step, state.ema_count, state.opt_state["count"]])
np.savez(a["out"], **out)
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
sys.exit(f"imported {bad}" if bad else 0)
"""


def test_jax_checkpoint_loads_without_jax_optax_or_ml_dtypes(tmp_path):
    jtr, jstate, jdata = _jax_state(False)
    ckpt = str(tmp_path / "jax.pkl")
    jtr.save_checkpoint(jstate, ckpt)
    named = {m.split(".")[0] for m, _ in _globals_named(ckpt)}
    assert named == {"numpy", "optax"}, named  # float32 params: no ml_dtypes global
    img, pix, noise = _batch(30, 2, 64 * 64)
    np.savez(tmp_path / "draws.npz", img=img, pix=pix, noise=noise)
    args = dict(dims=DIMS, rkw=RKW, tkw=TKW, ckpt=ckpt, draws=str(tmp_path / "draws.npz"),
                out=str(tmp_path / "out.npz"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(args)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    got = np.load(tmp_path / "out.npz")
    jnext, aux = _jax_step(jtr, jstate, jdata, (img, pix, noise))
    np.testing.assert_allclose(float(got["loss"]), float(aux["loss"]), rtol=1e-4)
    assert got["counts"].tolist() == [3, 3, 3] == [int(jnext.step), int(jnext.ema_count),
                                                   int(jnext.opt_state[0].count)]
    _close_params({k[len("params."):]: torch.from_numpy(got[k]) for k in got.files
                   if k.startswith("params.")}, jnext.params)


@pytest.mark.parametrize("weight_decay", [False, True])
def test_port_checkpoint_loads_in_jax_and_takes_an_optax_step(tmp_path, weight_decay):
    jtr, jstate, jdata = _jax_state(weight_decay)
    _, pcfg = _configs(weight_decay)
    ptr = PTR.Trainer(*pcfg, device="cpu")
    data = ptr.scene_to_device(PS.make_synthetic_scene(num_views=2, H=64, W=64, num_steps=32))
    state = train_state_from_jax(jstate, device="cpu")
    draws = _batch(40, 2, 64 * 64)
    state, _ = ptr.train_step(state, data, with_stats=False, batch=_port_batch(draws))
    jstate, _ = _jax_step(jtr, jstate, jdata, draws)
    ckpt = str(tmp_path / "port.pkl")
    ptr.save_checkpoint(state, ckpt)
    kinds = {name for _, name in _globals_named(ckpt) if _ != "numpy" and not _.startswith("numpy.")}
    assert kinds == ({"ScaleByAdamState", "ScaleByScheduleState"}
                     | ({"MaskedState", "EmptyState"} if weight_decay else set()))
    loaded = jtr.load_checkpoint(ckpt)
    assert jax.tree.structure(loaded.opt_state) == jax.tree.structure(jstate.opt_state)
    assert int(loaded.step) == 3 and int(loaded.opt_state[-1].count) == 3
    draws = _batch(41, 2, 64 * 64)
    jnext, jaux = _jax_step(jtr, loaded, jdata, draws)
    state, paux = ptr.train_step(state, data, with_stats=False, batch=_port_batch(draws))
    np.testing.assert_allclose(float(paux["loss"]), float(jaux["loss"]), rtol=1e-4)
    _close_params(state.params, jnext.params)
    _close_params(state.ema_params, jnext.ema_params)


def test_round_trip_and_occupancy_rebuild_match_jax(tmp_path):
    jtr, jstate, _ = _jax_state(False)
    _, pcfg = _configs(False)
    ptr = PTR.Trainer(*pcfg, device="cpu")
    ckpt = str(tmp_path / "jax.pkl")
    jtr.save_checkpoint(jstate, ckpt)
    state = ptr.load_checkpoint(ckpt)
    jl = jtr.load_checkpoint(ckpt)
    for f in ("occ", "occ_coarse", "bbox", "density_grid", "mean_density"):
        np.testing.assert_array_equal(getattr(state.occ, f).numpy(), np.asarray(getattr(jl.occ, f)), f)
    assert int(state.occ.iter_density) == int(jl.occ.iter_density) == 0
    again = str(tmp_path / "port.pkl")
    ptr.save_checkpoint(state, again)
    a, b = CK.load(ckpt), CK.load(again)
    assert a.keys() == b.keys()
    for k in ("ema_count", "step", "mean_density"):
        assert a[k] == b[k] and type(a[k]) is type(b[k])
    np.testing.assert_array_equal(a["density_grid"], b["density_grid"])
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) and all(np.array_equal(x, y) for x, y in zip(la, lb))
    # the threshold at a stored mean above density_thresh, and below it
    grid = np.random.default_rng(1).gamma(1.0, 8.0, (2, 32**3)).astype(np.float32)
    grid[:, ::7] = -1.0
    for mean in (float(np.float32(3.7)), float(np.float32(13.1))):
        occ, coarse, bbox = PR.occupancy_rebuild(torch.from_numpy(grid), mean, ptr.render_cfg)
        thresh = min(mean, jtr.render_cfg.density_thresh) * jtr.render_cfg.occ_thresh_scale
        jocc = jnp.asarray(grid > thresh).reshape(occ.shape)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
        np.testing.assert_array_equal(coarse.numpy(), np.asarray(
            JR._dilate3(jocc, jtr.render_cfg.coarse_dilation_radius)))
        np.testing.assert_array_equal(bbox.numpy(), np.asarray(JR._occupied_bbox(jocc, jtr.render_cfg)))


def test_load_model_for_stage_carries_the_shared_leaves(tmp_path):
    jtr, jstate, _ = _jax_state(False)
    ckpt = str(tmp_path / "jax.pkl")
    jtr.save_checkpoint(jstate, ckpt)
    big = dict(channels=16, resolution=128, wavelet_scale=8)
    kw = dict(bound=1.5, compute_dtype="float32", plane_dtype="float32")
    ptr = PTR.Trainer(PN.NeRFConfig(triplane=PT.TriplaneConfig(**big), **kw), PR.RenderConfig(**RKW),
                      PTR.TrainConfig(**TKW), device="cpu")
    jbig = JTR.Trainer(JN.NeRFConfig(triplane=JT.TriplaneConfig(**big), **kw), JR.RenderConfig(**RKW),
                       JTR.TrainConfig(**TKW))
    old_p = PN.NeRFConfig(triplane=PT.TriplaneConfig(**DIMS), **kw)
    old_j = JN.NeRFConfig(triplane=JT.TriplaneConfig(**DIMS), **kw)
    state = ptr.load_model_for_stage(ckpt, None, old_p)
    jgrown = jbig.load_model_for_stage(ckpt, jax.random.PRNGKey(0), old_j)
    lp, lj, old = _leaves(state.params), _leaves(jax.tree.map(np.asarray, jgrown.params)), \
        _leaves(jax.tree.map(np.asarray, jstate.params))
    assert {k: v.shape for k, v in lp.items()} == {k: v.shape for k, v in lj.items()}
    carried = [k for k in lj if k in old and old[k].shape == lj[k].shape]
    assert "encoder.base" in carried and "sigma_net.w0" in carried and len(carried) >= 6
    for k in carried:
        np.testing.assert_array_equal(lp[k], old[k], k)
        np.testing.assert_array_equal(lj[k], old[k], k)
    assert state.step == 0 and state.opt_state["count"] == 0 and state.ema_count == 0
    assert all((v == 0).all() for v in _leaves(state.opt_state["mu"]).values())
    assert all(np.array_equal(lp[k], v) for k, v in _leaves(state.ema_params).items())
    assert all(t.requires_grad for _, t in PTR._leaves(state.params))


def test_unpickler_refuses_other_globals(tmp_path):
    path = str(tmp_path / "evil.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": {}, "x": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd"):
        CK.load(path)
    state = CK.optax_chain_state({"count": 2, "mu": {"a": np.ones(2)}, "nu": {"a": np.ones(2)}}, True)
    CK.save(path, {"opt_state": state})
    ops = [op.name for op, _, _ in pickletools.genops(open(path, "rb").read())]
    assert ops.count("NEWOBJ") == 4 and "REDUCE" in ops
    back = CK.load(path)["opt_state"]
    assert [type(s).__name__ for s in back] == ["ScaleByAdamState", "MaskedState", "ScaleByScheduleState"]
    assert int(back[0].count) == int(back[2].count) == 2 and back[1].inner_state == CK.EmptyState()


@pytest.mark.parametrize("target", ["numpy.testing._private.utils.runstring", "numpy.save",
                                    "numpy.load"])
def test_unpickler_refuses_numpy_globals_that_run_code(tmp_path, target):
    """numpy names callables that execute code or touch files; only the
    globals that rebuild arrays, scalars and dtypes pass, at every protocol
    either package may write."""
    module, name = target.rsplit(".", 1)
    path = str(tmp_path / "evil.pkl")
    with open(path, "wb") as f:  # GLOBAL module name, EMPTY_TUPLE, REDUCE: a call
        f.write(b"\x80\x04c" + f"{module}\n{name}\n".encode() + b")R.")
    with pytest.raises(pickle.UnpicklingError, match=target.replace(".", r"\.")):
        CK.load(path)
    payload = {"f32": np.arange(6, dtype=np.float32).reshape(2, 3), "i32": np.int32(7),
               "strided": np.arange(8.0)[::2], "empty": np.zeros((0, 2), np.uint8)}
    for protocol in (3, 4, 5):
        with open(path, "wb") as f:
            pickle.dump(dict(payload, dtype=np.dtype(np.float16)), f, protocol=protocol)
        back = CK.load(path)
        assert back.pop("dtype") == np.dtype(np.float16)
        for k, v in payload.items():
            assert type(back[k]) is type(v) and back[k].dtype == v.dtype
            np.testing.assert_array_equal(back[k], v)
