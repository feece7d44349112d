"""The experiment logger in the PyTorch port against the JAX package's
(CPU): the text log and ``config.json`` (parsed and compared, any field
that differs named), ``StepTimer``, ``profile_trace``, and the trainer's
workspace log."""

import dataclasses
import json
import os
import re
import time

import numpy as np
import torch

from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu.train import trainer as JTR
from trinerflet_tpu.utils import logging as JL
from trinerflet_tpu_torch.data.synthetic import make_synthetic_scene
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.models import triplane as PT
from trinerflet_tpu_torch.render import renderer as PR
from trinerflet_tpu_torch.train import trainer as PTR
from trinerflet_tpu_torch.utils import logging as PL


def _differing(a, b, path=""):
    """The dotted paths where two parsed JSON values differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b)):
            if k not in a or k not in b:
                out.append(path + k)
            else:
                out += _differing(a[k], b[k], f"{path}{k}.")
        return out
    return [] if a == b else [path.rstrip(".")]


def _configs(pkg_nerf, pkg_tri, pkg_render, pkg_train):
    """Non-default values in every section, lists and nested dataclasses
    included."""
    tri = pkg_tri.TriplaneConfig(channels=8, resolution=128, wavelet_scale=8, wavelet_type="bior2.2",
                                 learned_rotation=True, upscale_ratio_bound=0.5, upscale_levels=3)
    return {"nerf": pkg_nerf.NeRFConfig(triplane=tri, bound=1.5, hidden_dim=32, bg_radius=4.0,
                                        compute_dtype="bfloat16"),
            "render": pkg_render.RenderConfig(bound=1.5, grid_size=64, dt_gamma=1 / 128, max_steps=256,
                                              compaction="global", global_slots_per_ray=8),
            "train": pkg_train.TrainConfig(lr=5e-3, iters=123, num_rays=2048, error_map=True,
                                           renderer="dense", criterion="huber")}


def test_logger_files_match_jax(tmp_path):
    """The same calls through both loggers: ``log_{name}.txt`` (the lines
    without their time stamps) and ``config.json`` (parsed) are the same;
    no field differs."""
    out = {}
    for pkg, mods in (("j", (JL, JN, JT, JR, JTR)), ("p", (PL, PN, PT, PR, PTR))):
        lg_mod = mods[0]
        lg = lg_mod.ExperimentLogger(str(tmp_path / pkg), "exp", use_tensorboard=False)
        lg.text("hello", to_console=False)
        lg.text("step      1 loss 0.50000 (1,234 rays/s)", to_console=False)
        lg.scalars(1, {"loss": 0.5})  # no writer: nothing
        lg.config(_configs(*mods[1:]))
        lg.config({"a": 1, "t": (1, 2), "obj": object.__name__}, fname="other.json")
        lg.close()
        with open(lg.log_path) as f:
            lines = f.read().splitlines()
        assert all(re.match(r"^\[\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\] ", ln) for ln in lines)
        with open(tmp_path / pkg / "config.json") as f, open(tmp_path / pkg / "other.json") as g:
            out[pkg] = ([ln[22:] for ln in lines], json.load(f), json.load(g), sorted(os.listdir(tmp_path / pkg)))
    (lp, cp, op, fp), (lj, cj, oj, fj) = out["p"], out["j"]
    assert lp == lj == ["hello", "step      1 loss 0.50000 (1,234 rays/s)"]
    assert fp == fj == ["config.json", "log_exp.txt", "other.json"]
    assert _differing(cp, cj) == [] and cp == cj
    assert op == oj == {"a": 1, "t": [1, 2], "obj": "object"}
    assert cp["nerf"]["triplane"]["upscale_ratio_bound"] == 0.5 and cp["train"]["renderer"] == "dense"


def test_logger_scalars_go_to_the_writer(tmp_path):
    """With a writer, every value becomes ``{prefix}/{key}`` at the step, a
    tensor read with float(); values float() refuses are skipped."""
    lg = PL.ExperimentLogger(str(tmp_path), use_tensorboard=False)
    calls = []
    lg.writer = type("W", (), {"add_scalar": lambda self, *a: calls.append(a), "close": lambda self: None})()
    lg.scalars(7, {"loss": torch.tensor(0.25), "lr": np.float32(0.01), "bad": "x"}, prefix="p")
    assert calls == [("p/loss", 0.25, 7), ("p/lr", float(np.float32(0.01)), 7)]


def test_step_timer():
    t = PL.StepTimer(window=3)
    assert t.mean_ms == 0.0
    for _ in range(5):
        t.tick()
        time.sleep(0.002)
    assert len(t.times) == 3 and t.mean_ms >= 2.0 and t.total_s >= 0.008


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with PL.profile_trace(str(tmp_path / "trace")) as d:
        x = torch.randn(64, 64)
        (x @ x).sum()
    files = os.listdir(d)
    assert len(files) == 1 and files[0].startswith("trace_") and files[0].endswith(".json")
    with open(os.path.join(d, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trainer_workspace_writes_jax_config_and_log(tmp_path, monkeypatch):
    """A trainer with a workspace writes the JAX trainer's ``config.json``
    (parsed, no field differs); ``fit``'s log lines go to
    ``log_trinerflet.txt`` and, on log steps only, the 0-d aux entries and
    ``lr`` to the scalars."""
    cj = _configs(JN, JT, JR, JTR)
    cp = _configs(PN, PT, PR, PTR)
    jtr = JTR.Trainer(cj["nerf"], cj["render"], dataclasses.replace(cj["train"], renderer="occgrid"),
                      workspace=str(tmp_path / "j"))
    ptr = PTR.Trainer(cp["nerf"], cp["render"], dataclasses.replace(cp["train"], renderer="occgrid"),
                      device="cpu", workspace=str(tmp_path / "p"))
    with open(tmp_path / "j" / "config.json") as f, open(tmp_path / "p" / "config.json") as g:
        j, p = json.load(f), json.load(g)
    assert _differing(p, j) == [] and p == j
    assert jtr.logger is not None and ptr.logger is not None

    small = dict(triplane=PT.TriplaneConfig(channels=4, resolution=32, wavelet_scale=2), bound=1.0)
    tr = PTR.Trainer(PN.NeRFConfig(**small),
                     PR.RenderConfig(bound=1.0, grid_size=16, density_thresh=0.01, max_steps=32,
                                     samples_per_ray_budget=8),
                     PTR.TrainConfig(iters=5, num_rays=64), device="cpu", workspace=str(tmp_path / "fit"))
    seen = []
    monkeypatch.setattr(tr.logger, "scalars", lambda step, values: seen.append((step, dict(values))))
    scene = make_synthetic_scene(num_views=2, H=16, W=16, num_steps=16)
    tr.fit(tr.init_state(), scene, log_every=2)
    with open(tmp_path / "fit" / "log_trinerflet.txt") as f:
        lines = [ln[22:] for ln in f.read().splitlines()]
    assert [ln.split(" loss ")[0] for ln in lines] == ["step      1", "step      3", "step      5"]
    assert [s for s, _ in seen] == [1, 3, 5]
    for step, values in seen:
        assert {"loss", "mse", "wavelet_reg", "lr"} <= set(values)
        assert all(np.ndim(v) == 0 for v in values.values())
        assert values["lr"] == tr.lr_fn(step)
    assert PTR.Trainer(PN.NeRFConfig(**small), PR.RenderConfig(grid_size=16), PTR.TrainConfig(),
                       device="cpu").logger is None
