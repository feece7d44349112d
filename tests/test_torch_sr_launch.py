"""The SR launcher end to end, the PyTorch port against the JAX package (CPU).

Both ``sr.launch.main`` run one tiny synthetic recipe (the srtex scene
through the npz cache, a 64^2 triplane with ``low_res_scale`` 2, 2 LR and
2 HR steps with the resize guidance, then ``evaluate``), each in its own
workspace. The port starts from the JAX package's initial parameters (its
``init_state`` is wrapped to take them) and both take the same draws from
the start of ``fit`` (tests/test_torch_sr_system.py's ``Draws``).

Compared: the results files (PSNR within 1e-3 dB, SSIM within 1e-5), the
checkpoints (the trajectory tolerance of tests/test_torch_sr_system.py),
and each package resuming the other's ``sr_state.pkl`` and scene npz with
``--test`` (the same numbers as its own). Also: the refusals (a
generation config with the SR system's keys, the default CUDA device
without a card).
"""

import json
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_sr_system import Draws, _leaves, assert_params_close, no_jit
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.sr import launch as JLAUNCH
from trinerflet_tpu.sr import system as JSYS
from trinerflet_tpu_torch.carry import params_from_jax
from trinerflet_tpu_torch.sr import launch as PLAUNCH
from trinerflet_tpu_torch.sr import system as PSYS
from trinerflet_tpu_torch.train.trainer import _fresh_adam, _map

CFG = {
    "data": {"synthetic": True, "variant": "srtex", "num_views": 3, "lr_size": 8, "scale_ratio": 2,
             "background_color": 0.0, "backend": "numpy", "lr_from": "downsample"},
    "triplane": {"channels": 8, "resolution": 64, "wavelet_scale": 4, "wavelet_type": "bior6.8",
                 "low_res_scale": 2},
    "model": {"bound": 1.0, "hidden_dim": 32, "hidden_dim_color": 32, "compute_dtype": "float32"},
    "renderer": {"grid_size": 32, "density_thresh": 1.0, "max_steps": 128, "samples_per_ray_budget": 16},
    "system": {"total_steps": 4, "sr_start_step": 2, "hr_fit_refresh_every": 2, "num_rays_lr": 64,
               "crop_size_lr": 4, "update_extra_interval": 100, "eval_chunk": 1024,
               "wavelet_regularization": 0.01, "lambda_l1_hr": [2, 0.0, 1.0, 4]},
    "guidance": {"kind": "resize", "num_inference_steps": 10, "noise_level": 20},
}


def _config(tmp_path):
    cfg = dict(CFG, data=dict(CFG["data"], cache=str(tmp_path / "scene.npz")))
    path = str(tmp_path / "sr.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _jax_initial_params():
    """JAX's initial SR params for CFG (its init_state: init_nerf_params on
    the first half of PRNGKey(seed)'s split), as numpy."""
    c = CFG
    jcfg = JN.NeRFConfig(triplane=JT.TriplaneConfig(**c["triplane"]), **c["model"])
    k1, _ = jax.random.split(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, JN.init_nerf_params(k1, jcfg))


def _init_from_jax(pinit, jparams):
    """The port's init_state, with JAX's initial params."""

    def init_state(self, generator=None, density_grid=None):
        state = pinit(self, generator, density_grid)
        params = _map(lambda t: t.requires_grad_(True), params_from_jax(jparams, "cpu"))
        return state._replace(params=params, opt_state=_fresh_adam(params))

    return init_state


def _arm_at(mp, cls, name, draws):
    """Patch JAX's draws when ``cls.name`` is first called (after the JAX
    initialisers have drawn with the real ``jax.random``)."""
    real = getattr(cls, name)
    armed = []

    def wrapped(self, *a, **k):
        if not armed:
            draws.patch_jax(mp)
            armed.append(True)
        return real(self, *a, **k)

    mp.setattr(cls, name, wrapped)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's main, then the port's, training on one config (the port's
    scene read from the npz JAX wrote), each in its workspace."""
    tmp = tmp_path_factory.mktemp("sr_launch")
    path = _config(tmp)
    draws = Draws(41)
    ws_j, ws_p = str(tmp / "ws_j"), str(tmp / "ws_p")
    jparams = _jax_initial_params()
    with pytest.MonkeyPatch.context() as mp:
        no_jit(mp)
        _arm_at(mp, JSYS.SRSystem, "fit", draws)
        mp.setattr(PSYS.SRSystem, "init_state", _init_from_jax(PSYS.SRSystem.init_state, jparams))
        draws.patch_port(mp)
        JLAUNCH.main(["--config", path, "--train", "--workspace", ws_j])
        assert os.path.exists(str(tmp / "scene.npz"))
        pstate = PLAUNCH.main(["--config", path, "--train", "--workspace", ws_p, "--device", "cpu"])
    return tmp, path, ws_j, ws_p, pstate


def _results(ws, step=4):
    with open(os.path.join(ws, f"final_results_{step}.json")) as f:
        return json.load(f)


def _close(res_p, res_j):
    assert set(res_p) == set(res_j) and len(res_p["per_frame"]) == len(res_j["per_frame"]) == 3
    for k in ("PSNR_lr", "PSNR_hr", "PSNR_bilinear", "SSIM_hr"):
        np.testing.assert_allclose(res_p[k], res_j[k], rtol=0, atol=1e-5 if k == "SSIM_hr" else 1e-3,
                                   err_msg=k)


def test_launcher_end_to_end_matches_jax(runs, capsys):
    """The same recipe through both launchers: the files, the results
    and the checkpoints."""
    _, _, ws_j, ws_p, pstate = runs
    assert sorted(os.listdir(ws_p)) == sorted(os.listdir(ws_j)) == ["final_results_4.json", "sr_state.pkl"]
    _close(_results(ws_p), _results(ws_j))
    with open(os.path.join(ws_j, "sr_state.pkl"), "rb") as f:
        jpay = pickle.load(f)
    with open(os.path.join(ws_p, "sr_state.pkl"), "rb") as f:
        ppay = pickle.load(f)
    assert jpay["step"] == ppay["step"] == pstate.step == 4 and isinstance(ppay["step"], int)
    assert set(_leaves(ppay["params"])) == set(_leaves(jpay["params"]))
    assert_params_close(ppay["params"], jpay["params"], 1e-2, 4)


def test_each_package_resumes_the_others_state(runs):
    """``--test`` on JAX's sr_state.pkl in both packages (the same draws for
    the grid refresh after loading): the port loads JAX's params bit for
    bit and the evaluations agree as in test_evaluate; JAX's ``--test``
    loads the port's checkpoint (its params as the port wrote them)."""
    tmp, path, ws_j, ws_p, _ = runs
    for name, src in (("a_j", ws_j), ("a_p", ws_j), ("b_j", ws_p)):
        os.makedirs(str(tmp / name))
        shutil.copy(os.path.join(src, "sr_state.pkl"), str(tmp / name / "sr_state.pkl"))
    draws = Draws(51)
    with pytest.MonkeyPatch.context() as mp:
        no_jit(mp)
        _arm_at(mp, JSYS.SRSystem, "_update_grid_impl", draws)
        draws.patch_port(mp)
        JLAUNCH.main(["--config", path, "--test", "--workspace", str(tmp / "a_j")])
        pstate = PLAUNCH.main(["--config", path, "--test", "--workspace", str(tmp / "a_p"), "--device", "cpu"])
    with open(os.path.join(ws_j, "sr_state.pkl"), "rb") as f:
        jpay = pickle.load(f)
    lp = _leaves(pstate.params)
    for n, v in _leaves(jpay["params"]).items():
        np.testing.assert_array_equal(lp[n], v, err_msg=n)
    assert pstate.step == 4
    _close(_results(str(tmp / "a_p")), _results(str(tmp / "a_j")))
    with pytest.MonkeyPatch.context() as mp:
        no_jit(mp)
        JLAUNCH.main(["--config", path, "--test", "--workspace", str(tmp / "b_j")])
    res = _results(str(tmp / "b_j"))
    assert np.isfinite(res["PSNR_hr"]) and res["PSNR_bilinear"] == pytest.approx(_results(ws_p)["PSNR_bilinear"])


def test_launcher_refusals(tmp_path):
    path = _config(tmp_path)
    cfg = yaml.safe_load(open(path))
    cfg["system"]["kind"] = "generation"
    gen = str(tmp_path / "gen.yaml")
    with open(gen, "w") as f:
        yaml.safe_dump(cfg, f)
    with pytest.raises(ValueError, match="unknown config keys for TextTo3DConfig"):
        PLAUNCH.main(["--config", gen, "--workspace", str(tmp_path / "g"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PLAUNCH.main(["--config", path, "--workspace", str(tmp_path / "c")])
    with pytest.raises(ValueError, match="unknown guidance kind"):
        PLAUNCH.build(dict(yaml.safe_load(open(path)), guidance={"kind": "nope"}), str(tmp_path / "w"),
                      device="cpu")
