"""The port's CLI (``trinerflet_tpu_torch/cli.py``) against the JAX package's
``cli.py``: the same flags and defaults, the same configurations from them,
the same dataset dispatch, the refused flags, and a two-stage run on the CPU
at tiny widths that writes the checkpoints, the results, the test renders,
the mesh, the video frames and the plane dumps.
"""

import builtins
import dataclasses
import glob
import json
import os

import numpy as np
import pytest

from trinerflet_tpu import cli as JCLI
from trinerflet_tpu.data import synthetic as JS
from trinerflet_tpu_torch import cli as PCLI
from trinerflet_tpu_torch.data import synthetic as PS

from .test_llff import _write_llff_dataset
from .test_torch_loaders import _same_scene, _write_colmap
from .test_torch_train import one_torch_thread  # noqa: F401

TINY = ["--triplane_wavelet", "--bound", "1.5", "--dt_gamma", "0", "--scale", "1.0", "-O",
        "--triplane_resolution", "32", "64", "--triplane_wavelet_levels", "2", "4",
        "--triplane_channels", "4", "--num_rays", "256", "512", "--wavelet_regularization", "0.2",
        "--iters", "6", "6", "--eval_interval_stages", "2", "--max_keep_ckpt", "2",
        "--max_ray_batch", "4096", "--mute"]

ARG_SETS = [
    [],
    TINY,
    ["--nerfacc_renderer", "--nerfacc_estimator", "importance", "--fp16", "--upsample_steps", "8"],
    ["--nerfacc_renderer", "--nerfacc_estimator", "proposal", "--mlp_weight_decay", "0.01",
     "--huber_loss", "--error_map", "--train_rand_bg", "--no_budget_autotune", "--seed", "3"],
    ["--cuda_ray", "--triplane_rotation", "--lbound_auto_scale", "--upscale_ratio_bound", "0.5",
     "--bg_radius", "4", "--eval_samples_per_ray", "48", "--warmup_steps", "10", "--lr", "5e-3"],
]


def test_flags_and_defaults_match_jax():
    for args in ARG_SETS:
        assert vars(PCLI.get_params(args)) == vars(JCLI.get_params(args))
    assert PCLI.STAGE_KEYS == JCLI.STAGE_KEYS


def _common_fields(p, j):
    pf = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    return {k: pf[k] for k in pf if k in jf}, {k: jf[k] for k in pf if k in jf}


@pytest.mark.parametrize("args", ARG_SETS[1:])
def test_build_configs_match_jax(args):
    popt, jopt = PCLI.get_params(args), JCLI.get_params(args)
    for o in (popt, jopt):
        for k in PCLI.STAGE_KEYS:
            vars(o)[k] = vars(o)[k][-1]
        if o.O:
            o.fp16 = o.cuda_ray = True
    for p, j in zip(PCLI.build_configs(popt), JCLI.build_configs(jopt)):
        pc, jc = _common_fields(p, j)
        if "triplane" in pc:
            pt, jt = _common_fields(pc.pop("triplane"), jc.pop("triplane"))
            assert pt == jt
        assert pc == jc and len(pc) >= 10


@pytest.fixture(scope="module")
def dataset_roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("formats")
    roots = {"blender": JS.write_synthetic_scene(str(base / "blender"), num_views=3, num_test_views=2,
                                                 H=16, W=16),
             "llff": _write_llff_dataset(str(base / "llff"), V=4, H=16, W=20),
             "colmap": _write_colmap(str(base / "colmap"))}
    for name, dirs in (("nsvf", ("rgb", "pose")), ("nerfpp", ("train/rgb",)), ("rtmv", ("images",))):
        for d in dirs:
            os.makedirs(base / name / d)
        roots[name] = str(base / name)
    open(base / "rtmv" / "00000.json", "w").write("{}")
    os.makedirs(base / "none")
    roots["none"] = str(base / "none")
    return roots


def test_detect_data_format_matches_jax(dataset_roots):
    for name, root in dataset_roots.items():
        if name == "none":
            for detect in (PCLI.detect_data_format, JCLI.detect_data_format):
                with pytest.raises(ValueError, match="auto-detect"):
                    detect(root)
        else:
            assert PCLI.detect_data_format(root) == JCLI.detect_data_format(root) == name


@pytest.mark.parametrize("name,args", [
    ("blender", ["--downscale", "2"]), ("blender", ["--data_format", "blender", "--offset", "0.1", "0", "0"]),
    ("llff", ["--llff_ndc", "--llff_hold", "2", "--llff_downscale", "1"]),
    ("llff", ["--llff_downscale", "2", "--llff_hold", "0"]),
    ("colmap", ["--llff_hold", "2", "--scale", "0.5"])])
@pytest.mark.parametrize("split", ["train", "test"])
def test_load_scene_routes_as_jax(dataset_roots, name, args, split):
    popt = PCLI.get_params(["--path", dataset_roots[name]] + args)
    jopt = JCLI.get_params(["--path", dataset_roots[name]] + args)
    for o in (popt, jopt):
        o.downscale = o.downscale[0]
    _same_scene(PCLI.load_scene(popt, split), JCLI.load_scene(jopt, split), image_atol=1e-6)


@pytest.mark.parametrize("flags,what", [(["--gui"], "--gui"), (["--rand_pose", "0"], "--rand_pose"),
                                        (["--rand_pose", "3", "--test"], "--rand_pose")])
def test_refused_flags_raise_before_any_work(tmp_path, flags, what):
    """--gui and --rand_pose are ported: with a missing scene each raises
    for the path before any work; --rand_pose without a --clip_ckpt
    directory raises for it (no CLIP weights are in the repository) before
    any work."""
    ws = tmp_path / "ws"
    with pytest.raises(FileNotFoundError, match="--path"):
        PCLI.main(["--path", str(tmp_path / "missing"), "--workspace", str(ws)] + flags, device="cpu")
    assert not ws.exists()
    if what == "--rand_pose" and "--test" not in flags:
        with pytest.raises(NotImplementedError, match="--rand_pose needs --clip_ckpt"):
            PCLI.main(["--path", str(tmp_path), "--workspace", str(ws)] + flags, device="cpu")
        assert not ws.exists()


def test_stage_keys_must_broadcast(tmp_path):
    with pytest.raises(ValueError, match="--iters has 2 values; give 1 or 3"):
        PCLI.main(["--path", str(tmp_path), "--iters", "1", "2", "--num_rays", "1", "2", "3"], device="cpu")


def test_two_stage_run_then_test_and_planes(tmp_path, monkeypatch):
    """The README's two-stage recipe at tiny widths on the CPU, the
    --test run (with no video writer: the PNG sequence) and --save_planes."""
    scene = PS.write_synthetic_scene(str(tmp_path / "scene"), num_views=4, num_test_views=3, H=24, W=24)
    ws = str(tmp_path / "ws")
    args = ["--path", scene, "--workspace", ws] + TINY
    trainer, state = PCLI.main(args, device="cpu")
    assert state.step == 6 and trainer.nerf_cfg.triplane.resolution == 64
    assert trainer.cfg.num_rays == 512 and trainer.nerf_cfg.compute_dtype == "bfloat16"
    files = set(os.listdir(ws))
    assert {"latest_model.pkl", "best_model.pkl", "stage_0.pkl", "stage_1.pkl", "results_stage0.json",
            "results_stage1.json"} <= files
    assert sorted(f for f in files if f.startswith("ckpt_")) == ["ckpt_000004.pkl", "ckpt_000006.pkl"]
    for tag in ("results_stage0", "results_stage1"):
        with open(os.path.join(ws, f"{tag}.json")) as f:
            res = json.load(f)
        assert np.isfinite(res["PSNR"]) and len(res["per_image"]) == 3

    real_import = builtins.__import__

    def no_video_writers(name, *a, **k):
        if name in ("imageio", "cv2"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_video_writers)
    PCLI.main(args + ["--test", "--test_with_ema", "--ckpt", "best"], device="cpu")
    monkeypatch.undo()
    with open(os.path.join(ws, "results.json")) as f:
        assert np.isfinite(json.load(f)["PSNR"])
    assert len(glob.glob(os.path.join(ws, "test_renders", "results_*_depth.png"))) == 3
    assert os.path.exists(os.path.join(ws, "mesh.obj"))
    assert sorted(os.listdir(os.path.join(ws, "test_video_frames"))) == ["0000.png", "0001.png", "0002.png"]
    assert not os.path.exists(os.path.join(ws, "test_video.mp4"))
    PCLI.main(args + ["--test", "--save_planes"], device="cpu")
    planes = sorted(os.listdir(os.path.join(ws, "planes")))
    assert planes == sorted(f"plane_{g}_{p}.png" for g in ("base", "level_0", "level_1") for p in range(3))


def test_write_video_prefers_an_encoder(tmp_path):
    frames = [np.full((8, 8, 3), 40 * i, np.uint8) for i in range(3)]
    out = PCLI.write_video(str(tmp_path / "v.mp4"), frames)
    assert os.path.exists(out)
    if out.endswith("_frames"):
        assert len(os.listdir(out)) == 3
    else:
        assert os.path.getsize(out) > 0
