"""The PyTorch port stands alone: it never imports JAX or the JAX package,
and its entry points run on CUDA or raise -- never silently on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "trinerflet_tpu_torch"


def _port_modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def _map(fn, tree):
    """fn over the leaves of a nest of dicts and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    return fn(tree)


def test_port_modules_import_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'trinerflet_tpu', 'safetensors', 'optax')]\n"
        "print(len(sys.modules)); sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax_import():
    """No port source (the SR app's and the utilities' included) imports
    JAX, the JAX package, safetensors (the port reads the format itself) or
    optax."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "trinerflet_tpu", "safetensors", "optax"), \
                    f"{f}: imports {n}"


def _tensors_of(ts):
    """The tensors of a TrainState (its counters and generator aside)."""
    assert ts.step == ts.ema_count == ts.opt_state["count"] == 3
    return {"params": ts.params, "mu": ts.opt_state["mu"], "nu": ts.opt_state["nu"],
            "ema": ts.ema_params, "occ": tuple(ts.occ)}


def test_entry_points_raise_without_cuda(monkeypatch):
    from trinerflet_tpu_torch import resolve_device
    from trinerflet_tpu_torch.models.nerf import NeRFConfig
    from trinerflet_tpu_torch.models.triplane import TriplaneConfig
    from trinerflet_tpu_torch.render.renderer import RenderConfig
    from trinerflet_tpu_torch.train.trainer import TrainConfig, Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = NeRFConfig(triplane=TriplaneConfig(channels=4, resolution=64, wavelet_scale=4))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, RenderConfig(), TrainConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"
    assert Trainer(cfg, RenderConfig(), TrainConfig(), device="cpu").device.type == "cpu"


def test_state_makers_default_to_cuda(monkeypatch):
    """Every function that makes or carries in params or occupancy state
    defaults to CUDA, so without CUDA it raises unless given device='cpu'."""
    from trinerflet_tpu_torch.carry import occupancy_from_jax, params_from_jax, train_state_from_jax
    from trinerflet_tpu_torch.models.nerf import NeRFConfig, init_nerf_params
    from trinerflet_tpu_torch.models.triplane import TriplaneConfig, init_triplane_params
    from trinerflet_tpu_torch.render.renderer import RenderConfig, init_occupancy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = TriplaneConfig(channels=4, resolution=64, wavelet_scale=4)
    ncfg = NeRFConfig(triplane=tcfg)
    rcfg = RenderConfig(grid_size=8)
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(0), device="cpu")
    tree = _map(lambda t: t.numpy(), params)
    state = {k: v.numpy() for k, v in init_occupancy(rcfg, device="cpu")._asdict().items()}
    makers = {
        "init_nerf_params": lambda **kw: init_nerf_params(ncfg, **kw),
        "init_triplane_params": lambda **kw: init_triplane_params(tcfg, **kw),
        "init_occupancy": lambda **kw: init_occupancy(rcfg, **kw),
        "params_from_jax": lambda **kw: params_from_jax(tree, **kw),
        "occupancy_from_jax": lambda **kw: occupancy_from_jax(state, **kw),
        "train_state_from_jax": lambda **kw: _tensors_of(train_state_from_jax(
            {"params": tree, "opt_state": ({"count": 3, "mu": tree, "nu": tree},),
             "ema_params": tree, "ema_count": 3, "occ": state, "step": 3}, **kw)),
    }
    from trinerflet_tpu_torch.carry import network_params_from_jax, sr_state_from_jax
    from trinerflet_tpu_torch.sr import diffusion, guidance, system, text
    from trinerflet_tpu_torch.utils.lpips import init_lpips_params

    tiny_vae = diffusion.VAEConfig(block_out_channels=(8, 16), latent_channels=4, layers_per_block=1,
                                   norm_num_groups=4)
    sr_ncfg = NeRFConfig(triplane=TriplaneConfig(channels=4, resolution=64, wavelet_scale=4,
                                                 low_res_scale=2))
    makers.update({
        "init_vae_params": lambda **kw: diffusion.init_vae_params(tiny_vae, **kw),
        "init_text_params": lambda **kw: text.init_text_params(text.TextConfig(
            vocab_size=8, hidden_size=8, num_layers=1, num_heads=2, intermediate_size=8,
            max_length=4), **kw),
        "init_lpips_params": lambda **kw: (lambda lp: (lp["backbone"], tuple(lp["lins"])))(
            init_lpips_params("alex", **kw)),
        "network_params_from_jax": lambda **kw: network_params_from_jax(
            {"conv": {"weight": np.zeros((3, 3, 2, 4), np.float32)}}, **kw),
        "sr_state_from_jax": lambda **kw: _map(lambda t: t, sr_state_from_jax(
            {"params": tree, "opt_state": ({"count": 3, "mu": tree, "nu": tree},), "occ": state,
             "step": 3}, **kw).params),
        "SRSystem.init_state": lambda **kw: system.SRSystem(
            sr_ncfg, rcfg, system.SRConfig(), guidance.make_resize_guidance(guidance.GuidanceConfig()),
            **kw).init_state().params,
    })
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="cuda"):
            make()
        leaves = []
        _map(leaves.append, make(device="cpu"))
        assert leaves and all(t.device.type == "cpu" for t in leaves), name


def test_trainer_rejects_state_on_another_device():
    """A trainer refuses params or occupancy that are not on its device
    (here: a CPU trainer given 'meta' tensors) before it does any work."""
    from trinerflet_tpu_torch.models.nerf import NeRFConfig, init_nerf_params
    from trinerflet_tpu_torch.models.triplane import TriplaneConfig
    from trinerflet_tpu_torch.render.renderer import RenderConfig, init_occupancy
    from trinerflet_tpu_torch.train.trainer import TrainConfig, Trainer

    ncfg = NeRFConfig(triplane=TriplaneConfig(channels=4, resolution=64, wavelet_scale=4))
    rcfg = RenderConfig(grid_size=8)
    tr = Trainer(ncfg, rcfg, TrainConfig(), device="cpu")
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(0), device="cpu")
    occ = init_occupancy(rcfg, device="cpu")
    moved = _map(lambda t: t.to("meta"), params)
    pose = np.eye(4, dtype=np.float32)
    intr = np.array([4.0, 4.0, 2.0, 2.0], dtype=np.float32)
    with pytest.raises(ValueError, match="params are on meta"):
        tr.render_image(moved, occ, pose, intr, 4, 4)
    with pytest.raises(ValueError, match="occupancy are on meta"):
        tr.update_grid(params, type(occ)(*[x.to("meta") for x in occ]))


def _code_strings(path):
    """The string constants of a module's code (docstrings aside)."""
    tree = ast.parse(Path(path).read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_host_library_and_cli_read_nothing_of_the_jax_package():
    """The port's host library builds from its own source into the checkout's
    build/, and neither it nor the CLI names a path of the JAX package or of
    the repository's native/ directory in its code."""
    from trinerflet_tpu_torch import cli, native

    assert Path(native._SRC).parent == PKG / "native" and Path(native._SRC).exists()
    assert Path(native.BUILD_DIR) == ROOT / "build" / "native"
    for f in (PKG / "cli.py", PKG / "native" / "__init__.py"):
        for s in _code_strings(f):
            assert ".." not in s and "trinerflet_tpu/" not in s, f"{f}: {s!r}"
    assert [ln for ln in Path(native._SRC).read_text().splitlines() if ln.startswith("#include")] == [
        "#include <cmath>", "#include <cstdint>", "#include <cstdio>", "#include <cstring>",
        "#include <vector>", "#include <zlib.h>"]
    assert cli.__file__.startswith(str(PKG))


def test_cli_raises_without_cuda(monkeypatch, tmp_path):
    from trinerflet_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ws = tmp_path / "ws"
    for argv in (["--path", str(tmp_path), "--workspace", str(ws)],
                 ["--path", str(tmp_path), "--workspace", str(ws), "--test"]):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(argv)
        with pytest.raises(RuntimeError, match="cuda"):
            cli.run(cli.get_params(argv))
    assert not ws.exists()


def test_generation_gui_and_clip_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The text-to-3D system and its launcher, the CLI with --gui or
    --rand_pose, and the CLIP tree makers default to CUDA and raise without
    it, before any work (no workspace appears)."""
    import yaml

    from trinerflet_tpu_torch import cli
    from trinerflet_tpu_torch.models.nerf import NeRFConfig
    from trinerflet_tpu_torch.models.triplane import TriplaneConfig
    from trinerflet_tpu_torch.render.renderer import RenderConfig
    from trinerflet_tpu_torch.sr import guidance, launch
    from trinerflet_tpu_torch.sr.text import TextConfig
    from trinerflet_tpu_torch.sr.text_to_3d import TextTo3DConfig, TextTo3DSystem
    from trinerflet_tpu_torch.utils import clip_loss

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ncfg = NeRFConfig(triplane=TriplaneConfig(channels=4, resolution=64, wavelet_scale=4))
    g = guidance.make_cond_guidance(guidance.GuidanceConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        TextTo3DSystem(ncfg, RenderConfig(grid_size=8), TextTo3DConfig(), g)
    assert TextTo3DSystem(ncfg, RenderConfig(grid_size=8), TextTo3DConfig(), g, device="cpu").device.type == "cpu"
    gen = {"triplane": {"channels": 4, "resolution": 32, "wavelet_scale": 2},
           "system": {"kind": "generation", "total_steps": 1}, "guidance": {"kind": "cond"}}
    path = tmp_path / "gen.yaml"
    path.write_text(yaml.safe_dump(gen))
    ws = tmp_path / "ws"
    with pytest.raises(RuntimeError, match="cuda"):
        launch.build(gen, str(ws))
    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(["--config", str(path), "--train", "--workspace", str(ws)])
    for flags in (["--gui"], ["--gui", "--test"], ["--rand_pose", "1", "--clip_ckpt", str(tmp_path)]):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--path", str(tmp_path), "--workspace", str(ws)] + flags)
    assert not ws.exists()
    vcfg = clip_loss.VisionConfig(image_size=16, patch_size=8, hidden_size=8, num_layers=1, num_heads=2,
                                  intermediate_size=8, projection_dim=4)
    tcfg = TextConfig(vocab_size=8, hidden_size=8, num_layers=1, num_heads=2, intermediate_size=8,
                      max_length=4)
    makers = {"init_vision_params": lambda **kw: clip_loss.init_vision_params(vcfg, **kw),
              "init_clip_params": lambda **kw: clip_loss.init_clip_params(vcfg, tcfg, **kw),
              "state_dict_to_tree": lambda **kw: clip_loss.state_dict_to_tree(
                  {"visual_projection.weight": np.zeros((4, 8), np.float32)}, **kw)}
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="cuda"):
            make()
        leaves = []
        _map(leaves.append, make(device="cpu"))
        assert leaves and all(t.device.type == "cpu" for t in leaves), name
