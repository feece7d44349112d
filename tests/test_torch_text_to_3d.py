"""Text-to-3D generation in the PyTorch port against the JAX package (CPU):
the orbit cameras, a generation trajectory, the generation launcher and
the text-to-image guidance path.

Setup: tests/test_torch_sr_system.py's 8-channel 64^2 bior6.8 triplane
(2 IDWT levels, ``low_res_scale`` 2), 32-wide MLPs and 32^3 grid; 2 views a
round, the oracle guidance (a target of the view's size, 4 DDIM steps).
Both systems start from the JAX package's initial state
(``carry.sr_state_from_jax``); every random draw is handed to both
packages (``Draws`` of that file: the host's camera and crop draws come
from ``np.random.default_rng(seed)`` in both, in the same order, with
nothing injected).

The trajectory: 6 steps on 16^2 views (the crop is the whole view, 256
rays) with refreshes at steps 0 and 3. The crops of larger views are held
on their own: on 68^2 views the port's 64^2 crop at the drawn (x0, y0)
(x0 the row) must be the JAX package's rays (its ``rays_for_pixels`` on
the same poses and pixels) and the same slice of the cached pseudo-GT.
(A trajectory on 68^2 views agrees in its losses but not in its
parameters past the first step: the 4,096-ray gradients leave some wavelet
coefficients within rounding of zero, Adam's first step moves each entry
by about lr whatever its gradient's size, so one entry a level steps the
other way at step 0 and every later gradient around it differs: measured,
1 entry of each level after step 0, ~10% of level_0 beyond 1e-5 after
step 2.)

Tolerances (those of tests/test_torch_sr_system.py): per-step losses rtol
1e-4, the wavelet L1 term rtol 1e-3, the parameters as
``assert_params_close`` holds them.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_sr_system import NERF, RND, TRI, Draws, assert_params_close, no_jit
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu.sr import guidance as JG
from trinerflet_tpu.sr import text_to_3d as J3
from trinerflet_tpu_torch.carry import sr_state_from_jax
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.models import triplane as PT
from trinerflet_tpu_torch.render import renderer as PR
from trinerflet_tpu_torch.sr import guidance as PG
from trinerflet_tpu_torch.sr import launch as PLAUNCH
from trinerflet_tpu_torch.sr import text_to_3d as P3

GEN = dict(total_steps=6, views_per_refresh=2, refresh_every=3, render_size=16, num_rays=64,
           eval_chunk=8192, wavelet_regularization=0.01, lambda_fit=[3, 1.0, 0.5, 6])


def test_orbit_cameras_match_jax():
    for seed in (0, 7):
        np.testing.assert_array_equal(P3.sample_orbit_cameras(np.random.default_rng(seed), 5),
                                      J3.sample_orbit_cameras(np.random.default_rng(seed), 5))
    kw = dict(radius_range=(1.0, 1.5), theta_range=(0.2, 0.4))
    np.testing.assert_array_equal(P3.sample_orbit_cameras(np.random.default_rng(3), 3, **kw),
                                  J3.sample_orbit_cameras(np.random.default_rng(3), 3, **kw))


def _systems(gen=None, low_res_scale=2):
    gen = dict(GEN, **(gen or {}))
    tri = dict(TRI, low_res_scale=low_res_scale)
    cj = JN.NeRFConfig(triplane=JT.TriplaneConfig(**tri), **NERF)
    cp = PN.NeRFConfig(triplane=PT.TriplaneConfig(**tri), **NERF)
    S = gen["render_size"]
    target = (0.2 + 0.6 * np.random.default_rng(4).random((1, S, S, 3))).astype(np.float32)
    gc = dict(num_inference_steps=4, guidance_scale=1.0)
    gj = JG.make_oracle_guidance(JG.GuidanceConfig(**gc), jnp.asarray(target))
    gp = PG.make_oracle_guidance(PG.GuidanceConfig(**gc), torch.from_numpy(target).permute(0, 3, 1, 2))
    jsys = J3.TextTo3DSystem(cj, JR.RenderConfig(**RND), J3.TextTo3DConfig(**gen), gj)
    psys = P3.TextTo3DSystem(cp, PR.RenderConfig(**RND), P3.TextTo3DConfig(**gen), gp, device="cpu")
    return jsys, psys


def _trajectory():
    draws = Draws(13)
    with pytest.MonkeyPatch.context() as mp:
        no_jit(mp)
        jsys, psys = _systems()
        jstate = jsys.init_state()
        pstate = sr_state_from_jax(jstate, "cpu")
        draws.patch_jax(mp)
        draws.patch_port(mp)
        refreshes = {"j": [], "p": []}
        for key, sys_ in (("j", jsys), ("p", psys)):
            real = sys_.guidance.generate_sr

            def spy(*a, _real=real, _key=key, **k):
                refreshes[_key].append(k["step"])
                return _real(*a, **k)

            mp.setattr(sys_.guidance, "generate_sr", spy)
        jaux, paux = [], []
        jstate = jsys.fit(jstate, log_every=0,
                          callback=lambda s, a: jaux.append({k: float(v) for k, v in a.items()}))
        pstate = psys.fit(pstate, log_every=0,
                          callback=lambda s, a: paux.append({k: float(v) for k, v in a.items()}))
    return jsys, psys, jstate, pstate, jaux, paux, refreshes


def test_generation_trajectory_matches_jax():
    """6 steps on 16^2 views against the oracle's pseudo-GT, refreshed (2
    views each) at steps 0 and 3; the fit weight on a schedule, the wavelet
    L1 on, SDS off as in the JAX package."""
    jsys, psys, jstate, pstate, jaux, paux, refreshes = _trajectory()
    assert refreshes["p"] == refreshes["j"] == [0, 0, 3, 3]
    assert len(paux) == len(jaux) == 6
    for s, (a, b) in enumerate(zip(paux, jaux)):
        assert set(a) == set(b), s
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3 if k == "reg" else 1e-4, atol=1e-7,
                                       err_msg=f"step {s} {k}")
    assert len({round(a["l2_hr"], 6) for a in paux}) == 6
    assert pstate.step == int(jstate.step) == 6
    assert pstate.opt_state["count"] == int(jstate.opt_state[0].count) == 6
    assert_params_close(pstate.params, jstate.params, 1e-2, 6)
    np.testing.assert_array_equal(pstate.occ.occ.numpy(), np.asarray(jstate.occ.occ))


def test_generation_crops_match_jax(monkeypatch):
    """On 68^2 views the 64^2 crops move: each step's rays, pseudo-GT crop
    and its 16^2 LR resize against the JAX package's formula (its host
    draws replayed, its ``rays_for_pixels`` and ``jax.image.resize``)."""
    from trinerflet_tpu.data.rays import rays_for_pixels as jrays

    S, crop, steps = 68, 64, 4
    _, psys = _systems(dict(render_size=S, total_steps=steps, refresh_every=100, eval_chunk=2048))
    pseudo, seen = [], []
    real_gen, real_step = psys.guidance.generate_sr, psys.inner._hr_step

    def gen(*a, **k):
        out = real_gen(*a, **k)
        pseudo.append(out[0].permute(1, 2, 0).numpy().copy())
        return out

    def hr_step(state, ro, rd, tgt, lr_tgt, weights, *a, **k):
        seen.append(tuple(t.numpy().copy() for t in (ro, rd, tgt, lr_tgt)))
        return real_step(state, ro, rd, tgt, lr_tgt, weights, *a, **k)

    monkeypatch.setattr(psys.guidance, "generate_sr", gen)
    monkeypatch.setattr(psys.inner, "_hr_step", hr_step)
    psys.fit(psys.init_state(), log_every=0)
    rng = np.random.default_rng(psys.cfg.seed)
    J3.sample_orbit_cameras(rng, 2)
    poses = J3.sample_orbit_cameras(rng, 2)          # the refresh at step 0
    fy = 0.5 * S / np.tan(0.5 * np.deg2rad(psys.cfg.fovy_deg))
    intr = jnp.asarray((fy, fy, S / 2.0, S / 2.0), jnp.float32)
    corners = []
    for ro, rd, tgt, lr_tgt in seen:
        v, x0, y0 = int(rng.integers(0, 2)), int(rng.integers(0, S - crop + 1)), int(rng.integers(0, S - crop + 1))
        corners.append((x0, y0))
        dy, dx = np.meshgrid(np.arange(crop), np.arange(crop), indexing="ij")
        pix = ((x0 + dy) * S + (y0 + dx)).reshape(-1).astype(np.int32)
        jo, jd = jrays(jnp.asarray(poses), intr, S, jnp.full((len(pix),), v, jnp.int32), jnp.asarray(pix))
        np.testing.assert_allclose(ro, np.asarray(jo), rtol=0, atol=1e-6)
        np.testing.assert_allclose(rd, np.asarray(jd), rtol=0, atol=1e-6)
        jt = pseudo[v][x0 : x0 + crop, y0 : y0 + crop]
        np.testing.assert_array_equal(tgt, jt)
        jl = jax.image.resize(jnp.asarray(jt)[None], (1, crop // 4, crop // 4, 3), "bilinear")[0]
        np.testing.assert_allclose(lr_tgt, np.asarray(jl), rtol=0, atol=1e-6)
    assert len(seen) == steps and len(pseudo) == 2
    assert any(x0 != y0 for x0, y0 in corners), corners


def test_generation_forces_a_low_res_snapshot():
    jsys, psys = _systems(dict(total_steps=1), low_res_scale=1)
    assert psys.inner.nerf_cfg.triplane.low_res_scale == jsys.inner.nerf_cfg.triplane.low_res_scale == 2
    assert psys.inner.cfg.sr_start_step == 0 and not psys.inner._use_sds
    jsys, psys = _systems(dict(total_steps=1, lambda_sds=0.5), low_res_scale=4)
    assert psys.inner.nerf_cfg.triplane.low_res_scale == 4
    assert not psys.inner._use_sds  # lambda_sds is parsed and unused, as in the JAX package


GEN_YAML = {
    "triplane": {"channels": 4, "resolution": 32, "wavelet_scale": 2, "low_res_scale": 2},
    "model": {"hidden_dim": 16, "hidden_dim_color": 16},
    "renderer": {"grid_size": 16, "max_steps": 32, "samples_per_ray_budget": 8},
    "system": {"kind": "generation", "total_steps": 3, "views_per_refresh": 2, "refresh_every": 2,
               "render_size": 16, "num_rays": 64, "eval_chunk": 1024},
    "guidance": {"kind": "cond", "num_inference_steps": 3},
}


def test_generation_launcher_builds_and_main_writes_jax_state(tmp_path):
    """``build`` on a data-free generation config gives (TextTo3DSystem,
    None); ``main --train`` writes ``sr_state.pkl`` with the JAX package's
    keys and shapes and the turntable (mp4, or its frames); a resize or
    oracle guidance without data raises."""
    system, scene = PLAUNCH.build(GEN_YAML, str(tmp_path / "b"), device="cpu")
    assert isinstance(system, P3.TextTo3DSystem) and scene is None
    assert system.cfg.total_steps == 3 and system.cfg.render_size == 16
    for kind in ("resize", "oracle"):
        with pytest.raises(ValueError, match="needs a data section"):
            PLAUNCH.build(dict(GEN_YAML, guidance={"kind": kind}), str(tmp_path / "b"), device="cpu")
    path = tmp_path / "gen.yaml"
    path.write_text(yaml.safe_dump(GEN_YAML))
    ws = tmp_path / "ws"
    state = PLAUNCH.main(["--config", str(path), "--train", "--workspace", str(ws), "--device", "cpu"])
    assert state.step == 3
    with open(ws / "sr_state.pkl", "rb") as f:
        payload = pickle.load(f)
    assert set(payload) == {"params", "step"} and payload["step"] == 3
    from trinerflet_tpu.sr.launch import build as jbuild

    jsys, _ = jbuild(json.loads(json.dumps(GEN_YAML)), str(tmp_path / "j"))
    lj = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jsys.init_state().params))[0]
    lp = jax.tree_util.tree_flatten_with_path(payload["params"])[0]
    assert [(k, type(v), v.dtype, v.shape) for k, v in lp] == [(k, type(v), v.dtype, v.shape) for k, v in lj]
    frames = ws / "turntable_frames"
    mp4 = ws / "turntable.mp4"
    assert (mp4.exists() and mp4.stat().st_size > 0) or len(os.listdir(frames)) == 30


TINY_T2I = dict(in_channels=4, out_channels=4, block_out_channels=(16, 32),
                down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
                cross_attention_dim=24, attention_head_dim=(2, 2), norm_num_groups=8,
                use_linear_projection=True, class_embed_type=None)


def test_text2img_generation_launcher_runs(tmp_path):
    """``system.kind: generation`` with ``guidance.kind: text2img`` from a
    tiny text-to-image checkpoint written here (a UNet and a VAE as
    ``.safetensors``, precomputed prompt embeddings): 5 finite steps
    through the port's own safetensors reader (the JAX package's
    tests/test_text2img.py recipe)."""
    from safetensors.torch import save_file

    from trinerflet_tpu_torch.sr import diffusion as D
    from trinerflet_tpu_torch.train.trainer import _leaves as tleaves

    g = torch.Generator().manual_seed(0)
    tiny_vae = D.VAEConfig(block_out_channels=(8, 16), latent_channels=4, layers_per_block=1,
                           norm_num_groups=4)
    for name, tree in (("unet", D.init_unet_params(D.UNetConfig(**TINY_T2I), g, "cpu")),
                       ("vae", D.init_vae_params(tiny_vae, g, "cpu"))):
        save_file({n: t.contiguous() for n, t in tleaves(tree)}, str(tmp_path / f"{name}.safetensors"))
    with open(tmp_path / "unet_config.json", "w") as f:
        json.dump(dict(TINY_T2I, attention_head_dim=2, class_embed_type=None), f)
    with open(tmp_path / "vae_config.json", "w") as f:
        json.dump({"in_channels": 3, "out_channels": 3, "latent_channels": 4, "block_out_channels": [8, 16],
                   "layers_per_block": 1, "norm_num_groups": 4, "scaling_factor": 0.18215}, f)
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "embeds.npz", cond=rng.standard_normal((1, 5, 24)).astype(np.float32),
             uncond=np.zeros((1, 5, 24), np.float32))
    cfg = dict(GEN_YAML, system=dict(GEN_YAML["system"], total_steps=5, refresh_every=3), guidance={
        "kind": "text2img", "num_inference_steps": 3,
        "weights": {"unet_path": str(tmp_path / "unet.safetensors"),
                    "unet_config": str(tmp_path / "unet_config.json"),
                    "vae_path": str(tmp_path / "vae.safetensors"),
                    "vae_config": str(tmp_path / "vae_config.json"),
                    "prompt_embeds": str(tmp_path / "embeds.npz")}})
    system, scene = PLAUNCH.build(cfg, str(tmp_path / "ws"), device="cpu")
    assert isinstance(system, P3.TextTo3DSystem) and scene is None
    assert isinstance(system.guidance, PG.Text2ImgGuidance)
    losses = []
    state = system.fit(system.init_state(), log_every=0,
                       callback=lambda s, a: losses.append(float(a["loss"])))
    assert len(losses) == 5 and np.isfinite(losses).all() and state.step == 5
