"""YAML-driven SR launcher (port of ``trinerflet_tpu/sr/launch.py``).

Load a YAML config (with dotlist overrides), build the scene and the system,
train, then test and write ``final_results_{step}.json``:

  python -m trinerflet_tpu_torch.sr.launch --config configs/triplane-sr.yaml --train
  python -m trinerflet_tpu_torch.sr.launch --config ... --test system.sr_start_step=0

It runs on ``cuda`` unless ``--device`` (or ``main(argv, device=...)``)
says otherwise. The checkpoint ``sr_state.pkl`` is the JAX package's
payload, a pickle of {"params": a numpy tree, "step": int}, so either
package resumes the other's run. ``data.backend: jax`` (the JAX package's
"render the ground truth on the accelerator") renders it on this package's
device. ``system.kind: generation`` builds the text-to-3D system
(``sr/text_to_3d.py``) with no data section (random orbit cameras); its
``--train`` fits, writes ``sr_state.pkl`` and renders ``turntable.mp4`` (or
its frames), and its ``--test`` renders the turntable of a fresh state, as
the JAX launcher does.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

__all__ = ["build", "build_diffusion_guidance", "main", "save_sr_state", "load_sr_state"]


def build(cfg_dict, workspace, device: DeviceLike = None):
    """(system, scene) from a config dict; ``system.kind: generation`` gives
    (``TextTo3DSystem``, None) when the config has no data section."""
    from ..models.nerf import NeRFConfig
    from ..models.triplane import TriplaneConfig
    from ..render.renderer import RenderConfig
    from .config import parse_structured
    from .data import (load_sr_blender, load_sr_llff, load_sr_scene_npz, make_synthetic_sr_scene,
                       save_sr_scene_npz)
    from .guidance import GuidanceConfig, make_cond_guidance, make_oracle_guidance, make_resize_guidance
    from .system import SRConfig, SRSystem

    device = resolve_device(device)
    sys_dict = dict(cfg_dict.get("system", {}))
    sys_kind = sys_dict.pop("kind", "sr")

    data_cfg = cfg_dict.get("data", {})
    if sys_kind == "generation" and not data_cfg:
        scene = None  # generation is data-free (random orbit cameras)
    elif data_cfg.get("synthetic", False):
        cache = data_cfg.get("cache", "")
        if cache and os.path.exists(cache):
            scene = load_sr_scene_npz(cache)
        else:
            scene = make_synthetic_sr_scene(
                num_views=data_cfg.get("num_views", 8),
                lr_size=data_cfg.get("lr_size", 32),
                scale=data_cfg.get("scale_ratio", 4),
                background_color=data_cfg.get("background_color", 0.0),
                variant=data_cfg.get("variant", "spheres"),
                backend=data_cfg.get("backend", "numpy"),
                lr_from=data_cfg.get("lr_from", "downsample"),
                device=device,
            )
            if cache:
                os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
                save_sr_scene_npz(scene, cache)
    elif data_cfg.get("llff", False):
        scene = load_sr_llff(
            data_cfg["root"],
            split=data_cfg.get("split", "train"),
            hr_downscale=data_cfg.get("hr_downscale", 4),
            scale_ratio=data_cfg.get("scale_ratio", 4),
            llff_hold=data_cfg.get("llff_hold", 8),
            ndc=data_cfg.get("ndc", True),
        )
    else:
        scene = load_sr_blender(
            data_cfg["root"],
            split=data_cfg.get("split", "train"),
            hr_downscale=data_cfg.get("hr_downscale", 1),
            scale_ratio=data_cfg.get("scale_ratio", 4),
            background_color=data_cfg.get("background_color", 0.0),
            data_scale=data_cfg.get("data_scale", 0.33),
        )

    tri_cfg = cfg_dict.get("triplane", {})
    tri = TriplaneConfig(
        channels=tri_cfg.get("channels", 16),
        resolution=tri_cfg.get("resolution", 1024),
        wavelet_scale=tri_cfg.get("wavelet_scale", 16),
        wavelet_type=tri_cfg.get("wavelet_type", "bior6.8"),
        low_res_scale=tri_cfg.get("low_res_scale", 4),
    )
    model_cfg = cfg_dict.get("model", {})
    nerf_cfg = NeRFConfig(
        triplane=tri,
        bound=model_cfg.get("bound", 1.0),
        hidden_dim=model_cfg.get("hidden_dim", 64),
        hidden_dim_color=model_cfg.get("hidden_dim_color", 64),
        compute_dtype=model_cfg.get("compute_dtype", "float32"),
    )
    rnd = cfg_dict.get("renderer", {})
    render_cfg = RenderConfig(
        bound=model_cfg.get("bound", 1.0),
        grid_size=rnd.get("grid_size", 128),
        density_thresh=rnd.get("density_thresh", 1.0),
        max_steps=rnd.get("max_steps", 512),
        samples_per_ray_budget=rnd.get("samples_per_ray_budget", 24),
    )
    g_dict = dict(cfg_dict.get("guidance", {}))
    g_kind = g_dict.pop("kind", "resize")
    weights = g_dict.pop("weights", {})  # checkpoint paths for 'diffusion'
    gcfg = parse_structured(GuidanceConfig, g_dict)
    if g_kind in ("oracle", "resize") and scene is None:
        raise ValueError(f"{g_kind} guidance needs a data section")
    if g_kind == "oracle":
        target = torch.from_numpy(np.ascontiguousarray(scene.hr.images[..., :3]).mean(0))
        guidance = make_oracle_guidance(gcfg, target.permute(2, 0, 1)[None].to(device))
    elif g_kind == "resize":
        guidance = make_resize_guidance(gcfg, scale=scene.scale)
    elif g_kind == "cond":
        guidance = make_cond_guidance(gcfg)
    elif g_kind in ("diffusion", "text2img"):
        guidance = build_diffusion_guidance(gcfg, weights, workspace, kind=g_kind, device=device)
    else:
        raise ValueError(f"unknown guidance kind {g_kind!r}")

    if sys_kind == "generation":
        from .text_to_3d import TextTo3DConfig, TextTo3DSystem

        system = TextTo3DSystem(nerf_cfg, render_cfg, parse_structured(TextTo3DConfig, sys_dict),
                                guidance, workspace=workspace, device=device)
        return system, scene

    sys_cfg = parse_structured(SRConfig, sys_dict)
    lpips_params = None
    lp = cfg_dict.get("lpips", {})
    if lp.get("backbone_path") and lp.get("lin_path"):
        from ..utils.lpips import load_any, load_torch_state_dict

        lpips_params = load_torch_state_dict(load_any(lp["backbone_path"]), load_any(lp["lin_path"]),
                                             net=lp.get("net", "vgg"), device=device)
    system = SRSystem(nerf_cfg, render_cfg, sys_cfg, guidance, workspace=workspace,
                      lpips_params=lpips_params, lpips_net=lp.get("net", "vgg"), device=device)
    return system, scene


def build_diffusion_guidance(gcfg, weights: dict, workspace: str, kind: str = "diffusion",
                             device: DeviceLike = None):
    """Diffusion guidance from a diffusers checkpoint layout:
    unet/{config.json, *.safetensors}, vae/{...}, text_encoder/{config.json,
    *.safetensors}, tokenizer/{vocab.json, merges.txt} (or precomputed
    ``prompt_embeds`` npz with ``cond`` / ``uncond``). ``kind="diffusion"``:
    the SD x4 upscaler (LR-conditioned, noise-level class embedding);
    ``"text2img"``: an SD2-style text-to-image prior."""
    from .diffusion import (load_safetensors_params, make_text2img_denoiser, make_unet_denoiser,
                            unet_config_from_json, vae_config_from_json, vae_decode, vae_encode)
    from .guidance import Text2ImgGuidance, UpscalerGuidance
    from .text import CLIPTokenizer, PromptProcessor, TextConfig

    device = resolve_device(device)
    unet_cfg = unet_config_from_json(weights["unet_config"])
    unet_params = load_safetensors_params(weights["unet_path"], device=device)
    vae_cfg = vae_config_from_json(weights["vae_config"])
    vae_params = load_safetensors_params(weights["vae_path"], device=device)

    if weights.get("text_encoder_path"):
        pp = PromptProcessor(weights.get("prompt", ""), weights.get("negative_prompt", ""),
                             params=load_safetensors_params(weights["text_encoder_path"], device=device),
                             cfg=TextConfig.from_json(weights["text_config"]),
                             tokenizer=CLIPTokenizer(weights["tokenizer_vocab"],
                                                     weights["tokenizer_merges"]),
                             cache_dir=workspace, device=device)
        cond, uncond = pp()
    else:  # embeddings computed elsewhere
        z = np.load(weights["prompt_embeds"])
        cond, uncond = (torch.from_numpy(z[k]).to(device) for k in ("cond", "uncond"))

    def encode(x):
        with torch.no_grad():
            return vae_encode(vae_params, vae_cfg, 2.0 * x - 1.0)

    def decode(z):
        with torch.no_grad():
            return 0.5 * (vae_decode(vae_params, vae_cfg, z) + 1.0)

    if kind == "text2img":
        return Text2ImgGuidance(gcfg, make_text2img_denoiser(unet_params, unet_cfg, cond, uncond),
                                encode=encode, decode=decode)
    return UpscalerGuidance(gcfg, make_unet_denoiser(unet_params, unet_cfg, cond, uncond),
                            encode=encode, decode=decode)


def save_sr_state(path: str, state) -> None:
    """Write {"params": numpy tree, "step": int} atomically (a crash never
    truncates the file)."""
    from ..train.trainer import _map

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"params": _map(lambda t: t.detach().cpu().numpy(), state.params),
                     "step": int(state.step)}, f)
    os.replace(tmp, path)


def load_sr_state(path: str, state, device: DeviceLike = None):
    """``state`` with the params and step of an ``sr_state.pkl`` written by
    either package (read with the checkpoint reader, which takes numpy
    arrays and nothing else); Adam starts afresh, as in the JAX package."""
    from ..carry import params_from_jax
    from ..train import checkpoint
    from ..train.trainer import _fresh_adam, _map

    payload = checkpoint.load(path)
    params = _map(lambda t: t.requires_grad_(True),
                  params_from_jax(payload["params"], resolve_device(device)))
    return state._replace(params=params, opt_state=_fresh_adam(params), step=int(payload["step"]))


def main(argv=None, device: DeviceLike = None):
    from ..render.renderer import mark_untrained_grid
    from .config import apply_overrides, load_yaml_config

    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--train", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--workspace", default=None)
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    device = resolve_device(args.device or device)

    cfg = apply_overrides(load_yaml_config(args.config), args.overrides)
    workspace = args.workspace or cfg.get("workspace", "sr_workspace")
    os.makedirs(workspace, exist_ok=True)
    system, scene = build(cfg, workspace, device)
    ckpt = os.path.join(workspace, "sr_state.pkl")

    from .text_to_3d import TextTo3DSystem

    if isinstance(system, TextTo3DSystem):
        state = system.init_state()
        if args.train:
            state = system.fit(state)
            save_sr_state(ckpt, state)
        if args.test or args.train:
            out = system.render_turntable(state, os.path.join(workspace, "turntable.mp4"))
            print(f"turntable -> {out}")
        return state

    grid = None
    if getattr(scene.lr, "poses", None) is not None:
        # cull the occupancy grid to the LR cameras' frusta
        grid = mark_untrained_grid(scene.lr.poses, scene.lr.intrinsics, system.render_cfg)
    state = system.init_state(density_grid=grid)
    if os.path.exists(ckpt):
        state = system._update_grid(load_sr_state(ckpt, state, device))
        print(f"resumed from {ckpt} at step {state.step}")

    if args.train:
        count = [0]

        def _cb(st, aux):  # a checkpoint every 1000 steps
            count[0] += 1
            if count[0] % 1000 == 0:
                save_sr_state(ckpt, st)

        state = system.fit(state, scene, callback=_cb)
        save_sr_state(ckpt, state)
    if args.test or args.train:
        res = system.evaluate(state, scene)
        print(f"LR PSNR {res['PSNR_lr']:.3f} | HR PSNR {res['PSNR_hr']:.3f} "
              f"(bilinear {res['PSNR_bilinear']:.3f}) | HR SSIM {res['SSIM_hr']:.4f}")
    return state


if __name__ == "__main__":
    main()
