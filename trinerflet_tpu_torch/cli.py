"""Command-line entry point of the port: multiscale wavelet-triplane NeRF
reconstruction (port of ``trinerflet_tpu/cli.py``).

    python -m trinerflet_tpu_torch.cli --path <scene> --workspace <dir> -O \
        --triplane_wavelet --bound 1.5 --dt_gamma 0 --iters 1000 5000 \
        --num_rays 20000 60000 --triplane_resolution 512 1024 \
        --triplane_wavelet_levels 8 16 --triplane_channels 16 \
        --wavelet_regularization 0.2
    python -m trinerflet_tpu_torch.cli --path <scene> --workspace <dir> -O \
        --triplane_wavelet ... --test --test_with_ema

The JAX CLI's flags with their meanings: list-valued stage keys
(``STAGE_KEYS``) are broadcast per stage; each stage after the first grows
from ``latest_model.pkl``; ``--test`` evaluates a checkpoint, exports the
mesh, renders the test views as a video (or a PNG sequence) and, with
``--save_planes``, dumps the planes instead. ``-O`` means ``--fp16
--cuda_ray --preload``: bfloat16 planes and MLPs on the occupancy-grid
renderer.

``--gui`` serves the HTTP orbit viewer (``utils/gui.py``) while training
the first stage, or with ``--test`` over ``latest_model.pkl`` until
``/stop``; ``--rand_pose k`` adds CLIP-guided steps on random poses
(``utils/clip_loss.py``) from the ``--clip_ckpt`` directory (a transformers
``CLIPModel``: ``config.json``, ``*.safetensors`` or ``*.bin``,
``vocab.json``, ``merges.txt``).

Differences from the JAX CLI: ``run`` and ``main`` take ``device`` (None:
``cuda``, which raises without a card; the tests pass ``"cpu"``); there is
no ``JAX_PLATFORMS`` handling; a failed mesh export raises instead of
printing; the CLIP loss is built once, before the first stage (the JAX CLI
builds it in each stage), so a missing ``--clip_ckpt`` raises before any
work.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import time

import numpy as np
import torch

from ._device import resolve_device
from .data.images import write_png


def get_params(argv=None):
    parser = argparse.ArgumentParser(description="trinerflet_tpu_torch reconstruction")
    parser.add_argument("--path", type=str, default=None)
    parser.add_argument("-O", action="store_true", help="equals --fp16 --cuda_ray --preload")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--workspace", type=str, default="workspace")
    parser.add_argument("--seed", type=int, default=0)

    # training
    parser.add_argument("--iters", type=int, nargs="+", default=[30000])
    parser.add_argument("--lr", type=float, nargs="+", default=[1e-2])
    parser.add_argument("--ckpt", type=str, default="latest",
                        help="latest | best | explicit checkpoint path (test mode)")
    parser.add_argument("--max_keep_ckpt", type=int, default=2,
                        help="rotating periodic checkpoints to keep "
                             "(reference utils.py:1419-1425)")
    parser.add_argument("--num_rays", type=int, nargs="+", default=[4096])
    parser.add_argument("--cuda_ray", action="store_true",
                        help="use occupancy-grid accelerated marching")
    parser.add_argument("--nerfacc_renderer", action="store_true",
                        help="alternative estimator renderer (reference "
                        "--nerfacc_renderer); pick with --nerfacc_estimator")
    parser.add_argument("--nerfacc_estimator", type=str, default="proposal",
                        choices=["occgrid", "proposal", "importance"])
    parser.add_argument("--max_steps", type=int, default=1024)
    parser.add_argument("--num_steps", type=int, default=512)
    parser.add_argument("--upsample_steps", type=int, default=0)
    parser.add_argument("--update_extra_interval", type=int, default=16)
    parser.add_argument("--max_ray_batch", type=int, default=4096)

    # backbone
    parser.add_argument("--fp16", action="store_true", help="bfloat16 matmuls and planes")

    # dataset
    parser.add_argument("--data_format", type=str, default="auto",
                        choices=["auto", "blender", "colmap", "llff", "nsvf",
                                 "nerfpp", "topia", "rtmv"],
                        help="dataset dispatch (reference get_dataset, "
                        "provider.py:382-388); auto sniffs the directory")
    parser.add_argument("--llff_hold", type=int, default=8,
                        help="hold out every Nth view for val/test (LLFF/colmap)")
    parser.add_argument("--llff_spherify", action="store_true")
    parser.add_argument("--llff_ndc", action="store_true",
                        help="NDC ray parameterization for LLFF scenes")
    parser.add_argument("--llff_downscale", type=int, default=8,
                        help="LLFF image minification factor")
    parser.add_argument("--topia_poses_fname", type=str, default="",
                        help="directory of per-image pose txt files (topia)")
    parser.add_argument("--topia_render_res", type=int, default=128)
    parser.add_argument("--color_space", type=str, default="srgb")
    parser.add_argument("--preload", action="store_true")
    parser.add_argument("--bound", type=float, default=2)
    parser.add_argument("--scale", type=float, default=0.33)
    parser.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    parser.add_argument("--dt_gamma", type=float, default=1 / 128)
    parser.add_argument("--min_near", type=float, default=0.2)
    parser.add_argument("--density_thresh", type=float, default=10)
    parser.add_argument("--bg_radius", type=float, default=-1)

    # TriNeRFLet
    parser.add_argument("--triplane_wavelet", action="store_true")
    parser.add_argument("--wavelet_regularization", type=float, nargs="+", default=[0.1])
    parser.add_argument("--weighted_regularization", action="store_true")
    parser.add_argument("--save_every", type=int, default=1)
    parser.add_argument("--background_color", type=float, default=0)
    parser.add_argument("--train_rand_bg", action="store_true")
    parser.add_argument("--rand_pose", type=int, default=-1,
                        help="semi-supervised CLIP mode (reference utils.py:500): "
                             "-1 off, 0 CLIP-only, k>0 one CLIP step per k supervised")
    parser.add_argument("--clip_text", type=str, default="",
                        help="text prompt for --rand_pose CLIP guidance")
    parser.add_argument("--clip_ckpt", type=str, default="",
                        help="dir with a transformers CLIPModel checkpoint "
                             "(config.json + model.safetensors + vocab/merges)")
    # GUI (reference gui.py dearpygui viewer; here an HTTP orbit viewer)
    parser.add_argument("--gui", action="store_true",
                        help="serve an interactive orbit viewer over HTTP "
                             "while training (or viewing, with --test)")
    parser.add_argument("--gui_port", type=int, default=7860)
    parser.add_argument("--W", type=int, default=400, help="GUI render width")
    parser.add_argument("--H", type=int, default=400, help="GUI render height")
    parser.add_argument("--radius", type=float, default=2.0,
                        help="GUI orbit camera radius")
    parser.add_argument("--fovy", type=float, default=60.0)
    parser.add_argument("--error_map", action="store_true",
                        help="error-guided ray sampling")
    parser.add_argument("--triplane_channels", type=int, default=16)
    parser.add_argument("--triplane_resolution", type=int, nargs="+", default=[2048])
    parser.add_argument("--triplane_wavelet_levels", type=int, nargs="+", default=[128])
    parser.add_argument("--hidden_dim", type=int, default=64)
    parser.add_argument("--hidden_dim_color", type=int, default=64)
    parser.add_argument("--hidden_dim_bg", type=int, default=64)
    parser.add_argument("--save_planes", action="store_true")
    parser.add_argument("--sched_base", type=float, default=0.1)
    parser.add_argument("--sched_exp", type=float, default=2.5)
    parser.add_argument("--downscale", type=int, nargs="+", default=[1])
    parser.add_argument("--warmup_steps", type=int, nargs="+", default=[0])
    parser.add_argument("--warmup_factor", type=float, default=1e-3)
    parser.add_argument("--ema_decay", type=float, default=0.95)
    parser.add_argument("--test_with_ema", action="store_true")
    parser.add_argument("--fast_training", action="store_true")
    parser.add_argument("--mute", action="store_true")
    parser.add_argument("--wavelet_type", type=str, default="bior6.8")
    parser.add_argument("--wavelet_base_resolution", type=int, default=0)
    parser.add_argument("--triplane_rotation", action="store_true",
                        help="learnable global rotation of sample coords "
                        "(reference triplane_encoder.py:335-362)")
    parser.add_argument("--lbound_auto_scale", action="store_true",
                        help="learnable zoom of the plane extent "
                        "(reference triplane_encoder.py:304-312)")
    parser.add_argument("--upscale_ratio_bound", type=float, nargs="+", default=[-1])
    parser.add_argument("--upscale_levels", type=int, nargs="+", default=[2])
    parser.add_argument("--huber_loss", action="store_true")
    parser.add_argument("--density_scale", type=float, default=1)
    parser.add_argument("--alpha_bce", type=float, default=0)
    parser.add_argument("--density_blob_scale", type=float, default=0)
    parser.add_argument("--density_blob_std", type=float, default=0.5)
    parser.add_argument("--z_variance_reg", type=float, default=-1)
    parser.add_argument("--mlp_weight_decay", type=float, default=-1)

    # performance knobs
    parser.add_argument("--samples_per_ray_budget", type=int, default=24,
                        help="static compaction budget per ray (occgrid path)")
    parser.add_argument("--no_budget_autotune", action="store_true",
                        help="disable shrinking the per-ray budget to the "
                             "live p99 sample demand")
    parser.add_argument("--eval_samples_per_ray", type=int, default=0,
                        help="deep test-time budget (reference --max_steps 4096 "
                        "eval); 0 = same as training budget")
    parser.add_argument("--eval_interval_stages", type=int, default=0,
                        help="evaluate 2 val views every N steps during training "
                        "and log wall-clock (time-to-PSNR curves; 0=end only)")

    return parser.parse_args(argv)


def detect_data_format(root: str) -> str:
    """Sniff the dataset layout (reference get_dataset dispatch is flag-driven,
    provider.py:382-388; we also auto-detect from the directory contents)."""
    if os.path.exists(os.path.join(root, "transforms_train.json")) or os.path.exists(
        os.path.join(root, "transforms.json")
    ):
        return "blender"
    if os.path.exists(os.path.join(root, "poses_bounds.npy")):
        return "llff"
    if os.path.isdir(os.path.join(root, "sparse", "0")):
        return "colmap"
    if os.path.isdir(os.path.join(root, "rgb")) and os.path.isdir(os.path.join(root, "pose")):
        return "nsvf"
    if os.path.isdir(os.path.join(root, "train", "rgb")):
        return "nerfpp"
    if os.path.exists(os.path.join(root, "00000.json")) and os.path.isdir(
        os.path.join(root, "images")
    ):
        return "rtmv"
    raise ValueError(f"cannot auto-detect dataset format under {root}; "
                     f"pass --data_format explicitly")


def load_scene(opt, split: str):
    """Dataset dispatch: opt.data_format -> the matching loader, normalized to
    a trainer-consumable scene (SceneData or LLFFScene)."""
    fmt = opt.data_format
    if fmt == "auto":
        fmt = detect_data_format(opt.path)
    if fmt == "blender":
        from .data.blender import load_blender

        return load_blender(opt.path, split, downscale=opt.downscale,
                            scale=opt.scale, offset=tuple(opt.offset))
    if fmt == "llff":
        from .data.llff import load_llff_scene

        ds = opt.llff_downscale if opt.downscale == 1 else opt.downscale
        return load_llff_scene(opt.path, split, downscale=ds,
                               llff_hold=opt.llff_hold,
                               spherify=opt.llff_spherify, ndc=opt.llff_ndc)
    if fmt == "colmap":
        from .data.colmap import load_colmap_scene

        return load_colmap_scene(opt.path, downscale=opt.downscale,
                                 scale=opt.scale, offset=tuple(opt.offset),
                                 hold_every=opt.llff_hold, split=split)
    if fmt == "nsvf":
        from .data.formats import load_nsvf_scene

        return load_nsvf_scene(opt.path, split, downscale=opt.downscale,
                               scale=opt.scale, offset=tuple(opt.offset))
    if fmt == "nerfpp":
        from .data.formats import load_nerfpp_scene

        return load_nerfpp_scene(opt.path, split, downscale=opt.downscale,
                                 scale=opt.scale, offset=tuple(opt.offset))
    if fmt == "rtmv":
        from .data.formats import load_rtmv_scene

        return load_rtmv_scene(opt.path, split, downscale=opt.downscale,
                               scale=opt.scale, offset=tuple(opt.offset))
    if fmt == "topia":
        from .data.formats import load_topia_scene

        poses_dir = opt.topia_poses_fname or os.path.join(opt.path, "poses")
        return load_topia_scene(opt.path, poses_dir, downscale=opt.downscale,
                                render_res=opt.topia_render_res)
    raise ValueError(fmt)


STAGE_KEYS = [
    "iters", "num_rays", "triplane_resolution", "triplane_wavelet_levels",
    "downscale", "warmup_steps", "lr", "wavelet_regularization",
    "upscale_ratio_bound", "upscale_levels",
]


def build_configs(opt):
    """One stage's flat opt -> (NeRFConfig, RenderConfig, TrainConfig)."""
    from .models.nerf import NeRFConfig
    from .models.triplane import TriplaneConfig
    from .render.renderer import RenderConfig
    from .train.trainer import TrainConfig

    tri = TriplaneConfig(
        channels=opt.triplane_channels,
        resolution=opt.triplane_resolution,
        wavelet_scale=opt.triplane_wavelet_levels,
        wavelet_type=opt.wavelet_type,
        wavelet_base_resolution=opt.wavelet_base_resolution,
        learned_rotation=opt.triplane_rotation,
        lbound_auto_scale=opt.lbound_auto_scale,
        upscale_ratio_bound=opt.upscale_ratio_bound,
        upscale_levels=opt.upscale_levels,
    )
    nerf_cfg = NeRFConfig(
        triplane=tri,
        bound=opt.bound,
        hidden_dim=opt.hidden_dim,
        hidden_dim_color=opt.hidden_dim_color,
        density_scale=opt.density_scale,
        density_blob_scale=opt.density_blob_scale,
        density_blob_std=opt.density_blob_std,
        bg_radius=opt.bg_radius,
        num_layers_bg=2,
        hidden_dim_bg=opt.hidden_dim_bg,
        compute_dtype="bfloat16" if opt.fp16 else "float32",
        plane_dtype="bfloat16" if opt.fp16 else "float32",
    )
    render_cfg = RenderConfig(
        bound=opt.bound,
        density_thresh=opt.density_thresh,
        min_near=opt.min_near,
        max_steps=opt.max_steps,
        num_steps=opt.num_steps,
        upsample_steps=(
            max(opt.upsample_steps, 64)
            if (opt.nerfacc_renderer and opt.nerfacc_estimator == "importance")
            else opt.upsample_steps
        ),
        dt_gamma=opt.dt_gamma,
        density_scale=opt.density_scale,
        bg_radius=opt.bg_radius,
        samples_per_ray_budget=opt.samples_per_ray_budget,
        eval_samples_per_ray=opt.eval_samples_per_ray,
    )
    train_cfg = TrainConfig(
        lr=opt.lr,
        iters=opt.iters,
        warmup_steps=opt.warmup_steps,
        warmup_factor=opt.warmup_factor,
        sched_base=opt.sched_base,
        sched_exp=opt.sched_exp,
        num_rays=opt.num_rays,
        ema_decay=opt.ema_decay,
        wavelet_regularization=opt.wavelet_regularization if opt.triplane_wavelet else 0.0,
        weighted_regularization=opt.weighted_regularization,
        background_color=opt.background_color,
        train_rand_bg=opt.train_rand_bg,
        criterion="huber" if opt.huber_loss else "mse",
        alpha_bce=opt.alpha_bce,
        error_map=opt.error_map,
        z_variance_reg=opt.z_variance_reg,
        mlp_weight_decay=opt.mlp_weight_decay,
        update_extra_interval=opt.update_extra_interval,
        renderer=(
            {"occgrid": "occgrid", "proposal": "proposal", "importance": "dense"}
            [opt.nerfacc_estimator]
            if opt.nerfacc_renderer
            else ("occgrid" if opt.cuda_ray else "dense")
        ),
        eval_chunk=opt.max_ray_batch,
        budget_autotune=not opt.no_budget_autotune,
        seed=opt.seed,
    )
    return nerf_cfg, render_cfg, train_cfg


def save_triplane_pngs(params, out_dir, tag="plane"):
    """Plane dumps: per plane, the channel mean of the base plane and the
    mean |coefficient| of each wavelet level, normalised to 8-bit grey
    PNGs."""
    os.makedirs(out_dir, exist_ok=True)
    for name, arr in params["encoder"].items():
        if name == "base":
            planes = arr.detach().float().cpu().numpy()  # (3, C, h, w)
            for p in range(3):
                img = planes[p].mean(0)
                img = (img - img.min()) / (img.max() - img.min() + 1e-9)
                write_png(os.path.join(out_dir, f"{tag}_base_{p}.png"), (img * 255).astype(np.uint8))
        elif name == "wavelets":
            for lvl, coefs in arr.items():
                c = np.abs(coefs.detach().float().cpu().numpy()).mean(axis=(1, 2))  # (3, s, s)
                for p in range(3):
                    img = c[p] / (c[p].max() + 1e-9)
                    write_png(os.path.join(out_dir, f"{tag}_{lvl}_{p}.png"),
                              (img * 255).astype(np.uint8))


def write_video(path, frames, fps=25):
    """mp4 through imageio when it is installed, else through cv2; where
    neither writes one, a PNG sequence in ``<path stem>_frames/``. Returns
    the path written."""
    try:
        import imageio

        imageio.mimwrite(path, frames, fps=fps, quality=8, macro_block_size=1)
        return path
    except Exception:  # no imageio, or no ffmpeg backend: the next writer
        pass
    try:
        import cv2

        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        ok = vw.isOpened()
        for f in frames:
            vw.write(f[..., ::-1])
        vw.release()
        if ok and os.path.getsize(path) > 0:
            return path
    except Exception:  # no cv2, or no encoder: the PNG sequence
        pass
    seq_dir = os.path.splitext(path)[0] + "_frames"
    os.makedirs(seq_dir, exist_ok=True)
    for i, f in enumerate(frames):
        write_png(os.path.join(seq_dir, f"{i:04d}.png"), f)
    return seq_dir


def _build_clip_loss(opt, device=None):
    """``CLIPLoss`` from the ``--clip_ckpt`` directory of a transformers
    ``CLIPModel``: ``config.json``, the weights as ``*.safetensors`` (read
    with the port's own reader) or ``*.bin`` (``torch.load`` with
    ``weights_only``), and the tokenizer's ``vocab.json`` and
    ``merges.txt``; the ``--clip_text`` prompt (default "an object")
    embedded once. No CLIP weights are in the repository."""
    import glob
    import json

    from .sr.diffusion import read_safetensors
    from .sr.text import CLIPTokenizer, TextConfig
    from .utils.clip_loss import CLIPLoss, VisionConfig, state_dict_to_tree

    d = opt.clip_ckpt
    if not d or not os.path.isdir(d):
        raise NotImplementedError(
            "--rand_pose needs --clip_ckpt <dir> with a CLIP ViT checkpoint (config.json, "
            "*.safetensors or *.bin, vocab.json, merges.txt); none is in the repository")
    cfg_path = os.path.join(d, "config.json")
    vcfg = VisionConfig.from_json(cfg_path)
    with open(cfg_path) as f:
        tc = json.load(f).get("text_config", {})
    tcfg = TextConfig(
        vocab_size=tc.get("vocab_size", 49408),
        hidden_size=tc.get("hidden_size", 512),
        num_layers=tc.get("num_hidden_layers", 12),
        num_heads=tc.get("num_attention_heads", 8),
        intermediate_size=tc.get("intermediate_size", 2048),
        max_length=tc.get("max_position_embeddings", 77),
        hidden_act=tc.get("hidden_act", "quick_gelu"),
    )
    st = sorted(glob.glob(os.path.join(d, "*.safetensors")))
    if st:
        flat = read_safetensors(st[0])
    else:
        flat = torch.load(sorted(glob.glob(os.path.join(d, "*.bin")))[0], map_location="cpu",
                          weights_only=True)
    tok = CLIPTokenizer(os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt"), tcfg.max_length)
    loss = CLIPLoss(params=state_dict_to_tree(flat, device=device), vision_cfg=vcfg, text_cfg=tcfg,
                    tokenizer=tok)
    loss.prepare_text([opt.clip_text or "an object"])
    return loss


def run_stage(opt, stage_idx, prev_cfgs, device=None, clip_loss=None):
    """One stage: build the trainer (with CLIP guidance every
    ``--rand_pose`` steps when ``clip_loss`` is given), grow from
    ``latest_model.pkl`` after the first stage (else cull the untrained
    grid cells), ``fit`` with the periodic evaluation and rotating
    checkpoints of ``--eval_interval_stages``, save ``latest_model.pkl``
    and ``stage_<i>.pkl``, evaluate on the val split. Returns (configs,
    trainer, state)."""
    from .render.renderer import mark_untrained_grid
    from .train.trainer import Trainer

    nerf_cfg, render_cfg, train_cfg = build_configs(opt)
    trainer = Trainer(nerf_cfg, render_cfg, train_cfg, device=device, workspace=opt.workspace)
    if clip_loss is not None:
        trainer.set_clip_guidance(clip_loss, opt.rand_pose)

    scene = load_scene(opt, "train")
    ckpt_path = os.path.join(opt.workspace, "latest_model.pkl")
    if stage_idx > 0 and os.path.exists(ckpt_path) and prev_cfgs is not None:
        print(f"[stage {stage_idx}] growing from {ckpt_path}")
        state = trainer.load_model_for_stage(ckpt_path, None, prev_cfgs[0])
    elif getattr(scene, "poses", None) is not None:
        grid = mark_untrained_grid(scene.poses, scene.intrinsics, render_cfg)
        state = trainer.init_state(density_grid=grid)
    else:  # pregenerated-ray scenes (LLFF / NDC) have no pinhole poses to cull with
        state = trainer.init_state()

    callback = None
    if opt.eval_interval_stages > 0 and not opt.fast_training:
        try:
            val_full = load_scene(opt, "val")
        except FileNotFoundError:
            val_full = None
        if val_full is not None:
            if getattr(val_full, "poses", None) is not None:
                val_mini = dataclasses.replace(val_full, images=val_full.images[:2],
                                               poses=val_full.poses[:2])
            else:
                val_mini = dataclasses.replace(val_full, images=val_full.images[:2],
                                               rays_o=val_full.rays_o[:2],
                                               rays_d=val_full.rays_d[:2])
            t_start = time.time()
            kept_ckpts = []   # the rotating periodic checkpoints
            best = {"psnr": -1.0}

            def callback(st, aux):
                step = int(st.step)
                if step % opt.eval_interval_stages == 0:
                    r = trainer.evaluate(st, val_mini, use_ema=opt.test_with_ema,
                                         tag=f"t2p_{step}")
                    print(f"[t2p] step {step:6d} wall {time.time() - t_start:7.1f}s "
                          f"val PSNR {r['PSNR']:.2f}", flush=True)
                    cp = os.path.join(opt.workspace, f"ckpt_{step:06d}.pkl")
                    trainer.save_checkpoint(st, cp)
                    kept_ckpts.append(cp)
                    while len(kept_ckpts) > opt.max_keep_ckpt:
                        old = kept_ckpts.pop(0)
                        if os.path.exists(old):
                            os.remove(old)
                    if r["PSNR"] > best["psnr"]:
                        best["psnr"] = r["PSNR"]
                        trainer.save_checkpoint(st, os.path.join(opt.workspace, "best_model.pkl"))

    state = trainer.fit(state, scene, log_every=0 if opt.mute else 100, callback=callback)
    trainer.save_checkpoint(state, ckpt_path)
    trainer.save_checkpoint(state, os.path.join(opt.workspace, f"stage_{stage_idx}.pkl"))

    if not opt.fast_training:
        try:
            val = load_scene(opt, "val")
        except FileNotFoundError:
            val = None
        if val is not None:
            res = trainer.evaluate(state, val, use_ema=opt.test_with_ema,
                                   tag=f"results_stage{stage_idx}")
            print(f"[stage {stage_idx}] val PSNR={res['PSNR']:.3f} SSIM={res['SSIM']:.4f}")
    return (nerf_cfg, render_cfg, train_cfg), trainer, state


def run_gui(opt, device=None):
    """``--gui``: with ``--test``, serve frames of ``latest_model.pkl`` until
    ``/stop``; else train the stage's configuration through the viewer's
    train loop (``cfg.iters`` steps or until ``/stop``) and save
    ``latest_model.pkl``. Returns (trainer, state)."""
    from .render.renderer import mark_untrained_grid
    from .train.trainer import Trainer
    from .utils.gui import NeRFGUI

    nerf_cfg, render_cfg, train_cfg = build_configs(opt)
    trainer = Trainer(nerf_cfg, render_cfg, train_cfg, device=device, workspace=opt.workspace)
    ckpt_path = os.path.join(opt.workspace, "latest_model.pkl")
    if opt.test:
        state = trainer.load_checkpoint(ckpt_path)
        gui = NeRFGUI(trainer, state, W=opt.W, H=opt.H, radius=opt.radius, fovy=opt.fovy,
                      port=opt.gui_port)
        print(f"[gui] viewing on http://127.0.0.1:{gui.port}/ (GET /stop to quit)", flush=True)
        gui.test_loop()
        gui.close()
        return trainer, state
    scene = load_scene(opt, "train")
    if getattr(scene, "poses", None) is not None:
        grid = mark_untrained_grid(scene.poses, scene.intrinsics, render_cfg)
        state = trainer.init_state(density_grid=grid)
    else:
        state = trainer.init_state()
    gui = NeRFGUI(trainer, state, W=opt.W, H=opt.H, radius=opt.radius, fovy=opt.fovy,
                  port=opt.gui_port)
    print(f"[gui] training on http://127.0.0.1:{gui.port}/ (GET /stop to quit)", flush=True)
    state = gui.train_loop(scene)
    trainer.save_checkpoint(state, ckpt_path)
    gui.close()
    return trainer, state


def run_test(opt, device=None):
    """``--test``: load ``--ckpt`` (latest | best | a path), then either dump
    the planes (``--save_planes``) or evaluate the test split into
    ``test_renders/``, export ``mesh.obj`` (resolution 192, threshold 10)
    and write the test views as ``test_video.mp4`` (or its frames). Returns
    (trainer, state)."""
    from .train.trainer import Trainer

    nerf_cfg, render_cfg, train_cfg = build_configs(opt)
    trainer = Trainer(nerf_cfg, render_cfg, train_cfg, device=device, workspace=opt.workspace)
    if opt.ckpt in ("latest", "best"):
        ckpt_path = os.path.join(opt.workspace, f"{opt.ckpt}_model.pkl")
        if opt.ckpt == "best" and not os.path.exists(ckpt_path):
            print("[WARN] no best_model.pkl (best tracking requires "
                  "--eval_interval_stages > 0); falling back to latest")
            ckpt_path = os.path.join(opt.workspace, "latest_model.pkl")
    else:
        ckpt_path = opt.ckpt
    state = trainer.load_checkpoint(ckpt_path)

    if opt.save_planes:
        save_triplane_pngs(state.params, os.path.join(opt.workspace, "planes"))
        return trainer, state

    test = load_scene(opt, "test")
    res = trainer.evaluate(state, test, use_ema=opt.test_with_ema,
                           save_dir=os.path.join(opt.workspace, "test_renders"), tag="results")
    print(f"test PSNR={res['PSNR']:.3f} SSIM={res['SSIM']:.4f}")
    trainer.save_mesh(state, os.path.join(opt.workspace, "mesh.obj"), resolution=192,
                      threshold=10.0)

    frames = []
    params = state.ema_params if opt.test_with_ema else state.params
    for v in range(test.num_views):
        if getattr(test, "poses", None) is not None:
            img, _ = trainer.render_image(params, state.occ, test.poses[v], test.intrinsics,
                                          test.H, test.W)
        else:
            img, _ = trainer.render_rays(params, state.occ, test.rays_o[v], test.rays_d[v],
                                         test.H, test.W)
        frames.append((img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
    write_video(os.path.join(opt.workspace, "test_video.mp4"), frames, fps=25)
    return trainer, state


def run(opt, device=None):
    """Train the stages, or with ``--test`` evaluate a checkpoint, or with
    ``--gui`` run the viewer (the first stage's keys, or with ``--test`` the
    last's), on ``device`` (None: ``cuda``). Returns the last stage's (or
    the test's, or the viewer's) (trainer, state)."""
    device = resolve_device(device)
    if opt.path is None or not os.path.exists(opt.path):
        raise FileNotFoundError(f"--path {opt.path!r} does not exist")
    if opt.O:
        opt.fp16 = True
        opt.cuda_ray = True
        opt.preload = True

    opt_vars = vars(opt)
    length = max(len(opt_vars[k]) for k in STAGE_KEYS)
    for k in STAGE_KEYS:
        if len(opt_vars[k]) not in (1, length):
            raise ValueError(f"--{k} has {len(opt_vars[k])} values; give 1 or {length}")

    if opt.gui:
        o = copy.deepcopy(opt)
        for k in STAGE_KEYS:
            vars(o)[k] = opt_vars[k][-1] if opt.test else opt_vars[k][0]
        return run_gui(o, device)

    if opt.test:
        o = copy.deepcopy(opt)
        for k in STAGE_KEYS:
            vars(o)[k] = opt_vars[k][-1]
        return run_test(o, device)

    clip_loss = _build_clip_loss(opt, device) if opt.rand_pose >= 0 else None
    prev_cfgs = trainer = state = None
    for i in range(length):
        o = copy.deepcopy(opt)
        for k in STAGE_KEYS:
            vals = opt_vars[k]
            vars(o)[k] = vals[i] if len(vals) == length else vals[0]
        print(f"===== stage {i + 1}/{length}: res={o.triplane_resolution} "
              f"levels={o.triplane_wavelet_levels} iters={o.iters} rays={o.num_rays}")
        prev_cfgs, trainer, state = run_stage(o, i, prev_cfgs, device, clip_loss)
    return trainer, state


def main(argv=None, device=None):
    return run(get_params(argv), device)


if __name__ == "__main__":
    main()
