"""More scene formats (port of ``trinerflet_tpu/data/formats.py``): NSVF,
NeRF++, Topia and RTMV layouts, each as a ``SceneData`` with poses in the ngp
convention. Images are read by ``data/images.py`` (PNG through the host
library, other formats through cv2 or PIL) and resized with its
``INTER_AREA`` counterpart.

* NSVF: ``intrinsics.txt`` (4x4 K or "f cx cy ..."), ``pose/*.txt`` (4x4
  cam2world, OpenCV or OpenGL per ``opengl_cam``), ``rgb/*.png``; the split
  in the filename prefix (0_ train, 1_ val, 2_ test).
* NeRF++: per-split directories (``train/ test/ validation/``) each holding
  ``rgb/``, ``pose/`` (flattened 4x4) and ``intrinsics/`` (flattened 4x4 K
  per image).
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np

from .blender import SceneData, nerf_matrix_to_ngp
from .images import downscale_area, read_image, resize_area

__all__ = ["load_nsvf_scene", "load_nerfpp_scene", "load_topia_scene",
           "load_rtmv_scene"]

_OPENCV_TO_GL = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def _read_image(path: str, downscale: int) -> np.ndarray:
    img = read_image(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return downscale_area(img, downscale)


def _read_matrix(path: str) -> np.ndarray:
    vals = np.loadtxt(path).reshape(-1)
    if vals.size >= 16:
        return vals[:16].reshape(4, 4).astype(np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :4] = vals[:12].reshape(3, 4)
    return m


def load_nsvf_scene(
    root: str,
    split: str = "train",
    downscale: int = 1,
    scale: float = 0.33,
    offset=(0, 0, 0),
    opengl_cam: bool = False,
) -> SceneData:
    """NSVF-format scene (rgb/ + pose/ + intrinsics.txt, split by prefix)."""
    prefix = {"train": "0_", "val": "1_", "test": "2_"}[split]
    rgb_paths = sorted(glob.glob(os.path.join(root, "rgb", f"{prefix}*")))
    if not rgb_paths:  # unsplit datasets: use everything
        rgb_paths = sorted(glob.glob(os.path.join(root, "rgb", "*")))
    images, poses = [], []
    for p in rgb_paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        pose = _read_matrix(os.path.join(root, "pose", stem + ".txt"))
        if not opengl_cam:  # NSVF poses are OpenCV cam2world
            pose = pose @ _OPENCV_TO_GL
        poses.append(nerf_matrix_to_ngp(pose, scale, offset))
        images.append(_read_image(p, downscale))
    images = np.stack(images)

    intr = np.loadtxt(os.path.join(root, "intrinsics.txt")).reshape(-1)
    if intr.size >= 16:
        K = intr[:16].reshape(4, 4)
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    else:
        fx = fy = intr[0]
        cx, cy = intr[1], intr[2]
    fx, fy, cx, cy = (v / downscale for v in (fx, fy, cx, cy))
    return SceneData(images=images, poses=np.stack(poses),
                     intrinsics=(float(fx), float(fy), float(cx), float(cy)),
                     H=images.shape[1], W=images.shape[2])


def load_nerfpp_scene(
    root: str,
    split: str = "train",
    downscale: int = 1,
    scale: float = 0.33,
    offset=(0, 0, 0),
) -> SceneData:
    """NeRF++-format scene (per-split rgb/ pose/ intrinsics/ directories)."""
    sdir = os.path.join(root, {"val": "validation"}.get(split, split))
    if not os.path.isdir(sdir):
        sdir = os.path.join(root, "test" if split == "val" else split)
    rgb_paths = sorted(glob.glob(os.path.join(sdir, "rgb", "*")))
    images, poses, intrs = [], [], []
    for p in rgb_paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        pose = _read_matrix(os.path.join(sdir, "pose", stem + ".txt"))
        pose = pose @ _OPENCV_TO_GL  # nerf++ uses OpenCV cam axes
        poses.append(nerf_matrix_to_ngp(pose, scale, offset))
        K = _read_matrix(os.path.join(sdir, "intrinsics", stem + ".txt"))
        intrs.append((K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
        images.append(_read_image(p, downscale))
    images = np.stack(images)
    fx, fy, cx, cy = (v / downscale for v in np.asarray(intrs).mean(axis=0))
    return SceneData(images=images, poses=np.stack(poses),
                     intrinsics=(float(fx), float(fy), float(cx), float(cy)),
                     H=images.shape[1], W=images.shape[2])


# axis permutation used by the Topia exporter (provider.py:592-599): world
# y-up <- z-up, applied on the left of each cam2world
_TOPIA_PERM = np.array(
    [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32
)


def load_topia_scene(
    root: str,
    poses_dir: str,
    downscale: int = 1,
    render_res: int = 128,
    translation_scale: float = 2.2,
) -> SceneData:
    """Topia export (reference NeRFDatasetTopia, provider.py:590-680): numbered
    ``{idx}.png`` images in ``root`` + per-image flattened 4x4 cam2world txt
    files in ``poses_dir``; fixed-focal intrinsics f = 560 / (512//render_res),
    principal point at render_res/2; translations pre-scaled by 2.2 and axes
    permuted from z-up to y-up."""
    pose_files = sorted(
        os.path.join(poses_dir, f) for f in os.listdir(poses_dir)
    )
    ratio = 512 // render_res
    poses, images = [], []
    H = W = None
    for idx, pf in enumerate(pose_files):
        c2w = np.loadtxt(pf).reshape(4, 4).astype(np.float32)
        c2w[:3, 3] *= translation_scale
        c2w = _TOPIA_PERM @ c2w
        poses.append(c2w)
        img = _read_image(os.path.join(root, f"{idx}.png"), 1)
        if H is None:
            H, W = img.shape[0] // downscale, img.shape[1] // downscale
        if img.shape[0] != H or img.shape[1] != W:
            img = resize_area(img, W, H)
        images.append(img)
    # reference (provider.py Topia branch): fx = 560 / ratio / downscale with
    # the principal point at the center of the actually-loaded images
    f = 560.0 / ratio / downscale
    return SceneData(
        images=np.stack(images), poses=np.stack(poses),
        intrinsics=(f, f, W * 0.5, H * 0.5), H=H, W=W,
    )


def load_rtmv_scene(
    root: str,
    split: str = "train",
    downscale: int = 1,
    scale: float = 0.33,
    offset=(0, 0, 0),
) -> SceneData:
    """RTMV export (reference dataset_llff/rtmv.py:14-70): per-frame
    ``NNNNN.json`` files with ``camera_data`` (intrinsics + cam2world) next to
    an ``images/`` directory; splits by frame index (train 0-100, trainval
    0-105, test 105-150). 'bricks' scenes are recentred/rescaled to the scene
    box recorded in frame 0."""
    import json as _json

    with open(os.path.join(root, "00000.json")) as f:
        meta = _json.load(f)["camera_data"]
    shift = np.array(meta["scene_center_3d_box"], np.float32)
    half = (np.array(meta["scene_max_3d_box"], np.float32)
            - np.array(meta["scene_min_3d_box"], np.float32)).max() / 2 * 1.05
    fx, fy = meta["intrinsics"]["fx"], meta["intrinsics"]["fy"]
    cx, cy = meta["intrinsics"]["cx"], meta["intrinsics"]["cy"]

    lo, hi = {"train": (0, 100), "trainval": (0, 105),
              "test": (105, 150), "val": (100, 105)}.get(split, (0, 150))
    img_paths = sorted(glob.glob(os.path.join(root, "images", "*")))[lo:hi]
    pose_paths = sorted(glob.glob(os.path.join(root, "*.json")))[lo:hi]
    bricks = "bricks" in root

    images, poses = [], []
    for ip, pp in zip(img_paths, pose_paths):
        with open(pp) as f:
            p = _json.load(f)["camera_data"]
        c2w = np.array(p["cam2world"], np.float32).T  # column-major on disk
        c2w[:3, 1:3] *= -1  # OpenCV -> OpenGL camera axes
        if bricks:
            c2w[:3, 3] -= shift
            c2w[:3, 3] /= 2 * half  # bound in [-0.5, 0.5]
        m = np.eye(4, dtype=np.float32)
        m[:3] = c2w[:3]
        poses.append(nerf_matrix_to_ngp(m, scale, offset))
        images.append(_read_image(ip, downscale))
    images = np.stack(images)
    fx, fy, cx, cy = (v / downscale for v in (fx, fy, cx, cy))
    return SceneData(images=images, poses=np.stack(poses),
                     intrinsics=(float(fx), float(fy), float(cx), float(cy)),
                     H=images.shape[1], W=images.shape[2])
