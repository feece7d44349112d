"""COLMAP binary models (port of ``trinerflet_tpu/data/colmap.py``): reads
``cameras.bin`` / ``images.bin`` of a ``sparse/0`` reconstruction into
per-image intrinsics and cam2world poses in the ngp convention, the
slerp test path through them, and the scene loader. Images are read by
``data/images.py`` (PNG through the host library, JPEG through cv2 or PIL).
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from .blender import SceneData, nerf_matrix_to_ngp
from .images import downscale_area, read_images

__all__ = ["ColmapCamera", "ColmapImage", "read_cameras_bin", "read_images_bin", "load_colmap_poses",
           "interpolate_pose_path", "colmap_test_path", "load_colmap_scene"]

# camera model id -> (name, num_params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
}


@dataclasses.dataclass
class ColmapCamera:
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def intrinsics(self) -> Tuple[float, float, float, float]:
        if self.model == "SIMPLE_PINHOLE" or self.model == "SIMPLE_RADIAL":
            f, cx, cy = self.params[:3]
            return float(f), float(f), float(cx), float(cy)
        fx, fy, cx, cy = self.params[:4]
        return float(fx), float(fy), float(cx), float(cy)


@dataclasses.dataclass
class ColmapImage:
    name: str
    camera_id: int
    qvec: np.ndarray  # (w, x, y, z)
    tvec: np.ndarray

    @property
    def c2w(self) -> np.ndarray:
        """world2cam (R, t) stored by colmap -> cam2world 4x4."""
        w, x, y, z = self.qvec
        R = np.array([
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ])
        m = np.eye(4, dtype=np.float64)
        m[:3, :3] = R.T
        m[:3, 3] = -R.T @ self.tvec
        return m.astype(np.float32)


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_ = _CAMERA_MODELS.get(model_id, (f"MODEL_{model_id}", 4))
            params = np.asarray(struct.unpack(f"<{np_}d", f.read(8 * np_)))
            cams[cam_id] = ColmapCamera(name, int(w), int(h), params)
    return cams


def read_images_bin(path: str) -> List[ColmapImage]:
    images = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            img_id = struct.unpack("<i", f.read(4))[0]  # noqa: F841
            qvec = np.asarray(struct.unpack("<4d", f.read(32)))
            tvec = np.asarray(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * n2d, os.SEEK_CUR)  # skip 2D points
            images.append(ColmapImage(name.decode(), cam_id, qvec, tvec))
    images.sort(key=lambda im: im.name)
    return images


def load_colmap_poses(sparse_dir: str):
    """Returns (names, poses (V,4,4) cam2world OpenCV convention, intrinsics)."""
    cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
    images = read_images_bin(os.path.join(sparse_dir, "images.bin"))
    poses = np.stack([im.c2w for im in images])
    cam = cams[images[0].camera_id]
    return [im.name for im in images], poses, cam.intrinsics


def interpolate_pose_path(poses: np.ndarray, n_frames: int = 120) -> np.ndarray:
    """Smooth camera trajectory through the given cam2world poses: slerp on
    rotations, linear interpolation on centers (reference colmap test-path
    interpolation, provider.py:172-189). Returns (n_frames, 4, 4)."""
    from scipy.spatial.transform import Rotation, Slerp

    key_t = np.arange(len(poses), dtype=np.float64)
    slerp = Slerp(key_t, Rotation.from_matrix(poses[:, :3, :3].astype(np.float64)))
    t = np.linspace(0.0, len(poses) - 1.0, n_frames)
    R = slerp(t).as_matrix()
    centers = np.stack(
        [np.interp(t, key_t, poses[:, i, 3].astype(np.float64)) for i in range(3)], -1
    )
    out = np.broadcast_to(np.eye(4), (n_frames, 4, 4)).copy()
    out[:, :3, :3] = R
    out[:, :3, 3] = centers
    return out.astype(np.float32)


def colmap_test_path(root: str, n_frames: int = 120, downscale: int = 1,
                     scale: float = 0.33, offset=(0, 0, 0)):
    """Render-only test trajectory for a COLMAP scene: slerp through the
    registered camera poses (ngp convention). Returns (poses, intrinsics)."""
    names, poses_cv, intr = load_colmap_poses(os.path.join(root, "sparse", "0"))
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    poses_gl = np.stack([p @ flip for p in poses_cv])
    poses = np.stack([nerf_matrix_to_ngp(p, scale, offset) for p in poses_gl])
    path = interpolate_pose_path(poses, n_frames)
    fx, fy, cx, cy = (v / downscale for v in intr)
    return path, (fx, fy, cx, cy)


def load_colmap_scene(root: str, downscale: int = 1, scale: float = 0.33,
                      offset=(0, 0, 0), hold_every: int = 0, split: str = "train"):
    """COLMAP reconstruction (root/sparse/0 + root/images) -> SceneData with
    the ngp pose convention."""
    names, poses_cv, intr = load_colmap_poses(os.path.join(root, "sparse", "0"))
    # OpenCV cam (z forward, y down) -> OpenGL/blender (z backward, y up)
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    poses_gl = np.stack([p @ flip for p in poses_cv])
    poses = np.stack([nerf_matrix_to_ngp(p, scale, offset) for p in poses_gl])

    imgs = read_images([os.path.join(root, "images", n) for n in names])
    imgs = [np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img for img in imgs]
    images = np.stack([downscale_area(img, downscale) for img in imgs])
    fx, fy, cx, cy = (v / downscale for v in intr)
    idx = np.arange(len(images))
    if hold_every > 0:
        test_idx = idx[::hold_every]
        sel = test_idx if split in ("test", "val") else np.setdiff1d(idx, test_idx)
        images, poses = images[sel], poses[sel]
    return SceneData(images=images, poses=poses, intrinsics=(fx, fy, cx, cy),
                     H=images.shape[1], W=images.shape[2])
