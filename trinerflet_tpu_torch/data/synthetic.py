"""Camera model of the synthetic scene (port of the parts of
``trinerflet_tpu/data/synthetic.py`` the serving path uses): orbit poses
looking at the origin and the intrinsics law fx = fy = 0.9 W, c = (W/2, H/2)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["orbit_pose", "synthetic_intrinsics"]


def orbit_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """cam2world (4, 4) float32; the camera looks along +z of its rotation,
    toward the origin."""
    cx = radius * np.sin(theta) * np.cos(phi)
    cy = radius * np.cos(theta)
    cz = radius * np.sin(theta) * np.sin(phi)
    center = np.array([cx, cy, cz], np.float32)
    forward = -center / np.linalg.norm(center)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(up, forward)
    right /= np.linalg.norm(right) + 1e-9
    up2 = np.cross(forward, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0] = right
    pose[:3, 1] = up2
    pose[:3, 2] = forward
    pose[:3, 3] = center
    return pose


def synthetic_intrinsics(H: int, W: int) -> Tuple[float, float, float, float]:
    """(fx, fy, cx, cy) of the synthetic scene's cameras."""
    fx = fy = 0.9 * W
    return (fx, fy, W / 2.0, H / 2.0)
