"""Scene container (port of ``SceneData`` from
``trinerflet_tpu/data/blender.py``; the Blender loader itself is queued with
the CLI slice). All arrays are host numpy; the trainer moves them to the
device once."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["SceneData"]


@dataclasses.dataclass
class SceneData:
    images: np.ndarray        # (V, H, W, C) float32 in [0, 1], C in {3, 4}
    poses: np.ndarray         # (V, 4, 4) cam2world, ngp convention
    intrinsics: Tuple[float, float, float, float]  # fx, fy, cx, cy
    H: int
    W: int

    @property
    def num_views(self) -> int:
        return len(self.images)
