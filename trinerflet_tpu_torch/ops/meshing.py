"""Iso-surface extraction and OBJ export (port of
``trinerflet_tpu/ops/meshing.py``): marching tetrahedra (the 6-tet Kuhn
decomposition of each cube: table-free and watertight) over a density
grid, an indexed mesh from its triangle soup, and a minimal OBJ writer.

The tetrahedra run in the port's host library on all host cores
(``trinerflet_tpu_torch/native``); the density is whatever ``density_fn``
computes (``Trainer.save_mesh`` queries the field on the trainer's device).
The JAX package's numpy marcher, its fallback when the library does not
build, is not ported: a failed build raises.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from .. import native

__all__ = ["marching_tetrahedra", "extract_mesh", "write_obj"]


def marching_tetrahedra(grid: np.ndarray, threshold: float, origin=(0.0, 0.0, 0.0),
                        spacing=1.0) -> np.ndarray:
    """The iso-surface of a dense (X, Y, Z) scalar field as a triangle soup
    (T, 3, 3) of world-space vertices (``extract_mesh`` indexes it)."""
    return native.marching_tetrahedra(grid, threshold, origin, spacing)


def extract_mesh(
    density_fn: Callable[[np.ndarray], np.ndarray],
    bound: float,
    resolution: int = 256,
    threshold: float = 10.0,
    chunk: int = 1 << 18,
) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluate ``density_fn`` on a resolution^3 grid over [-bound, bound]^3
    in chunks of points and extract an indexed (vertices, faces) mesh:
    vertices merged at 1e-4 of the grid spacing, degenerate faces dropped."""
    axis = np.linspace(-bound, bound, resolution, dtype=np.float32)
    pts = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    dens = np.concatenate(
        [np.asarray(density_fn(pts[i : i + chunk])) for i in range(0, len(pts), chunk)]
    ).reshape(resolution, resolution, resolution)
    spacing = 2 * bound / (resolution - 1)
    soup = marching_tetrahedra(dens, threshold, origin=(-bound,) * 3, spacing=spacing)
    flat = soup.reshape(-1, 3)
    verts, inv = np.unique(np.round(flat / (spacing * 1e-4)).astype(np.int64),
                           axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    seen = np.full(len(verts), -1, np.int64)
    seen[inv] = np.arange(len(inv))  # a representative position per vertex
    vpos = flat[seen]
    faces = inv.reshape(-1, 3)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return vpos.astype(np.float32), faces[ok].astype(np.int64)


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
