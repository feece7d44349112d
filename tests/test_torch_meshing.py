"""Mesh export (``ops/meshing.py`` over the host library's marching
tetrahedra, ``Trainer.save_mesh``) against the JAX package's.

* The triangle soup equals the JAX package's native one bit for bit (the
  same C++ source and build flags) and its numpy marcher's within 2e-5
  after both are rounded to 1e-5 and sorted (float32 against float64
  interpolation: the rounding may split a 1e-6 difference into 1e-5).
* ``extract_mesh`` on analytic densities gives the JAX package's vertex and
  face sets EXACTLY after sorting.
* ``save_mesh`` writes the OBJ of ``extract_mesh`` over the field's density.
"""

import numpy as np
import pytest
import torch

from trinerflet_tpu import native as JNAT
from trinerflet_tpu.ops import meshing as JM
from trinerflet_tpu_torch.models.nerf import NeRFConfig
from trinerflet_tpu_torch.models.triplane import TriplaneConfig
from trinerflet_tpu_torch.ops import meshing as PM
from trinerflet_tpu_torch.render.renderer import RenderConfig
from trinerflet_tpu_torch.train.trainer import TrainConfig, Trainer


def _blobs(p):
    p = np.asarray(p, np.float32)
    return (25.0 * np.exp(-np.sum((p - 0.2) ** 2, -1) / 0.2)
            + 18.0 * np.exp(-np.sum((p + 0.4) ** 2, -1) / 0.05) + 4.0 * np.sin(3.0 * p[:, 0]))


def _sphere(p):
    return 20.0 - 30.0 * np.linalg.norm(np.asarray(p, np.float32) - 0.1, axis=-1)


def _sorted_soup(soup):
    tris = np.round(np.asarray(soup, np.float64), 5).reshape(-1, 9)
    return tris[np.lexsort(tris.T[::-1])]


@pytest.mark.parametrize("res", [9, 20])
def test_soup_matches_jax(res, monkeypatch):
    axis = np.linspace(-1, 1, res, dtype=np.float32)
    grid = _blobs(np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3))
    grid = grid.reshape(res, res, res)
    kw = dict(origin=(-1.0, -1.0, -1.0), spacing=2.0 / (res - 1))
    got = PM.marching_tetrahedra(grid, 10.0, **kw)
    assert got.dtype == np.float32 and got.ndim == 3 and len(got) > 0
    np.testing.assert_array_equal(got, JM.marching_tetrahedra(grid, 10.0, **kw))
    monkeypatch.setattr(JNAT, "marching_tetrahedra", lambda *a, **k: None)  # JAX's numpy marcher
    ref = JM.marching_tetrahedra(grid, 10.0, **kw)
    np.testing.assert_allclose(_sorted_soup(got), _sorted_soup(ref), rtol=0, atol=2e-5)
    assert len(PM.marching_tetrahedra(np.zeros((4, 4, 4), np.float32), 1.0)) == 0


@pytest.mark.parametrize("fn,bound,res,thresh", [(_blobs, 1.0, 33, 10.0), (_sphere, 1.5, 24, 0.0),
                                                 (_blobs, 0.8, 16, 5.0)])
def test_extract_mesh_matches_jax(fn, bound, res, thresh):
    pv, pf = PM.extract_mesh(fn, bound, res, thresh, chunk=4096)
    jv, jf = JM.extract_mesh(fn, bound, res, thresh, chunk=4096)
    assert len(pf) > 0 and pv.dtype == jv.dtype and pf.dtype == jf.dtype
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(np.sort(pf, axis=1)[np.lexsort(np.sort(pf, axis=1).T[::-1])],
                                  np.sort(jf, axis=1)[np.lexsort(np.sort(jf, axis=1).T[::-1])])


def test_save_mesh_writes_the_fields_iso_surface(tmp_path):
    tr = Trainer(NeRFConfig(triplane=TriplaneConfig(channels=4, resolution=32, wavelet_scale=2),
                            bound=1.5), RenderConfig(bound=1.5, grid_size=16), TrainConfig(),
                 device="cpu")
    state = tr.init_state()
    with torch.no_grad():
        planes = tr.field.build_planes(state.params)

        def density(p):
            return tr.field.density(state.params, planes, torch.as_tensor(p))[0].detach().numpy()

        thresh = float(np.median(density(np.random.default_rng(0).uniform(-1.5, 1.5, (4096, 3))
                                         .astype(np.float32))))
    path = str(tmp_path / "mesh.obj")
    verts, faces = tr.save_mesh(state, path, resolution=20, threshold=thresh)
    ev, ef = PM.extract_mesh(density, 1.5, 20, thresh)
    np.testing.assert_array_equal(verts, ev)
    np.testing.assert_array_equal(faces, ef)
    lines = open(path).read().splitlines()
    assert len(faces) > 0 and len(lines) == len(verts) + len(faces)
    v = np.array([[float(x) for x in ln.split()[1:]] for ln in lines if ln.startswith("v ")])
    f = np.array([[int(x) for x in ln.split()[1:]] for ln in lines if ln.startswith("f ")])
    np.testing.assert_allclose(v, verts, atol=5e-7)
    np.testing.assert_array_equal(f, faces + 1)
