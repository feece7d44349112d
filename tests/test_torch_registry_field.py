"""The registry's field of the PyTorch port against the JAX package (CPU):
``trinerflet_tpu_torch/models/registry.py``'s ``RegistryField`` against
``trinerflet_tpu/models/registry.py``'s, for every geometry, material,
background and normal type.
``tests/test_torch_registry.py`` holds the registry's functions (K10, K7x,
K11, the SDF, the materials, the backgrounds, the parameter trees) and
shares its setup
(``_fields``: the JAX package's initial params, carried by
``params_from_jax``).

Tolerances: sigma within 1e-5 relative, colours within 1e-6, except behind
finite-difference normals, where the density difference over eps amplifies
a float32 rounding (1e-4); unit normals within 1e-5 (analytic and pred),
1e-4 (finite differences).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_registry import N_PTS, _fields, _flat, _np, _rays
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu_torch.models import gridencoder as PG
from trinerflet_tpu_torch.models import registry as PR
from trinerflet_tpu_torch.ops import grid_sample as GS


# ---------------------------------------------------------------------------
# RegistryField
# ---------------------------------------------------------------------------

COMBOS = [  # (geometry, material, background, encoding)
    ("implicit-volume", "no-material", "textured-background", "triplane_wavelet"),
    ("volume-grid", "neural-radiance-material", "solid-color-background", "triplane_wavelet"),
    ("volume-grid", "no-material", "textured-background", "triplane_wavelet"),
    ("implicit-sdf", "neural-radiance-material", "neural-environment-map-background", "triplane_wavelet"),
    ("implicit-volume", "neural-radiance-material", "neural-environment-map-background", "hashgrid"),
]


@pytest.mark.parametrize("combo", COMBOS, ids=["-".join(c[:3]) for c in COMBOS])
def test_field_density_color_background_match_jax(combo):
    geometry, material, background, encoding = combo
    jf, pf, jp, pp = _fields(geometry, material, background, encoding)
    x, d = _rays(N_PTS, 14)
    jpl, ppl = jf.build_planes(jp), pf.build_planes(pp)
    js, jrgb = jf(jp, jpl, jnp.asarray(x), jnp.asarray(d))
    ps, prgb = pf(pp, ppl, torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(_np(ps), np.asarray(js), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(prgb), np.asarray(jrgb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(pf.background(pp, torch.from_numpy(d))),
                               np.asarray(jf.background(jp, jnp.asarray(d))), rtol=0, atol=1e-6)
    if geometry == "implicit-sdf":
        np.testing.assert_allclose(_np(pf.sdf(pp, ppl, torch.from_numpy(x))),
                                   np.asarray(jf.sdf(jp, jpl, jnp.asarray(x))), rtol=0, atol=1e-6)


NORMAL_CASES = [(g, e, n) for g, e in [("implicit-volume", "triplane_wavelet"), ("volume-grid", "triplane_wavelet"),
                                       ("implicit-sdf", "triplane_wavelet"), ("implicit-volume", "hashgrid")]
                for n in ("finite_difference", "finite_difference_laplacian", "analytic", "pred")]


@pytest.mark.parametrize("geometry,encoding,normal_type", NORMAL_CASES,
                         ids=[f"{g}-{e}-{n}" for g, e, n in NORMAL_CASES])
def test_field_normals_and_shading_match_jax(geometry, encoding, normal_type):
    """Every normal type on the triplane, the voxel grid, the SDF and the
    hash grid, then the diffuse material through the field. The JAX package
    reads a triplane for the pred head whatever the encoding (and fails on
    the hash grid); there the port's normal is held to unit length."""
    jf, pf, jp, pp = _fields(geometry, "diffuse-with-point-light-material", encoding=encoding,
                             normal_type=normal_type, fd_normal_eps=0.02)
    x, d = _rays(N_PTS, 15, extent=0.7)
    jpl, ppl = jf.build_planes(jp), pf.build_planes(pp)
    pn = pf.normal(pp, ppl, torch.from_numpy(x))
    np.testing.assert_allclose(np.linalg.norm(_np(pn), axis=-1), 1.0, atol=1e-5)
    if normal_type == "pred" and encoding != "triplane_wavelet":
        return
    jn = np.asarray(jf.normal(jp, jpl, jnp.asarray(x)))
    fd = normal_type.startswith("finite")
    np.testing.assert_allclose(_np(pn), jn, rtol=0, atol=1e-4 if fd else 1e-5)
    js, jrgb = jf(jp, jpl, jnp.asarray(x), jnp.asarray(d))
    ps, prgb = pf(pp, ppl, torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(_np(prgb), np.asarray(jrgb), rtol=0, atol=1e-4 if fd else 1e-6)


def _trainable(tree):
    """A copy of a parameter tree whose every leaf requires a gradient."""
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


@pytest.mark.parametrize("geometry", ["implicit-volume", "volume-grid", "implicit-sdf"])
def test_analytic_normal_in_training_raises_before_any_work(geometry, monkeypatch):
    """Training through an analytic normal (it raised before the samplers'
    second derivatives were ported; the test keeps its name). Under no_grad
    (a served view), or with no parameter requiring a gradient, the normal
    runs the first-order path alone: no second-order plain version (K2x²,
    K7x², K10²) is called and nothing carries a graph. With every parameter
    requiring a gradient the normal is the same, carries a graph, and a loss
    through the diffuse colour gives finite gradients in every parameter,
    nonzero in the encoding's, through exactly one second-order call."""
    _, pf, _, pp = _fields(geometry, "diffuse-with-point-light-material", normal_type="analytic")
    x, d = _rays(16, 16)
    x, d = torch.from_numpy(x), torch.from_numpy(d)
    second = []
    for mod, name in ((GS, "sample_points_backward_xyz_backward_plain"),
                      (PG, "grid_encode_backward_x_backward_plain"),
                      (PR, "sample_volume_grid_backward_x_backward_plain")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k: second.append(_n) or _o(*a, **k))
    planes = pf.build_planes(pp)
    served = pf.normal(pp, planes, x)
    train = _trainable(pp)
    with torch.no_grad():
        tplanes = pf.build_planes(train)
        n = pf.normal(train, tplanes, x)
        _, rgb = pf(train, tplanes, x, d)
    assert torch.equal(n, served) and not n.requires_grad and not rgb.requires_grad
    assert torch.isfinite(rgb).all() and second == []
    tplanes = pf.build_planes(train)
    n = pf.normal(train, tplanes, x)
    assert n.requires_grad and second == []
    torch.testing.assert_close(n.detach(), served, rtol=0, atol=1e-6)
    _, rgb = pf(train, tplanes, x, d)
    leaves = _flat(train)
    grads = torch.autograd.grad(rgb.square().sum(), list(leaves.values()), allow_unused=True)
    assert len(second) == 1
    for k, g in zip(leaves, grads):
        assert g is None or torch.isfinite(g).all(), k
    enc = [g for k, g in zip(leaves, grads) if k.startswith("encoder.")]
    assert enc and all(g is not None for g in enc) and any(g.abs().max() > 0 for g in enc)


@pytest.mark.parametrize("geometry,encoding", [("implicit-volume", "triplane_wavelet"),
                                               ("implicit-sdf", "triplane_wavelet"),
                                               ("volume-grid", "triplane_wavelet"),
                                               ("implicit-volume", "hashgrid")])
def test_analytic_normal_inner_gradient_runs_no_parameter_pass(geometry, encoding, monkeypatch):
    """The analytic normal's inner gradient in the points, taken with a
    graph while every parameter requires a gradient, runs no plane, table
    or grid gradient (``kernels.wanted``: the engine runs none of their
    nodes there), and the parameters still get their gradients through the
    second derivative."""
    _, pf, _, pp = _fields(geometry, "diffuse-with-point-light-material", encoding=encoding,
                           normal_type="analytic")
    x = torch.from_numpy(_rays(16, 16)[0])
    passes = []

    def spy(mod, name, asked):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **k: (passes.append(name) if asked(a, k) else None)
                            or orig(*a, **k))

    spy(GS, "sample_points_backward_xyz_plain", lambda a, k: k.get("planes_grad", True))
    spy(GS, "sample_points_backward_plain", lambda a, k: True)
    spy(PG, "grid_encode_backward_plain", lambda a, k: True)
    spy(PR, "sample_volume_grid_backward_plain", lambda a, k: a[5])
    train = _trainable(pp)
    n = pf.normal(train, pf.build_planes(train), x)
    assert n.requires_grad and passes == []
    leaves = _flat(train)
    grads = torch.autograd.grad(n.sum(), list(leaves.values()), allow_unused=True)
    enc = [g for k, g in zip(leaves, grads) if k.startswith("encoder.")]
    assert enc and all(g is not None and torch.isfinite(g).all() for g in enc)
    assert any(g.abs().max() > 0 for g in enc)
