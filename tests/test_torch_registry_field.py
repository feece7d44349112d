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


@pytest.mark.parametrize("geometry", ["implicit-volume", "volume-grid", "implicit-sdf"])
def test_analytic_normal_in_training_raises_before_any_work(geometry, monkeypatch):
    """Training through an analytic normal needs the kernels' second
    derivative: the normal raises first (nothing is sampled). Under no_grad
    (a served view), or with no parameter requiring a gradient, it works."""
    _, pf, _, pp = _fields(geometry, "diffuse-with-point-light-material", normal_type="analytic")
    planes = pf.build_planes(pp)
    x, d = _rays(16, 16)
    x, d = torch.from_numpy(x), torch.from_numpy(d)
    calls = []
    for name in ("_density_only", "sdf"):
        orig = getattr(pf, name)
        monkeypatch.setattr(pf, name, lambda *a, _o=orig, _n=name, **k: calls.append(_n) or _o(*a, **k))
    train = {k: v for k, v in pp.items()}
    leaf = next(t for t in _flat(train).values())
    leaf.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="analytic normals"):
        pf.normal(train, planes, x)
    assert calls == []
    with torch.no_grad():
        n = pf.normal(train, planes, x)
        sigma, rgb = pf(train, planes, x, d)
    assert calls and torch.isfinite(n).all() and torch.isfinite(rgb).all() and not rgb.requires_grad
    leaf.requires_grad_(False)
    assert torch.isfinite(pf.normal(pp, planes, x)).all()
