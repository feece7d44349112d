"""Training registry fields through the renderer: the PyTorch port against
the JAX package (CPU).

The losses of ``tests/test_registry.py`` (32 rays from (0, 0, -0.9) about
+z, a fully occupied 16^3 grid, the flat march with 64 steps and a budget
of 8, MSE against numpy-made colours): the voxel grid with the solid and
the textured background (``bg_fn``, bg_radius 2), the SDF field, and the
diffuse point-light material with finite-difference normals. Each loss and
each parameter's gradient is held against ``jax.value_and_grad`` of the JAX
package's loss (jitted: one compile costs less than the eager trace of the
diffuse field's four density calls per sample), from the JAX package's
initial parameters carried by ``carry.params_from_jax``; then a 3-step
trajectory (the JAX test's update, p - lr g) on the voxel grid with the
textured background.

Tolerances: the march is identical, so the sample counts are EQUAL; losses
within 1e-5 relative; each parameter's gradient within 1e-4 of its largest
entry (float32 sums in other orders, and XLA's fusions, through the
samplers' backwards, the compositor, the MLPs and the finite-difference
normal's division by eps); the trajectory's losses within 1e-5 relative per
step and its parameters within 1e-5 absolute.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_registry import _fields, _flat
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.render import renderer as JRR
from trinerflet_tpu_torch.render import renderer as PRR

N_RAYS = 32


def _rcfg(lib, combo):
    kw = dict(bound=1.0, grid_size=16, max_steps=64, samples_per_ray_budget=8)
    if combo != "diffuse":
        kw.update(dt_gamma=0.0, march="flat", num_steps=64)
    if combo.startswith("grid"):
        kw["bg_radius"] = 2.0
    return lib.RenderConfig(**kw)


SETUPS = {  # name -> (geometry, material, background, field kwargs)
    "grid-solid": ("volume-grid", "no-material", "solid-color-background", {}),
    "grid-textured": ("volume-grid", "no-material", "textured-background", {}),
    "sdf": ("implicit-sdf", "no-material", "solid-color-background",
            {"sdf_cfg": dict(sdf_bias="sphere", sdf_bias_params=(0.5,))}),
    "diffuse": ("implicit-volume", "diffuse-with-point-light-material", "solid-color-background",
                {"normal_type": "finite_difference"}),
}


@functools.lru_cache(maxsize=None)
def _case(combo):
    geometry, material, background, kw = SETUPS[combo]
    jf, pf, jp, pp = _fields(geometry, material, background, seed=3, bump=False, **kw)
    rng = np.random.default_rng(6)
    o = np.tile(np.array([[0.0, 0.0, -0.9]], np.float32), (N_RAYS, 1))
    d = rng.standard_normal((N_RAYS, 3)) * 0.1 + np.array([0, 0, 1.0])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    gt = rng.uniform(0.3, 0.7, (N_RAYS, 3)).astype(np.float32)
    return jf, pf, jp, pp, o, d, gt


def _jax_loss(combo):
    jf, _, _, _, o, d, gt = _case(combo)
    rcfg = _rcfg(JRR, combo)
    occ = jnp.ones((1, 16, 16, 16), bool)
    bg = combo.startswith("grid")

    def loss_fn(p):
        planes = jf.build_planes(p)
        out = JRR.render_occgrid(lambda x, dd: jf(p, planes, x, dd), jnp.asarray(o), jnp.asarray(d), occ,
                                 rcfg, bg_fn=(lambda sph, dd: jf.background(p, dd)) if bg else None)
        return jnp.mean((out["image"] - jnp.asarray(gt)) ** 2), out["num_samples"]

    return loss_fn


def _port_loss(combo, params):
    _, pf, _, _, o, d, gt = _case(combo)
    planes = pf.build_planes(params)
    out = PRR.render_occgrid(lambda x, dd: pf(params, planes, x, dd), torch.from_numpy(o), torch.from_numpy(d),
                             torch.ones((1, 16, 16, 16), dtype=torch.bool), _rcfg(PRR, combo),
                             bg_fn=(lambda sph, dd: pf.background(params, dd)) if combo.startswith("grid")
                             else None)
    return ((out["image"] - torch.from_numpy(gt)) ** 2).mean(), out["num_samples"]


def _port_value_and_grad(combo, params):
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, n = _port_loss(combo, params)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves.values(), grads)]  # JAX's zeros
    return loss.item(), int(n), dict(zip(leaves, grads))


@pytest.mark.parametrize("combo", sorted(SETUPS))
def test_registry_loss_and_gradients_match_jax(combo):
    _, _, jp, pp, *_ = _case(combo)
    (jl, jn), jg = jax.jit(jax.value_and_grad(_jax_loss(combo), has_aux=True))(jp)
    pl, pn, pg = _port_value_and_grad(combo, {k: v for k, v in pp.items()})
    assert pn == int(jn) > 0
    np.testing.assert_allclose(pl, float(jl), rtol=1e-5)
    jg = _flat(jg)
    assert set(pg) == set(jg)
    for k, want in jg.items():
        want = np.asarray(want)
        got = pg[k].numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-12, err_msg=k)
    key = {"grid-solid": "encoder.grid", "grid-textured": "bg_texture", "sdf": "sdf_net.w0",
           "diffuse": "encoder.base"}[combo]
    assert np.abs(np.asarray(jg[key])).max() > 0, key


def test_registry_trajectory_matches_jax():
    """Three steps of the JAX test's update p - 10 g on the voxel grid with
    the textured background."""
    combo, lr = "grid-textured", 10.0
    _, _, jp, pp, *_ = _case(combo)
    vg = jax.jit(jax.value_and_grad(_jax_loss(combo), has_aux=True))
    params = {k: (v.detach().clone() if torch.is_tensor(v) else {n: w.detach().clone() for n, w in v.items()})
              for k, v in pp.items()}
    jlosses, plosses = [], []
    for _ in range(3):
        (jl, _), jg = vg(jp)
        jp = jax.tree.map(lambda a, b: a - lr * b, jp, jg)
        pl, _, pg = _port_value_and_grad(combo, params)
        with torch.no_grad():
            for k, t in _flat(params).items():
                t -= lr * pg[k]
        jlosses.append(float(jl))
        plosses.append(pl)
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    assert jlosses[-1] < jlosses[0]
    for k, want in _flat(jp).items():
        np.testing.assert_allclose(_flat(params)[k].detach().numpy(), np.asarray(want), rtol=0, atol=1e-5,
                                   err_msg=k)
