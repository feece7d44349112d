"""Division by a Python float: the port rounds the same on every device, as
the JAX package does where it decides a cell.

torch on the CPU divides a tensor by a Python float truly, and on the card
multiplies by its float32 reciprocal, so a point on a texel edge could take
one cell on the CPU and the next on the card. The port now writes out the
rounding it wants where a division picks a cell:

* K2 and K2x (the sampler): ``x / lbound`` is a true division on every
  device (by a float32 tensor on the points' device; the kernels divide
  truly). The JAX package's parity tests run its train step op by op, which
  divides truly; under jit XLA turns the division into a reciprocal
  multiply, but whether it also fuses the ``+ 1`` depends on the program
  (a forward-only program does not, a forward-and-backward one does, see
  ``test_jit_rounds_the_sampler_by_program``), so jit gives the sampler no
  single rounding to follow.
* The rays: ``(i - cx) / fx`` divides by the intrinsics as tensors, truly,
  as the JAX train step divides by its traced intrinsics.
* K10 (the voxel grid): jit's ``fma(x, f32(1 / bound) * 0.5, 0.5)``, the
  same in every program, as K7 follows jit's fused cell coordinate.

Every test uses points where the true division and the reciprocal multiply
fall on either side of an edge (each checks that its points do).
Tolerances: corners, cells and rays bit for bit; features and gradients
within 1e-6 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trinerflet_tpu.data import rays as JRY
from trinerflet_tpu.models import registry as JREG
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.ops import grid_sample as JGS
from trinerflet_tpu_torch.data.rays import rays_for_pixels
from trinerflet_tpu_torch.data.synthetic import orbit_pose, synthetic_intrinsics
from trinerflet_tpu_torch.models import registry as PREG
from trinerflet_tpu_torch.ops import grid_sample as PGS

f32 = np.float32
LB = 1.5


def _fma(a, b, c):
    return (np.asarray(a, np.float64) * np.float64(b) + np.float64(c)).astype(f32)


def _texel(x, n, kind):
    """The texel coordinate (x / LB + 1) * 0.5 * (n - 1) of points x, rounded
    as a true division, jit's reciprocal multiply, or that multiply fused
    with the + 1."""
    r = f32(1) / f32(LB)
    unit = {"true": x / f32(LB) + f32(1), "recip": x * r + f32(1), "fused": _fma(x, r, 1.0)}[kind]
    return unit * f32(0.5) * f32(n - 1)


def _edge_points(n, ulps=6):
    """Points within ``ulps`` ulps of every interior texel edge of an n-texel
    axis at bound LB."""
    out = []
    for k in range(1, n - 1):
        v = f32(LB) * (f32(2 * k) / f32(n - 1) - f32(1))
        for _ in range(ulps):
            v = np.nextafter(v, f32(-10))
        for _ in range(2 * ulps + 1):
            out.append(v)
            v = np.nextafter(v, f32(10))
    return np.array(out, f32)


def _cell(t, n):
    return np.minimum(np.floor(np.clip(t, 0, n - 1)), n - 2)


def _straddling_points(seed, n=8):
    """Planes (3, n, n, 4) and points whose coordinate on one axis falls in
    one cell by a true division and in the next by the reciprocal multiply,
    on each axis in turn, the other two coordinates inside a cell."""
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((3, n, n, 4)).astype(f32)
    e = _edge_points(n)
    e = e[_cell(_texel(e, n, "true"), n) != _cell(_texel(e, n, "recip"), n)]
    assert len(e) >= 2
    xyz = np.concatenate([np.roll(np.stack([e, np.full_like(e, 0.1), np.full_like(e, -0.2)], 1), a, axis=1)
                          for a in range(3)]).astype(f32)
    return planes, xyz, rng


def test_sampler_divides_truly_at_texel_edges():
    """K2's plain version on an 8 x 8 plane against ``sample_planes`` of JAX's
    ``project_to_planes``: the corners (``_corner_weights``) equal, the
    features within 1e-6; and the dividing tensor's device is the points',
    so the card divides as the CPU does (the kernel divides truly)."""
    planes, xyz, _ = _straddling_points(0)
    x_pt = torch.from_numpy(xyz)
    for p, (xr, yr) in enumerate(PGS._point_cells(planes.shape, x_pt, LB)):
        idx, _ = PGS._cell(8, 8, xr, yr)
        jidx = np.asarray(JGS._corner_weights((8, 8), JT.project_to_planes(jnp.asarray(xyz), LB)[p])[0])
        np.testing.assert_array_equal(idx.numpy(), jidx)
        # the card's former reciprocal multiply takes the other corner here
        a = PGS._PLANE_AXES[p][0]
        assert np.any(_cell(_texel(xyz[:, a], 8, "recip"), 8) != _cell(xr.numpy(), 8))
    got = PGS.sample_points_plain(torch.from_numpy(planes), x_pt, LB).numpy()
    ref = np.asarray(JGS.sample_planes(jnp.asarray(planes), JT.project_to_planes(jnp.asarray(xyz), LB)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    assert PGS._divide(x_pt, LB).equal(x_pt / torch.tensor(LB))


def test_sampler_coordinate_gradient_divides_truly():
    """K2x's plain dL/dxyz against ``jax.grad`` at those points, within 1e-6
    of its largest entry. With the reciprocal multiply of the card's plain
    version, a point on a cell edge took the neighbouring cell's slope (0.23
    in a full-size step)."""
    planes, xyz, rng = _straddling_points(1)
    g = rng.standard_normal((len(xyz), 3, 4)).astype(f32)

    def loss(x):
        return (JGS.sample_planes(jnp.asarray(planes), JT.project_to_planes(x, LB)) * g).sum()

    ref = np.asarray(jax.grad(loss)(jnp.asarray(xyz)))
    _, got = PGS.sample_points_backward_xyz_plain(torch.from_numpy(g), torch.from_numpy(planes),
                                                  torch.from_numpy(xyz), LB, planes_grad=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    recip_x = torch.from_numpy(xyz * (f32(1) / f32(LB)))
    _, old = PGS.sample_points_backward_xyz_plain(torch.from_numpy(g), torch.from_numpy(planes), recip_x, 1.0,
                                                  planes_grad=False)
    assert np.abs(old.numpy() / f32(LB) - ref).max() > 1e-2 * np.abs(ref).max()


def _triplane_rounding(program, planes, xyz):
    """Which roundings of x / LB reproduce the features of a jitted
    ``sample_triplane`` program: the kinds whose bilinear sample lies within
    1e-6 of the program's on every point."""
    cfg = JT.TriplaneConfig(channels=4, resolution=64, wavelet_scale=4)
    n = planes.shape[1]

    def fwd(p, x):
        return JT.sample_triplane({"full": p}, x, cfg, lbound=LB)

    if program == "forward":
        ref = jax.jit(fwd)(jnp.asarray(planes), jnp.asarray(xyz))
    else:
        def step(p, x):
            feats, pull = jax.vjp(lambda q: fwd(q, x), p)
            return feats, pull(jnp.ones_like(feats))[0]

        ref = jax.jit(step)(jnp.asarray(planes), jnp.asarray(xyz))[0]
    ref = np.asarray(ref).reshape(-1, 3, 4)
    kinds = []
    for kind in ("true", "recip", "fused"):
        out = np.zeros_like(ref)
        for p, (a, b) in enumerate(PGS._PLANE_AXES):
            x, y = np.clip(_texel(xyz[:, a], n, kind), 0, n - 1), np.clip(_texel(xyz[:, b], n, kind), 0, n - 1)
            x0, y0 = _cell(x, n), _cell(y, n)
            wx, wy = (x - x0)[:, None], (y - y0)[:, None]
            rows = planes[p].reshape(-1, 4)
            k = (y0 * n + x0).astype(int)
            out[:, p] = ((rows[k] * ((1 - wx) * (1 - wy)) + rows[k + 1] * (wx * (1 - wy)))
                         + rows[k + n] * ((1 - wx) * wy)) + rows[k + n + 1] * (wx * wy)
        if np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max():
            kinds.append(kind)
    return kinds


def test_jit_rounds_the_sampler_by_program():
    """What the sampler's rounding would follow under jit: at 64^2 and 3,000
    points a forward-only program rounds the reciprocal's product before the
    + 1, and a forward-and-backward program fuses them; neither divides
    truly. The port divides truly (see the module's note)."""
    rng = np.random.default_rng(3)
    planes = rng.standard_normal((3, 64, 64, 4)).astype(f32)
    xyz = rng.uniform(-1.6, 1.6, (3000, 3)).astype(f32)
    assert _triplane_rounding("forward", planes, xyz) == ["recip"]
    assert _triplane_rounding("vjp", planes, xyz) == ["fused"]


def test_rays_divide_truly_bit_for_bit():
    """Ray directions at chip_smoke's intrinsics (256^2, fx = 230.4) against
    JAX's ``rays_for_pixels`` with array intrinsics, as the train step passes
    them (a true division), bit for bit, from a tuple or a tensor."""
    intr = synthetic_intrinsics(256, 256)
    assert intr[0] == pytest.approx(230.4)
    poses = np.stack([orbit_pose(0.3 + 0.2 * v, 0.7 * v, 2.0) for v in range(8)]).astype(f32)
    rng = np.random.default_rng(2)
    img = rng.integers(0, 8, 20000).astype(np.int32)
    pix = rng.integers(0, 256 * 256, 20000).astype(np.int32)
    jo, jd = JRY.rays_for_pixels(jnp.asarray(poses), jnp.asarray(intr, jnp.float32), 256, jnp.asarray(img),
                                 jnp.asarray(pix))
    for intrinsics in (intr, torch.tensor(intr, dtype=torch.float32)):
        po, pd = rays_for_pixels(torch.from_numpy(poses), intrinsics, 256, torch.from_numpy(img).long(),
                                 torch.from_numpy(pix).long())
        np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    # the columns where a multiply by f32(1 / fx) would have rounded otherwise
    i = np.arange(256, dtype=f32) + f32(0.5)
    assert np.any((i - f32(128)) / f32(intr[0]) != (i - f32(128)) * (f32(1) / f32(intr[0])))


def test_volume_grid_cell_follows_jit():
    """K10's cell q0 at points on the grid's nodes: a grid that is x^2 along
    the first axis, so jitted JAX's gradient along x names the cell (its
    slope 2 q0 + 1), against the port's cell, bit for bit."""
    R = 16
    cfg = JREG.VolumeGridConfig(resolution=R, feature_dim=0)
    node = np.arange(R, dtype=f32)
    grid = np.broadcast_to((node ** 2)[:, None, None, None], (R, R, R, 1)).astype(f32)
    e = _edge_points(R)
    x = np.stack([e, np.full_like(e, 0.05), np.full_like(e, 0.05)], 1).astype(f32)

    def loss(xx):
        return JREG.sample_volume_grid({"grid": jnp.asarray(grid)}, xx, cfg, LB).sum()

    gx = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(x)))[:, 0]
    jit_cell = (np.round(gx / (f32(R - 1) * f32(0.5) * (f32(1) / f32(LB)))) - 1) / 2
    _, q0, _ = PREG._voxel_cell(torch.from_numpy(x), R, LB)
    np.testing.assert_array_equal(q0[:, 0].numpy(), jit_cell)
    true_cell = np.floor(np.clip((x[:, 0] / f32(LB) * f32(0.5) + f32(0.5)) * f32(R - 1), 0, f32(R - 1 - 1e-6)))
    assert np.any(true_cell != jit_cell)
