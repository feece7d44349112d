"""Second derivatives through the port's kernel functions: where none is
ported they raise, on the CPU as on the card; the samplers' coordinate
gradients are differentiable twice, and a third derivative raises.

Each kernel's ``torch.autograd.Function`` (K2 / K2x ``_SamplePoints``, K7 /
K7x ``_GridEncode``, K4 ``_Idwt2d``, K3 ``_CompositeDense``, K3c
``_CompositeCompact``, K10 ``_SampleVolumeGrid``, K11
``_TexturedBackground``) marks the backward it runs once
``kernels.first_order``. On the card the backward is a kernel launch into a
fresh tensor with no graph, so a second derivative would come out as a
silent zero; on the CPU the plain backward is torch ops that autograd would
record. Both raise torch's ``once_differentiable`` error when a
``create_graph=True`` gradient is differentiated again, even when the first
cotangent is a constant (the ``y.sum()`` of an analytic normal): K3, K3c,
K4, K11, and the K2 backward taken in the planes alone (no path needs their
second derivatives). A first-order ``create_graph=True`` call still works.
``trunc_exp``'s backward is plain torch on both devices and stays twice
differentiable.

The coordinate gradients of K2 (K2x), K7 (K7x) and K10 (K10x), which
training through an analytic normal differentiates once more, are autograd
functions under grad mode whose backwards are K2x², K7x² and K10² (marked
``first_order``): their second derivative in (points, parameters,
cotangent) equals the plain versions' autograd-free results
(``sample_points_backward_xyz_backward_plain``,
``grid_encode_backward_x_backward_plain``,
``sample_volume_grid_backward_x_backward_plain``; bit for bit on the CPU,
where autograd runs exactly those; within 1e-5 of the largest entry on the
card, where the kernels sum in other orders), and a third derivative
raises. ``tests/test_torch_second_order_parity.py`` holds the plain versions
against the JAX package.

The cases take a device: ``tests/test_torch_kernels.py`` runs the same
cases on the card. No JAX here (the card's machine has none).
"""

import pytest
import torch

from trinerflet_tpu_torch.models import gridencoder as GE
from trinerflet_tpu_torch.models import registry as REG
from trinerflet_tpu_torch.ops import grid_sample as GS
from trinerflet_tpu_torch.ops import raymarch as RM
from trinerflet_tpu_torch.ops import wavelets as W
from trinerflet_tpu_torch.ops.activation import trunc_exp

SECOND_ORDER_ERROR = "differentiate twice"
K7_CFG = GE.GridEncoderConfig(num_levels=3, level_dim=2, base_resolution=4, desired_resolution=16,
                              log2_hashmap_size=8)
K10_CFG = REG.VolumeGridConfig(resolution=8, feature_dim=3)
TWICE = ("grid_encode", "sample_points", "volume_grid")  # differentiable twice in the points


def _rand(g, dev, *shape, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * torch.rand(shape, generator=g)).to(dev)


def second_order_cases(dev):
    """name -> () -> (an output that depends on ``x``, ``x``, the other
    inputs that require a gradient); ``x`` is what the first gradient is
    taken in."""
    g = torch.Generator().manual_seed(0)

    def points(n=64, b=0.9):
        return _rand(g, dev, n, 3, lo=-b, hi=b).requires_grad_(True)

    def sample_points():
        planes = _rand(g, dev, 3, 8, 8, 4).requires_grad_(True)
        x = points()
        return GS.sample_points(planes, x, 1.0), x, [planes]

    def sample_points_planes():  # the first gradient in the planes: the K2 backward alone
        planes = _rand(g, dev, 3, 8, 8, 4).requires_grad_(True)
        return GS.sample_points(planes, points().detach(), 1.0), planes, []

    def grid_encode():
        params = {k: v.requires_grad_(True) for k, v in GE.init_grid_params(K7_CFG, g, dev, std=0.5).items()}
        x = points()
        return GE.grid_encode(params, x, K7_CFG, 1.0), x, list(params.values())

    def idwt2d():
        yl = _rand(g, dev, 3, 4, 12, 12).requires_grad_(True)
        yh = _rand(g, dev, 3, 4, 3, 12, 12).requires_grad_(True)
        return W.idwt2d(yl, yh, "bior2.2"), yl, [yh]

    def composite_dense():
        sig = _rand(g, dev, 16, 8, hi=5.0).requires_grad_(True)
        rgb = _rand(g, dev, 16, 8, 3).requires_grad_(True)
        deltas = _rand(g, dev, 16, 8, lo=0.01, hi=0.1)
        ts = torch.cumsum(deltas, dim=1)
        return RM.composite_dense(sig, rgb, deltas, ts)[2], sig, [rgb]

    def composite_compact():
        N, S = 8, 4
        counts = torch.full((N,), S, dtype=torch.int32, device=dev)
        offsets = torch.arange(N, dtype=torch.int32, device=dev) * S
        ray_id = torch.arange(N, dtype=torch.int32, device=dev).repeat_interleave(S)
        dts = _rand(g, dev, N * S, lo=0.01, hi=0.1)
        ts = torch.cumsum(dts, dim=0)
        comp = RM.CompactSamples(torch.zeros((N * S, 3), device=dev), torch.zeros((N * S, 3), device=dev),
                                 ts, dts, ray_id, offsets, counts,
                                 torch.tensor(N * S, dtype=torch.int32, device=dev))
        sig = _rand(g, dev, N * S, hi=5.0).requires_grad_(True)
        rgb = _rand(g, dev, N * S, 3).requires_grad_(True)
        return RM.composite_compact(sig, rgb, comp, N)[2], sig, [rgb]

    def volume_grid():
        params = {"grid": _rand(g, dev, 8, 8, 8, 4, lo=-1.0).requires_grad_(True)}
        x = points()
        return REG.sample_volume_grid(params, x, K10_CFG, 1.0), x, [params["grid"]]

    def textured_background():
        tex = _rand(g, dev, 8, 16, 3, lo=-1.0).requires_grad_(True)
        return REG.background_textured({"bg_texture": tex}, points(b=1.0)), tex, []

    return {"sample_points": sample_points, "sample_points_planes": sample_points_planes,
            "grid_encode": grid_encode, "idwt2d": idwt2d,
            "composite_dense": composite_dense, "composite_compact": composite_compact,
            "volume_grid": volume_grid, "textured_background": textured_background}


CASES = sorted(second_order_cases("cpu"))


def check_second_order_raises(make):
    """A create_graph=True gradient in x works (it is first order); a
    backward through it raises, whether its cotangent is a constant or
    depends on the output."""
    for cot in ("constant", "dependent"):
        out, x, _ = make()
        y = out.sum() if cot == "constant" else out.square().sum()
        (gx,) = torch.autograd.grad(y, [x], create_graph=True)
        assert gx.shape == x.shape and torch.isfinite(gx).all()
        with pytest.raises(RuntimeError, match=SECOND_ORDER_ERROR):
            gx.square().sum().backward()


def _plain_second(name, gg, ct, x, others):
    """The plain K2x², K7x² or K10² on the CPU: the second derivative of
    sum(gg * dL/dx), dL/dx the coordinate gradient under cotangent ct, in
    [x, *others, ct]."""
    x, gg, ct, others = x.cpu(), gg.cpu(), ct.cpu(), [t.cpu() for t in others]
    if name == "sample_points":
        dp, dx, dg = GS.sample_points_backward_xyz_backward_plain(gg, None, others[0], x, ct, 1.0)
        return [dx, dp, dg]
    if name == "grid_encode":
        dx, dg, dt = GE.grid_encode_backward_x_backward_plain(gg, None, x, ct, others, K7_CFG, 1.0)
        return [dx, *dt, dg]
    (grid,) = others
    R = K10_CFG.resolution
    dgrid, dx, dg = REG.sample_volume_grid_backward_x_backward_plain(gg, None, grid.reshape(R**3, -1), x, ct, R,
                                                                     1.0)
    return [dx, dgrid.reshape(grid.shape), dg]


def check_second_order_matches_plain(make, name, rel=0.0):
    """For a sampler whose coordinate gradient is differentiable twice: its
    second derivative in (x, the parameters, the first cotangent) equals
    the plain version's (within ``rel`` of each output's largest entry; 0:
    equal), and a derivative of it raises."""
    out, x, others = make()
    gen = torch.Generator().manual_seed(3)
    ct = torch.randn(out.shape, generator=gen).to(out.device).requires_grad_(True)
    gg = torch.randn(x.shape, generator=gen).to(x.device)
    (gx,) = torch.autograd.grad((out * ct).sum(), [x], create_graph=True)
    got = torch.autograd.grad((gx * gg).sum(), [x, *others, ct], create_graph=True)
    want = _plain_second(name, gg, ct.detach(), x.detach(), [t.detach() for t in others])
    for a, b in zip(got, want):
        a = a.detach().cpu()
        assert a.shape == b.shape and a.dtype == b.dtype
        if rel == 0.0:
            assert torch.equal(a, b)
        else:
            assert (a - b).abs().max().item() <= rel * max(b.abs().max().item(), 1e-30)
    assert got[0].abs().max() > 0 and got[1].abs().max() > 0
    with pytest.raises(RuntimeError, match=SECOND_ORDER_ERROR):
        sum(t.square().sum() for t in got).backward()


@pytest.mark.parametrize("name", CASES)
def test_second_derivative_raises(name):
    """K3, K3c, K4, K11 and the K2 backward in the planes alone raise at the
    second derivative. The samplers' coordinate gradients (K2x, K7x, K10x)
    are differentiable twice now: their second derivative equals the plain
    K2x², K7x², K10² bit for bit, and the third derivative raises."""
    make = second_order_cases("cpu")[name]
    if name in TWICE:
        check_second_order_matches_plain(make, name)
    else:
        check_second_order_raises(make)


@pytest.mark.parametrize("name", CASES)
def test_first_derivative_unchanged_under_create_graph(name):
    """create_graph=True changes no first-order value."""
    make = second_order_cases("cpu")[name]
    torch.manual_seed(0)
    out, x, others = make()
    ct = torch.rand(out.shape, generator=torch.Generator().manual_seed(1))
    a = torch.autograd.grad((out * ct).sum(), [x] + others, create_graph=True)
    b = torch.autograd.grad((out * ct).sum(), [x] + others)
    assert all(torch.equal(u.detach(), v) for u, v in zip(a, b))


def test_trunc_exp_stays_twice_differentiable():
    x = torch.tensor([-20.0, -1.0, 0.5, 20.0], requires_grad=True)
    (gx,) = torch.autograd.grad(trunc_exp(x).sum(), [x], create_graph=True)
    (ggx,) = torch.autograd.grad(gx.sum(), [x])
    want = torch.where(x.abs() < 15, torch.exp(x.detach()), torch.zeros(()))  # clamp's gradient
    torch.testing.assert_close(ggx, want, rtol=1e-6, atol=0)


def _k10_ray_case(R, seed, n_rays=200, per_ray=20, bound=1.5, CH=16):
    """A voxel grid, ray-ordered points (runs of samples 0.4 cells apart,
    so neighbours share cells), a cotangent g and a gg on about one sample
    in six, as an analytic-normal step leaves them."""
    gen = torch.Generator().manual_seed(seed)
    cell = 2 * bound / (R - 1)
    o = (2 * torch.rand((n_rays, 1, 3), generator=gen) - 1) * bound
    d = torch.nn.functional.normalize(torch.randn((n_rays, 1, 3), generator=gen), dim=-1)
    x = (o + d * 0.4 * cell * torch.arange(per_ray, dtype=torch.float32)[None, :, None]).reshape(-1, 3)
    n = x.shape[0]
    grid = torch.randn((R**3, CH), generator=gen)
    g = torch.randn((n, CH), generator=gen)
    gg = torch.randn((n, 3), generator=gen) * (torch.rand((n, 1), generator=gen) < 1 / 6)
    return grid, x, g, gg, bound


@pytest.mark.parametrize("kernel", ["x_backward", "backward"])
@pytest.mark.parametrize("R", [16, 64])
def test_volume_grid_gradient_within_its_float_summation_bound(R, kernel):
    """The error bound that K10²'s (and the K10 backward's) float-atomic
    grid gradient is held to on the card: the plain version's index_add_
    sum lies within it; the same sum with one reached entry moved by 1e-3
    of the largest term, or an entry no term reaches made nonzero, does
    not."""
    grid, x, g, gg, bound = _k10_ray_case(R, 40 + R)
    if kernel == "x_backward":
        ggrid = REG.sample_volume_grid_backward_x_backward_plain(gg, None, grid, x, g, R, bound,
                                                                 (True, False, False))[0]
        err = lambda t: REG.sample_volume_grid_backward_x_backward_error(t, gg, x, g, R, bound)  # noqa: E731
        _, _, corners = REG._k10xx_corners(gg, x, R, bound)
        largest = max(float((omega[:, None] * g).abs().max()) for _, _, _, omega in corners)
    else:
        g = g * (gg != 0).any(-1, keepdim=True)  # masked samples carry no cotangent
        ggrid = REG.sample_volume_grid_backward_plain(g, grid, x, R, bound, x_grad=False)[0]
        err = lambda t: REG.sample_volume_grid_backward_error(t, g, x, R, bound)  # noqa: E731
        largest = float(g.abs().max())  # a weight is at most 1
    assert err(ggrid) <= 1.0
    moved = ggrid.clone().reshape(-1)
    i = int(moved.abs().argmax())
    moved[i] += 1e-3 * largest
    assert err(moved.reshape(ggrid.shape)) > 1.0
    stray = ggrid.clone()
    stray[(ggrid == 0).all(-1).nonzero()[0, 0], 0] = 1e-30  # a row no term reaches
    assert err(stray) == float("inf")
