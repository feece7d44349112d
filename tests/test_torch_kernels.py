"""Each CUDA kernel (K1-K4 forward and backward, K2x, K1f, K5, K3c forward
and backward, K6, K7 forward and backward, K7x, K10 and K11 forward and
backward, and the second derivatives K2x², K7x², K10²) against its plain
PyTorch version, on the card.

These tests need an NVIDIA GPU and nvcc (the kernels have no CPU mode); they
carry the ``cuda`` marker and skip elsewhere. Run them on a GPU machine with
``python -m pytest tests/test_torch_kernels.py -q``.

Tolerances: K1 must agree bit for bit (mask, stride, seg_lastocc, t), and
so must K1f in both modes (t, dt, mask, stride, t0; ts, dts, valid): it
rounds where its plain version rounds and calls the same expf / logf. K3 is
float32 with atol 1e-5 (fused multiply-adds and summation order), its
weights the plain version's bit for bit (the transmittance in the order of
torch's CUDA cumprod) and the same bits on every call; K2 atol
1e-4 (see the test: a one-ulp coordinate difference times the texel slope).
K4 rounds where the plain version rounds (after each 1-D operator and each
add) but sums its taps in another order, so a bf16 rounding may flip: bf16
outputs agree within 2^-6 of the plane's max magnitude (a few bf16 ulps);
float32 within 1e-5. Backward kernels: K2 sums each texel in an order fixed
by the inputs, not the plain version's (float32 atol 1e-5 relative to the
largest gradient; bf16 one ulp, 2^-7), the same bits on every call; K3's
reverse pass matches its plain version's arithmetic to 1e-5 relative; the K4 adjoint as the forward (2^-6 relative in bf16, 1e-5 in
f32). K6: the merged grid, occupancy,
dilation and bbox are equal; the mean (a blocked float sum in a fixed
order) to rtol 1e-5; a second call gives the same bits.
K5 is equal bit for bit on every field. K3c keeps each ray's exponent in
float64 and rounds it as the plain version does, so both take the same
t_thresh cut; its sums run in float64 in another order than the plain
version's (forward atol 1e-5, backward 1e-5 relative to the largest
gradient), the same bits on every call. K7 rounds where its plain version rounds
(the cell coordinate's fused multiply-add, then each operation alone, the
corners summed in order): features within 1e-6 on random points, and on
ray-ordered points (a renderer's layout) equal bit for bit, a second call
the same bits. Its backward's float atomics add in an unspecified order, and
so does the plain version's ``index_add_`` on the card, with up to 3,000
points on one cell: each is held to a float64 sum of the same float32 terms
within the float-summation bound n (eps sum|term| + tiny) of every entry
(``grid_encode_backward_error``; float atomics flush subnormals), not to
the other. K2x: the plane gradient
equal to K2's backward on the same inputs (the same passes), and as K2's
backward against the plain version; the coordinate gradient within 1e-5 of
its largest entry (the channel sums run in another order), rows with no
cotangent exactly 0.
K10 (the voxel grid) and K11 (the textured background) round each
operation alone, as their plain versions do; they are held to the plain
versions run on the CPU, where x / bound and theta / pi are true divisions
as in the kernels (on the card torch divides by a CPU scalar as a multiply
by its reciprocal, so a point on a node could take the neighbour cell).
K10's features equal bit for bit, on random and on ray-ordered points; K11's
colours within 1e-4: CUDA's acosf and atan2f differ from the CPU's by an
ulp or two (~5e-7 rad), which moves u or v by up to ~5e-5 texels, times
this N(0, 1) texture's steepest neighbour difference (~6) and the
sigmoid's slope 1/4 (measured 1.4e-5); a direction within 1e-5 of the
texture's seam may take either side's value, as in the CPU tests; within
2.6 degrees of a pole (|d_y| / |d| > 0.999), where acos's slope
1 / sqrt(1 - y^2) magnifies those ulps, 1e-3. Their
backwards' float atomics add in an unspecified
order: gradients within 1e-5 of the largest entry; K11's within 1e-4, from
the same sigmoid output and with no cotangent on the seam's and the poles'
rays, since its tap weights inherit the direction arithmetic's ulps as its
colours do; other texture sizes scale the N(0, 1) texture by 63 / (H - 1),
so that its slope per radian, which turns those ulps into colour, is the
64 x 128 one's. K7x fuses no
multiply-add where its plain version does not and sums the corners and the
levels in its order: the plain version's bits at C <= 2, where the
channel sum has one order, else within 1e-5 of its largest entry.
K2x², K7x² and K10² against their plain versions run on the CPU (true
divisions there, as in the kernels; K2x² on 1024^2 planes against the plain
version on the card): dL/dg and dL/dx within 1e-5 of their
largest entries (channel and corner sums in other orders); K2x²'s plane
gradient as the K2 backward's (1e-5 relative in f32, one bf16 ulp, 2^-7,
in bf16), the same bits on a second call; K7x²'s table and K10²'s grid
gradients (float atomics) within 1e-5 of the largest entry; each with and
without a cotangent on the first-order parameter gradient; K10² also on
sparse ray-ordered points, its grid gradient within its float-summation
bound (``sample_volume_grid_backward_x_backward_error``). A second
derivative through each kernel function raises as on the CPU, or, for the
samplers' coordinate gradients, matches the plain second derivative and a
third raises (``tests/test_torch_second_order.py``'s cases).
"""

import numpy as np
import pytest
import torch

from trinerflet_tpu_torch import kernels
from trinerflet_tpu_torch.kernels import _build
from tests.test_torch_second_order import (TWICE, check_second_order_matches_plain, check_second_order_raises,
                                           second_order_cases)
from trinerflet_tpu_torch.models import gridencoder as GE
from trinerflet_tpu_torch.models import registry as REG
from trinerflet_tpu_torch.ops import grid_sample as GS
from trinerflet_tpu_torch.ops import raymarch as RM
from trinerflet_tpu_torch.ops import wavelets as W
from trinerflet_tpu_torch.render import renderer as R
from trinerflet_tpu_torch.render.renderer import _dilate3

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# K4 cases: bench.py's four ladder levels (P = 3 x 16 planes), the variants'
# zoom-in crop (a strided 520^2 window of a larger plane), a shape that is no
# multiple of the tiles, and one whose lowpass is a row and a column longer
# than its bands (the trailing-lowpass crop); (yl shape, yh spatial shape, offset
# of the yl window in its parent or None)
IDWT_CASES = {
    "level_72": ((3, 16, 72, 72), (72, 72), None),
    "level_136": ((3, 16, 136, 136), (136, 136), None),
    "level_264": ((3, 16, 264, 264), (264, 264), None),
    "level_520": ((3, 16, 520, 520), (520, 520), None),
    "zoom_crop_520": ((3, 16, 520, 520), (520, 520), 252),
    "ragged": ((2, 3, 37, 53), (37, 53), None),
    "lowpass_crop": ((2, 3, 38, 54), (37, 53), None),
}


def _idwt_inputs(dev, dtype, case, seed):
    (B, C, H, W), hw, off = IDWT_CASES[case]
    g = torch.Generator().manual_seed(seed)
    if off is None:
        yl = torch.randn((B, C, H, W), generator=g).to(dev, dtype)
    else:
        yl = torch.randn((B, C, H + 2 * off, W + 2 * off), generator=g).to(dev, dtype)
        yl = yl[:, :, off : off + H, off : off + W]
    yh = (0.3 * torch.randn((B, C, 3) + hw, generator=g)).to(dev, dtype)
    return yl, yh


@pytest.mark.parametrize("name", sorted(W._IDWT_PAD))
@pytest.mark.parametrize("case", list(IDWT_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_idwt_kernel_matches_plain(dev, dtype, case, name):
    yl, yh = _idwt_inputs(dev, dtype, case, 0)
    n0 = kernels.launches["idwt"]
    got = W.idwt2d(yl, yh, name)
    assert kernels.launches["idwt"] == n0 + 1
    ref = W.idwt2d_plain(yl, yh, name)
    torch.cuda.synchronize()
    L = len(W.synthesis_taps(name, dtype)[0])
    assert got.shape == ref.shape == yh.shape[:2] + tuple(2 * n - L + 2 for n in yh.shape[-2:])
    assert got.dtype == dtype
    err = (got.float() - ref.float()).abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2.0**-6 * ref.float().abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("C", [4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sample_kernel_matches_plain(dev, dtype, C):
    g = torch.Generator().manual_seed(1)
    planes = torch.randn((3, 64, 48, C), generator=g).to(dev, dtype)
    xyz = (3.4 * torch.rand((5000, 3), generator=g) - 1.7).to(dev)  # past the bound: clamp
    n0 = kernels.launches["grid_sample"]
    got = GS.sample_points(planes, xyz, 1.5)
    assert kernels.launches["grid_sample"] == n0 + 1
    ref = GS.sample_points_plain(planes, xyz, 1.5)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (5000, 3, C)
    # both divide by 1.5 truly and round each product; the plain version's
    # sum over the four corners may run in another order on the card
    assert (got - ref).abs().max().item() <= 1e-4


def _k2_points(kind, H, W, M, lbound, gen):
    """Points for the K2 cases: ``random`` over the box and past it (the
    clamp); ``edges`` on the texel edges of the backward's tiles (32 texels
    wide, 16 or 32 high) and of the plane's border (x0 = W - 2, and x = W - 1
    exactly), on every axis; ``one_texel`` all in one texel (one tile, split
    across many blocks)."""
    if kind == "random":
        return 2.2 * lbound * torch.rand((M, 3), generator=gen) - 1.1 * lbound
    if kind == "one_texel":
        return 0.1 + 1e-4 * torch.rand((M, 3), generator=gen)
    us = []
    for n in (H, W):  # an axis is the planes' H on some and W on others
        t = torch.tensor([15.0, 16.0, 31.0, 31.5, 32.0, 47.0, 63.0, 64.0], dtype=torch.float64)
        t = torch.cat([t[t < n - 2], torch.tensor([n - 2.0, n - 1.5, n - 1.0, 0.0, 0.5])])
        us.append((t / (n - 1) * 2.0 - 1.0) * lbound)
    u = torch.cat(us)
    pick = torch.randint(0, len(u), (M, 3), generator=gen)
    return u[pick].float()


# (H, W, C, dtype, points): H != W, sides no multiple of the tiles, every
# channel count, tile and border edges, one texel (the split tiles), bench's
# 1024^2 x 16 bf16 planes, and planes of more than 16,384 tiles
K2_CASES = {
    "c4_f32_ragged": (37, 70, 4, torch.float32, "edges"),
    "c8_bf16_ragged": (70, 37, 8, torch.bfloat16, "edges"),
    "c16_bf16_ragged": (100, 67, 16, torch.bfloat16, "edges"),
    "c32_f32_ragged": (45, 66, 32, torch.float32, "edges"),
    "c32_bf16_random": (64, 96, 32, torch.bfloat16, "random"),
    "c16_f32_kplanes": (64, 64, 16, torch.float32, "random"),
    "c16_bf16_one_texel": (64, 48, 16, torch.bfloat16, "one_texel"),
    "c4_f32_one_texel": (40, 40, 4, torch.float32, "one_texel"),
    "c16_bf16_bench": (1024, 1024, 16, torch.bfloat16, "random"),
    # more tiles than a block-local histogram holds: the count pass adds to
    # the global counts directly
    "c4_bf16_wide": (1024, 5632, 4, torch.bfloat16, "random"),
}


@pytest.mark.parametrize("case", list(K2_CASES))
def test_sample_kernels_match_plain_on_edges(dev, case):
    """K2 forward and backward against their plain versions (forward atol
    1e-4, backward 1e-5 f32 / 2^-7 bf16 of the largest gradient), a fifth of
    the cotangent rows zero."""
    H, W, C, dtype, kind = K2_CASES[case]
    gen = torch.Generator().manual_seed(11)
    M = {"random": 200_000, "edges": 30_000, "one_texel": 20_000}[kind]
    planes = torch.randn((3, H, W, C), generator=gen).to(dev, dtype)
    xyz = _k2_points(kind, H, W, M, 1.5, gen).to(dev)
    ct = torch.randn((M, 3, C), generator=gen)
    ct[torch.rand((M,), generator=gen) < 0.2] = 0.0
    ct = ct.to(dev)
    got = GS._sample_points_cuda(planes, xyz, 1.5)
    ref = GS.sample_points_plain(planes, xyz, 1.5)
    assert (got - ref).abs().max().item() <= 1e-4
    n0 = kernels.launches["grid_sample_bwd"]
    gg = GS._sample_points_backward_cuda(ct, xyz, 1.5, (3, H, W, C), dtype)
    assert kernels.launches["grid_sample_bwd"] == n0 + GS.K2_BWD_LAUNCHES
    rg = GS.sample_points_backward_plain(ct, xyz, 1.5, (3, H, W, C), dtype)
    torch.cuda.synchronize()
    assert gg.dtype == rg.dtype == dtype and gg.shape == (3, H, W, C)
    assert _rel_close(gg, rg, 1e-5 if dtype == torch.float32 else 2.0**-7)
    assert ((gg != 0) == (rg != 0)).float().mean().item() > 0.999  # the texels reached


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sample_backward_kernel_zero_cotangent_and_no_points(dev, dtype):
    """An all-zero cotangent gives a zero gradient (every texel written);
    no points give zeros without a launch."""
    gen = torch.Generator().manual_seed(12)
    planes_shape = (3, 50, 70, 8)
    xyz = (3.0 * torch.rand((4000, 3), generator=gen) - 1.5).to(dev)
    out = GS._sample_points_backward_cuda(torch.zeros((4000, 3, 8), device=dev), xyz, 1.5, planes_shape, dtype)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == planes_shape and (out == 0).all()
    n0 = kernels.launches["grid_sample_bwd"]
    out = GS._sample_points_backward_cuda(torch.zeros((0, 3, 8), device=dev), xyz[:0], 1.5, planes_shape, dtype)
    assert kernels.launches["grid_sample_bwd"] == n0 and (out == 0).all() and out.dtype == dtype


@pytest.mark.parametrize("case", ["c16_bf16_bench", "c4_f32_one_texel", "c4_bf16_wide"])
def test_sample_backward_kernel_is_deterministic(dev, case):
    """Two K2 backward calls on the same cotangent and points give the same
    bits: the tile lists hold their rows in the order the scatter walks
    them and each texel's sum runs in an order fixed by the inputs (the
    bench's planes, one split texel, and planes of more tiles than a
    block-local histogram holds)."""
    H, W, C, dtype, kind = K2_CASES[case]
    gen = torch.Generator().manual_seed(13)
    M = {"random": 200_000, "one_texel": 20_000}[kind]
    xyz = _k2_points(kind, H, W, M, 1.5, gen).to(dev)
    ct = torch.randn((M, 3, C), generator=gen).to(dev)
    a = GS._sample_points_backward_cuda(ct, xyz, 1.5, (3, H, W, C), dtype)
    b = GS._sample_points_backward_cuda(ct, xyz, 1.5, (3, H, W, C), dtype)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and a.abs().max().item() > 0


# K3 cases: row lengths that fill no chunk (1, 7), the per-ray layout's B
# (20), one chunk of 32 lanes exactly and one past it (32, 33), the proposal
# weights' P (64) and the dense renderer's 512 and 576; one ray and 3,000 (no
# multiple of a block's rays); "edge" rows: every fifth ray fully masked,
# every fifth (offset 2) with sigma up to 1e4, so the transmittance
# underflows through the subnormals to 0 within a few samples.
K3_T = [1, 7, 20, 32, 33, 64, 512, 576]


def _k3_inputs(dev, N, T, rows, scale, seed):
    g = torch.Generator().manual_seed(seed)
    sig = scale * torch.rand((N, T), generator=g)
    rgb = torch.rand((N, T, 3), generator=g)
    dl = 0.05 * torch.rand((N, T), generator=g)
    mask = torch.rand((N, T), generator=g) < 0.8
    if rows == "edge":
        mask[0::5] = False
        sig[2::5] = 1e4 * torch.rand(sig[2::5].shape, generator=g)
    return g, (sig.to(dev), rgb.to(dev), dl.to(dev), torch.cumsum(dl, 1).to(dev), mask.to(dev))


@pytest.mark.parametrize("t_thresh", [0.0, 1e-4])
@pytest.mark.parametrize("rows", ["random", "edge"])
@pytest.mark.parametrize("N", [1, 3000])
@pytest.mark.parametrize("T", K3_T)
def test_composite_kernel_matches_plain(dev, T, N, rows, t_thresh):
    _, args = _k3_inputs(dev, N, T, rows, 60.0, 2)
    n0 = kernels.launches["composite"]
    got = RM.composite_dense(*args, t_thresh=t_thresh)
    assert kernels.launches["composite"] == n0 + 1
    ref = RM.composite_dense_plain(*args, t_thresh=t_thresh)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 1e-5
    if rows == "edge":
        assert not got[3][0::5].any() and not got[0][0::5].any()


@pytest.mark.parametrize("t_thresh", [0.0, 1e-4])
@pytest.mark.parametrize("T", K3_T)
def test_composite_weights_equal_the_plain_version_bit_for_bit(dev, T, t_thresh):
    """K3 forms the transmittance in the order of torch's CUDA cumprod on
    rows of many rays (blocks of 32 samples, Sklansky's tree), so the
    weights, and with them the t_thresh cut, are the plain version's bits.
    That order was read from, and checked against, torch 2.11.0+cu128: on
    another torch a failure here may be ATen's scan, not the kernel."""
    _, args = _k3_inputs(dev, 3000, T, "edge", 60.0, 3)
    got = RM._composite_cuda(*args, t_thresh)[3]
    assert torch.equal(got, RM.composite_dense_plain(*args, t_thresh=t_thresh)[3])


@pytest.mark.parametrize("T", [20, 576])
def test_composite_kernels_give_the_same_bits_on_every_call(dev, T):
    g, args = _k3_inputs(dev, 3000, T, "edge", 60.0, 7)
    N = args[0].shape[0]
    cts = [torch.randn(s, generator=g).to(dev) for s in ((N,), (N,), (N, 3), (N, T))]
    for t_thresh in (0.0, 1e-4):
        a, b = RM._composite_cuda(*args, t_thresh), RM._composite_cuda(*args, t_thresh)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        a = RM._composite_backward_cuda(*args, t_thresh, *cts)
        b = RM._composite_backward_cuda(*args, t_thresh, *cts)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# K1 cases: (grid H, cascades, max_steps, occupied fraction, fine stride,
# coarse stride, coarse_budget, budget, num_coarse or None for the worst case
# ceil(bound * steps / F), share of rays that miss the box). The first four
# are the stride cases at a 64^3 grid; then bench's full width (128^3 x 2,
# 1024 steps, num_coarse 128, the training strides), a tuner-lowered
# num_coarse, one warp of kept segments (coarse_budget 32) and a budget past
# one warp (40), empty and full grids, and spread ranks past the count
# (coarse_budget 7, budget 13: ceil(b * count / budget) in float32 exceeds
# the count on a full grid)
K1_CASES = {
    "sparse": (64, 2, 512, 0.02, 1, 1, 8, 20, None, 0.0),
    "stride_1_1": (64, 2, 512, 0.3, 1, 1, 8, 20, None, 0.0),
    "stride_2_1": (64, 2, 512, 0.3, 2, 1, 8, 20, None, 0.0),
    "stride_3_2": (64, 2, 512, 0.1, 3, 2, 8, 20, None, 0.0),
    "bench_width": (128, 2, 1024, 0.05, 2, 2, 8, 20, None, 0.1),
    "tuned_num_coarse": (128, 2, 1024, 0.05, 2, 2, 8, 20, 77, 0.1),
    "wide_budgets": (128, 2, 1024, 0.3, 1, 1, 32, 40, None, 0.1),
    "empty_grid": (128, 2, 1024, 0.0, 2, 2, 8, 20, None, 0.25),
    "full_grid": (128, 2, 1024, 1.0, 2, 2, 8, 20, None, 0.25),
    "rank_past_count": (64, 2, 512, 1.0, 1, 1, 7, 13, None, 0.1),
}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_march_kernel_matches_plain_bit_for_bit(dev, case):
    H, CAS, steps, frac, fs, cs, cb, B, nc, miss = K1_CASES[case]
    g = torch.Generator().manual_seed(3)
    N, bound = 4000, 1.5
    v = torch.randn((N, 3), generator=g)
    o = 2.0 * v / v.norm(dim=1, keepdim=True)
    d = 0.6 * (2 * torch.rand((N, 3), generator=g) - 1) - o
    k = int(miss * N)  # rays on the plane y = 4, parallel to it: they miss the box
    o[:k] = torch.tensor([0.0, 4.0, 0.0]) + 0.1 * torch.rand((k, 3), generator=g)
    d[:k] = torch.randn((k, 3), generator=g) * torch.tensor([1.0, 0.0, 1.0])
    d = d / d.norm(dim=1, keepdim=True)
    occ = torch.rand((CAS, H, H, H), generator=g) < frac
    occ_c = _dilate3(occ, 2)
    o, d, occ, occ_c = o.to(dev), d.to(dev), occ.to(dev), occ_c.to(dev)
    aabb = torch.tensor([-bound] * 3 + [bound] * 3, device=dev)
    n, f = RM.near_far_from_aabb(o, d, aabb, 0.2)
    hit = n < 1e30
    n, f = torch.where(hit, n, 0.0), torch.where(hit, f, 0.0)
    noise = torch.rand((N,), generator=g).to(dev)
    kw = dict(num_coarse=nc or int(np.ceil(bound * steps / 12)), fine_per_coarse=12, coarse_budget=cb,
              budget=B, max_steps=steps, grid_size=H, cascades=CAS, bound=bound,
              occ_test_stride=fs, coarse_test_stride=cs)
    n0 = kernels.launches["march"]
    got = RM.march_hierarchical(o, d, n, f, occ, occ_c, noise, **kw)
    assert kernels.launches["march"] == n0 + 1
    ref = RM.march_hierarchical_plain(o, d, n, f, occ, occ_c, noise, **kw)
    torch.cuda.synchronize()
    assert (ref[2].sum().item() > 0) == (frac > 0)
    assert (miss == 0 or (~hit).any()) and not ref[2][~hit].any()  # rays that miss keep nothing
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _k1f_inputs(dev, gamma, bound, steps, frac):
    """Rays, a grid and noise for K1f: a quarter of the rays start inside the
    box (at min_near, in the ladder's first phase), a sixteenth miss it
    (near = far = 0: no valid candidate)."""
    g = torch.Generator().manual_seed(14)
    N, H = 4000, 64
    cfg = R.RenderConfig(bound=bound, grid_size=H, max_steps=steps, dt_gamma=gamma)
    C, q = cfg.cascades, N // 4
    v = torch.randn((N, 3), generator=g)
    r = (1.5 + 1.5 * torch.rand((N, 1), generator=g)) * bound
    r[:q] = 0.5 * bound * torch.rand((q, 1), generator=g)
    o = r * v / v.norm(dim=1, keepdim=True)
    d = 0.5 * bound * (2 * torch.rand((N, 3), generator=g) - 1) - o
    d[:q] = torch.randn((q, 3), generator=g)
    d[-(N // 16):] = o[-(N // 16):]  # pointing away from the box
    d = d / d.norm(dim=1, keepdim=True)
    occ = torch.rand((C, H, H, H), generator=g) < frac
    noise = torch.rand((N,), generator=g)
    o, d, occ, noise = o.to(dev), d.to(dev), occ.to(dev), noise.to(dev)
    aabb = torch.tensor(cfg.aabb, device=dev)
    n, f = RM.near_far_from_aabb(o, d, aabb, cfg.min_near)
    hit = n < 1e30
    n, f = torch.where(hit, n, 0.0), torch.where(hit, f, 0.0)
    kw = dict(num_steps=cfg.num_candidates, max_steps=steps, grid_size=H, cascades=C, bound=bound,
              dt_gamma=gamma)
    return (o, d, n, f, occ, noise), kw


K1F_CASES = [
    (0.0, 1.5, 512, 0.3),          # constant dt_min, the uniform march (Kc 768)
    (1.0 / 128, 4.0, 1024, 0.2),   # the CLI's ladder: phases 1 and 2 within far (Kc 519)
    (1.0 / 64, 2.0, 64, 0.8),      # all three phases within far; the max_steps cap binds (Kc 109)
]


@pytest.mark.parametrize("B", [7, 13, 20, 48])
@pytest.mark.parametrize("gamma,bound,steps,frac", K1F_CASES)
def test_march_flat_kernel_matches_plain_bit_for_bit(dev, gamma, bound, steps, frac, B):
    """K1f's per-ray and candidate modes, every output, and a second call
    the same bits. At B = 7 and 13 some rays' spread rank runs past their
    count (the slot takes the last candidate, mask 1); B = 48 takes more
    than a warp's 32 slots a ray; some rays keep nothing."""
    args, kw = _k1f_inputs(dev, gamma, bound, steps, frac)
    n0 = kernels.launches["march_flat"]
    got = RM.march_flat(*args, budget=B, **kw)
    cand = RM.march_flat_candidates(*args, **kw)
    assert kernels.launches["march_flat"] == n0 + 2
    ref = RM.march_flat_plain(*args, budget=B, **kw)
    ref_c = RM.march_candidates_plain(*args, **kw)
    again = list(RM.march_flat(*args, budget=B, **kw)) + list(RM.march_flat_candidates(*args, **kw))
    torch.cuda.synchronize()
    for a, b, c in zip(list(got) + list(cand), list(ref) + list(ref_c), again):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b) and torch.equal(a, c)
    valid = ref_c.valid
    count = valid.sum(1)
    assert ref[2].sum().item() > 0 and (ref[3] > 1).any()  # kept samples, spread rays
    assert (count == 0).any()  # rays with no valid candidate
    b1 = torch.arange(1, B + 1, device=dev, dtype=torch.float32)
    tgt = torch.ceil(b1[None, :] * count[:, None].float() * RM._inv(B))
    past = (count > B) & (tgt > count[:, None]).any(1)
    assert past.any() == (B in (7, 13)), int(past.sum())
    if past.any():  # the slot past the count: the last candidate, masked true
        assert torch.equal(ref[0][past, -1], ref_c.ts[past, -1]) and ref[2][past, -1].all()
    if steps < kw["num_steps"] and frac > 0.5:
        assert count.max().item() == steps
    if gamma > 0:  # valid candidates in every phase the case names
        C = kw["cascades"]
        dt_min, dt_max = 2 * RM.SQRT3 / steps, 2 * RM.SQRT3 * 2 ** (C - 1) / kw["grid_size"]
        ts = ref_c.ts[valid]
        assert (ts < dt_min / gamma).any() and (ts > dt_min / gamma).any()
        assert (ts > dt_max / gamma).any() == (bound == 2.0)


def _rel_close(a, b, rel):
    a, b = a.float(), b.float()
    return (a - b).abs().max().item() <= rel * max(b.abs().max().item(), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sample_backward_kernel_matches_plain(dev, dtype):
    g = torch.Generator().manual_seed(4)
    H, W, C, M = 64, 48, 16, 20000
    xyz = (3.4 * torch.rand((M, 3), generator=g) - 1.7).to(dev)
    xyz[:500] = 0.1  # contention: many samples on one texel
    ct = torch.randn((M, 3, C), generator=g).to(dev)
    ct[1000:3000] = 0.0  # masked samples
    n0 = kernels.launches["grid_sample_bwd"]
    got = GS._sample_points_backward_cuda(ct, xyz, 1.5, (3, H, W, C), dtype)
    assert kernels.launches["grid_sample_bwd"] == n0 + GS.K2_BWD_LAUNCHES
    ref = GS.sample_points_backward_plain(ct, xyz, 1.5, (3, H, W, C), dtype)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == dtype and got.shape == (3, H, W, C)
    assert _rel_close(got, ref, 1e-5 if dtype == torch.float32 else 2.0**-7)


def _k2x_inputs(dev, dtype, H, W, C, M, seed):
    g = torch.Generator().manual_seed(seed)
    planes = torch.randn((3, H, W, C), generator=g).to(dev, dtype)
    xyz = 2.6 * torch.rand((M, 3), generator=g) - 1.3             # inside and clamped outside
    xyz[:300, 0], xyz[300:600, 1], xyz[600:900, 2] = 1.0, -1.0, 1.0  # on the border: the 0.5 tie
    k = torch.randint(1, W - 1, (1000, 3), generator=g)
    xyz[900:1900] = 2.0 * k / (W - 1) - 1.0                         # interior cell edges
    xyz[2000:2500] = 0.1                                            # contention on one texel
    ct = torch.randn((M, 3, C), generator=g)
    ct[3000:5000] = 0.0                                             # unrouted or masked rows
    return planes, xyz.to(dev), ct.to(dev)


@pytest.mark.parametrize("case", ["random", "zoom_in"])
@pytest.mark.parametrize("C", [4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sample_backward_xyz_kernel_matches_plain(dev, dtype, C, case):
    """K2x at lbound 1.0, as the learned zoom calls it (the point arrives
    divided by the learned bound), on 64 x 48 planes: its plane gradient is
    the K2 backward's bit for bit on the same cotangent and points (the same
    passes, each sum in an order fixed by the inputs), and near the plain
    version's; dL/dxyz within 1e-5 of its largest entry, rows with no
    cotangent exactly 0. ``zoom_in``: as on a zoom-in plane, 90% of the
    points carry no cotangent (the router sent them to another level)."""
    planes, xyz, ct = _k2x_inputs(dev, dtype, 64, 48, C, 20000, 6)
    if case == "zoom_in":
        ct[torch.rand((20000,), generator=torch.Generator().manual_seed(9)).to(dev) < 0.9] = 0.0
    n0 = kernels.launches["grid_sample_bwd_xyz"]
    pg, xg = GS._sample_points_backward_xyz_cuda(ct, planes, xyz, 1.0)
    assert kernels.launches["grid_sample_bwd_xyz"] == n0 + 1 + GS.K2_BWD_LAUNCHES
    k2 = GS._sample_points_backward_cuda(ct, xyz, 1.0, tuple(planes.shape), dtype)
    rpg, rxg = GS.sample_points_backward_xyz_plain(ct, planes, xyz, 1.0)
    torch.cuda.synchronize()
    assert pg.dtype == rpg.dtype == dtype and xg.shape == (20000, 3) and xg.dtype == torch.float32
    assert torch.equal(pg, k2)
    assert _rel_close(pg, rpg, 1e-5 if dtype == torch.float32 else 2.0**-7)
    assert _rel_close(xg, rxg, 1e-5)
    dead = (ct == 0).all(-1).all(-1)
    assert (xg[dead] == 0).all() and (xg[:900] != 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sample_backward_xyz_kernel_without_plane_gradient(dev, dtype):
    """K2x as an analytic normal calls it (planes_grad=False): one launch, no
    plane gradient, dL/dxyz as with it and as the plain version on the CPU
    (where xyz / 1.5 is a true division, as in the kernel: on the card torch
    multiplies by the reciprocal, and a point on a cell edge may take the
    neighbour cell's slope)."""
    planes, xyz, ct = _k2x_inputs(dev, dtype, 64, 48, 16, 20000, 8)
    n0 = kernels.launches["grid_sample_bwd_xyz"]
    pg, xg = GS._sample_points_backward_xyz_cuda(ct, planes, xyz, 1.5, planes_grad=False)
    assert kernels.launches["grid_sample_bwd_xyz"] == n0 + 1
    _, xg_full = GS._sample_points_backward_xyz_cuda(ct, planes, xyz, 1.5)
    rpg, rxg = GS.sample_points_backward_xyz_plain(ct.cpu(), planes.cpu(), xyz.cpu(), 1.5, planes_grad=False)
    torch.cuda.synchronize()
    assert pg is None and rpg is None and xg.shape == (20000, 3) and xg.dtype == torch.float32
    assert torch.equal(xg, xg_full)
    assert _rel_close(xg.cpu(), rxg, 1e-5)
    x = xyz.clone().requires_grad_(True)  # autograd asks for it when the planes need no gradient
    n0 = kernels.launches["grid_sample_bwd_xyz"]
    (gx,) = torch.autograd.grad((GS.sample_points(planes, x, 1.5) * ct).sum(), x)
    assert kernels.launches["grid_sample_bwd_xyz"] == n0 + 1
    assert torch.equal(gx, xg)


def test_sample_points_autograd_launches_k2x_only_for_points(dev):
    planes, xyz, ct = _k2x_inputs(dev, torch.bfloat16, 64, 48, 16, 6000, 7)
    planes.requires_grad_(True)
    names = ("grid_sample_bwd", "grid_sample_bwd_xyz")
    n0 = [kernels.launches[k] for k in names]
    (GS.sample_points(planes, xyz, 1.5) * ct).sum().backward()
    assert [kernels.launches[k] - a for k, a in zip(names, n0)] == [GS.K2_BWD_LAUNCHES, 0]
    grad_planes = planes.grad
    planes.grad = None
    xyz = xyz.clone().requires_grad_(True)
    (GS.sample_points(planes, xyz, 1.5) * ct).sum().backward()
    assert [kernels.launches[k] - a for k, a in zip(names, n0)] == [GS.K2_BWD_LAUNCHES,
                                                                    1 + GS.K2_BWD_LAUNCHES]
    ref_pg, ref_xg = GS.sample_points_backward_xyz_plain(ct, planes.detach(), xyz.detach(), 1.5)
    assert torch.equal(planes.grad, grad_planes) and _rel_close(planes.grad, ref_pg, 2.0**-7)
    # the coordinate gradient is held in L2 (the kernel fuses the channel
    # sums' multiply-adds no more, but sums them in another order)
    d = (xyz.grad - ref_xg).norm() / ref_xg.norm()
    assert d.item() <= 1e-3, d.item()
    with pytest.raises(TypeError, match="bf16 or f32"):
        GS._sample_points_backward_xyz_cuda(ct, planes.detach().double(), xyz.detach(), 1.0)


@pytest.mark.parametrize("t_thresh", [0.0, 1e-4])
@pytest.mark.parametrize("rows", ["random", "edge"])
@pytest.mark.parametrize("N", [1, 3000])
@pytest.mark.parametrize("T", K3_T)
def test_composite_backward_kernel_matches_plain(dev, T, N, rows, t_thresh):
    g, (sig, rgb, dl, ts, mask) = _k3_inputs(dev, N, T, rows, 80.0, 5)
    cts = [torch.randn(s, generator=g).to(dev) for s in ((N,), (N,), (N, 3), (N, T))]
    n0 = kernels.launches["composite_bwd"]
    got = RM._composite_backward_cuda(sig, rgb, dl, ts, mask, t_thresh, *cts)
    assert kernels.launches["composite_bwd"] == n0 + 1
    ref = RM.composite_dense_backward_plain(sig, rgb, dl, ts, mask, t_thresh, *cts)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert _rel_close(a, b, 1e-5)


def test_composite_backward_kernel_refuses_rows_past_its_shared_memory(dev):
    """The backward keeps a block's chunk starts in 48 KB of shared memory:
    98,304 samples a ray at most. Its launcher refuses a longer row, and
    nothing launches."""
    for T, refused in ((98304, False), (98305, True)):
        g, args = _k3_inputs(dev, 1, T, "random", 1e-3, 9)
        cts = [torch.randn(s, generator=g).to(dev) for s in ((1,), (1,), (1, 3), (1, T))]
        n0 = kernels.launches["composite_bwd"]
        if refused:
            with pytest.raises(RuntimeError, match="composite_dense backward"):
                RM._composite_backward_cuda(*args, 0.0, *cts)
        else:
            assert torch.isfinite(RM._composite_backward_cuda(*args, 0.0, *cts)[0]).all()
        assert kernels.launches["composite_bwd"] == n0 + (not refused)


@pytest.mark.parametrize("name", sorted(W._IDWT_PAD))
@pytest.mark.parametrize("case", list(IDWT_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_idwt_adjoint_kernel_matches_plain(dev, dtype, case, name):
    (B, C, _, _), (H, W_), _ = IDWT_CASES[case]
    L = len(W.synthesis_taps(name, dtype)[0])
    g = torch.Generator().manual_seed(6)
    ct = torch.randn((B, C, 2 * H - L + 2, 2 * W_ - L + 2), generator=g).to(dev, dtype)
    n0 = kernels.launches["idwt_adjoint"]
    got = W._idwt2d_adjoint_cuda(ct, name)
    assert kernels.launches["idwt_adjoint"] == n0 + 1
    ref = W.idwt2d_adjoint_plain(ct, name)
    torch.cuda.synchronize()
    assert got[0].shape == (B, C, H, W_) and got[1].shape == (B, C, 3, H, W_)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == dtype
        assert _rel_close(a, b, 1e-5 if dtype == torch.float32 else 2.0**-6)


@pytest.mark.parametrize("name", sorted(W._IDWT_PAD))
@pytest.mark.parametrize("case", ["level_72", "ragged"])
def test_idwt_adjoint_identity(dev, case, name):
    """<idwt2d(yl, yh), G> = <yl, d_yl> + <yh, d_yh> in float32, the inner
    products taken in float64, within 1e-5 of the sum of |products|."""
    yl, yh = _idwt_inputs(dev, torch.float32, case, 7)
    out = W.idwt2d(yl, yh, name)
    G = torch.randn(out.shape, generator=torch.Generator().manual_seed(8)).to(dev)
    d_yl, d_yh = W._idwt2d_adjoint_cuda(G, name)
    terms = [(out, G), (yl, d_yl), (yh, d_yh)]
    lhs = (out.double() * G.double()).sum().item()
    rhs = sum((a.double() * b.double()).sum().item() for a, b in terms[1:])
    scale = sum((a.double() * b.double()).abs().sum().item() for a, b in terms)
    assert abs(lhs - rhs) <= 1e-5 * scale, (lhs, rhs, scale)


def _occupancy_config(H, r, bound):
    """A render config with grid H and dilation radius r: max_steps so that
    a coarse segment spans 2r - 1 cells (r = ceil of half of it)."""
    cfg = R.RenderConfig(bound=bound, grid_size=H,
                         max_steps=round(12 * 3**0.5 * H / (2 * r - 1)))
    assert cfg.coarse_dilation_radius == r
    return cfg


# occupied cells that K6's tiles (16 rows a side) and words (32 cells) must
# carry across: on the tile edges (x, y = 15, 16), on the word edges (z =
# 31, 32) and on the grid's faces and corners
def _edge_cells(H):
    t = [v for v in (15, 16) if v < H]
    w = [v for v in (31, 32) if v < H]
    return ([(x, y, z) for x in t for y in t for z in w]
            + [(0, 0, 0), (H - 1, H - 1, H - 1), (0, H - 1, H // 2), (H - 1, 0, 0),
               (H // 2, 0, H - 1)])


@pytest.mark.parametrize("frac", [1.0, 0.25])
@pytest.mark.parametrize("bound", [1.5, 4.0])  # 2 and 3 cascades
@pytest.mark.parametrize("H", [37, 40, 64, 128])
@pytest.mark.parametrize("r", [1, 2, 3])
def test_occupancy_kernel_matches_plain(dev, r, H, bound, frac):
    """K6 at dilation radius 1-3, on grids no multiple of 32 (40) or of 4
    (37: scalar loads and byte stores), with 2 and 3 cascades, full and
    partial refresh (the partial one at an offset no multiple of 4: the
    merge's scalar path); sparse occupancy with occupied cells on the
    tiles', words' and grid's edges, a cascade that stays empty beside the
    occupied ones, cells at -1 that stay; a second call gives the same bits;
    an all-empty grid gives the scene box."""
    g = torch.Generator().manual_seed(7 + H + r)
    cfg = _occupancy_config(H, r, bound)
    C, n = cfg.cascades, H**3
    spike = lambda shape: torch.where(torch.rand(shape, generator=g) < 0.002,  # noqa: E731
                                      50 + 50 * torch.rand(shape, generator=g),
                                      0.01 * torch.rand(shape, generator=g))
    old = spike((C, n))
    old[:, n // 2 : n // 2 + n // 10] = -1.0  # cells no camera sees
    for x, y, z in _edge_cells(H):
        old[0, (x * H + y) * H + z] = 80.0
    old[1] = 0.0  # cascade 1 stays empty
    S = int(n * frac)
    off = n // 4 + 1 if frac < 1 else 0
    tmp = spike((C, S))
    tmp[1] = 0.0
    old, tmp = old.to(dev), tmp.to(dev)
    n0 = kernels.launches["occupancy"]
    got = R._occupancy_upkeep_cuda(old, tmp, off, cfg, 0.95)
    assert kernels.launches["occupancy"] == n0 + 2
    again = R._occupancy_upkeep_cuda(old, tmp, off, cfg, 0.95)
    ref = R.occupancy_upkeep_plain(old, tmp, off, cfg, 0.95)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    assert (got[0][old < 0] == -1).all()
    assert abs(got[3].item() - ref[3].item()) <= 1e-5 * ref[3].item()
    # threshold at the kernel's own mean: the plain occupancy, dilation, bbox
    thresh = torch.clamp_max(got[3], cfg.density_thresh) * cfg.occ_thresh_scale
    occ = (ref[0] > thresh).reshape(got[1].shape)
    coarse = _dilate3(occ, r)
    assert occ.any() and not occ[1].any() and coarse[0].any() and not coarse.all()
    assert all(occ[0, x, y, z] for x, y, z in _edge_cells(H))
    assert torch.equal(got[1], occ)
    assert torch.equal(got[2], coarse)
    assert torch.equal(got[4], R._occupied_bbox(occ, cfg))
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    empty = R._occupancy_upkeep_cuda(torch.zeros_like(old), torch.zeros_like(tmp), off, cfg, 0.95)
    assert not empty[1].any() and not empty[2].any()
    assert torch.equal(empty[4].cpu(), torch.tensor(cfg.aabb))


@pytest.mark.parametrize("bound", [1.5, 4.0])
@pytest.mark.parametrize("H", [37, 40, 128])
@pytest.mark.parametrize("r", [1, 3])
def test_occupancy_rebuild_matches_plain(dev, r, H, bound):
    """K6's rebuild of a checkpoint's occupancy (its second launch on a
    stored grid at a stored mean) against its plain version, at a mean below
    and above density_thresh; between upkeep calls on the same stream (the
    scratch each leaves behind); on an upkeep's own output at its own mean
    it gives the upkeep's occupancy, dilation and bbox."""
    g = torch.Generator().manual_seed(11 + H + r)
    cfg = _occupancy_config(H, r, bound)
    C, n = cfg.cascades, H**3
    grid = torch.where(torch.rand((C, n), generator=g) < 0.003, 60 * torch.rand((C, n), generator=g),
                       0.5 * torch.rand((C, n), generator=g))
    grid[:, : n // 7] = -1.0
    for x, y, z in _edge_cells(H):
        grid[0, (x * H + y) * H + z] = 70.0
    grid = grid.to(dev)
    up = R._occupancy_upkeep_cuda(grid, grid[:, : n // 3].clone(), 0, cfg, 0.95)
    for mean in (float(up[3]), 0.0371, 12.5):
        n0 = kernels.launches["occupancy"]
        got = R._occupancy_rebuild_cuda(grid, mean, cfg)
        assert kernels.launches["occupancy"] == n0 + 2
        ref = R.occupancy_rebuild_plain(grid, mean, cfg)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert got[0].any() and not got[1].all()
    again = R._occupancy_upkeep_cuda(grid, grid[:, : n // 3].clone(), 0, cfg, 0.95)
    for a, b in zip(up, again):
        assert torch.equal(a, b)
    own = R._occupancy_rebuild_cuda(up[0], float(up[3]), cfg)
    for a, b in zip(own, (up[1], up[2], up[4])):
        assert torch.equal(a, b)


def _dense_layout(dev, N, B, prefix, seed):
    g = torch.Generator().manual_seed(seed)
    o, d = torch.randn((N, 3), generator=g), torch.randn((N, 3), generator=g)
    if prefix:
        cnt = torch.randint(0, B + 1, (N,), generator=g)
        mask = torch.arange(B)[None] < cnt[:, None]
    else:
        mask = torch.rand((N, B), generator=g) < 0.4
    t = torch.where(mask, 0.5 + 2.5 * torch.rand((N, B), generator=g), 0.0)
    dt = torch.where(mask, 0.003 + 0.003 * torch.rand((N, B), generator=g), 0.0)
    t0 = 0.2 + 0.3 * torch.rand((N,), generator=g)
    return [x.to(dev) for x in (o, d, t, dt, mask, t0)]


@pytest.mark.parametrize("B", [8, 12, 20, 520])
@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("case", ["ample", "overflow", "empty"])
def test_compact_kernel_matches_plain_bit_for_bit(dev, case, prefix, B):
    """K5 at the per-ray budgets the tuner picks (B = 8 and 12: 4 and 2 rows
    a warp; 20: a row a warp) and at the flat march's candidate rows (B =
    Kc ~ 520); N = 5,000 rays, no multiple of a tile; the overflowing buffer
    ends inside a ray; a second call gives the same bits."""
    N = 5000
    o, d, t, dt, mask, t0 = _dense_layout(dev, N, B, prefix, 8)
    if case == "empty":
        mask[:] = False
    total = int(mask.sum())
    full = mask.sum(1, dtype=torch.int32)
    start = torch.cumsum(full, 0) - full
    M = N * B if case == "ample" else 6 * N
    if case == "overflow":  # the buffer ends in the middle of the last ray
        # (with two samples or more) that starts ~1,000 slots before the end
        r = int(((start <= total - 1001) & (full >= 2)).nonzero()[-1])
        M = int(start[r] + full[r] // 2)
    n0 = kernels.launches["compact"]
    got = RM.compact_global_dense(o, d, t, dt, mask, t0, m_budget=M, bound=1.5)
    assert kernels.launches["compact"] == n0 + 2
    ref = RM.compact_global_dense_plain(o, d, t, dt, mask, t0, m_budget=M, bound=1.5)
    again = RM.compact_global_dense(o, d, t, dt, mask, t0, m_budget=M, bound=1.5)
    torch.cuda.synchronize()
    for f, a, b, c in zip(ref._fields, got, ref, again):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b) and torch.equal(a, c), f
    assert int(got.num_valid) == min(total, M)
    if case == "overflow":  # ray r keeps part of its samples
        assert 0 < int(ref.counts[r]) < int(full[r]) and int(ref.counts[r + 1:].sum()) == 0


# the buffer's slots a ray, M / N, from which the host picks K3c's lanes a
# ray (8 up to 24, 16 up to 64, 32 past that), and the overflowing buffer's
K3C_SLOTS = {8: 16, 16: 48, 32: 520}
K3C_OVERFLOW_SLOTS = {8: 16, 16: 48, 32: 72}


def _compact_inputs(dev, G, case, seed, N=5000):
    """A K5 buffer of N rays at M = N * K3C_SLOTS[G] slots (``samples``: a
    ``compact_samples`` buffer of scattered valid candidates): rows of 0, 1,
    G - 1, G + 1 slots and, every 64th ray, 519; ``overflow``: every 8th
    ray 519, and the buffer ends 200 slots into a long row just short of N *
    K3C_OVERFLOW_SLOTS[G]. sigma is 50x lower on the long rows, so their
    weights live past their first few slots."""
    g = torch.Generator().manual_seed(seed)
    B, S = 520, K3C_SLOTS[G]
    o, d = torch.randn((N, 3), generator=g), torch.randn((N, 3), generator=g)
    if case == "samples":
        mask = torch.rand((N, B), generator=g) < (S / 2) / B
    else:
        cnt = torch.tensor([0, 1, G - 1, G + 1])[torch.randint(0, 4, (N,), generator=g)]
        cnt[:: 8 if case == "overflow" else 64] = 519
        mask = torch.arange(B)[None] < cnt[:, None]
    t = torch.where(mask, 0.5 + 2.5 * torch.rand((N, B), generator=g), 0.0)
    dt = torch.where(mask, 0.003 + 0.003 * torch.rand((N, B), generator=g), 0.0)
    M = N * S
    if case == "overflow":  # the buffer ends in the middle of a long row
        full = mask.sum(1)
        start = torch.cumsum(full, 0) - full
        r = int(((full == 519) & (start + 200 <= N * K3C_OVERFLOW_SLOTS[G])).nonzero()[-1])
        M = int(start[r]) + 200
    o, d, t, dt, mask = [x.to(dev) for x in (o, d, t, dt, mask)]
    if case == "samples":
        comp = RM.compact_samples(o, d, RM.MarchResults(t, dt, mask), m_budget=M, bound=1.5)
    else:
        comp = RM.compact_global_dense(o, d, t, dt, mask, t[:, 0], m_budget=M, bound=1.5)
    long_row = (comp.counts.long() >= 519).cpu()[comp.ray_id.long().clamp_max(N - 1).cpu()]
    sig = 400 * torch.rand((M,), generator=g) * torch.where(long_row, 0.02, 1.0)
    rgb = torch.rand((M, 3), generator=g)
    cts = [torch.randn(s, generator=g).to(dev) for s in ((N,), (N,), (N, 3), (N,))]
    return comp, sig.to(dev), rgb.to(dev), cts


@pytest.mark.parametrize("t_thresh", [0.0, 1e-4])
@pytest.mark.parametrize("case", ["rows", "overflow", "samples"])
@pytest.mark.parametrize("G", sorted(K3C_SLOTS))
def test_composite_compact_kernels_match_plain(dev, G, case, t_thresh):
    """K3c forward and backward at 8, 16 and 32 lanes a ray (by M / N), on
    rows of 0, 1, G - 1, G + 1 and 519 slots, on a buffer that ends inside
    a ray and on a ``compact_samples`` buffer; a second call gives the same
    bits, and padding slots get zero gradients."""
    N = 5000
    comp, sig, rgb, cts = _compact_inputs(dev, G, case, 9 + G)
    cnt, mean = comp.counts, -(-comp.ts.shape[0] // N)
    assert {8: mean <= 24, 16: 24 < mean <= 64, 32: mean > 64}[G]
    if case != "samples":
        assert {0, 1, G - 1, G + 1, 519} <= set(cnt.tolist())
    if case == "overflow":
        cut = int((cnt > 0).nonzero()[-1])
        assert 0 < int(cnt[cut]) < 519 and int(comp.num_valid) == comp.ts.shape[0]
    args = (sig, rgb, comp.dts, comp.ts, comp.ray_id, comp.offsets, comp.counts, N, t_thresh)
    n0 = kernels.launches["composite_compact"]
    got = RM._composite_compact_cuda(*args)
    assert kernels.launches["composite_compact"] == n0 + 1
    again = RM._composite_compact_cuda(*args)
    ref = RM.composite_compact_plain(*args)
    torch.cuda.synchronize()
    for a, b, c in zip(got, ref, again):
        assert (a - b).abs().max().item() <= 1e-5 and torch.equal(a, c)
    assert (got[0][cnt == 0] == 0).all()
    n0 = kernels.launches["composite_compact_bwd"]
    got = RM._composite_compact_backward_cuda(*args, *cts)
    assert kernels.launches["composite_compact_bwd"] == n0 + 1
    again = RM._composite_compact_backward_cuda(*args, *cts)
    ref = RM.composite_compact_backward_plain(*args, *cts)
    torch.cuda.synchronize()
    for a, b, c in zip(got, ref, again):
        assert _rel_close(a, b, 1e-5) and torch.equal(a, c)
    pad = comp.ray_id >= N
    assert pad.any() == (case != "overflow")
    assert (got[0][pad] == 0).all() and (got[1][pad] == 0).all()


K7_CASES = {  # the proposal grid, the hash-grid field's default, and the other variants
    "proposal": dict(num_levels=5, level_dim=2, base_resolution=16, desired_resolution=128,
                     log2_hashmap_size=17),
    "hashgrid": dict(),
    "tiled_smoothstep": dict(num_levels=6, level_dim=4, base_resolution=8, desired_resolution=200,
                             log2_hashmap_size=16, gridtype="tiled", interpolation="smoothstep"),
    "c1": dict(num_levels=4, level_dim=1, base_resolution=16, desired_resolution=512,
               log2_hashmap_size=14),
    "c8": dict(num_levels=3, level_dim=8, base_resolution=4, desired_resolution=64,
               log2_hashmap_size=12),
}


def _k7_inputs(dev, cfg, bound, n, seed):
    g = torch.Generator().manual_seed(seed)
    x = (2 * torch.rand((n, 3), generator=g) - 1) * bound
    res = cfg.level_resolution(cfg.num_levels - 1)
    k = torch.randint(0, res + 1, (n // 4, 3), generator=g)
    x[: n // 4] = (2.0 * k / res - 1.0) * bound  # on the top level's cell edges
    x[:2] = torch.tensor([[-bound] * 3, [bound] * 3])
    tables = [torch.rand((cfg.level_size(l), cfg.level_dim), generator=g) * 2 - 1
              for l in range(cfg.num_levels)]
    return x.to(dev), [t.to(dev) for t in tables]


@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_grid_encode_kernel_matches_plain(dev, case):
    cfg = GE.GridEncoderConfig(**K7_CASES[case])
    x, tables = _k7_inputs(dev, cfg, 1.5, 50000, 10)
    n0 = kernels.launches["grid_encode"]
    got = GE._grid_encode_cuda(tables, x, cfg, 1.5)
    assert kernels.launches["grid_encode"] == n0 + 1
    ref = GE.grid_encode_plain(tables, x, cfg, 1.5)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (50000, cfg.output_dim)
    assert (got - ref).abs().max().item() <= 1e-6


@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_grid_encode_backward_kernel_matches_plain(dev, case):
    cfg = GE.GridEncoderConfig(**K7_CASES[case])
    x, _ = _k7_inputs(dev, cfg, 1.5, 50000, 11)
    x[:3000] = 0.01  # contention: many points on one cell
    ct = torch.randn((50000, cfg.output_dim), generator=torch.Generator().manual_seed(12)).to(dev)
    ct[5000:9000] = 0.0  # rows with no cotangent add nothing
    n0 = kernels.launches["grid_encode_bwd"]
    got = GE._grid_encode_backward_cuda(ct, x, cfg, 1.5)
    assert kernels.launches["grid_encode_bwd"] == n0 + 1
    ref = GE.grid_encode_backward_plain(ct, x, cfg, 1.5)
    torch.cuda.synchronize()
    for l, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape == (cfg.level_size(l), cfg.level_dim)
    err_k = GE.grid_encode_backward_error(got, ct, x, cfg, 1.5)
    err_p = GE.grid_encode_backward_error(ref, ct, x, cfg, 1.5)
    assert max(err_k) <= 1.0 and max(err_p) <= 1.0, (err_k, err_p)


# ray-ordered cases: K7_CASES plus 32 levels (two groups of 16 staged
# levels) and C = 8 over two groups of 4
K7_RAY_CASES = dict(K7_CASES,
                    levels32=dict(num_levels=32, level_dim=2, base_resolution=4, desired_resolution=300,
                                  log2_hashmap_size=13),
                    c8_groups=dict(num_levels=6, level_dim=8, base_resolution=4, desired_resolution=96,
                                   log2_hashmap_size=12))


def _k7_ray_inputs(dev, cfg, bound, n, seed):
    """n points as a renderer lays them out: 64 consecutive samples along each
    ray through the box, clipped to it (so runs of samples share a cell, and
    some sit on the box's faces), then the tables."""
    g = torch.Generator().manual_seed(seed)
    rays = -(-n // 64)
    o = (2 * torch.rand((rays, 3), generator=g) - 1) * 0.5 * bound
    d = torch.randn((rays, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.linspace(-2.0 * bound, 2.0 * bound, 64)
    x = (o[:, None] + d[:, None] * t[None, :, None]).clamp(-bound, bound).reshape(-1, 3)[:n]
    tables = [torch.rand((cfg.level_size(l), cfg.level_dim), generator=g) * 2 - 1
              for l in range(cfg.num_levels)]
    return x.contiguous().to(dev), [t_.to(dev) for t_ in tables]


@pytest.mark.parametrize("n", [1, 257, 20000])
@pytest.mark.parametrize("case", sorted(K7_RAY_CASES))
def test_grid_encode_kernel_on_ray_ordered_points_gives_the_plain_versions_bits(dev, case, n):
    cfg = GE.GridEncoderConfig(**K7_RAY_CASES[case])
    x, tables = _k7_ray_inputs(dev, cfg, 1.5, n, 20)
    got = GE._grid_encode_cuda(tables, x, cfg, 1.5)
    again = GE._grid_encode_cuda(tables, x, cfg, 1.5)
    ref = GE.grid_encode_plain(tables, x, cfg, 1.5)
    torch.cuda.synchronize()
    assert got.shape == (n, cfg.output_dim)
    assert torch.equal(got, ref) and torch.equal(got, again)


@pytest.mark.parametrize("n", [1, 257, 20000])
@pytest.mark.parametrize("case", sorted(K7_RAY_CASES))
def test_grid_encode_backward_kernel_on_ray_ordered_points(dev, case, n):
    cfg = GE.GridEncoderConfig(**K7_RAY_CASES[case])
    x, _ = _k7_ray_inputs(dev, cfg, 1.5, n, 21)
    ct = torch.randn((n, cfg.output_dim), generator=torch.Generator().manual_seed(22)).to(dev)
    ct[64:128] = 0.0  # one ray with no cotangent
    ct[::3, : cfg.level_dim] = 0.0  # every third point none at level 0
    n0 = kernels.launches["grid_encode_bwd"]
    got = GE._grid_encode_backward_cuda(ct, x, cfg, 1.5)
    assert kernels.launches["grid_encode_bwd"] == n0 + 1
    torch.cuda.synchronize()
    for l, a in enumerate(got):
        assert a.shape == (cfg.level_size(l), cfg.level_dim) and a.is_contiguous()
    err = GE.grid_encode_backward_error(got, ct, x, cfg, 1.5)
    assert max(err) <= 1.0, err


@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_grid_encode_backward_kernel_with_zero_cotangent_rows(dev, C):
    cfg = GE.GridEncoderConfig(num_levels=5, level_dim=C, base_resolution=8, desired_resolution=128,
                               log2_hashmap_size=12)
    x, _ = _k7_ray_inputs(dev, cfg, 1.5, 5000, 23)
    ct = torch.zeros((5000, cfg.output_dim), device=dev)
    assert all(bool((a == 0).all()) for a in GE._grid_encode_backward_cuda(ct, x, cfg, 1.5))
    ct[::7] = torch.randn((len(range(0, 5000, 7)), cfg.output_dim),
                          generator=torch.Generator().manual_seed(24)).to(dev)
    got = GE._grid_encode_backward_cuda(ct, x, cfg, 1.5)
    torch.cuda.synchronize()
    err = GE.grid_encode_backward_error(got, ct, x, cfg, 1.5)  # untouched rows exactly 0
    assert max(err) <= 1.0, err


def test_grid_encode_autograd_launches_and_refuses(dev):
    cfg = GE.GridEncoderConfig(**K7_CASES["proposal"])
    x, tables = _k7_inputs(dev, cfg, 1.5, 4000, 13)
    params = {f"level_{l}": t.requires_grad_(True) for l, t in enumerate(tables)}
    n0, n1 = kernels.launches["grid_encode"], kernels.launches["grid_encode_bwd"]
    GE.grid_encode(params, x, cfg, 1.5).square().sum().backward()
    assert kernels.launches["grid_encode"] == n0 + 1 and kernels.launches["grid_encode_bwd"] == n1 + 1
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in params.values())
    with pytest.raises(ValueError, match="level_dim"):
        GE._grid_encode_cuda(tables, x, GE.GridEncoderConfig(num_levels=5, level_dim=3), 1.5)
    with pytest.raises(ValueError, match="level_0"):
        GE._grid_encode_cuda([t.double() for t in tables], x, cfg, 1.5)


# K7x cases: the ray-ordered cases (dense and hashed levels, tiled,
# smoothstep, C 1-8, 32 levels) and the largest block, 32 levels of C = 8
K7X_CASES = dict(K7_RAY_CASES, levels32_c8=dict(num_levels=32, level_dim=8, base_resolution=4,
                                                desired_resolution=300, log2_hashmap_size=12))


@pytest.mark.parametrize("n", [257, 50000])  # neither a multiple of the 32-point tile
@pytest.mark.parametrize("layout", ["random", "rays"])
@pytest.mark.parametrize("case", sorted(K7X_CASES))
def test_grid_encode_backward_x_kernel_matches_plain(dev, case, layout, n):
    cfg = GE.GridEncoderConfig(**K7X_CASES[case])
    C = cfg.level_dim
    if layout == "rays":
        x, tables = _k7_ray_inputs(dev, cfg, 1.5, n, 14)
    else:
        x, tables = _k7_inputs(dev, cfg, 1.5, n, 14)
        x[2:100] = torch.tensor([1.0, -1.0, 0.5], device=dev)  # u = 0 or 1 exactly at bound 1: the ties
    ct = torch.randn((n, cfg.output_dim), generator=torch.Generator().manual_seed(15)).to(dev)
    ct[n // 10 : n // 5] = 0.0      # points with no cotangent
    ct[:64, C : 2 * C] = 0.0        # level 1 of two whole tiles: warps with no live lane
    ct[::7, :C] = 0.0               # single lanes with none at level 0
    for bound in (1.0, 1.5):
        n0 = kernels.launches["grid_encode_bwd_x"]
        got = GE._grid_encode_backward_x_cuda(ct, tables, x, cfg, bound)
        assert kernels.launches["grid_encode_bwd_x"] == n0 + 1
        ref = GE.grid_encode_backward_x_plain(ct, tables, x, cfg, bound)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (n, 3)
        assert _rel_close(got, ref, 1e-5)
        if C <= 2:  # the channel sum has one order: the plain version's bits (gridencoder.cu)
            assert torch.equal(got, ref)
        assert (got[n // 10 : n // 5] == 0).all()


def test_grid_encode_autograd_launches_k7x_for_points(dev):
    cfg = GE.GridEncoderConfig(**K7_CASES["hashgrid"])
    x, tables = _k7_inputs(dev, cfg, 1.5, 4000, 16)
    params = {f"level_{l}": t for l, t in enumerate(tables)}
    names = ("grid_encode_bwd", "grid_encode_bwd_x")
    n0 = [kernels.launches[k] for k in names]
    x.requires_grad_(True)
    (gx,) = torch.autograd.grad(GE.grid_encode(params, x, cfg, 1.5).square().sum(), [x])
    assert [kernels.launches[k] - a for k, a in zip(names, n0)] == [0, 1]  # no table gradient asked for
    assert torch.isfinite(gx).all() and gx.abs().sum() > 0


def _volume_inputs(dev, R, CH, N, bound, seed, layout="random"):
    """A grid, points and cotangents. ``random``: points spread inside and
    outside the box, on the nodes, on the faces and 3,000 on one point;
    ``rays``: a renderer's layout, runs of 20 samples along straight lines,
    consecutive in memory, every other run 0.4 cells a step (within and
    across cells) and the rest 3 cells a step, and 58 samples in one cell
    from index 1003 (across the warp boundaries of every lane-group width)."""
    g = torch.Generator().manual_seed(seed)
    grid = torch.randn((R**3, CH), generator=g)
    if layout == "rays":
        cell = 2 * bound / (R - 1)
        o = (2 * torch.rand((N // 20, 1, 3), generator=g) - 1) * bound
        d = torch.nn.functional.normalize(torch.randn((N // 20, 1, 3), generator=g), dim=-1)
        step = cell * torch.where(torch.arange(N // 20) % 2 == 0, 0.4, 3.0)[:, None, None]
        x = (o + d * step * torch.arange(20.0)[None, :, None]).reshape(N, 3)
        corner = (2.0 * torch.randint(0, R - 1, (1, 3), generator=g) / (R - 1) - 1.0) * bound
        x[1003:1061] = corner + 0.1 * cell + 0.8 * cell * torch.linspace(0, 1, 58)[:, None] * d[0].abs()
    else:
        x = (2 * torch.rand((N, 3), generator=g) - 1) * 1.1 * bound     # inside and outside
        k = torch.randint(0, R, (N // 4, 3), generator=g)
        x[: N // 4] = (2.0 * k / (R - 1) - 1.0) * bound                 # on the nodes
        x[N // 4 : N // 4 + 6] = torch.tensor([[bound, 0.1, 0.2], [-bound, 0.1, 0.2], [0.1, bound, 0.2],
                                               [0.1, -bound, 0.2], [0.1, 0.2, bound], [0.1, 0.2, -bound]])
        x[N // 2 : N // 2 + 3000] = 0.3                                   # contention on one cell
    ct = torch.randn((N, CH), generator=g)
    ct[N - 4000 :] = 0.0                                              # masked samples
    return grid.to(dev), x.to(dev), ct.to(dev)


@pytest.mark.parametrize("layout", ["random", "rays"])
@pytest.mark.parametrize("R,CH", [(64, 16), (16, 5), (128, 8), (32, 36)])  # 36: two slices a lane
def test_volume_grid_kernels_match_plain(dev, R, CH, layout):
    bound = 1.5
    grid, x, ct = _volume_inputs(dev, R, CH, 60000, bound, 17, layout)
    if layout == "rays":  # the one-cell run crosses warp boundaries in one cell
        rows = REG._voxel_corner(*REG._voxel_cell(x.cpu(), R, bound)[1:], R, (0, 0, 0))[0]
        assert (rows[1003:1061] == rows[1003]).all()
    n0 = kernels.launches["volume_grid"]
    got = REG._sample_volume_grid_cuda(grid, x, R, bound)
    assert kernels.launches["volume_grid"] == n0 + 1
    ref = REG.sample_volume_grid_plain(grid.cpu(), x.cpu(), R, bound)
    assert got.shape == ref.shape == (60000, CH)
    assert torch.equal(got.cpu(), ref)  # the plain version's bits
    calls = {}
    for asked in ((True, True), (True, False), (False, True)):
        n0 = kernels.launches["volume_grid_bwd"]
        calls[asked] = REG._sample_volume_grid_backward_cuda(ct, grid, x, R, bound, *asked)
        assert kernels.launches["volume_grid_bwd"] == n0 + 1
    gg, gx = calls[True, True]
    rgg, rgx = REG.sample_volume_grid_backward_plain(ct.cpu(), grid.cpu(), x.cpu(), R, bound)
    assert _rel_close(gg.cpu(), rgg, 1e-5) and _rel_close(gx.cpu(), rgx, 1e-5)
    assert (gx[-4000:] == 0).all() and (gg.abs().sum(-1) > 0).any()
    only_grid, only_x = calls[True, False], calls[False, True]
    assert only_grid[1] is None and only_x[0] is None
    assert _rel_close(only_grid[0].cpu(), rgg, 1e-5) and _rel_close(only_grid[0], gg, 1e-5)
    assert torch.equal(only_x[1], gx)


def test_volume_grid_autograd_and_refusals(dev):
    cfg = REG.VolumeGridConfig(resolution=32, feature_dim=7)
    grid, x, ct = _volume_inputs(dev, 32, 8, 5000, 1.0, 18)
    params = {"grid": grid.reshape(32, 32, 32, 8).requires_grad_(True)}
    n0, n1 = kernels.launches["volume_grid"], kernels.launches["volume_grid_bwd"]
    (REG.sample_volume_grid(params, x, cfg, 1.0) * ct).sum().backward()
    assert kernels.launches["volume_grid"] == n0 + 1 and kernels.launches["volume_grid_bwd"] == n1 + 1
    assert params["grid"].grad.shape == (32, 32, 32, 8)
    with pytest.raises(ValueError, match="f32"):
        REG._sample_volume_grid_cuda(grid.double(), x, 32, 1.0)
    with pytest.raises(ValueError, match="rows"):
        REG._sample_volume_grid_cuda(grid[:100], x, 32, 1.0)


def _camera_directions(n, H=224, W=224):
    """One camera's rays in pixel order (a 40-degree pinhole looking along
    (0.3, 0.2, 1)): neighbouring rays share texels."""
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32), torch.arange(W, dtype=torch.float32),
                          indexing="ij")
    f = 0.5 * W / np.tan(np.radians(20.0))
    cam = torch.stack([(i - W / 2) / f, (j - H / 2) / f, torch.ones_like(i)], -1).reshape(-1, 3)
    fwd = torch.nn.functional.normalize(torch.tensor([0.3, 0.2, 1.0]), dim=0)
    right = torch.nn.functional.normalize(torch.linalg.cross(torch.tensor([0.0, 1.0, 0.0]), fwd), dim=0)
    up = torch.linalg.cross(fwd, right)
    return (cam @ torch.stack([right, up, fwd]))[:n].contiguous()


@pytest.mark.parametrize("dirs", ["random", "camera"])
@pytest.mark.parametrize("n", [45, 50000])  # below one of the backward's 64-ray blocks and no multiple of 32; many blocks
@pytest.mark.parametrize("hw", [(64, 128), (17, 33), (256, 512)])
def test_textured_background_kernels_match_plain(dev, hw, n, dirs):
    g = torch.Generator().manual_seed(19)
    H, W = hw
    # as steep a radian as the 64 x 128 N(0, 1) texture the tolerances are
    # derived for: an ulp of angle moves (H - 1) / pi texels a radian
    tex = (torch.randn((H, W, 3), generator=g) * (63 / (H - 1))).to(dev)
    if dirs == "camera":
        d = _camera_directions(n)
    else:
        d = torch.randn((50000, 3), generator=g)
        d[:200, 0] = 0.0                                   # on the seam (d_z < 0 for about half)
        d[200:400] = d[200:400] * torch.tensor([0.0, 1.0, 1.0]) + torch.tensor([1e-7, 0.0, -0.0])
        d[400:402] = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])  # the poles
        d[402:450, 1] = 300.0 * torch.sign(d[402:450, 1])                  # near them
        d = d[:n] if n > 450 else d[-n:]
    d = d.to(dev)
    n0 = kernels.launches["textured_bg"]
    got = REG._background_textured_cuda(tex, d)
    assert kernels.launches["textured_bg"] == n0 + 1
    tc, dc = tex.cpu(), d.cpu()
    ref = REG.background_textured_plain(tc, dc)
    other = REG.background_textured_plain(tc, dc * torch.tensor([-1.0, 1.0, 1.0]))
    phi = torch.atan2(dc[:, 0].double(), dc[:, 2].double()) + np.pi
    seam = (torch.minimum(phi, 2 * np.pi - phi) < 1e-5) & (dc[:, 2] < 0)
    pole = (dc[:, 1] / dc.norm(dim=-1)).abs() > 0.999
    err = (got.cpu() - ref).abs().amax(-1)
    err_other = (got.cpu() - other).abs().amax(-1)
    if dirs == "random" and n > 450:
        assert seam.sum() > 100 and pole.sum() > 10
    assert err[~seam & ~pole].max().item() <= 1e-4, err[~seam & ~pole].max().item()
    if seam.any():
        assert torch.minimum(err, err_other)[seam].max().item() <= 1e-4
    if (pole & ~seam).any():
        assert err[pole & ~seam].max().item() <= 1e-3
    ct = torch.randn((n, 3), generator=g)
    ct[seam | pole] = 0.0  # rays whose taps may differ
    ct[::5] = 0.0          # rays with no cotangent add nothing
    n0 = kernels.launches["textured_bg_bwd"]
    gt = REG._background_textured_backward_cuda(ct.to(dev), got, d, H, W)
    assert kernels.launches["textured_bg_bwd"] == n0 + 1  # the zero fill folded into the one launch
    rgt = REG.background_textured_backward_plain(ct, got.cpu(), dc, H, W)  # the same sigmoid output
    rel = (gt.cpu() - rgt).abs().max().item() / rgt.abs().max().item()
    assert gt.shape == (H, W, 3) and rel <= 1e-4, rel
    # the launch zeroes the gradient itself: a buffer full of NaN comes out as the sum
    dirty, ctd = torch.full((H, W, 3), float("nan"), device=dev), ct.to(dev)
    fn = _build.function("textured_bg", "textured_bg_backward_launch", REG._K11_BWD_ARGS)
    _build.check(fn(_build.ptr(d), _build.ptr(ctd), _build.ptr(got), n, H, W, REG._clip_hi(H),
                    REG._clip_hi(W), _build.ptr(dirty), _build.stream(d.device)),
                 "background_textured backward")
    rel = (dirty.cpu() - rgt).abs().max().item() / rgt.abs().max().item()
    assert rel <= 1e-4, rel


@pytest.mark.parametrize("C", [4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sample_backward_xyz_backward_kernel_matches_plain(dev, dtype, C):
    """K2x² at lbound 1.0 on 64 x 48 planes (border ties, cell edges, one
    contended texel, rows with no cotangent, points with no gg, points whose
    gg misses one plane's axes): a first pass for dL/dg and dL/dxyz that
    also bins the rows gg reaches, then the K2 backward's five other passes
    for the plane gradient; with gg on the plane gradient, K2 forward and
    K2x's pass on it besides."""
    planes, xyz, ct = _k2x_inputs(dev, dtype, 64, 48, C, 20000, 21)
    gen = torch.Generator().manual_seed(22)
    gg = torch.randn((20000, 3), generator=gen)
    gg[6000:7000] = 0.0
    gg[7000:8000, :2] = 0.0  # gg along z alone: the (x, y) plane's rows have zero weights and are left out
    gg = gg.to(dev)
    ggp = torch.randn(planes.shape, generator=gen).to(dev, dtype)
    cpu = [t.cpu() for t in (planes, xyz, ct, gg, ggp)]
    first = {}
    for with_ggp in (False, True):
        n0 = kernels.launches["grid_sample_bwd_xyz_bwd"]
        dp, dx, dg = GS._sample_points_backward_xyz_backward_cuda(gg, ggp if with_ggp else None, planes, xyz, ct,
                                                                   1.0)
        assert kernels.launches["grid_sample_bwd_xyz_bwd"] == n0 + GS.K2_BWD_LAUNCHES
        again = GS._sample_points_backward_xyz_backward_cuda(gg, None, planes, xyz, ct, 1.0)[0]
        rp, rx, rg = GS.sample_points_backward_xyz_backward_plain(cpu[3], cpu[4] if with_ggp else None, *cpu[:2],
                                                                  cpu[2], 1.0)
        torch.cuda.synchronize()
        assert dp.dtype == rp.dtype == dtype and dx.shape == (20000, 3) and dg.shape == (20000, 3, C)
        assert torch.equal(dp, again) and (dp.float().abs().max() > 0)
        assert _rel_close(dp.cpu(), rp, 1e-5 if dtype == torch.float32 else 2.0**-7)
        assert _rel_close(dx.cpu(), rx, 1e-5) and _rel_close(dg.cpu(), rg, 1e-5)
        first.setdefault("dx", dx)
        first.setdefault("dg", dg)
    # no plane gradient asked for (an analytic normal's parameters are leaves): one launch, the same bits
    n0 = kernels.launches["grid_sample_bwd_xyz_bwd"]
    none, dx1, dg1 = GS._sample_points_backward_xyz_backward_cuda(gg, None, planes, xyz, ct, 1.0,
                                                                  wants=(False, True, True))
    assert none is None and kernels.launches["grid_sample_bwd_xyz_bwd"] == n0 + 1
    assert torch.equal(dx1, first["dx"]) and torch.equal(dg1, first["dg"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sample_backward_xyz_backward_kernel_on_sparse_rows_of_large_planes(dev, dtype):
    """K2x² on 1024^2 x 16 planes (the SDF step's triplane) with gg on about
    16% of the points, as the analytic-normal step's masked samples leave
    it, the points inside [-0.3, 0.5]^3, so whole tiles of each plane have no
    row: those tiles come out exactly zero; the plane gradient the same bits
    on a second call, every output held to the plain version (on the card)."""
    M, C = 131072, 16
    gen = torch.Generator().manual_seed(27)
    planes = torch.randn((3, 1024, 1024, C), generator=gen).to(dev, dtype)
    xyz = (-0.3 + 0.8 * torch.rand((M, 3), generator=gen)).to(dev)
    ct = torch.randn((M, 3, C), generator=gen).to(dev)
    gg = torch.randn((M, 3), generator=gen)
    gg[torch.rand((M,), generator=gen) > 0.16] = 0.0
    gg[:2000, 1] = 0.0  # gg along x and z: every plane still reached
    gg = gg.to(dev)
    n0 = kernels.launches["grid_sample_bwd_xyz_bwd"]
    dp, dx, dg = GS._sample_points_backward_xyz_backward_cuda(gg, None, planes, xyz, ct, 1.0)
    assert kernels.launches["grid_sample_bwd_xyz_bwd"] == n0 + GS.K2_BWD_LAUNCHES
    again = GS._sample_points_backward_xyz_backward_cuda(gg, None, planes, xyz, ct, 1.0)[0]
    rp, rx, rg = GS.sample_points_backward_xyz_backward_plain(gg, None, planes, xyz, ct, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(dp, again)
    assert _rel_close(dp, rp, 1e-5 if dtype == torch.float32 else 2.0**-7)
    assert _rel_close(dx, rx, 1e-5) and _rel_close(dg, rg, 1e-5)
    lo = int((1 - 0.3) / 2 * 1023) // 32 * 32  # the first tile row and column any point reaches
    assert (dp[:, :lo] == 0).all() and (dp[:, :, :lo] == 0).all() and (dp[:, lo:, lo:].float().abs().sum() > 0)
    dead = (gg == 0).all(-1)
    assert (dg[dead] == 0).all() and (dx[dead] == 0).all()


# K7x² cases: C = 1 (dense coarse levels, hashed fine ones), 4 (tiled,
# smoothstep) and 8 (a dense level of resolution 4, hashed ones), and 32
# levels of C = 8, the largest block and its shared memory
K7XX_CASES = {name: K7X_CASES[name] for name in ("c1", "tiled_smoothstep", "c8", "levels32_c8")}


@pytest.mark.parametrize("case", sorted(K7XX_CASES))
def test_grid_encode_backward_x_backward_kernel_on_sparse_ray_samples(dev, case):
    """K7x² on ray-ordered points as the analytic-normal step hands them: a
    ray's 64 samples in one coarse cell (a warp's lanes merge their adds into
    one unit), gg on one sample in five (masked samples in every tile), two
    whole 128-point spans without gg and points with gg but no g; every
    output held to the plain version, the points without gg exactly zero."""
    cfg = GE.GridEncoderConfig(**K7XX_CASES[case])
    n, bound = 20000, 1.5
    x, tables = _k7_ray_inputs(dev, cfg, bound, n, 28)
    cell = 2 * bound / cfg.level_resolution(0)
    x[64:128] = -bound + cell * (0.3 + 0.4 * torch.linspace(0, 1, 64, device=dev)[:, None])  # one coarse cell
    gen = torch.Generator().manual_seed(29)
    ct = torch.randn((n, cfg.output_dim), generator=gen)
    ct[3000:3100] = 0.0
    gg = torch.randn((n, 3), generator=gen)
    gg[1000:] *= (torch.arange(n - 1000) % 5 == 0)[:, None].float()  # one live sample in five
    gg[256:512] = 0.0                                                # two spans with no live point
    ct, gg = ct.to(dev), gg.to(dev)
    n0 = kernels.launches["grid_encode_bwd_x_bwd"]
    dx, dg, dt = GE._grid_encode_backward_x_backward_cuda(gg, None, x, ct, tables, cfg, bound)
    assert kernels.launches["grid_encode_bwd_x_bwd"] == n0 + 1
    rx, rg, rt = GE.grid_encode_backward_x_backward_plain(gg.cpu(), None, x.cpu(), ct.cpu(),
                                                          [t.cpu() for t in tables], cfg, bound)
    torch.cuda.synchronize()
    assert _rel_close(dx.cpu(), rx, 1e-5) and _rel_close(dg.cpu(), rg, 1e-5)
    for a, b in zip(dt, rt):
        assert a.shape == b.shape and _rel_close(a.cpu(), b, 1e-5)
    dead = (gg == 0).all(-1)
    assert (dg[dead] == 0).all() and (dx[dead] == 0).all() and (dg[~dead] != 0).any()
    for want in ((True, False, False), (False, True, False), (False, False, True)):  # one output at a time
        one = GE._grid_encode_backward_x_backward_cuda(gg, None, x, ct, tables, cfg, bound, want)
        for got, ref, w in zip(one, (dx, dg, dt), want):
            assert (got is None) != w
            if w and not isinstance(ref, list):
                assert torch.equal(got, ref)  # dL/dx and dL/dg: no atomics, the same bits


@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_grid_encode_backward_x_backward_kernel_matches_plain(dev, interpolation):
    """K7x² at C = 2 (the hash-grid field's levels, fewer of them) on random
    and ray-ordered points, bound 1.0 (border ties) and 1.5."""
    cfg = GE.GridEncoderConfig(**K7_CASES["proposal"], interpolation=interpolation)
    for layout, n in (("random", 20000), ("rays", 20000)):
        if layout == "rays":
            x, tables = _k7_ray_inputs(dev, cfg, 1.5, n, 23)
        else:
            x, tables = _k7_inputs(dev, cfg, 1.5, n, 23)
            x[2:100] = torch.tensor([1.0, -1.0, 0.5], device=dev)
        gen = torch.Generator().manual_seed(24)
        ct = torch.randn((n, cfg.output_dim), generator=gen).to(dev)
        ct[n // 10 : n // 5] = 0.0
        gg = torch.randn((n, 3), generator=gen)
        gg[n // 4 : n // 3] = 0.0
        gg = gg.to(dev)
        ggt = [torch.randn(t.shape, generator=gen).to(dev) for t in tables]
        cpu = lambda ts: [t.cpu() for t in ts]  # noqa: E731
        for bound in (1.0, 1.5):
            for gg_tables in (None, ggt):
                n0 = kernels.launches["grid_encode_bwd_x_bwd"]
                dx, dg, dt = GE._grid_encode_backward_x_backward_cuda(gg, gg_tables, x, ct, tables, cfg, bound)
                assert kernels.launches["grid_encode_bwd_x_bwd"] == n0 + 1
                rx, rg, rt = GE.grid_encode_backward_x_backward_plain(
                    gg.cpu(), None if gg_tables is None else cpu(gg_tables), x.cpu(), ct.cpu(), cpu(tables), cfg,
                    bound)
                torch.cuda.synchronize()
                assert dx.shape == (n, 3) and dg.shape == (n, cfg.output_dim)
                assert _rel_close(dx.cpu(), rx, 1e-5) and _rel_close(dg.cpu(), rg, 1e-5)
                for a, b in zip(dt, rt):
                    assert a.shape == b.shape and _rel_close(a.cpu(), b, 1e-5)
                if gg_tables is None:  # points with no gg read nothing and write zeros
                    assert (dg[n // 4 : n // 3] == 0).all() and (dx[n // 4 : n // 3] == 0).all()


def test_volume_grid_backward_x_backward_kernel_matches_plain(dev):
    """K10² at R = 64, 16 channels (the registry-grid field), random and
    ray-ordered points, with and without a cotangent on the grid
    gradient."""
    R, CH, bound = 64, 16, 1.5
    for layout in ("random", "rays"):
        grid, x, ct = _volume_inputs(dev, R, CH, 60000, bound, 25, layout)
        gen = torch.Generator().manual_seed(26)
        gg = torch.randn((60000, 3), generator=gen)
        gg[:5000] = 0.0
        gg = gg.to(dev)
        ggrid = torch.randn(grid.shape, generator=gen).to(dev)
        for gg_grid in (None, ggrid):
            n0 = kernels.launches["volume_grid_bwd_x_bwd"]
            dgrid, dx, dg = REG._sample_volume_grid_backward_x_backward_cuda(gg, gg_grid, grid, x, ct, R, bound)
            assert kernels.launches["volume_grid_bwd_x_bwd"] == n0 + 1
            rgrid, rx, rg = REG.sample_volume_grid_backward_x_backward_plain(
                gg.cpu(), None if gg_grid is None else gg_grid.cpu(), grid.cpu(), x.cpu(), ct.cpu(), R, bound)
            torch.cuda.synchronize()
            assert dgrid.shape == (R**3, CH) and dx.shape == (60000, 3) and dg.shape == (60000, CH)
            assert _rel_close(dgrid.cpu(), rgrid, 1e-5)
            assert _rel_close(dx.cpu(), rx, 1e-5) and _rel_close(dg.cpu(), rg, 1e-5)
            if gg_grid is None:
                assert (dg[:5000] == 0).all() and (dx[:5000] == 0).all()


# every (LP, RUN) the launcher picks: LP 1 and 2 scalar; one slice a lane at
# LP 2, 4 and 8; LP 8 with two slices a lane (no runs)
@pytest.mark.parametrize("CH", [3, 5, 8, 16, 32, 36])
def test_volume_grid_backward_x_backward_kernel_on_sparse_ray_samples(dev, CH):
    """K10² on ray-ordered points as the analytic-normal step hands them: gg
    on one sample in six, on runs of 4 consecutive samples of every third
    ray and on a ray's 58 samples in one cell (runs a lane group merges
    before its atomics), on none of two whole 256-point spans, on points
    whose g is zero and on points on the clamp border (q on hi, clamped
    corners). dL/dg and dL/dx within 1e-5 of the plain version's largest
    entries and the same bits on a second call and one output at a time;
    the points gg does not reach exactly zero; the grid gradient within its
    float-summation bound; one launch a call."""
    R, n, bound = 64, 60000, 1.5
    grid, x, ct = _volume_inputs(dev, R, CH, n, bound, 30, "rays")
    gen = torch.Generator().manual_seed(31)
    i = torch.arange(n)
    live = (i % 6 == 0) | ((i // 20 % 3 == 0) & (i % 20 >= 8) & (i % 20 < 12))
    live[1003:1061] = True   # one cell
    live[2048:2560] = False  # two spans with no live point
    gg = torch.randn((n, 3), generator=gen) * live[:, None]
    x[7000:7040:2, 0] = bound   # q on hi along x
    x[7001:7040:2] = bound      # in the last cell's far corner
    gg[7000:7040] = torch.randn((40, 3), generator=gen)
    ct[5000:5100] = 0.0         # gg but no g
    gg[5000:5100] = torch.randn((100, 3), generator=gen)
    gg, ct = gg.to(dev), ct.to(dev)
    cpu = [t.cpu() for t in (gg, grid, x, ct)]
    n0 = kernels.launches["volume_grid_bwd_x_bwd"]
    dgrid, dx, dg = REG._sample_volume_grid_backward_x_backward_cuda(gg, None, grid, x, ct, R, bound)
    assert kernels.launches["volume_grid_bwd_x_bwd"] == n0 + 1
    _, dx2, dg2 = REG._sample_volume_grid_backward_x_backward_cuda(gg, None, grid, x, ct, R, bound)
    rgrid, rx, rg = REG.sample_volume_grid_backward_x_backward_plain(cpu[0], None, *cpu[1:], R, bound)
    torch.cuda.synchronize()
    assert dgrid.shape == (R**3, CH) and dx.shape == (n, 3) and dg.shape == (n, CH)
    assert _rel_close(dx.cpu(), rx, 1e-5) and _rel_close(dg.cpu(), rg, 1e-5)
    assert torch.equal(dx, dx2) and torch.equal(dg, dg2)
    err = REG.sample_volume_grid_backward_x_backward_error(dgrid.cpu(), cpu[0], cpu[2], cpu[3], R, bound)
    assert err <= 1.0, err
    A = REG._k10xx_corners(cpu[0], cpu[2], R, bound)[1]
    dead = (A == 0).all(-1)
    assert dead[2048:2560].all() and not dead[1003:1061].any() and not dead[7000:7040].all()
    assert (dg.cpu()[dead] == 0).all() and (dx.cpu()[dead] == 0).all() and (dg.cpu()[~dead] != 0).any()
    for want in ((True, False, False), (False, True, False), (False, False, True)):  # one output at a time
        one = REG._sample_volume_grid_backward_x_backward_cuda(gg, None, grid, x, ct, R, bound, want)
        for got, ref, w in zip(one, (dgrid, dx, dg), want):
            assert (got is None) != w
            if w and ref is not dgrid:
                assert torch.equal(got, ref)  # no atomics: the same bits
            elif w:
                assert REG.sample_volume_grid_backward_x_backward_error(got.cpu(), cpu[0], cpu[2], cpu[3], R,
                                                                        bound) <= 1.0


@pytest.mark.parametrize("name", sorted(second_order_cases("cpu")))
def test_second_derivative_raises_on_the_card(dev, name):
    """As ``test_second_derivative_raises``: the samplers' coordinate
    gradients match the plain second derivative (within 1e-5 of the largest
    entry) and a third derivative raises; every other case raises at the
    second."""
    if name in TWICE:
        check_second_order_matches_plain(second_order_cases(dev)[name], name, rel=1e-5)
    else:
        check_second_order_raises(second_order_cases(dev)[name])


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_channel_shards_of_k2_and_k4(dev, dtype, M):
    """The model axis's shards of a 16-channel triplane (``parallel``: 8
    channels at M = 2, 4 at M = 4): K4 forward and adjoint on a shard give
    the full-width call's channels bit for bit (the ladder is depthwise),
    K2 forward the full-width call's channels within 1e-6, and both K2
    passes stay within their plain versions' bounds at the shard's width."""
    gen = torch.Generator().manual_seed(21)
    C, w, n = 16, 16 // M, 20_000
    yl = torch.randn((3, C, 72, 72), generator=gen).to(dev, dtype)
    yh = (0.3 * torch.randn((3, C, 3, 72, 72), generator=gen)).to(dev, dtype)
    full = W.idwt2d(yl, yh, "bior6.8")
    g_up = torch.randn(tuple(full.shape), generator=gen).to(dev, dtype)
    adj_full = W._idwt2d_adjoint_cuda(g_up, "bior6.8")
    planes_full = full.permute(0, 2, 3, 1).contiguous()
    xyz = (3.0 * torch.rand((n, 3), generator=gen) - 1.5).to(dev)
    ct = torch.randn((n, 3, C), generator=gen).to(dev)
    f_full = GS._sample_points_cuda(planes_full, xyz, 1.5)
    for m in range(M):
        sl = slice(m * w, (m + 1) * w)
        n0 = kernels.launches["idwt"]
        part = W.idwt2d(yl[:, sl].contiguous(), yh[:, sl].contiguous(), "bior6.8")
        assert kernels.launches["idwt"] == n0 + 1 and torch.equal(part, full[:, sl])
        adj = W._idwt2d_adjoint_cuda(g_up[:, sl].contiguous(), "bior6.8")
        assert all(torch.equal(a, b[:, sl]) for a, b in zip(adj, adj_full))
        planes = part.permute(0, 2, 3, 1).contiguous()
        n0 = kernels.launches["grid_sample"]
        f = GS.sample_points(planes, xyz, 1.5)
        assert kernels.launches["grid_sample"] == n0 + 1 and f.shape == (n, 3, w)
        assert (f - f_full[..., sl]).abs().max().item() <= 1e-6
        assert (f - GS.sample_points_plain(planes, xyz, 1.5)).abs().max().item() <= 1e-4
        ctm = ct[..., sl].contiguous()
        got = GS._sample_points_backward_cuda(ctm, xyz, 1.5, tuple(planes.shape), dtype)
        ref = GS.sample_points_backward_plain(ctm, xyz, 1.5, tuple(planes.shape), dtype)
        torch.cuda.synchronize()
        assert _rel_close(got, ref, 1e-5 if dtype == torch.float32 else 2.0**-7)
