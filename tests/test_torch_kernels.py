"""Each CUDA kernel (K1-K4) against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and nvcc (the kernels have no CPU mode); they
carry the ``cuda`` marker and skip elsewhere. Run them on a GPU machine with
``python -m pytest tests/test_torch_kernels.py -q``.

Tolerances: K1 must agree bit for bit (mask, stride, seg_lastocc, t). K3 is
float32 with atol 1e-5 (fused multiply-adds and summation order); K2 atol
1e-4 (see the test: a one-ulp coordinate difference times the texel slope).
K4 keeps float32 between its two passes where the plain version rounds to
bf16, so bf16 outputs agree within 2^-6 of the plane's max magnitude (a few
bf16 ulps); float32 within 1e-5.
"""

import numpy as np
import pytest
import torch

from trinerflet_tpu_torch import kernels
from trinerflet_tpu_torch.ops import grid_sample as GS
from trinerflet_tpu_torch.ops import raymarch as RM
from trinerflet_tpu_torch.ops import wavelets as W
from trinerflet_tpu_torch.render.renderer import _dilate3

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_idwt_kernel_matches_plain(dev, dtype):
    g = torch.Generator().manual_seed(0)
    yl = torch.randn((3, 16, 72, 72), generator=g).to(dev, dtype)
    yh = (0.3 * torch.randn((3, 16, 3, 72, 72), generator=g)).to(dev, dtype)
    n0 = kernels.launches["idwt"]
    got = W.idwt2d(yl, yh, "bior6.8")
    assert kernels.launches["idwt"] == n0 + 2
    ref = W.idwt2d_plain(yl, yh, "bior6.8")
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (3, 16, 128, 128) and got.dtype == dtype
    err = (got.float() - ref.float()).abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2.0**-6 * ref.float().abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 16), (torch.float32, 16), (torch.bfloat16, 4)])
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
    # torch's CUDA division by a Python scalar multiplies by the reciprocal,
    # the kernel divides: the projected coordinate may differ by one f32 ulp,
    # i.e. ~W * 2^-24 texels, times texel steps of up to ~8 here
    assert (got - ref).abs().max().item() <= 1e-4


def test_composite_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(2)
    N, T = 3000, 20
    sig = (60 * torch.rand((N, T), generator=g)).to(dev)
    rgb = torch.rand((N, T, 3), generator=g).to(dev)
    dl = (0.05 * torch.rand((N, T), generator=g)).to(dev)
    ts = torch.cumsum(dl, 1)
    mask = (torch.rand((N, T), generator=g) < 0.8).to(dev)
    got = RM.composite_dense(sig, rgb, dl, ts, mask, t_thresh=1e-4)
    ref = RM.composite_dense_plain(sig, rgb, dl, ts, mask, t_thresh=1e-4)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.parametrize("frac", [0.02, 0.3])
def test_march_kernel_matches_plain_bit_for_bit(dev, frac):
    g = torch.Generator().manual_seed(3)
    N, H, CAS, bound, steps = 4000, 64, 2, 1.5, 512
    v = torch.randn((N, 3), generator=g)
    o = 2.0 * v / v.norm(dim=1, keepdim=True)
    d = 0.6 * (2 * torch.rand((N, 3), generator=g) - 1) - o
    d = d / d.norm(dim=1, keepdim=True)
    occ = torch.rand((CAS, H, H, H), generator=g) < frac
    occ_c = _dilate3(occ, 2)
    o, d, occ, occ_c = o.to(dev), d.to(dev), occ.to(dev), occ_c.to(dev)
    aabb = torch.tensor([-bound] * 3 + [bound] * 3, device=dev)
    n, f = RM.near_far_from_aabb(o, d, aabb, 0.2)
    hit = n < 1e30
    n, f = torch.where(hit, n, 0.0), torch.where(hit, f, 0.0)
    noise = torch.rand((N,), generator=g).to(dev)
    kw = dict(num_coarse=int(np.ceil(bound * steps / 12)), fine_per_coarse=12, coarse_budget=8,
              budget=20, max_steps=steps, grid_size=H, cascades=CAS, bound=bound)
    got = RM.march_hierarchical(o, d, n, f, occ, occ_c, noise, **kw)
    ref = RM.march_hierarchical_plain(o, d, n, f, occ, occ_c, noise, **kw)
    torch.cuda.synchronize()
    assert ref[2].sum().item() > 0
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
