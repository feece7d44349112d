"""LPIPS in the PyTorch port against the JAX package (CPU), and the LPIPS
meter.

The JAX package draws the random weights of the real shapes
(``init_lpips_params``); ``carry.network_params_from_jax`` carries them
(backbone kernels HWIO -> OIHW, the (C, 1) lins as they are). Images are
made with numpy, NHWC to JAX and NCHW to the port. Tolerance: relative
1e-5 on the distances (float32 convolutions summed in another order),
on crops above and below 64 px (the latter upsampled by both with the
JAX package's bilinear resize).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.train import metrics as JM
from trinerflet_tpu.utils import lpips as JL
from trinerflet_tpu_torch.carry import network_params_from_jax
from trinerflet_tpu_torch.train import metrics as PM
from trinerflet_tpu_torch.utils import lpips as PL


@functools.lru_cache(maxsize=None)
def _params(net):
    jp = JL.init_lpips_params(jax.random.PRNGKey(0), net)
    return jp, network_params_from_jax(jp, "cpu")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


@pytest.mark.parametrize("net", ["alex", "vgg"])
@pytest.mark.parametrize("shape", [(2, 40, 48, 3), (1, 70, 64, 3)], ids=["upsampled", "whole"])
def test_lpips_matches_jax(net, shape):
    jp, pp = _params(net)
    rng = np.random.default_rng(shape[1])
    a, b = (rng.random(shape).astype(np.float32) for _ in range(2))
    ref = np.asarray(jax.jit(JL.lpips, static_argnames="net")(jp, jnp.asarray(a), jnp.asarray(b), net=net))
    got = PL.lpips(pp, _nchw(a), _nchw(b), net=net).numpy()
    assert got.shape == (shape[0],) and (got > 0).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    same = PL.lpips(pp, _nchw(a), _nchw(a), net=net)
    assert float(same.abs().max()) == 0.0
    # [-1, 1] inputs without normalize: the same distance
    np.testing.assert_allclose(PL.lpips(pp, 2 * _nchw(a) - 1, 2 * _nchw(b) - 1, net=net, normalize=False).numpy(),
                               got, rtol=1e-5)


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
def test_state_dict_loading_matches_jax(tmp_path, fmt):
    """A torchvision-style vgg16 state dict and the lpips lin checkpoint
    (written here with random values, as both formats) load to the same
    tree in both packages and give the same distance."""
    rng = np.random.default_rng(3)
    layout, taps = JL._VGG_LAYOUT, JL.VGG_CHANNELS
    backbone, idx, cin = {}, 0, 3
    for item in layout:
        if item == "M":
            idx += 1
        elif isinstance(item, tuple):
            cout, k = item[0], item[1]
            backbone[f"features.{idx}.weight"] = (rng.standard_normal((cout, cin, k, k)) / np.sqrt(9 * cin)).astype(np.float32)
            backbone[f"features.{idx}.bias"] = (0.01 * rng.standard_normal(cout)).astype(np.float32)
            cin, idx = cout, idx + 2
    lins = {f"lin{i}.model.1.weight": rng.random((1, c, 1, 1)).astype(np.float32) / c for i, c in enumerate(taps)}
    paths = {}
    for name, sd in (("backbone", backbone), ("lin", lins)):
        paths[name] = str(tmp_path / f"{name}.{fmt}")
        if fmt == "pth":
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, paths[name])
        else:
            from safetensors.numpy import save_file

            save_file(sd, paths[name])
    jload = JL._load_any
    jp = JL.load_torch_state_dict(jload(paths["backbone"]), jload(paths["lin"]), "vgg")
    pp = PL.load_torch_state_dict(PL.load_any(paths["backbone"]), PL.load_any(paths["lin"]), "vgg", device="cpu")
    carried = network_params_from_jax(jp, "cpu")
    for k in carried["backbone"]:
        for n in ("w", "b"):
            assert torch.equal(pp["backbone"][k][n], carried["backbone"][k][n]), (k, n)
    for a, b in zip(pp["lins"], carried["lins"]):
        assert a.shape == b.shape and torch.equal(a, b)
    img0, img1 = rng.random((2, 64, 64, 3)).astype(np.float32)
    fn_j = JL.make_lpips_fn(paths["backbone"], paths["lin"], net="vgg")
    fn_p = PL.make_lpips_fn(paths["backbone"], paths["lin"], net="vgg", device="cpu")
    np.testing.assert_allclose(fn_p(img0, img1), fn_j(img0, img1), rtol=1e-5)


def test_lpips_meter_matches_jax():
    """Without weights both meters report NaN and take nothing; with the
    same parameters, the same running mean over HWC images and batches."""
    pm, jm = PM.LPIPSMeter(), JM.LPIPSMeter()
    assert not pm.available and np.isnan(pm.measure()) and np.isnan(jm.measure())
    pm.update(np.zeros((8, 8, 3)), np.ones((8, 8, 3)))
    assert pm.N == 0 and np.isnan(pm.measure())
    assert PL.make_lpips_fn() is None
    jp, pp = _params("alex")
    pm, jm = PM.LPIPSMeter.from_params(pp, net="alex"), JM.LPIPSMeter.from_params(jp, net="alex")
    rng = np.random.default_rng(5)
    for shape in ((64, 64, 3), (2, 64, 64, 3)):
        a, b = rng.random(shape).astype(np.float32), rng.random(shape).astype(np.float32)
        pm.update(a, b)
        jm.update(a, b)
        pm.update(torch.from_numpy(a), torch.from_numpy(b))
        jm.update(a, b)
    assert pm.N == jm.N == 4 and pm.available
    np.testing.assert_allclose(pm.measure(), jm.measure(), rtol=1e-5)
    assert pm.report2() == {"LPIPS": pm.measure()}
