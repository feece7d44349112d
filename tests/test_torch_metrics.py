"""Evaluation: the port's PSNR / SSIM and ``Trainer.evaluate`` against the JAX
package's ``train/metrics.py`` (its scipy SSIM path) and ``Trainer.evaluate``
(CPU).

Tolerances, stated per comparison:
* psnr: float64 both, 1e-12 relative.
* ssim: the port's float64 conv2d against scipy's float64 convolve2d over
  the same window and "valid" positions: 1e-10 absolute.
* evaluate: both render the same carried state (f32; the JAX renderer
  jitted, 1e-4 apart per pixel, test_torch_render.py), so each view's PSNR
  within 0.01 dB and SSIM within 1e-4.
"""

import json
import zlib

import jax
import numpy as np
import pytest
import torch

from trinerflet_tpu import native as jnative
from trinerflet_tpu.data import synthetic as JS
from trinerflet_tpu.models import nerf as JN
from trinerflet_tpu.models import triplane as JT
from trinerflet_tpu.render import renderer as JR
from trinerflet_tpu.train import metrics as JM
from trinerflet_tpu.train import trainer as JTR
from trinerflet_tpu_torch.carry import train_state_from_jax
from trinerflet_tpu_torch.data import synthetic as PS
from trinerflet_tpu_torch.models import nerf as PN
from trinerflet_tpu_torch.models import triplane as PT
from trinerflet_tpu_torch.render import renderer as PR
from trinerflet_tpu_torch.train import metrics as PM
from trinerflet_tpu_torch.train import trainer as PTR


@pytest.fixture
def scipy_ssim(monkeypatch):
    """The JAX package's SSIM through scipy (not its OpenMP native kernel)."""
    monkeypatch.setattr(jnative, "available", lambda: False)


def _pair(seed, H=37, W=29, C=3):
    rng = np.random.default_rng(seed)
    truth = rng.random((H, W, C)).astype(np.float32)
    pred = np.clip(truth + 0.08 * rng.standard_normal((H, W, C)), 0, 1).astype(np.float32)
    return pred, truth


@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_and_ssim_match_jax(seed, scipy_ssim):
    pred, truth = _pair(seed)
    np.testing.assert_allclose(PM.psnr(torch.from_numpy(pred), torch.from_numpy(truth)),
                               JM.psnr(pred, truth), rtol=1e-12)
    np.testing.assert_allclose(PM.psnr(pred, truth), JM.psnr(pred, truth), rtol=1e-12)
    s_j = JM.ssim(pred, truth)
    assert 0.2 < s_j < 0.99
    assert abs(PM.ssim(torch.from_numpy(pred), torch.from_numpy(truth)) - s_j) <= 1e-10
    assert abs(PM.ssim(pred, pred) - 1.0) <= 1e-12
    assert PM.psnr(pred, pred) == pytest.approx(120.0)  # mse floor 1e-12


def test_meters_match_jax(scipy_ssim):
    pairs = [_pair(s, 24, 24) for s in range(3)]
    jp, js, pp, ps = JM.PSNRMeter(), JM.SSIMMeter(), PM.PSNRMeter(), PM.SSIMMeter()
    for pred, truth in pairs:
        jp.update(pred, truth)
        pp.update(torch.from_numpy(pred), torch.from_numpy(truth))
    batch_p = np.stack([p for p, _ in pairs])
    batch_t = np.stack([t for _, t in pairs])
    js.update(batch_p, batch_t)
    ps.update(torch.from_numpy(batch_p), torch.from_numpy(batch_t))
    assert pp.N == jp.N == 3 and ps.N == js.N == 3
    np.testing.assert_allclose(pp.measure(), jp.measure(), rtol=1e-12)
    assert abs(ps.measure() - js.measure()) <= 1e-10
    assert set(pp.report2()) == {"PSNR"} and pp.report().startswith("PSNR = ")
    pp.clear()
    assert pp.measure() == 0.0


def test_evaluate_matches_jax(scipy_ssim, tmp_path):
    """A tiny carried state (a 32^2 x 8-channel triplane, 16^3 grid, one
    refresh) evaluated on 2 views of 24^2 RGBA in both packages; the port
    also writes its JSON and PNGs."""
    dims = dict(channels=8, resolution=32, wavelet_scale=4)
    rkw = dict(bound=1.5, grid_size=16, max_steps=128, samples_per_ray_budget=20)
    tkw = dict(num_rays=256, iters=100, background_color=0.0)
    jtr = JTR.Trainer(JN.NeRFConfig(triplane=JT.TriplaneConfig(**dims), bound=1.5),
                      JR.RenderConfig(**rkw), JTR.TrainConfig(**tkw))
    ptr = PTR.Trainer(PN.NeRFConfig(triplane=PT.TriplaneConfig(**dims), bound=1.5),
                      PR.RenderConfig(**rkw), PTR.TrainConfig(**tkw), device="cpu",
                      workspace=str(tmp_path / "ws"))
    js = JS.make_synthetic_scene(num_views=2, H=24, W=24, num_steps=32, seed=4)
    pscene = PS.make_synthetic_scene(num_views=2, H=24, W=24, num_steps=32, seed=4)
    np.testing.assert_array_equal(pscene.images, js.images)
    jstate = jtr.init_state(jax.random.PRNGKey(3),
                            density_grid=JR.mark_untrained_grid(js.poses, js.intrinsics, jtr.render_cfg))
    jstate = jtr._update_grid_impl(jstate, full=True)
    # distinct EMA params, so evaluate's choice of them shows
    jstate = jstate._replace(ema_params=jax.tree.map(lambda x: x * 0.5, jstate.params))
    rj = jtr.evaluate(jstate, js)
    state = train_state_from_jax(jstate, device="cpu")
    rp = ptr.evaluate(state, pscene, save_dir=str(tmp_path / "png"), tag="val")
    assert np.isfinite([rp["PSNR"], rp["SSIM"]]).all()
    assert [r["view"] for r in rp["per_image"]] == [r["view"] for r in rj["per_image"]] == [0, 1]
    for a, b in zip(rp["per_image"], rj["per_image"]):
        assert abs(a["PSNR"] - b["PSNR"]) <= 0.01 and abs(a["SSIM"] - b["SSIM"]) <= 1e-4
    assert abs(rp["PSNR"] - rj["PSNR"]) <= 0.01 and abs(rp["SSIM"] - rj["SSIM"]) <= 1e-4
    raw = ptr.evaluate(state, pscene, use_ema=False)
    assert abs(raw["PSNR"] - jtr.evaluate(jstate, js, use_ema=False)["PSNR"]) <= 0.01
    assert raw["PSNR"] != rp["PSNR"]
    assert json.loads((tmp_path / "ws" / "val.json").read_text()) == rp
    for name, shape in (("val_000.png", (24, 24, 3)), ("val_001_depth.png", (24, 24))):
        img = _read_png((tmp_path / "png" / name).read_bytes())
        assert img.shape == shape and img.dtype == np.uint8


def _read_png(data: bytes) -> np.ndarray:
    """Decode the 8-bit, filter-0 PNGs ``write_png`` makes."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n = int.from_bytes(data[pos : pos + 4], "big")
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        assert zlib.crc32(kind + body) == int.from_bytes(data[pos + 8 + n : pos + 12 + n], "big")
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    W, H = int.from_bytes(chunks[b"IHDR"][:4], "big"), int.from_bytes(chunks[b"IHDR"][4:8], "big")
    ch = {0: 1, 2: 3}[chunks[b"IHDR"][9]]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(H, 1 + W * ch)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape((H, W, ch) if ch == 3 else (H, W))


def test_write_png_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    for shape in ((7, 5, 3), (4, 9)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        PTR.write_png(str(tmp_path / "x.png"), img)
        np.testing.assert_array_equal(_read_png((tmp_path / "x.png").read_bytes()), img)
