"""The HTTP viewer, the orbit turntable and the host library's JPEG encoder
in the PyTorch port (CPU): the orbit camera against the JAX package's,
the viewer over loopback, its train loop against ``fit``, ``render_orbit``,
and the encoder decoded by cv2.

Tolerances: the camera atol 1e-6; a served frame's bytes equal the encoder's
bytes of ``render_image``'s frame, and they decode (cv2) within 2 levels of
it on average; the train loop's losses equal ``fit``'s (one code path, one
generator); the encoder: PSNR >= 40 dB on smooth content, within 0.5 dB of
cv2's own quality-90 round trip on a render with hard edges, and a mean
difference of at most 1 level from cv2's own round trip.
"""

import json
import threading
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.utils import gui as JGUI
from trinerflet_tpu_torch import native
from trinerflet_tpu_torch.data.synthetic import make_synthetic_scene, orbit_pose
from trinerflet_tpu_torch.models.nerf import NeRFConfig
from trinerflet_tpu_torch.models.triplane import TriplaneConfig
from trinerflet_tpu_torch.render.renderer import RenderConfig, mark_untrained_grid
from trinerflet_tpu_torch.train.trainer import TrainConfig, Trainer
from trinerflet_tpu_torch.utils import gui as PGUI
from trinerflet_tpu_torch.utils.viewer import render_orbit


@pytest.mark.parametrize("theta,phi,radius", [(1.2, 0.7, None), (0.3, -2.0, 3.5), (2.9, 4.0, 1.1)])
def test_orbit_camera_matches_jax(theta, phi, radius):
    pc, jc = PGUI.OrbitCamera(64, 48, radius=2.0, fovy=55.0), JGUI.OrbitCamera(64, 48, radius=2.0, fovy=55.0)
    np.testing.assert_allclose(pc.pose(theta, phi, radius), jc.pose(theta, phi, radius), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pc.intrinsics(), jc.intrinsics(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pc.intrinsics(100, 30), jc.intrinsics(100, 30), rtol=0, atol=1e-6)


def _tiny(iters=8):
    """A tiny triplane on the occupancy-grid renderer (the JAX package's
    tests/test_gui.py configuration), on the CPU."""
    nerf_cfg = NeRFConfig(triplane=TriplaneConfig(channels=4, resolution=32, wavelet_scale=2), bound=1.0)
    render_cfg = RenderConfig(bound=1.0, grid_size=16, density_thresh=0.01, max_steps=32,
                              samples_per_ray_budget=8)
    train_cfg = TrainConfig(lr=1e-2, iters=iters, num_rays=128, eval_chunk=2048)
    return Trainer(nerf_cfg, render_cfg, train_cfg, device="cpu")


def _scene():
    return make_synthetic_scene(num_views=2, H=24, W=24, num_steps=16)


def _decode(body):
    return cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


def test_viewer_serves_page_state_frames_and_stops():
    """Over loopback: the page, /state, /frame (a JPEG, the encoder's bytes
    of render_image's frame at the same orbit pose, with the EMA params),
    an unknown path's 404, then /stop ends test_loop."""
    tr = _tiny()
    state = tr.init_state()
    state = state._replace(occ=tr.update_grid(state.params, state.occ, generator=state.rng))
    state, _ = tr.train_step(state, tr.scene_to_device(_scene()))
    gui = PGUI.NeRFGUI(tr, state, W=24, H=20, port=0)
    base = f"http://127.0.0.1:{gui.port}"
    got = {}

    def client():
        get = lambda p: urllib.request.urlopen(base + p, timeout=60).read()  # noqa: E731
        got["page"] = get("/")
        got["state"] = json.loads(get("/state"))
        got["frame"] = get("/frame?theta=1.0&phi=0.5&radius=2.5&w=32&h=28")
        got["default"] = get("/frame?theta=1.2&phi=0.0")
        try:
            get("/nope")
        except urllib.error.HTTPError as e:
            got["404"] = e.code
        got["stop"] = get("/stop")

    t = threading.Thread(target=client)
    t.start()
    gui.test_loop(max_seconds=120)
    t.join(timeout=10)
    gui.close()
    assert b"/frame?theta=" in got["page"] and b"r=2.0" in got["page"]
    assert got["state"] == {"step": 1, "loss": 0.0, "training": False, "mode": "infer"}
    assert got["404"] == 404 and got["stop"] == b"ok" and gui._stop
    for key, (th, ph, r, W, H) in (("frame", (1.0, 0.5, 2.5, 32, 28)), ("default", (1.2, 0.0, 2.0, 24, 20))):
        body = got[key]
        assert body[:2] == b"\xff\xd8" and body[-2:] == b"\xff\xd9"
        img, _ = tr.render_image(state.ema_params, state.occ, gui.cam.pose(th, ph, r), gui.cam.intrinsics(W, H),
                                 H, W)
        u8 = (img.clamp(0, 1) * 255).to(torch.uint8).numpy()
        assert body == native.encode_jpeg(u8, 90)
        dec = _decode(body)
        assert dec.shape == (H, W, 3) and np.abs(dec.astype(int) - u8).mean() <= 2.0


def test_train_loop_matches_fit():
    """N steps of the viewer's train loop (bursts, the refresh cadence,
    the retune, the burst adaptation, a request poll between bursts) give
    ``fit``'s N losses and parameters, bit for bit, on the same generator."""
    n = 40
    scene = _scene()
    losses = {}
    states = {}
    for how in ("fit", "gui"):
        tr = _tiny(iters=n)
        grid = mark_untrained_grid(scene.poses, scene.intrinsics, tr.render_cfg)
        state = tr.init_state(density_grid=grid)
        seen = losses[how] = []
        real = tr.train_step

        def step(*a, _real=real, _seen=seen, **k):
            st, aux = _real(*a, **k)
            _seen.append(float(aux["loss"]))
            return st, aux

        tr.train_step = step
        if how == "fit":
            states[how] = (tr.fit(state, scene, log_every=0), tr)
        else:
            gui = PGUI.NeRFGUI(tr, state, W=8, H=8, port=0, train_steps=16)
            states[how] = (gui.train_loop(scene), tr)
            assert gui.step == n and not gui.training and gui.loss == seen[-1]
            assert 4 <= gui.train_steps <= 64
            gui.close()
    assert len(losses["gui"]) == n and losses["gui"] == losses["fit"]
    (sf, tf), (sg, tg) = states["fit"], states["gui"]
    assert sf.step == sg.step == n and tf.render_cfg == tg.render_cfg
    from trinerflet_tpu_torch.train.trainer import _leaves

    for (na, a), (nb, b) in zip(_leaves(sf.params), _leaves(sg.params)):
        assert na == nb and torch.equal(a, b), na
    assert torch.equal(sf.occ.occ, sg.occ.occ)


def test_render_orbit_frames(monkeypatch):
    """``render_orbit``: num_frames views stepping phi once around, the first
    at phi 0, through render_image with the EMA params; the frames go to
    ``cli.write_video``."""
    from trinerflet_tpu_torch import cli

    tr = _tiny()
    state = tr.init_state()
    state = state._replace(occ=tr.update_grid(state.params, state.occ, generator=state.rng))
    written = {}

    def fake_write(path, frames, fps=25):
        written.update(path=path, frames=frames, fps=fps)
        return path

    monkeypatch.setattr(cli, "write_video", fake_write)
    out = render_orbit(tr, state, "orbit.mp4", num_frames=5, radius=2.2, theta=1.1, H=12, W=16, fps=10)
    assert out == "orbit.mp4" and written["fps"] == 10 and len(written["frames"]) == 5
    fy = 0.5 * 12 / np.tan(0.5 * np.deg2rad(50.0))
    img, _ = tr.render_image(state.ema_params, state.occ, orbit_pose(1.1, 0.0, 2.2), (fy, fy, 8.0, 6.0), 12, 16)
    first = written["frames"][0]
    assert first.dtype == np.uint8 and first.shape == (12, 16, 3)
    np.testing.assert_array_equal(first, (img.clamp(0, 1) * 255).to(torch.uint8).numpy())
    assert not np.array_equal(written["frames"][1], first)


# --------------------------------------------------------------- the encoder

def _psnr(a, b):
    return 10 * np.log10(255.0**2 / ((a.astype(np.float64) - b) ** 2).mean())


def _cv2_round_trip(u8):
    ok, buf = cv2.imencode(".jpg", u8[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert ok
    return _decode(buf.tobytes())


def _render_u8(H=96, W=120):
    im = make_synthetic_scene(num_views=1, H=H, W=W, num_steps=64).images[0][..., :3]
    return (np.clip(im, 0, 1) * 255).astype(np.uint8)


def test_encoder_on_smooth_content_and_a_render():
    """Smooth content (a render upsampled 4x, and a sinusoid field) decodes
    at PSNR >= 40 dB; a render with hard silhouettes on black within 0.5 dB
    of cv2's own quality-90 round trip (measured: 38.6 dB, cv2 38.5); each
    within 1 level of cv2's round trip on average."""
    r = _render_u8(48, 60)
    smooth = cv2.resize(r, (240, 192), interpolation=cv2.INTER_LINEAR)
    yy, xx = np.mgrid[0:150, 0:210]
    waves = np.stack([128 + 90 * np.sin(xx / 17.0), 128 + 90 * np.cos(yy / 23.0),
                      128 + 60 * np.sin((xx + yy) / 31.0)], -1).astype(np.uint8)
    for img in (smooth, waves):
        dec = _decode(native.encode_jpeg(img, 90))
        assert _psnr(dec, img) >= 40.0
        assert np.abs(dec.astype(int) - _cv2_round_trip(img)).mean() <= 1.0
    render = _render_u8()
    dec = _decode(native.encode_jpeg(render, 90))
    assert _psnr(dec, render) >= _psnr(_cv2_round_trip(render), render) - 0.5
    assert np.abs(dec.astype(int) - _cv2_round_trip(render)).mean() <= 1.0


@pytest.mark.parametrize("H,W", [(1, 1), (7, 9), (17, 33), (37, 45), (16, 16), (100, 3)])
def test_encoder_sides_flat_and_grey(H, W):
    """Sides that are not multiples of 16 (the edge MCUs repeat the last row
    and column), flat colours (within 1 level) and grey ramps (R = G = B,
    within 1 level of cv2's round trip on average)."""
    rng = np.random.default_rng(H * 100 + W)
    flat = np.broadcast_to(rng.integers(0, 256, 3).astype(np.uint8), (H, W, 3)).copy()
    grey = np.repeat(np.linspace(0, 255, H * W).reshape(H, W, 1), 3, -1).astype(np.uint8)
    for img in (flat, grey):
        body = native.encode_jpeg(img, 90)
        assert body[:2] == b"\xff\xd8" and body[-2:] == b"\xff\xd9"
        dec = _decode(body)
        assert dec.shape == (H, W, 3)
        assert np.abs(dec.astype(int) - _cv2_round_trip(img)).mean() <= 1.0
    assert np.abs(_decode(native.encode_jpeg(flat, 90)).astype(int) - flat).max() <= 1
    dec = _decode(native.encode_jpeg(grey, 90)).astype(int)
    assert np.abs(dec[..., 0] - dec[..., 2]).max() <= 2  # grey stays grey


def test_encoder_quality_and_shape_checks():
    img = _render_u8(32, 40)
    sizes = [len(native.encode_jpeg(img, q)) for q in (10, 50, 90, 100)]
    assert sizes == sorted(sizes) and sizes[0] < sizes[-1]
    assert _psnr(_decode(native.encode_jpeg(img, 100)), img) > _psnr(_decode(native.encode_jpeg(img, 50)), img)
    for bad in (img[..., :2], img.astype(np.float32), img[..., 0]):
        with pytest.raises(ValueError, match="uint8"):
            native.encode_jpeg(bad)
