"""The port's scene loaders (``data/blender.py``, ``llff.py``, ``colmap.py``,
``formats.py``, ``synthetic.py``) against the JAX package's on the same
files: the JAX tests' writers (``tests/test_llff.py``, ``tests/test_formats.py``,
``tests/test_extras.py``) and both packages' ``write_synthetic_scene``.

Poses, intrinsics and pregenerated / NDC rays are computed by the same
numpy code: EQUAL. Images: equal where no resize runs (the same 8-bit
values over 255); within 1e-6 after an ``INTER_AREA`` resize (float64 sums
against OpenCV's float32).
"""

import json
import os
import struct

import numpy as np
import pytest

from trinerflet_tpu.data import blender as JB
from trinerflet_tpu.data import colmap as JC
from trinerflet_tpu.data import formats as JF
from trinerflet_tpu.data import llff as JL
from trinerflet_tpu.data import synthetic as JS
from trinerflet_tpu_torch.data import blender as PB
from trinerflet_tpu_torch.data import colmap as PC
from trinerflet_tpu_torch.data import formats as PF
from trinerflet_tpu_torch.data import llff as PL
from trinerflet_tpu_torch.data import synthetic as PS

from .test_formats import _pose
from .test_llff import _write_llff_dataset

cv2 = pytest.importorskip("cv2")


def _same_scene(p, j, image_atol=0.0):
    assert type(p).__name__ == type(j).__name__
    for f in ("H", "W"):
        assert getattr(p, f) == getattr(j, f)
    if hasattr(j, "intrinsics"):
        np.testing.assert_array_equal(np.asarray(p.intrinsics, np.float64),
                                      np.asarray(j.intrinsics, np.float64))
        np.testing.assert_array_equal(p.poses, j.poses)
    else:
        np.testing.assert_array_equal(p.rays_o, j.rays_o)
        np.testing.assert_array_equal(p.rays_d, j.rays_d)
    assert p.images.shape == j.images.shape and p.images.dtype == j.images.dtype
    np.testing.assert_allclose(p.images, j.images, rtol=0, atol=image_atol)


def _write_img(path, h, w, seed, channels=3):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, channels)).astype(np.uint8)
    cv2.imwrite(path, img)


@pytest.fixture(scope="module")
def blender_roots(tmp_path_factory):
    """The same scene written by each package's writer."""
    jroot = JS.write_synthetic_scene(str(tmp_path_factory.mktemp("jblender")), num_views=4,
                                     num_test_views=2, H=20, W=24, seed=3)
    proot = PS.write_synthetic_scene(str(tmp_path_factory.mktemp("pblender")), num_views=4,
                                     num_test_views=2, H=20, W=24, seed=3)
    return jroot, proot


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("downscale,scale", [(1, 1.0), (2, 0.33)])
def test_blender_matches_jax(blender_roots, split, downscale, scale):
    jroot, proot = blender_roots
    for root in (jroot, proot):
        kw = dict(downscale=downscale, scale=scale, offset=(0.1, -0.2, 0.3))
        _same_scene(PB.load_blender(root, split, **kw), JB.load_blender(root, split, **kw),
                    image_atol=1e-6 if downscale > 1 else 0.0)
    # the two writers wrote the same images and poses
    _same_scene(PB.load_blender(proot, split, scale=1.0), JB.load_blender(jroot, split, scale=1.0))
    pose = np.arange(16, dtype=np.float32).reshape(4, 4)
    np.testing.assert_array_equal(PB.nerf_matrix_to_ngp(pose, 0.5, (1, 2, 3)),
                                  JB.nerf_matrix_to_ngp(pose, 0.5, (1, 2, 3)))


def test_synthetic_scene_matches_jax_bit_for_bit():
    """The views, rendered on several threads, are the JAX package's
    sequential numpy renders bit for bit."""
    a = PS.make_synthetic_scene(9, 24, 20, num_steps=48, seed=2)
    b = JS.make_synthetic_scene(9, 24, 20, num_steps=48, seed=2)
    np.testing.assert_array_equal(a.poses, b.poses)
    np.testing.assert_array_equal(a.images, b.images)


@pytest.fixture(scope="module")
def llff_root(tmp_path_factory):
    return _write_llff_dataset(str(tmp_path_factory.mktemp("llff")), V=5, H=24, W=32)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("kw", [dict(downscale=1, ndc=True, llff_hold=2),
                                dict(downscale=2, ndc=True, llff_hold=3),
                                dict(downscale=1, ndc=False, llff_hold=0),
                                dict(downscale=1, ndc=False, llff_hold=2, spherify=True)])
def test_llff_matches_jax(llff_root, split, kw):
    p = PL.load_llff_scene(llff_root, split, **kw)
    j = JL.load_llff_scene(llff_root, split, **kw)
    _same_scene(p, j, image_atol=1e-6 if kw["downscale"] > 1 else 0.0)
    rng = np.random.default_rng(0)
    o, d = rng.normal(size=(7, 3)), rng.normal(size=(7, 3))
    for a, b in zip(PL.ndc_rays(24, 32, 30.0, 1.0, o, d), JL.ndc_rays(24, 32, 30.0, 1.0, o, d)):
        np.testing.assert_array_equal(a, b)


def _write_colmap(root, n=4, h=12, w=16):
    """A COLMAP model (one PINHOLE camera, n images with rotations) and its
    PNG images."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, w, h))
        f.write(struct.pack("<4d", 20.0, 21.0, 8.0, 6.0))
    rng = np.random.default_rng(7)
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            name = f"img_{n - i:02d}.png".encode()  # written out of order: the reader sorts
            f.write(struct.pack("<i", i + 1) + struct.pack("<4d", *q))
            f.write(struct.pack("<3d", *rng.normal(size=3)) + struct.pack("<i", 1))
            f.write(name + b"\x00" + struct.pack("<Q", 2) + bytes(48))
            _write_img(os.path.join(root, "images", name.decode()), h, w, i)
    return root


@pytest.mark.parametrize("kw", [dict(), dict(downscale=2, hold_every=2, split="test"),
                                dict(hold_every=2, split="train", scale=0.5, offset=(0.1, 0, 0))])
def test_colmap_matches_jax(tmp_path, kw):
    root = _write_colmap(str(tmp_path / "colmap"))
    _same_scene(PC.load_colmap_scene(root, **kw), JC.load_colmap_scene(root, **kw),
                image_atol=1e-6 if kw.get("downscale", 1) > 1 else 0.0)
    sparse = os.path.join(root, "sparse", "0")
    pn, pp, pi = PC.load_colmap_poses(sparse)
    jn, jp, ji = JC.load_colmap_poses(sparse)
    assert pn == jn and pi == ji
    np.testing.assert_array_equal(pp, jp)
    for a, b in zip(PC.colmap_test_path(root, n_frames=9, downscale=2),
                    JC.colmap_test_path(root, n_frames=9, downscale=2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_nsvf_and_nerfpp_match_jax(tmp_path):
    nsvf = str(tmp_path / "nsvf")
    os.makedirs(os.path.join(nsvf, "rgb"))
    os.makedirs(os.path.join(nsvf, "pose"))
    for i, pref in enumerate(["0_", "0_", "1_", "2_"]):
        _write_img(os.path.join(nsvf, "rgb", f"{pref}{i:04d}.png"), 12, 16, i)
        np.savetxt(os.path.join(nsvf, "pose", f"{pref}{i:04d}.txt"), _pose(2.0 + i))
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 20.0, 22.0, 8.0, 6.0
    np.savetxt(os.path.join(nsvf, "intrinsics.txt"), K)
    for split in ("train", "val", "test"):
        for kw in (dict(scale=1.0), dict(downscale=2, opengl_cam=True)):
            _same_scene(PF.load_nsvf_scene(nsvf, split, **kw), JF.load_nsvf_scene(nsvf, split, **kw),
                        image_atol=1e-6)
    npp = str(tmp_path / "npp")
    for split, n in [("train", 3), ("test", 2)]:
        for sub in ("rgb", "pose", "intrinsics"):
            os.makedirs(os.path.join(npp, split, sub))
        for i in range(n):
            _write_img(os.path.join(npp, split, "rgb", f"{i:05d}.png"), 12, 16, 10 + i, channels=1)
            np.savetxt(os.path.join(npp, split, "pose", f"{i:05d}.txt"), _pose(2.0 + i).reshape(-1))
            np.savetxt(os.path.join(npp, split, "intrinsics", f"{i:05d}.txt"), K.reshape(-1))
    for split in ("train", "val", "test"):
        _same_scene(PF.load_nerfpp_scene(npp, split, scale=1.0), JF.load_nerfpp_scene(npp, split, scale=1.0))


def test_topia_and_rtmv_match_jax(tmp_path):
    """Topia's views of another size are resized to the first view's (area
    weights); RTMV splits by frame index."""
    root, pdir = str(tmp_path / "imgs"), str(tmp_path / "poses")
    os.makedirs(root)
    os.makedirs(pdir)
    for i, (h, w) in enumerate([(16, 16), (23, 21), (16, 16)]):
        _write_img(os.path.join(root, f"{i}.png"), h, w, i, channels=4)
        m = np.eye(4)
        m[:3, 3] = [0.1 * i, 0.2, -1.0]
        np.savetxt(os.path.join(pdir, f"p_{i:03d}.txt"), m.reshape(-1))
    for kw in (dict(render_res=128), dict(render_res=256, downscale=2)):
        _same_scene(PF.load_topia_scene(root, pdir, **kw), JF.load_topia_scene(root, pdir, **kw),
                    image_atol=1e-6)
    rtmv = str(tmp_path / "rtmv_bricks")
    os.makedirs(os.path.join(rtmv, "images"))
    for i in range(6):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.1 * i, 0.2, 3.0]
        meta = {"camera_data": {"cam2world": c2w.T.tolist(),
                                "intrinsics": {"fx": 40.0, "fy": 41.0, "cx": 8.0, "cy": 6.0},
                                "scene_center_3d_box": [0.1, 0, 0], "scene_min_3d_box": [-1, -1, -1],
                                "scene_max_3d_box": [1, 1.5, 1]}}
        with open(os.path.join(rtmv, f"{i:05d}.json"), "w") as f:
            json.dump(meta, f)
        _write_img(os.path.join(rtmv, "images", f"{i:05d}.png"), 12, 16, 20 + i)
    for split, kw in (("all", dict(scale=1.0)), ("train", dict(downscale=2))):
        _same_scene(PF.load_rtmv_scene(rtmv, split, **kw), JF.load_rtmv_scene(rtmv, split, **kw),
                    image_atol=1e-6)
