"""The port's image reading and area resizing (``data/images.py`` over the
host library in ``native/``) against OpenCV, which the JAX loaders call.

* PNGs written with each scanline filter (0 none, 1 sub, 2 up, 3 average,
  4 Paeth) in grey, grey + alpha, RGB and RGBA decode to ``cv2.imread``'s
  values bit for bit (after the JAX loaders' BGR to RGB flip), in both of
  the loaders' read modes.
* ``resize_area`` matches ``cv2.resize(..., INTER_AREA)`` within 1e-6 at
  factors 2, 4 and 8, at sizes they do not divide, at Topia's resize to a
  given size, and where an axis grows.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from trinerflet_tpu_torch import native
from trinerflet_tpu_torch.data import images as IM

cv2 = pytest.importorskip("cv2")

CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> channels


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_row(row, prev, bpp, kind):
    """One scanline filtered with ``kind`` (the encoder's side of the
    decoder's unfiltering)."""
    out = bytearray(len(row))
    for x in range(len(row)):
        a = row[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
        out[x] = (row[x] - pred) & 0xFF
    return bytes([kind]) + bytes(out)


def _write_png(path, px, color_type, filters):
    """A PNG of uint8 ``px`` (H, W, C) whose row y uses filters[y % len]."""
    H, W, C = px.shape
    prev = bytes(W * C)
    raw = b""
    for y in range(H):
        row = px[y].tobytes()
        raw += _filter_row(row, prev, C, filters[y % len(filters)])
        prev = row

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, color_type, 0, 0, 0)
    idat = zlib.compress(raw, 9)
    with open(path, "wb") as f:  # IDAT split in two chunks, as large encoders write it
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", idat[:7])
                + chunk(b"IDAT", idat[7:]) + chunk(b"IEND", b""))


def _cv2_read(path, color):
    """What the JAX loaders make of ``cv2.imread``: BGR(A) -> RGB(A), / 255."""
    img = cv2.imread(path, cv2.IMREAD_COLOR if color else cv2.IMREAD_UNCHANGED)
    if img.ndim == 3 and img.shape[-1] >= 3:
        img[..., :3] = img[..., 2::-1]
    return img.astype(np.float32) / 255.0


@pytest.mark.parametrize("color_type", [0, 4, 2, 6])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_filters_decode_as_cv2(tmp_path, color_type, kind):
    rng = np.random.default_rng(10 * color_type + kind)
    px = rng.integers(0, 256, (13, 17, CHANNELS[color_type])).astype(np.uint8)
    px[4:8] = px[3]  # repeated rows: the up and average filters meet zero residuals
    path = str(tmp_path / "x.png")
    _write_png(path, px, color_type, [kind])
    np.testing.assert_array_equal(native.decode_png(path), px)
    for color in (False, True):
        got, want = IM.read_image(path, color=color), _cv2_read(path, color)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_png_mixed_filters_and_batch_decode(tmp_path):
    """Rows cycling through every filter; the batch decoder gives each
    file's pixels; a file of another shape in a batch is named."""
    rng = np.random.default_rng(3)
    paths, pxs = [], []
    for i in range(5):
        px = rng.integers(0, 256, (9, 11, 4)).astype(np.uint8)
        paths.append(str(tmp_path / f"{i}.png"))
        _write_png(paths[-1], px, 6, [0, 1, 2, 3, 4][i:] + [0, 1, 2, 3, 4][:i])
        pxs.append(px)
    np.testing.assert_array_equal(native.decode_png_batch(paths), np.stack(pxs))
    for got, p in zip(IM.read_images(paths), paths):
        np.testing.assert_array_equal(got, _cv2_read(p, False))
    odd = str(tmp_path / "odd.png")
    _write_png(odd, pxs[0][:, :10], 6, [1])
    with pytest.raises(ValueError, match="odd.png"):
        native.decode_png_batch(paths + [odd])
    assert [x.shape for x in IM.read_images(paths[:1] + [odd])] == [(9, 11, 4), (9, 10, 4)]


def test_png_refusals(tmp_path):
    with pytest.raises(FileNotFoundError):
        IM.read_image(str(tmp_path / "missing.png"))
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(ValueError, match="bit depth"):
        IM.read_image(deep)


def test_write_png_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    for shape in [(6, 7), (6, 7, 2), (6, 7, 3), (6, 7, 4)]:
        px = rng.integers(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / "w.png")
        IM.write_png(path, px)
        got = native.decode_png(path)
        np.testing.assert_array_equal(got.reshape(px.shape), px)
        np.testing.assert_array_equal(IM.read_image(path), _cv2_read(path, False))


def test_other_formats_go_through_cv2_or_raise(tmp_path, monkeypatch):
    """JPEG is decoded by cv2 (or PIL); with neither installed, reading one
    raises naming the file and the missing decoder."""
    import builtins

    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, np.random.default_rng(5).integers(0, 256, (8, 12, 3)).astype(np.uint8))
    np.testing.assert_array_equal(IM.read_image(path, color=True), _cv2_read(path, True))
    real_import = builtins.__import__

    def no_decoders(name, *a, **k):
        if name in ("cv2", "PIL"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_decoders)
    with pytest.raises(RuntimeError, match=r"x\.jpg.*cv2 or PIL"):
        IM.read_image(path)


@pytest.mark.parametrize("factor", [2, 4, 8])
@pytest.mark.parametrize("shape", [(64, 48), (64, 48, 3), (64, 48, 4), (70, 45, 3)])
def test_area_downscale_matches_inter_area(factor, shape):
    img = np.random.default_rng(factor).random(shape).astype(np.float32)
    want = cv2.resize(img, (shape[1] // factor, shape[0] // factor), interpolation=cv2.INTER_AREA)
    got = IM.downscale_area(img, factor)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((50, 40), (30, 25)), ((37, 53), (16, 16)),
                                     ((30, 20), (45, 33)), ((30, 40), (20, 60))])
def test_area_resize_to_a_size_matches_inter_area(src, dst):
    """Topia's resize to the first view's size: area weights when both axes
    shrink, OpenCV's area-mode linear weights when one grows."""
    img = np.random.default_rng(sum(src)).random(src + (3,)).astype(np.float32)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(IM.resize_area(img, dst[1], dst[0]), want, rtol=0, atol=1e-6)


def test_host_library_source_is_the_ports_own():
    assert os.path.dirname(native._SRC) == os.path.dirname(native.__file__)
    assert native.load() is native.load()
