"""A PNG's ``tRNS`` chunk in the port's codec (``utils/png``) against PIL
12.1.0 and the JAX loaders, bit for bit.

PIL's ``convert("RGBA")`` turns a gray or RGB file's key colour into
alpha 0 (the JAX Blender loader reads frames so); ``convert("RGB")``
leaves the pixels as they are (the LLFF loaders of both packages drop
alpha).  Frames are written by PIL with ``transparency=``; the out-of-spec
cases (a key above 255, ``tRNS`` in a file with alpha) are spliced in by
hand and held to PIL itself.  A palette file's ``tRNS`` (per-index
alpha) is held to PIL and the JAX loaders too; every other layout is
``test_torch_png_formats.py``'s."""

import io as _io
import json
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from nerf_keras_tpu.data import blender as jblender
from nerf_keras_tpu.data import llff as jllff
from nerf_keras_tpu_torch.data import blender as pblender
from nerf_keras_tpu_torch.data import llff as pllff
from nerf_keras_tpu_torch.utils.png import decode_png, png_transparency, to_rgba

GRAY_KEY = 7
RGB_KEY = (0, 0, 0)


def _frame(mode: str, key, seed: int = 0) -> Image.Image:
    """A 6x9 frame of random pixels, a third of them the key colour."""
    rng = np.random.default_rng(seed)
    c = 1 if mode == "L" else 3
    arr = rng.integers(0, 256, (6, 9, c), dtype=np.uint8)
    arr[rng.random((6, 9)) < 1 / 3] = np.asarray(key, np.uint8)
    return Image.fromarray(arr[..., 0] if c == 1 else arr, mode=mode)


def _save(img: Image.Image, path: str, **kw) -> str:
    img.save(path, format="PNG", **kw)
    return path


def _with_chunk(png: bytes, kind: bytes, body: bytes) -> bytes:
    """``png`` with a chunk inserted just before its first IDAT."""
    chunk = (struct.pack(">I", len(body)) + kind + body
             + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    at = png.index(b"IDAT") - 4
    return png[:at] + chunk + png[at:]


@pytest.mark.parametrize("mode,key", [("L", GRAY_KEY), ("RGB", RGB_KEY), ("RGB", (200, 13, 77))])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_keyed_frame_equals_the_jax_loader(tmp_path, mode, key, white_bkgd):
    path = _save(_frame(mode, key), str(tmp_path / "r_0.png"), transparency=key)
    got, want = pblender._read_rgba(path), jblender._read_rgba(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got[..., 3] == 0).any() and (got[..., 3] == 1).any()
    np.testing.assert_array_equal(pblender._composite(got, white_bkgd),
                                  jblender._composite(want, white_bkgd))


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_keyed_scene_equals_the_jax_loader(tmp_path, white_bkgd):
    """A Blender split of a gray and an RGB keyed frame, loaded by both
    packages."""
    (tmp_path / "train").mkdir()
    _save(_frame("L", GRAY_KEY, 1), str(tmp_path / "train" / "r_0.png"), transparency=GRAY_KEY)
    _save(_frame("RGB", RGB_KEY, 2), str(tmp_path / "train" / "r_1.png"), transparency=RGB_KEY)
    pose = np.eye(4).tolist()
    meta = {"camera_angle_x": 0.69, "frames": [
        {"file_path": f"./train/r_{i}", "transform_matrix": pose} for i in range(2)]}
    (tmp_path / "transforms_train.json").write_text(json.dumps(meta))
    got = pblender.load_blender_split(str(tmp_path), "train", white_bkgd=white_bkgd)
    want = jblender.load_blender_split(str(tmp_path), "train", white_bkgd=white_bkgd)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("mode,key", [("L", GRAY_KEY), ("RGB", RGB_KEY)])
def test_llff_drops_the_key_as_both_packages(tmp_path, mode, key):
    path = _save(_frame(mode, key), str(tmp_path / "f.png"), transparency=key)
    got = pllff._read_rgb_u8(path)
    with Image.open(path) as img:
        np.testing.assert_array_equal(got, np.asarray(img.convert("RGB")))
    np.testing.assert_array_equal(got.astype(np.float32) / 255.0, jllff._read_image(path))


@pytest.mark.parametrize("mode,body", [
    ("L", struct.pack(">H", 0x0100 | GRAY_KEY)),        # the high byte set: PIL keys on the low
    ("RGB", struct.pack(">3H", 0x0100, 0x0200, 0x0300)),  # ... so this keys on (0, 0, 0)
    ("LA", struct.pack(">H", GRAY_KEY)),                  # tRNS beside alpha: ignored
    ("RGBA", struct.pack(">3H", 0, 0, 0)),
])
def test_spliced_trns_equals_pil(mode, body):
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    arr = np.random.default_rng(c).integers(0, 256, (5, 7, c), dtype=np.uint8)
    arr[::2, ::3, :min(c, 3)] = GRAY_KEY if c <= 2 else 0
    buf = _io.BytesIO()
    Image.fromarray(arr[..., 0] if c == 1 else arr, mode=mode).save(buf, format="PNG")
    png = _with_chunk(buf.getvalue(), b"tRNS", body)
    with Image.open(_io.BytesIO(png)) as img:
        want = np.asarray(img.convert("RGBA"))
    got = to_rgba(decode_png(png), png_transparency(png))
    np.testing.assert_array_equal(got, want)
    assert (want[..., 3] == 0).any() == (c in (1, 3))


def test_png_transparency_reads_the_key_or_none():
    buf = _io.BytesIO()
    _frame("RGB", RGB_KEY).save(buf, format="PNG", transparency=(1, 2, 3))
    assert png_transparency(buf.getvalue()) == (1, 2, 3)
    buf = _io.BytesIO()
    _frame("L", GRAY_KEY).save(buf, format="PNG")
    assert png_transparency(buf.getvalue()) is None


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_palette_with_trns_equals_pil_and_jax(tmp_path, white_bkgd):
    """The palette file PIL writes with ``transparency=0`` (a ``tRNS`` of
    one 0 among 255s): each index's alpha, through both loaders, against
    PIL and the JAX loaders."""
    img = _frame("RGB", RGB_KEY).convert("P", palette=Image.Palette.ADAPTIVE, colors=8)
    path = _save(img, str(tmp_path / "r_0.png"), transparency=0)
    with open(path, "rb") as f:
        assert b"tRNS" in f.read()
    with Image.open(path) as im:
        assert im.mode == "P"
        want_rgba, want_rgb = np.asarray(im.convert("RGBA")), np.asarray(im.convert("RGB"))
    got = pblender._read_rgba(path)
    np.testing.assert_array_equal(got, want_rgba.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(got, jblender._read_rgba(path))
    assert (got[..., 3] == 0).any() and (got[..., 3] == 1).any()
    np.testing.assert_array_equal(pblender._composite(got, white_bkgd),
                                  jblender._composite(jblender._read_rgba(path), white_bkgd))
    rgb = pllff._read_rgb_u8(path)
    np.testing.assert_array_equal(rgb, want_rgb)
    np.testing.assert_array_equal(rgb.astype(np.float32) / 255.0, jllff._read_image(path))
