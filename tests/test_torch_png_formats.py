"""Every PNG layout PIL opens, through the port's decoder (``utils/png``
+ ``utils/native/png.cc``) and both loaders, bit for bit against PIL
12.1.0's ``convert`` and the JAX loaders.

The 15 (colour type, bit depth) pairs of the PNG specification, each
plain and Adam7, are written here by ``torch_png_fixtures.write_png``
(PIL writes neither Adam7 nor 16-bit colour) at odd widths, so 1-, 2- and
4-bit rows end in padding bits, with rows cycling through the five
filters; PIL decodes every file for the reference, so the writer is
never its own.  ``data/blender._read_rgba`` is held to ``convert("RGBA")``
and the JAX ``blender._read_rgba``; ``data/llff._read_rgb_u8`` to
``convert("RGB")`` and the JAX ``llff._read_image``.  PIL's rules, found
here: 1-bit gray is 0/255, 2- and 4-bit gray x85 and x17, 16-bit gray
(``I;16``) clipped to 255, 16-bit colour at the high byte; a gray or RGB
``tRNS`` key compares its low byte with those 8-bit values (a 1-bit
file's key is 255 where it is not 0); a palette's ``tRNS`` gives each index
its alpha, 255 past its end; indices past ``PLTE`` are black.  Files PIL
refuses raise ``ValueError`` naming the file and the cause."""

import io as _io
import json
import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

import torch_png_fixtures as fx
from nerf_keras_tpu.data import blender as jblender
from nerf_keras_tpu.data import llff as jllff
from nerf_keras_tpu_torch.data import blender as pblender
from nerf_keras_tpu_torch.data import llff as pllff
from nerf_keras_tpu_torch.utils import hostbuild, png
from nerf_keras_tpu_torch.utils.png import decode_png, png_transparency, to_rgba


def _pil(data: bytes, mode: str) -> np.ndarray:
    with warnings.catch_warnings():
        # PIL warns that a palette's per-index tRNS leaves convert("RGB").
        warnings.simplefilter("ignore", UserWarning)
        with Image.open(_io.BytesIO(data)) as img:
            return np.asarray(img.convert(mode))


def _assert_loaders_equal_pil_and_jax(path, data: bytes) -> None:
    """Both port loaders on ``path`` against PIL and the JAX loaders."""
    rgba = pblender._read_rgba(str(path))
    np.testing.assert_array_equal(rgba, _pil(data, "RGBA").astype(np.float32) / 255.0)
    np.testing.assert_array_equal(rgba, jblender._read_rgba(str(path)))
    rgb = pllff._read_rgb_u8(str(path))
    assert rgb.dtype == np.uint8
    np.testing.assert_array_equal(rgb, _pil(data, "RGB"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        np.testing.assert_array_equal(rgb.astype(np.float32) / 255.0,
                                      jllff._read_image(str(path)))


def _palette(depth: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (1 << depth, 3))


def _layout_png(color: int, depth: int, interlace: bool, h: int, w: int, seed: int,
                **kw) -> bytes:
    samples = fx.random_samples(h, w, color, depth, seed)
    pal = _palette(depth, seed) if color == 3 else None
    return fx.write_png(samples, color, depth, interlace=interlace, palette=pal, **kw)


# --- the 30 layouts ---------------------------------------------------------------

@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("color,depth", fx.LAYOUTS, ids=[f"c{c}d{d}" for c, d in fx.LAYOUTS])
def test_layout_loads_as_pil_and_jax(tmp_path, color, depth, interlace):
    """Odd widths (13 and 19: padded sub-byte rows), 11 and 6 rows
    cycling through the five filters."""
    for i, (h, w) in enumerate(((11, 13), (6, 19))):
        data = _layout_png(color, depth, interlace, h, w, seed=100 * depth + 10 * color + i)
        path = tmp_path / f"f{i}.png"
        path.write_bytes(data)
        _assert_loaders_equal_pil_and_jax(path, data)
    with Image.open(path) as img:
        assert img.size == (19, 6)
        assert img.info.get("interlace", 0) == int(interlace)


@pytest.mark.parametrize("f", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("color,depth", [(0, 1), (3, 4), (2, 16), (6, 16), (4, 8)])
def test_each_filter_alone_at_each_pixel_width(tmp_path, color, depth, f):
    """Every row with filter ``f``: bytes per pixel 1 (sub-byte and 8-bit
    gray+alpha's 2), 6 and 8."""
    data = _layout_png(color, depth, False, 9, 15, seed=f, filters=(f,))
    path = tmp_path / "f.png"
    path.write_bytes(data)
    _assert_loaders_equal_pil_and_jax(path, data)


@pytest.mark.parametrize("size", [(1, 1), (3, 3), (1, 9), (9, 1), (2, 5), (5, 2)])
@pytest.mark.parametrize("color,depth", [(0, 1), (0, 16), (3, 2), (6, 8), (2, 16)])
def test_tiny_adam7_images_with_empty_passes(tmp_path, color, depth, size):
    """Adam7 on images smaller than its 8x8 tile: passes with no column or
    no row hold no bytes at all (not even a filter byte)."""
    data = _layout_png(color, depth, True, *size, seed=sum(size))
    path = tmp_path / "tiny.png"
    path.write_bytes(data)
    _assert_loaders_equal_pil_and_jax(path, data)


def test_all_paeth_camera_frame_equals_pil():
    """An 800x800 RGBA frame whose every row is Paeth (the filter the
    unfilter once ran per pixel in Python), and the same as Adam7."""
    rgba = fx.random_samples(800, 800, 6, 8, seed=3)
    for interlace in (False, True):
        data = fx.write_png(rgba, 6, 8, interlace=interlace, filters=(4,))
        np.testing.assert_array_equal(decode_png(data), _pil(data, "RGBA"))


# --- tRNS ---------------------------------------------------------------------------

def _gray_trns_cases():
    """(depth, key): a key inside the range, 0, and keys past it whose
    low byte PIL compares (a 1-bit key is 255 where it is not 0)."""
    return [(1, 0), (1, 1), (1, 2), (1, 256), (2, 0), (2, 2), (2, 85), (2, 0x155),
            (4, 0), (4, 9), (4, 34), (8, 0), (8, 77), (8, 0x14D), (16, 0), (16, 0x34),
            (16, 0x1234), (16, 0x00FF), (16, 0x0100)]


@pytest.mark.parametrize("depth,key", _gray_trns_cases())
def test_gray_trns_key_as_pil(tmp_path, depth, key):
    top = min((1 << depth) - 1, 0xFFFF)
    samples = fx.random_samples(7, 11, 0, depth, seed=key)
    samples[::2, ::3] = key & top
    if depth == 16:  # values past 255 clip onto the keys' low bytes
        samples[1, :4, 0] = [0x34, 0x1234, 255, 256]
    data = fx.write_png(samples, 0, depth, trns=struct.pack(">H", key))
    path = tmp_path / "g.png"
    path.write_bytes(data)
    _assert_loaders_equal_pil_and_jax(path, data)


@pytest.mark.parametrize("depth,key", [(8, (0, 0, 0)), (8, (200, 13, 77)),
                                       (8, (0x100, 0x200, 0x300)),
                                       (16, (0x1234, 0x5678, 0x9ABC)), (16, (0, 0, 0))])
@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
def test_rgb_trns_key_as_pil(tmp_path, depth, key, interlace):
    """A 16-bit RGB key: its low bytes against the pixels' high bytes."""
    samples = fx.random_samples(7, 11, 2, depth, seed=depth)
    if depth == 16:
        samples[::2, ::3] = [(k & 0xFF) * 0x101 for k in key]  # high byte = key's low
    else:
        samples[::2, ::3] = [k & 0xFF for k in key]
    data = fx.write_png(samples, 2, depth, interlace=interlace,
                        trns=struct.pack(">3H", *key))
    path = tmp_path / "c.png"
    path.write_bytes(data)
    _assert_loaders_equal_pil_and_jax(path, data)
    assert (_pil(data, "RGBA")[..., 3] == 0).any()


@pytest.mark.parametrize("trns_len", [0, 1, 3, 256])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette_trns_as_pil(tmp_path, depth, trns_len):
    """Per-index alpha: a ``tRNS`` shorter than the palette (255 past its
    end), a single 0 among 255s (PIL's int ``transparency``), and one of
    256 entries, longer than the palette (its alpha reaches indices past
    ``PLTE``, which are black)."""
    rng = np.random.default_rng(depth + trns_len)
    n = 1 << depth
    samples = rng.integers(0, n, (9, 13))
    pal = rng.integers(0, 256, (max(1, n - 1), 3))  # the last index lies past PLTE
    trns = rng.integers(0, 256, trns_len).astype(np.uint8).tobytes()
    if trns_len == 3:
        trns = b"\xff\x00\xff"
    data = fx.write_png(samples, 3, depth, palette=pal, trns=trns)
    path = tmp_path / "p.png"
    path.write_bytes(data)
    _assert_loaders_equal_pil_and_jax(path, data)


def test_trns_after_the_image_data_and_the_last_of_two_as_pil(tmp_path):
    """PIL reads the chunks after the image data when it loads it: a
    ``tRNS`` there still keys the frame, and of two the last counts."""
    gray = fx.write_png(np.array([[0, 7, 9, 7]]), 0, 8)
    at = gray.index(b"IEND") - 4
    after = gray[:at] + fx.chunk(b"tRNS", struct.pack(">H", 7)) + gray[at:]
    two = fx.write_png(np.array([[0, 7, 9, 7]]), 0, 8, trns=struct.pack(">H", 7),
                       extra=[(b"tRNS", struct.pack(">H", 9))])
    pal = fx.write_png(np.array([[0, 1, 2, 1]]), 3, 8, palette=_palette(2, 0)[:3])
    at = pal.index(b"IEND") - 4
    pal_after = pal[:at] + fx.chunk(b"tRNS", b"\x10\x20") + pal[at:]
    for i, data in enumerate((after, two, pal_after)):
        path = tmp_path / f"t{i}.png"
        path.write_bytes(data)
        _assert_loaders_equal_pil_and_jax(path, data)
        assert (_pil(data, "RGBA")[..., 3] != 255).any()
    assert png_transparency(after) == (7,) and png_transparency(two) == (9,)


def test_odd_files_pil_decodes(tmp_path):
    """What PIL decodes although the specification frowns: a palette file
    without ``PLTE`` (black), a ``PLTE`` of 10 bytes (3 entries), a second
    ``PLTE`` (the last wins), one after the image data (ignored), unknown
    chunks, a bad CRC on IDAT (not checked), surplus inflated bytes, no
    IEND, and an interlace method of 2 (read as Adam7)."""
    idx = np.array([[0, 1, 2, 3], [3, 2, 1, 0]])
    pal = fx.write_png(idx, 3, 8, palette=[[1, 2, 3]])
    at = pal.index(b"IEND") - 4
    gray = fx.write_png(np.arange(12).reshape(3, 4) * 20, 0, 8)
    i = gray.index(b"IDAT") - 4
    n = struct.unpack(">I", gray[i:i + 4])[0]
    raw = b"\x00\x07\x08\x00\x09\x0a" + b"\x00" * 5
    header = fx.chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 0, 0, 0, 0))
    adam = _layout_png(0, 8, True, 5, 6, seed=1)
    cases = {
        "no_plte": fx.write_png(idx, 3, 8),
        "plte_10_bytes": fx.write_png(idx, 3, 8, extra=[(b"PLTE", bytes(range(10)))]),
        "two_plte": fx.write_png(idx, 3, 8, palette=[[1, 2, 3]],
                                 extra=[(b"PLTE", b"\x05\x06\x07\x08\x09\x0a")]),
        "plte_after_idat": pal[:at] + fx.chunk(b"PLTE", b"\x09" * 12) + pal[at:],
        "unknown_chunks": fx.write_png(idx, 3, 8, palette=[[1, 2, 3]] * 4,
                                       extra=[(b"tEXt", b"k\x00v"), (b"abCD", b"\x01")]),
        "bad_idat_crc": gray[:i + 8 + n] + b"\x00\x00\x00\x00" + gray[i + 12 + n:],
        "surplus_data": fx.PNG_SIG + header + fx.chunk(b"IDAT", zlib.compress(raw)),
        "no_adler": fx.PNG_SIG + header + fx.chunk(b"IDAT", zlib.compress(raw)[:-4])
        + fx.chunk(b"IEND", b""),
        "interlace_2": adam[:28] + b"\x02"
        + struct.pack(">I", zlib.crc32(adam[12:28] + b"\x02")) + adam[33:],
    }
    for name, data in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        _assert_loaders_equal_pil_and_jax(path, data)
    assert (_pil(cases["no_plte"], "RGB") == 0).all()


# --- what is refused ---------------------------------------------------------------

def _refused_cases():
    base = fx.write_png(np.arange(20).reshape(4, 5), 0, 8, filters=(0,))
    i = base.index(b"IDAT")
    n = struct.unpack(">I", base[i - 4:i])[0]
    raw = zlib.decompress(base[i + 4:i + 4 + n])

    def with_idat(raw_bytes):
        z = zlib.compress(raw_bytes)
        return base[:i - 4] + fx.chunk(b"IDAT", z) + base[i + 8 + n:]

    def with_header(depth, color, w=5, h=4, filt=0):
        body = struct.pack(">IIBBBBB", w, h, depth, color, 0, filt, 0)
        return base[:8] + fx.chunk(b"IHDR", body) + base[33:]

    bad_filter = bytearray(raw)
    bad_filter[6] = 5  # the second row's filter byte
    gray_text = fx.write_png(np.zeros((2, 2)), 0, 8, extra=[(b"tEXt", b"k\x00v")])
    t = gray_text.index(b"tEXt") + 7
    split = fx.write_png(np.arange(400).reshape(20, 20) % 256, 0, 8, idat_parts=2)
    second = split.index(b"IDAT", split.index(b"IDAT") + 4) - 4
    return {
        "bad_filter": (with_idat(bytes(bad_filter)), "unknown filter type 5"),
        "truncated_data": (with_idat(raw[:-3]), "truncated image data"),
        "corrupt_zlib": (base[:i - 4] + fx.chunk(b"IDAT", b"garbage!") + base[i + 8 + n:],
                         "corrupt image data"),
        "bad_header_crc": (gray_text[:t] + b"\x00\x00\x00\x00" + gray_text[t + 4:],
                           "bad CRC in the tEXt chunk"),
        "no_idat": (base[:i - 4] + fx.chunk(b"IEND", b""), "no image data"),
        "split_idat": (split[:second] + fx.chunk(b"tEXt", b"k\x00v") + split[second:],
                       "truncated image data"),
        "palette_16_bit": (with_header(16, 3), "bit depth 16 with color type 3"),
        "rgb_4_bit": (with_header(4, 2), "bit depth 4 with color type 2"),
        "zero_width": (with_header(8, 0, w=0), "image size 0x4"),
        "filter_method": (with_header(8, 0, filt=1), "unknown filter method 1"),
        "plte_257": (fx.write_png(np.zeros((2, 2)), 3, 8, palette=np.zeros((257, 3))),
                     "PLTE of 257 entries"),
        "trns_257": (fx.write_png(np.zeros((2, 2)), 3, 8, palette=np.zeros((4, 3)),
                                  trns=bytes(257)), "tRNS of 257 entries"),
        "short_gray_trns": (fx.write_png(np.zeros((2, 2)), 0, 8, trns=b"\x07"),
                            "tRNS chunk of 1 bytes"),
        "short_rgb_trns": (fx.write_png(np.zeros((2, 2, 3)), 2, 16, trns=b"\x00" * 4),
                           "tRNS chunk of 4 bytes"),
    }


@pytest.mark.parametrize("kind", sorted(_refused_cases()))
def test_refused_png_raises_naming_the_file_as_pil_refuses(tmp_path, kind):
    data, what = _refused_cases()[kind]
    path = tmp_path / f"frame_{kind}.png"
    path.write_bytes(data)
    for read in (pblender._read_rgba, pllff._read_rgb_u8):
        with pytest.raises(ValueError, match=f"frame_{kind}.png: .*{what}"):
            read(str(path))
    with pytest.raises((OSError, ValueError, SyntaxError)):
        _pil(data, "RGBA")


def test_decoder_without_gxx_names_the_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(png, "_lib", None)
    monkeypatch.setattr(png, "library_path", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(hostbuild.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        decode_png(fx.write_png(np.zeros((2, 2)), 0, 8))


def test_decode_png_keeps_its_8_bit_shapes():
    """The callers of ``decode_png`` (served and rendered PNGs, minify's
    output) get what they got: ``(H, W)`` gray and ``(H, W, C)`` 8-bit
    images as written; ``to_rgba`` widens each."""
    rng = np.random.default_rng(0)
    for c in (1, 2, 3, 4):
        img = rng.integers(0, 256, (5, 7, c), dtype=np.uint8)
        got = decode_png(png.encode_png(img))
        np.testing.assert_array_equal(got, img[..., 0] if c == 1 else img)
        assert got.dtype == np.uint8 and to_rgba(got).shape == (5, 7, 4)


# --- the committed Blender scene ----------------------------------------------------

def test_scene_goldens_are_what_pil_computes():
    """``goldens.json`` against PIL on the committed frames, each frame in
    the layout its name says, the fixture directory under 100 KB."""
    stored = json.loads(fx.GOLDENS.read_text())
    assert stored["decode"] == fx.pil_goldens()["decode"]
    assert sorted(stored["decode"]) == sorted(fx.SCENE_FRAMES)
    for rel, layout in fx.SCENE_FRAMES.items():
        data = (fx.SCENE / rel).read_bytes()
        w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", data[16:29])
        assert (w, h) == (fx.SCENE_SIZE, fx.SCENE_SIZE)
        assert interlace == layout.endswith("adam7"), rel
        assert (color, depth) == {"rgba16": (6, 16), "rgba8": (6, 8), "la16": (4, 16),
                                  "palette8": (3, 8), "palette4": (3, 4)}[
                                      layout.split("_")[0]], rel
        assert (b"tRNS" in data) == ("trns" in layout), rel
        assert fx.digest(to_rgba(decode_png(data), png_transparency(data))) == \
            stored["decode"][rel]
    size = sum(p.stat().st_size for p in fx.FIXTURES.rglob("*") if p.is_file())
    assert size < 100_000, size


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_scene_loads_as_the_jax_loader(white_bkgd):
    for split in ("train", "val"):
        got = pblender.load_blender_split(str(fx.SCENE), split, white_bkgd=white_bkgd)
        want = jblender.load_blender_split(str(fx.SCENE), split, white_bkgd=white_bkgd)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        assert got[0].shape[1:] == (fx.SCENE_SIZE, fx.SCENE_SIZE, 3)
    got = pblender.prepare_blender_data(20, 20, str(fx.SCENE), white_bkgd=white_bkgd)
    want = jblender.prepare_blender_data(20, 20, str(fx.SCENE), white_bkgd=white_bkgd)
    for a, b in zip(got[:2], want[:2]):
        for x, y in ((a.pixels, b.pixels), (a.origins, b.origins),
                     (a.directions, b.directions)):
            np.testing.assert_allclose(x, y, atol=1e-6, rtol=0)
    assert got[2:] == want[2:]
