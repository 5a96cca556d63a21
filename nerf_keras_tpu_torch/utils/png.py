"""A PNG encoder and decoder (zlib + struct + host C++), in place of PIL.

Encodes 8-bit grayscale, RGB and RGBA images (filter type 0 on every
row).  Decodes every PNG that PIL 12.1.0 opens: gray at 1, 2, 4, 8 and
16 bits, RGB, gray+alpha and RGBA at 8 and 16, palette at 1, 2, 4 and 8,
each non-interlaced or Adam7, with any of the five row filters.
``decode_png`` gives the 8-bit image that PIL's ``convert("RGB")`` and
``convert("RGBA")`` start from:

- gray at 1, 2 and 4 bits scaled to 0..255 (x255, x85, x17), as PIL's
  modes ``1`` and ``L`` hold it; 16-bit gray (PIL's ``I;16``) clipped to
  255, as its conversions clip it;
- 16-bit RGB, gray+alpha and RGBA at the high byte of each sample;
- a palette file looked up in its ``PLTE`` (entries past it black, as in
  PIL), as RGB, or as RGBA with each index's alpha from ``tRNS`` (255 past
  its end) where the file has one.

``to_rgba`` widens a decoded image as ``convert("RGBA")`` does, with the
key colour of a gray or RGB file's ``tRNS`` (``png_transparency``) made
transparent.  The chunk walk, the checks on chunks and zlib are Python;
undoing the filters, splitting the Adam7 passes and unpacking the
samples is host C++: g++ builds ``native/png.cc`` at first use into
``nerf_keras_tpu_torch/_build/``, named by a hash of the source, and
without g++ the decoder raises ``RuntimeError`` naming it.  Where PIL
refuses a file (a bad CRC before the image data, a filter byte past 4,
image data that ends early, a palette of more than 256 entries, a short
``tRNS``) ``decode_png`` raises ``ValueError`` naming the cause.
"""

from __future__ import annotations

import ctypes
import re
import struct
import threading
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from nerf_keras_tpu_torch.utils import hostbuild

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNEL_COLOR = {1: 0, 3: 2, 2: 4, 4: 6}
# The bit depths the specification allows for each colour type, and the
# colour type's samples per pixel.
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_GRAY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}
# Adam7's passes: (first column, first row, column step, row step).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
# PIL's test of a chunk type (``PngImagePlugin.is_cid``).
_CHUNK_TYPE = re.compile(rb"\w\w\w\w")

_SRC = Path(__file__).resolve().parent / "native" / "png.cc"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    return hostbuild.library_path(_SRC, "libpng_unfilter")


def load_library() -> ctypes.CDLL:
    """Compile (once) and load the unfilter."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = hostbuild.load_library(_SRC, library_path(), "the PNG decoder")
        p = ctypes.c_void_p
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [p, ctypes.c_int64] + [ctypes.c_int] * 5 + [
            p, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
        return _lib


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """``(H, W)``, ``(H, W, 1|2|3|4)`` uint8 -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _CHANNEL_COLOR:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w, c = img.shape
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1
    )
    header = struct.pack(">IIBBBBB", w, h, 8, _CHANNEL_COLOR[c], 0, 0, 0)
    return b"".join([
        PNG_SIGNATURE,
        _chunk(b"IHDR", header),
        _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
        _chunk(b"IEND", b""),
    ])


@dataclass
class _Png:
    width: int
    height: int
    depth: int
    color: int
    interlace: bool
    idat: bytes
    palette: bytes | None  # the last PLTE before the image data
    trns: bytes | None  # the last tRNS before IEND


def _parse(data: bytes) -> _Png:
    """Walk the chunks as PIL's ``PngImageFile`` reads them: the header,
    ``PLTE`` and the CRCs up to the first IDAT, the first run of IDAT
    chunks as the image data, and the chunks after it up to IEND (where a
    ``tRNS`` still counts) without their CRCs."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    header = palette = trns = None
    idat: list[bytes] = []
    pos, n = 8, len(data)
    state = "header"  # then "idat" inside the first run of IDATs, then "after"
    while pos + 8 <= n:
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if not _CHUNK_TYPE.fullmatch(kind):
            if state == "header":
                raise ValueError(f"broken PNG: chunk type {kind!r} at byte {pos}")
            break
        if len(body) < length:
            raise ValueError(f"truncated {kind.decode()} chunk: {len(body)} of its "
                             f"{length} bytes")
        if state == "header" and kind != b"IDAT":
            crc = data[pos + 8 + length:pos + 12 + length]
            if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
                raise ValueError(f"broken PNG: bad CRC in the {kind.decode()} chunk")
        pos += 12 + length
        if kind == b"IEND":
            break
        if header is None:
            if kind != b"IHDR":
                raise ValueError(f"the first chunk is {kind.decode()}, not IHDR")
            if length < 13:
                raise ValueError(f"truncated IHDR chunk ({length} bytes)")
            header = struct.unpack(">IIBBBBB", body[:13])
            continue
        if kind == b"IDAT":
            if state == "after":
                continue  # PIL reads only the first run of IDAT chunks
            state = "idat"
            idat.append(body)
            continue
        if state == "idat":
            state = "after"
        if kind == b"PLTE" and state == "header":
            palette = body
        elif kind == b"tRNS":
            trns = body
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, filter_method, interlace = header
    if color not in _DEPTHS or depth not in _DEPTHS[color]:
        raise ValueError(f"bit depth {depth} with color type {color} (not a PNG layout)")
    if filter_method:
        raise ValueError(f"unknown filter method {filter_method}")
    if w == 0 or h == 0:
        raise ValueError(f"image size {w}x{h}")
    if not idat:
        raise ValueError("no image data (IDAT)")
    if color == 3:
        if palette is not None and len(palette) // 3 > 256:
            raise ValueError(f"PLTE of {len(palette) // 3} entries (256 at most)")
        if trns is not None and len(trns) > 256:
            raise ValueError(f"tRNS of {len(trns)} entries in a palette PNG (256 at most)")
    elif color in (0, 2) and trns is not None and len(trns) < 2 * _CHANNELS[color]:
        raise ValueError(f"tRNS chunk of {len(trns)} bytes in a PNG of color type {color}")
    return _Png(w, h, depth, color, bool(interlace), b"".join(idat), palette, trns)


def _image_bytes(png: _Png) -> int:
    """The inflated size of the image data: a filter byte and the packed
    samples of each row of each (non-empty) pass."""
    bits = png.depth * _CHANNELS[png.color]
    passes = _ADAM7 if png.interlace else ((0, 0, 1, 1),)
    total = 0
    for x0, y0, dx, dy in passes:
        if png.width > x0 and png.height > y0:
            pw, ph = -(-(png.width - x0) // dx), -(-(png.height - y0) // dy)
            total += ph * (1 + (pw * bits + 7) // 8)
    return total


def _samples(png: _Png) -> np.ndarray:
    """Every sample, ``(H, W, C)``: uint8 below 16 bits (unscaled), uint16
    at 16."""
    try:
        raw = zlib.decompressobj().decompress(png.idat, _image_bytes(png))
    except zlib.error as e:
        raise ValueError(f"corrupt image data (zlib: {e})") from e
    c = _CHANNELS[png.color]
    out = np.empty((png.height, png.width, c), np.uint16 if png.depth == 16 else np.uint8)
    buf = np.frombuffer(raw, np.uint8)
    err = ctypes.create_string_buffer(256)
    rc = load_library().png_unfilter(buf.ctypes.data, buf.size, png.width, png.height,
                                     png.depth, c, int(png.interlace), out.ctypes.data, err,
                                     len(err))
    if rc != 0:
        raise ValueError(err.value.decode())
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``(H, W)`` (gray), ``(H, W, 2)``, ``(H, W, 3)`` or
    ``(H, W, 4)`` uint8: the 8-bit image of the module docstring."""
    png = _parse(data)
    s = _samples(png)
    if png.color == 3:
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        pal = np.frombuffer(png.palette or b"", np.uint8)
        entries = len(pal) // 3
        table[:entries, :3] = pal[:3 * entries].reshape(entries, 3)
        if png.trns is None:
            return table[s[..., 0], :3]
        table[:len(png.trns), 3] = np.frombuffer(png.trns, np.uint8)
        return table[s[..., 0]]
    if png.depth == 16:
        img = np.minimum(s, 255) if png.color == 0 else s >> 8
        img = img.astype(np.uint8)
    elif png.depth < 8:
        img = s * np.uint8(_GRAY_SCALE[png.depth])
    else:
        img = s
    return img[..., 0] if img.shape[-1] == 1 else img


def png_transparency(data: bytes) -> tuple[int, ...] | None:
    """The key colour of a gray (``(v,)``) or RGB (``(r, g, b)``) PNG's
    ``tRNS`` chunk as PIL holds it (``info["transparency"]``): each
    sample's 16 bits, a 1-bit file's as 255 where it is not 0; the last
    ``tRNS`` before IEND, after the image data too.  None without one,
    and for the other colour types: PIL ignores the chunk beside alpha,
    and a palette file's alphas are ``decode_png``'s."""
    png = _parse(data)
    if png.trns is None or png.color not in (0, 2):
        return None
    key = struct.unpack(f">{_CHANNELS[png.color]}H", png.trns[:2 * _CHANNELS[png.color]])
    if png.color == 0 and png.depth == 1:
        return (255 if key[0] else 0,)
    return key


def to_rgba(img: np.ndarray, transparency: tuple[int, ...] | None = None) -> np.ndarray:
    """A decoded 8-bit image -> ``(H, W, 4)`` uint8, as PIL's
    ``convert("RGBA")``: gray fills r, g and b; an absent alpha is 255,
    and 0 where a gray or RGB pixel equals ``transparency``
    (:func:`png_transparency`), whose samples PIL compares by their low
    byte with the 8-bit pixels."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    c = img.shape[-1]
    if c not in _CHANNEL_COLOR:
        raise ValueError(f"unsupported image shape {img.shape}")
    rgb = np.repeat(img[..., :1], 3, axis=-1) if c <= 2 else img[..., :3]
    if c in (2, 4):
        alpha = img[..., -1:]
    else:
        alpha = np.full(img.shape[:2] + (1,), 255, np.uint8)
        if transparency is not None:
            key = np.asarray(transparency, np.int64) & 0xFF
            alpha[(img == key).all(axis=-1)] = 0
    return np.concatenate([rgb, alpha], axis=-1).astype(np.uint8)
