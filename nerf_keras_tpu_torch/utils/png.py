"""A stdlib PNG encoder and decoder (zlib + struct), in place of PIL.

Encodes 8-bit grayscale, RGB and RGBA images (filter type 0 on every
row).  Decodes 8-bit, non-interlaced grayscale, gray+alpha, RGB and RGBA
PNGs with any of the five row filters, which covers what this package
and PIL write; palette, 16-bit and interlaced files raise ``ValueError``.
``to_rgba`` widens a decoded image as PIL's ``convert("RGBA")`` does,
with the key colour of a gray or RGB file's ``tRNS`` chunk
(``png_transparency``) made transparent.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_CHANNEL_COLOR = {1: 0, 3: 2, 2: 4, 4: 6}


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


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``(H, 1 + stride)`` scanlines."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per channel
            cur = line.reshape(-1, bpp).cumsum(axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential across pixels
            cur = line.copy()
            for x in range(0, stride, bpp):
                b = prev[x:x + bpp]
                if x == 0:
                    a = np.zeros(bpp, np.int32)
                    c = np.zeros(bpp, np.int32)
                else:
                    a = cur[x - bpp:x]
                    c = prev[x - bpp:x]
                if ftype == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[x:x + bpp] = (cur[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _chunks(data: bytes):
    """``(kind, body)`` of each chunk up to IEND."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``(H, W)`` (grayscale) or ``(H, W, C)`` uint8."""
    idat, header = [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _COLOR_CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, color type {color}, "
            f"interlace {interlace}"
        )
    c = _COLOR_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw.reshape(h, 1 + w * c), c).reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def png_transparency(data: bytes) -> tuple[int, ...] | None:
    """The key colour of a gray (``(v,)``) or RGB (``(r, g, b)``) PNG's
    ``tRNS`` chunk, each sample's 16 bits as PIL reads them; None without
    one.  PIL ignores the chunk in gray+alpha and RGBA files, and so does
    this; a palette file's raises in ``decode_png``."""
    color = None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            color = body[9]
        elif kind == b"tRNS" and color in (0, 2):
            n = 1 if color == 0 else 3
            if len(body) < 2 * n:
                raise ValueError(f"tRNS chunk of {len(body)} bytes in a PNG of color "
                                 f"type {color}")
            return struct.unpack(f">{n}H", body[:2 * n])
        elif kind == b"IDAT":
            break
    return None


def to_rgba(img: np.ndarray, transparency: tuple[int, ...] | None = None) -> np.ndarray:
    """A decoded 8-bit image -> ``(H, W, 4)`` uint8, as PIL's
    ``convert("RGBA")``: gray fills r, g and b; an absent alpha is 255,
    and 0 where a gray or RGB pixel equals ``transparency``
    (:func:`png_transparency`), whose samples PIL compares by their low
    byte."""
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
