"""A stdlib PNG encoder and decoder (zlib + struct), in place of PIL.

Encodes 8-bit grayscale, RGB and RGBA images (filter type 0 on every
row).  Decodes 8-bit, non-interlaced grayscale, gray+alpha, RGB and RGBA
PNGs with any of the five row filters, which covers what this package
and PIL write.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
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
        _SIGNATURE,
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


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``(H, W)`` (grayscale) or ``(H, W, C)`` uint8."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
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
