"""A baseline JPEG decoder, in place of PIL's (the card's machine has none).

``decode_jpeg`` gives what ``PIL.Image.open(f)`` decodes, bit for bit:
PIL runs libjpeg-turbo with its defaults (the accurate integer IDCT,
fancy chroma upsampling, the fixed-point YCbCr -> RGB tables), and
``native/jpeg.cc`` computes the same.  It reads:

- SOF0 and SOF1 Huffman streams with 8-bit samples;
- one component (gray) or three (YCbCr) at 4:4:4, 4:2:2, 4:2:0 or 4:4:0;
- restart intervals (DRI/RST), any size, several DQT/DHT tables
  (optimised Huffman tables included);
- APPn and COM segments are skipped; no EXIF orientation is applied, as
  PIL's ``open`` applies none.

Everything else raises ``ValueError`` naming the file and the marker or
field rather than guess: progressive (SOF2), lossless (SOF3),
hierarchical and arithmetic-coded streams, 12-bit samples, CMYK/YCCK and
RGB (Adobe transform 0) streams, more than one scan, and truncated or
corrupt data.

The scan itself (entropy decoding, IDCT, upsampling, colour) is host C++:
g++ builds ``native/jpeg.cc`` at first use into
``nerf_keras_tpu_torch/_build/``, named by a hash of the source, as
``data/native.py`` builds the ray batcher.  Without g++ the decoder raises
``RuntimeError`` naming it: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

from nerf_keras_tpu_torch.utils.hostbuild import BUILD_DIR, compile_library

_SRC = Path(__file__).resolve().parent / "native" / "jpeg.cc"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

SOI = b"\xff\xd8"

# The zigzag order of a DQT table's 64 entries (ITU T.81 Figure A.6).
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Markers the decoder refuses, by what they start.
_REFUSED = {
    0xC2: "SOF2 (progressive)", 0xC3: "SOF3 (lossless)",
    0xC5: "SOF5 (differential sequential)", 0xC6: "SOF6 (differential progressive)",
    0xC7: "SOF7 (differential lossless)", 0xC9: "SOF9 (arithmetic sequential)",
    0xCA: "SOF10 (arithmetic progressive)", 0xCB: "SOF11 (arithmetic lossless)",
    0xCC: "DAC (arithmetic conditioning)", 0xCD: "SOF13 (arithmetic differential)",
    0xCE: "SOF14 (arithmetic differential progressive)",
    0xCF: "SOF15 (arithmetic differential lossless)", 0xDC: "DNL (number of lines)",
    0xDE: "DHP (hierarchical)", 0xDF: "EXP (hierarchical)",
}


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libjpeg_scan-{digest}.so"


def load_library() -> ctypes.CDLL:
    """Compile (once) and load the scan decoder."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            if shutil.which("g++") is None:
                raise RuntimeError(
                    "the JPEG decoder needs g++ to build native/jpeg.cc, and no g++ "
                    "is on PATH")
            try:
                compile_library(_SRC, path)
            except subprocess.CalledProcessError as e:
                raise RuntimeError(f"g++ failed to build {_SRC}: "
                                   f"{e.stderr.decode(errors='replace')[:400]}") from e
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        lib.jpeg_decode_scan.restype = ctypes.c_int
        lib.jpeg_decode_scan.argtypes = [
            p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, p, p,
            ctypes.c_int, p, ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int]
        _lib = lib
        return _lib


def is_jpeg(data: bytes) -> bool:
    return data[:2] == SOI


def _u16(data: bytes, pos: int) -> int:
    return struct.unpack(">H", data[pos:pos + 2])[0]


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> ``(H, W)`` uint8 (gray) or ``(H, W, 3)`` RGB, as
    ``PIL.Image.open`` decodes them.  ``name`` (the file) starts every
    error message."""

    def refuse(what: str) -> ValueError:
        return ValueError(f"{name}: {what}")

    if not is_jpeg(data):
        raise refuse("not a JPEG (no SOI marker)")
    quant = np.zeros((4, 64), np.int32)
    have_quant = [False] * 4
    huff_bits = np.zeros((8, 17), np.uint8)
    huff_vals = np.zeros((8, 256), np.uint8)
    huff_present = np.zeros(8, np.int32)
    restart = 0
    frame = None  # (height, width, [(id, h, v, tq)])
    jfif = False
    adobe = None  # the Adobe APP14 transform flag
    image = None
    pos, n = 2, len(data)
    while True:
        if pos >= n:
            raise refuse("truncated data: the file ends before the EOI marker")
        if data[pos] != 0xFF:
            raise refuse(f"expected a marker at byte {pos}, found 0x{data[pos]:02x}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise refuse("truncated data: the file ends inside a marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            if image is None:
                raise refuse("EOI before any scan (SOS)")
            return image
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            raise refuse(f"marker 0x{marker:02x} outside a scan")
        if pos + 2 > n or pos + _u16(data, pos) > n:
            raise refuse(f"truncated data in the segment of marker 0x{marker:02x}")
        length = _u16(data, pos)
        if length < 2:
            raise refuse(f"marker 0x{marker:02x}: segment length {length}")
        seg = data[pos + 2:pos + length]
        pos += length
        if marker in _REFUSED:
            raise refuse(f"{_REFUSED[marker]} is not decoded (baseline SOF0/SOF1 "
                         "Huffman JPEGs only)")
        if 0xE0 <= marker <= 0xEF or marker == 0xFE:  # APPn, COM
            if marker == 0xE0 and seg[:5] == b"JFIF\x00":
                jfif = True
            elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
                adobe = seg[11]
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                precision, tq = seg[i] >> 4, seg[i] & 15
                size = 64 * (precision + 1)
                if precision > 1 or tq > 3 or i + 1 + size > len(seg):
                    raise refuse(f"DQT: table {tq}, precision field {precision}")
                vals = np.frombuffer(seg[i + 1:i + 1 + size], ">u1" if precision == 0
                                     else ">u2")
                quant[tq][_NATURAL] = vals
                have_quant[tq] = True
                i += 1 + size
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                if tc > 1 or th > 3 or i + 17 > len(seg):
                    raise refuse(f"DHT: class {tc}, table {th}")
                counts = np.frombuffer(seg[i + 1:i + 17], np.uint8)
                total = int(counts.sum(dtype=np.int64))
                if total > 256 or i + 17 + total > len(seg):
                    raise refuse(f"DHT: class {tc}, table {th} holds {total} codes")
                t = 4 * tc + th
                huff_bits[t] = 0
                huff_bits[t, 1:] = counts
                huff_vals[t] = 0
                huff_vals[t, :total] = np.frombuffer(seg[i + 17:i + 17 + total], np.uint8)
                huff_present[t] = 1
                i += 17 + total
        elif marker == 0xDD:  # DRI
            if len(seg) != 2:
                raise refuse(f"DRI: segment length {length}")
            restart = _u16(seg, 0)
        elif marker in (0xC0, 0xC1):  # SOF0, SOF1
            if frame is not None:
                raise refuse("a second frame header (SOF)")
            if len(seg) < 6:
                raise refuse(f"SOF{marker - 0xC0}: segment length {length}")
            precision, height, width, nf = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
            if precision != 8:
                raise refuse(f"SOF{marker - 0xC0}: {precision}-bit samples (8-bit only)")
            if height == 0 or width == 0:
                raise refuse(f"SOF{marker - 0xC0}: image size {width}x{height} (a height "
                             "of 0 needs DNL, which is not decoded)")
            if nf == 4:
                raise refuse(f"SOF{marker - 0xC0}: 4 components (CMYK/YCCK) are not "
                             "decoded")
            if nf not in (1, 3) or len(seg) != 6 + 3 * nf:
                raise refuse(f"SOF{marker - 0xC0}: {nf} components")
            comps = []
            for c in range(nf):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                    raise refuse(f"SOF{marker - 0xC0}: component {cid} sampling {h}x{v}, "
                                 f"quantisation table {tq}")
                comps.append((cid, h, v, tq))
            frame = (height, width, comps)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise refuse("SOS before the frame header (SOF)")
            if image is not None:
                raise refuse("a second scan (SOS): multi-scan JPEGs are not decoded")
            image, used = _decode_scan(data, pos, seg, frame, quant, have_quant, huff_bits,
                                       huff_vals, huff_present, restart, jfif, adobe, refuse)
            pos += used
        else:
            raise refuse(f"unknown marker 0x{marker:02x}")


def _decode_scan(data, pos, seg, frame, quant, have_quant, huff_bits, huff_vals,
                 huff_present, restart, jfif, adobe, refuse):
    """Check the scan header against the frame and run the C++ decoder on
    the entropy-coded data at ``data[pos:]``: ``(image, bytes consumed)``."""
    height, width, comps = frame
    nf = len(comps)
    if nf == 3 and not jfif:
        # libjpeg's colour-space guess (jdapimin.c): JFIF means YCbCr, then
        # the Adobe transform flag, then the component ids.
        if adobe == 0:
            raise refuse("Adobe APP14 transform=0 (RGB components) is not decoded")
        if adobe is None and [c[0] for c in comps] == [82, 71, 66]:
            raise refuse("component ids 'R', 'G', 'B' (RGB components) are not decoded")
    ns = seg[0] if seg else 0
    if len(seg) != 4 + 2 * ns:
        raise refuse(f"SOS: segment length {len(seg) + 2} for {ns} components")
    if ns != nf:
        raise refuse(f"SOS: a scan of {ns} of the frame's {nf} components "
                     "(multi-scan JPEGs are not decoded)")
    ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
    if (ss, se, ahal) != (0, 63, 0):
        raise refuse(f"SOS: spectral selection {ss}-{se}, approximation {ahal:#04x} "
                     "(a sequential scan has 0-63, 0)")
    ids = [c[0] for c in comps]
    table = np.zeros((nf, 5), np.int32)
    for k in range(ns):
        cid, tables = seg[1 + 2 * k], seg[2 + 2 * k]
        if cid != ids[k]:
            raise refuse(f"SOS: component {cid} where the frame has {ids[k]}")
        _, h, v, tq = comps[k]
        td, ta = tables >> 4, tables & 15
        if td > 3 or ta > 3 or not have_quant[tq]:
            raise refuse(f"SOS: component {cid}: tables DC {td}, AC {ta}, "
                         f"quantisation {tq} (undefined)")
        table[k] = (h, v, tq, td, ta)
    if nf == 3:
        hmax, vmax = table[:, 0].max(), table[:, 1].max()
        for h, v in table[:, :2]:
            if hmax % h or vmax % v or hmax // h > 2 or vmax // v > 2:
                raise refuse(f"SOF: sampling factors {table[:, :2].tolist()} "
                             "(4:4:4, 4:2:2, 4:2:0 and 4:4:0 only)")
    out = np.empty((height, width, 1 if nf == 1 else 3), np.uint8)
    scan = np.frombuffer(data, np.uint8, offset=pos)
    consumed = ctypes.c_int64(0)
    err = ctypes.create_string_buffer(256)
    lib = load_library()
    rc = lib.jpeg_decode_scan(
        scan.ctypes.data, scan.size, width, height, nf, table.ctypes.data,
        quant.ctypes.data, huff_bits.ctypes.data, huff_vals.ctypes.data,
        huff_present.ctypes.data, restart, out.ctypes.data, ctypes.byref(consumed), err,
        len(err))
    if rc != 0:
        raise refuse(err.value.decode())
    return (out[..., 0] if nf == 1 else out), int(consumed.value)
