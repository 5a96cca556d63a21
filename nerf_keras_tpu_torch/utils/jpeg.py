"""A baseline and progressive JPEG decoder, in place of PIL's (the card's
machine has none).

``decode_jpeg`` gives what ``PIL.Image.open(f)`` decodes, bit for bit:
PIL runs libjpeg-turbo with its defaults (the accurate integer IDCT,
fancy chroma upsampling, the fixed-point YCbCr -> RGB tables), and
``native/jpeg.cc`` computes the same.  It reads:

- SOF0 and SOF1 (one sequential scan) and SOF2 (progressive) Huffman
  streams with 8-bit samples;
- one component (gray) or three (YCbCr) at 4:4:4, 4:2:2, 4:2:0 or 4:4:0;
- progressive scans of any legal script: DC first and refinement scans
  (interleaved or not), AC first scans with end-of-band runs, AC
  refinement scans; each component's quantisation table latched at the
  first scan that holds it, as libjpeg latches it, so a later DQT does
  not touch it;
- restart intervals (DRI/RST), any size, several DQT/DHT tables
  (optimised Huffman tables included), and DHT, DQT and DRI segments
  between scans;
- APPn and COM segments are skipped; no EXIF orientation is applied, as
  PIL's ``open`` applies none.

Everything else raises ``ValueError`` naming the file and the marker or
field rather than guess: lossless (SOF3), hierarchical and arithmetic-
coded streams (SOF9 and up, SOF10 among them), DNL, 12-bit samples,
CMYK/YCCK and RGB (Adobe transform 0) streams, more than one scan in a
sequential frame, progressive scans whose Ss/Se/Ah/Al libjpeg rejects or
warns about (an AC scan of several components or before the DC scan, a
refinement that does not continue the previous Al, a DC scan mixing
first and refinement passes), a script that leaves any coefficient unsent
or unrefined to Al = 0 (where libjpeg-turbo smooths blocks, which is not
ported), and truncated or corrupt data.

The scans themselves (entropy decoding into coefficient buffers, then
IDCT, upsampling, colour) are host C++: g++ builds ``native/jpeg.cc`` at
first use into ``nerf_keras_tpu_torch/_build/``, named by a hash of the
source, as ``data/native.py`` builds the ray batcher.  Without g++ the
decoder raises ``RuntimeError`` naming it: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path

import numpy as np

from nerf_keras_tpu_torch.utils import hostbuild

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
    0xC3: "SOF3 (lossless)",
    0xC5: "SOF5 (differential sequential)", 0xC6: "SOF6 (differential progressive)",
    0xC7: "SOF7 (differential lossless)", 0xC9: "SOF9 (arithmetic sequential)",
    0xCA: "SOF10 (arithmetic progressive)", 0xCB: "SOF11 (arithmetic lossless)",
    0xCC: "DAC (arithmetic conditioning)", 0xCD: "SOF13 (arithmetic differential)",
    0xCE: "SOF14 (arithmetic differential progressive)",
    0xCF: "SOF15 (arithmetic differential lossless)", 0xDC: "DNL (number of lines)",
    0xDE: "DHP (hierarchical)", 0xDF: "EXP (hierarchical)",
}


def library_path() -> Path:
    return hostbuild.library_path(_SRC, "libjpeg_scan")


def load_library() -> ctypes.CDLL:
    """Compile (once) and load the scan decoder."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = hostbuild.load_library(_SRC, library_path(), "the JPEG decoder")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.jpeg_scan.restype = i
        lib.jpeg_scan.argtypes = [p, ctypes.c_int64, i, p, p, i, i, i, i, i, i, i, p, p, p, i,
                                  ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, i]
        lib.jpeg_finish.restype = i
        lib.jpeg_finish.argtypes = [i, i, i, p, p, p, p, ctypes.c_char_p, i]
        _lib = lib
        return _lib


def is_jpeg(data: bytes) -> bool:
    return data[:2] == SOI


def _u16(data: bytes, pos: int) -> int:
    return struct.unpack(">H", data[pos:pos + 2])[0]


class _Frame:
    """A frame header and what its scans have decoded so far: each
    component's coefficient blocks over the MCU-padded grid, its latched
    quantisation table, and the successive-approximation state of each of
    its 64 coefficients (-1: unsent, else the last scan's Al), as
    libjpeg's ``coef_bits``."""

    def __init__(self, marker: int, height: int, width: int, comps: list, refuse):
        self.sof = f"SOF{marker - 0xC0}"
        self.progressive = marker == 0xC2
        self.height, self.width, self.comps = height, width, comps
        self.refuse = refuse
        nf = len(comps)
        self.hmax = max(c[1] for c in comps)
        self.vmax = max(c[2] for c in comps)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))
        # Per component: (h, v, buffer stride in blocks, blocks wide, high).
        self.grid = np.zeros((nf, 5), np.int32)
        for k, (_, h, v, _) in enumerate(comps):
            cw = -(-width * h // self.hmax)
            ch = -(-height * v // self.vmax)
            self.grid[k] = h, v, self.mcux * h, -(-cw // 8), -(-ch // 8)
        self.coefs = [np.zeros((self.mcuy * v * self.mcux * h, 64), np.int16)
                      for _, h, v, _ in comps]
        self.quant = np.zeros((nf, 64), np.int32)
        self.latched = [False] * nf
        self.coef_bits = np.full((nf, 64), -1, np.int32)
        self.scans = 0

    def check_colour(self, jfif: bool, adobe) -> None:
        """At the first scan, as libjpeg decides: the colour space and the
        sampling factors this decoder upsamples."""
        refuse, comps = self.refuse, self.comps
        if len(comps) == 3 and not jfif:
            # libjpeg's colour-space guess (jdapimin.c): JFIF means YCbCr,
            # then the Adobe transform flag, then the component ids.
            if adobe == 0:
                raise refuse("Adobe APP14 transform=0 (RGB components) is not decoded")
            if adobe is None and [c[0] for c in comps] == [82, 71, 66]:
                raise refuse("component ids 'R', 'G', 'B' (RGB components) are not decoded")
        if len(comps) == 3:
            for h, v in self.grid[:, :2]:
                if self.hmax % h or self.vmax % v or self.hmax // h > 2 or self.vmax // v > 2:
                    raise refuse(f"SOF: sampling factors {self.grid[:, :2].tolist()} "
                                 "(4:4:4, 4:2:2, 4:2:0 and 4:4:0 only)")

    def scan_header(self, seg: bytes, quant, have_quant, huff_present):
        """Check an SOS header against the frame, the tables and the
        progression so far; latch the quantisation tables; returns the
        scan's component indices, its per-component descriptors for
        ``jpeg_scan`` and ``(Ss, Se, Ah, Al)``."""
        refuse, comps, nf = self.refuse, self.comps, len(self.comps)
        ns = seg[0] if seg else 0
        if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:
            raise refuse(f"SOS: segment length {len(seg) + 2} for {ns} components")
        ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
        ah, al = ahal >> 4, ahal & 15
        ids = [c[0] for c in comps]
        picked = []
        for k in range(ns):
            cid = seg[1 + 2 * k]
            if cid not in ids or (picked and ids.index(cid) <= picked[-1]):
                raise refuse(f"SOS: component {cid} (the frame's are {ids}, each once, "
                             "in order)")
            picked.append(ids.index(cid))
        if not self.progressive:
            if self.scans:
                raise refuse(f"a second scan (SOS) in a sequential ({self.sof}) frame: "
                             "multi-scan sequential JPEGs are not decoded")
            if ns != nf:
                raise refuse(f"SOS: a scan of {ns} of the frame's {nf} components "
                             "(multi-scan sequential JPEGs are not decoded)")
            if (ss, se, ahal) != (0, 63, 0):
                raise refuse(f"SOS: spectral selection {ss}-{se}, approximation {ahal:#04x} "
                             "(a sequential scan has 0-63, 0)")
        else:
            # jdphuff.c's start_pass_phuff_decoder: what libjpeg rejects ...
            why = None
            if ss == 0 and se != 0:
                why = "a DC scan ends at Se=0"
            elif ss > 0 and (ss > se or se > 63):
                why = "an AC band needs Ss <= Se <= 63"
            elif ss > 0 and ns != 1:
                why = "an AC scan holds one component"
            elif ah != 0 and al != ah - 1:
                why = "a refinement scan has Al = Ah - 1"
            elif al > 13:
                why = "Al is at most 13"
            if why:
                raise refuse(f"SOS: progressive scan Ss={ss} Se={se} Ah={ah} Al={al}: {why}")
            # ... and what it only warns about (JWRN_BOGUS_PROGRESSION).
            for c in picked:
                bits = self.coef_bits[c]
                if ss > 0 and bits[0] < 0:
                    raise refuse(f"SOS: an AC scan of component {ids[c]} before its first "
                                 "DC scan")
                for k in range(ss, se + 1):
                    if ah != max(int(bits[k]), 0):
                        state = "unsent" if bits[k] < 0 else f"at Al={bits[k]}"
                        kind = ("a DC scan mixing first and refinement passes"
                                if ss == 0 and ns > 1 else "a scan out of order")
                        raise refuse(f"SOS: {kind}: component {ids[c]}, coefficient {k} is "
                                     f"{state}, the scan has Ah={ah}")
        desc = np.zeros((ns, 7), np.int32)
        for k, c in enumerate(picked):
            cid, _, _, tq = comps[c]
            tables = seg[2 + 2 * k]
            td, ta = tables >> 4, tables & 15
            need_dc = ss == 0 and ah == 0
            need_ac = not self.progressive or ss > 0
            if (td > 3 or ta > 3 or (need_dc and not huff_present[td])
                    or (need_ac and not huff_present[4 + ta])):
                raise refuse(f"SOS: component {cid}: Huffman tables DC {td}, AC {ta} "
                             "(undefined)")
            if not self.latched[c]:
                if not have_quant[tq]:
                    raise refuse(f"SOS: component {cid}: quantisation table {tq} "
                                 "(undefined)")
                self.quant[c] = quant[tq]
                self.latched[c] = True
            desc[k] = (self.grid[c, 2], self.grid[c, 0], self.grid[c, 1], self.grid[c, 3],
                       self.grid[c, 4], td if need_dc else 0, ta if need_ac else 0)
        for c in picked:
            self.coef_bits[c, ss:se + 1] = al
        return picked, desc, (ss, se, ah, al)

    def finish(self) -> np.ndarray:
        """After EOI: every coefficient complete, then the image."""
        if self.progressive:
            left = np.argwhere(self.coef_bits != 0)
            if len(left):
                c, k = (int(v) for v in left[0])
                bits = int(self.coef_bits[c, k])
                state = "never sent" if bits < 0 else f"refined only to Al={bits}"
                raise self.refuse(
                    f"progressive scans leave coefficient {k} of component "
                    f"{self.comps[c][0]} incomplete ({state}; libjpeg-turbo smooths such "
                    "blocks, which is not ported)")
        nf = len(self.comps)
        out = np.empty((self.height, self.width, 1 if nf == 1 else 3), np.uint8)
        ptrs = (ctypes.c_void_p * nf)(*(c.ctypes.data for c in self.coefs))
        err = ctypes.create_string_buffer(256)
        grid = np.ascontiguousarray(self.grid)
        rc = load_library().jpeg_finish(self.width, self.height, nf, grid.ctypes.data,
                                        self.quant.ctypes.data, ptrs, out.ctypes.data, err,
                                        len(err))
        if rc != 0:
            raise self.refuse(err.value.decode())
        return out[..., 0] if nf == 1 else out


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
    frame: _Frame | None = None
    jfif = False
    adobe = None  # the Adobe APP14 transform flag
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
            if frame is None or not frame.scans:
                raise refuse("EOI before any scan (SOS)")
            return frame.finish()
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
            raise refuse(f"{_REFUSED[marker]} is not decoded (Huffman SOF0/SOF1/SOF2 "
                         "JPEGs only)")
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
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0, SOF1, SOF2
            sof = f"SOF{marker - 0xC0}"
            if frame is not None:
                raise refuse("a second frame header (SOF)")
            if len(seg) < 6:
                raise refuse(f"{sof}: segment length {length}")
            precision, height, width, nf = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
            if precision != 8:
                raise refuse(f"{sof}: {precision}-bit samples (8-bit only)")
            if height == 0 or width == 0:
                raise refuse(f"{sof}: image size {width}x{height} (a height of 0 needs "
                             "DNL, which is not decoded)")
            if nf == 4:
                raise refuse(f"{sof}: 4 components (CMYK/YCCK) are not decoded")
            if nf not in (1, 3) or len(seg) != 6 + 3 * nf:
                raise refuse(f"{sof}: {nf} components")
            comps = []
            for c in range(nf):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                    raise refuse(f"{sof}: component {cid} sampling {h}x{v}, "
                                 f"quantisation table {tq}")
                comps.append((cid, h, v, tq))
            frame = _Frame(marker, height, width, comps, refuse)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise refuse("SOS before the frame header (SOF)")
            if not frame.scans:
                frame.check_colour(jfif, adobe)
            pos += _decode_scan(frame, data, pos, seg, quant, have_quant, huff_bits,
                                huff_vals, huff_present, restart)
        else:
            raise refuse(f"unknown marker 0x{marker:02x}")


def _decode_scan(frame: _Frame, data, pos, seg, quant, have_quant, huff_bits, huff_vals,
                 huff_present, restart) -> int:
    """Run the C++ decoder over one scan's entropy-coded data at
    ``data[pos:]`` into ``frame``'s coefficients: the bytes consumed."""
    picked, desc, (ss, se, ah, al) = frame.scan_header(seg, quant, have_quant, huff_present)
    ptrs = (ctypes.c_void_p * len(picked))(*(frame.coefs[c].ctypes.data for c in picked))
    scan = np.frombuffer(data, np.uint8, offset=pos)
    consumed = ctypes.c_int64(0)
    err = ctypes.create_string_buffer(256)
    rc = load_library().jpeg_scan(
        scan.ctypes.data, scan.size, len(picked), desc.ctypes.data, ptrs, frame.mcux,
        frame.mcuy, int(frame.progressive), ss, se, ah, al, huff_bits.ctypes.data,
        huff_vals.ctypes.data, huff_present.ctypes.data, restart, ctypes.byref(consumed),
        err, len(err))
    if rc != 0:
        raise frame.refuse(err.value.decode())
    frame.scans += 1
    return int(consumed.value)
