"""An animated GIF writer and reader (struct + numpy + host C++), in place
of PIL's GIF plugin.

``encode_gif`` writes what the JAX package's ``Image.save(path,
save_all=True, append_images=..., duration=..., loop=0)`` writes, in what a
reader sees: the same frames after merging repeats, each frame's delay in
centiseconds (``int(ms / 10)``, so 33 ms reads back as 30), the
NETSCAPE2.0 loop count 0 (forever), the size.  Each frame gets its own
palette: a frame of at most 256 colours (every gray frame) keeps them
exactly; a frame of more gets 256 by median cut, with no dithering, and
each pixel takes the nearest entry (``palette_mapping`` gives that image).  A frame
equal to the one before it, after that mapping, adds its delay to it
instead of becoming a frame; a later frame covers only the rectangle in
which it differs from the one before.  Entries are sorted by colour,
descending, so no table is the gray ramp that PIL reads as mode ``L``.
The same frames give the same bytes.

``decode_gif`` reads a GIF as PIL 12.1.0 composites it and converts each
frame to RGB: the screen filled with index 0 (or frame 0's transparency
index) under frame 0, a later frame's pixels pasted over the frame before
except where they hold its transparency index, disposal 2 filling the
frame's rectangle as PIL does (a disposal method carries over to later
frames that leave it unspecified), indices past a colour table reading as
black.  Where frame 0's table is the gray ramp, PIL keeps the frame as a
gray image and writes the raw indices of later frames into it, whatever
their tables, up to the first frame whose table is not the ramp, and
composites in RGB from the frame after it; ``decode_gif`` does the same.
It raises
``ValueError``, naming the file and the block, on what it does not read:
disposal 3 and above, a frame without a colour table, a frame outside the
screen, an LZW code past the table, image data cut short or ended early,
a byte that starts no block, a file that ends before its trailer.

The palettes and LZW are host C++: g++ builds ``native/gif.cc`` at first
use into ``nerf_keras_tpu_torch/_build/``, named by a hash of the source,
and without g++ both directions raise ``RuntimeError`` naming it.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path

import numpy as np

from nerf_keras_tpu_torch.utils import hostbuild, io

_SRC = Path(__file__).resolve().parent / "native" / "gif.cc"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# PIL's gray image as RGB, and a colour table that PIL reads as one.
_RAMP = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)


def library_path() -> Path:
    return hostbuild.library_path(_SRC, "libgif")


def load_library() -> ctypes.CDLL:
    """Compile (once) and load the palette and LZW code."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = hostbuild.load_library(_SRC, library_path(), "the GIF writer and reader")
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.gif_quantize.restype = ctypes.c_int
        lib.gif_quantize.argtypes = [p, i64, ctypes.c_int, p, p]
        lib.gif_lzw_encode.restype = i64
        lib.gif_lzw_encode.argtypes = [p, i64, ctypes.c_int, p, i64]
        lib.gif_lzw_decode.restype = ctypes.c_int
        lib.gif_lzw_decode.argtypes = [p, i64, i64] + [ctypes.c_int] * 4 + [
            p, ctypes.POINTER(i64), ctypes.c_char_p, ctypes.c_int]
        _lib = lib
        return _lib


def _check_frame(frame: np.ndarray) -> np.ndarray:
    frame = np.ascontiguousarray(frame)
    if frame.dtype != np.uint8:
        raise TypeError(f"GIF frames are uint8, got {frame.dtype}")
    if not (frame.ndim == 2 or (frame.ndim == 3 and frame.shape[2] == 3)) or frame.size == 0:
        raise ValueError(f"a GIF frame is (H, W) or (H, W, 3), got {frame.shape}")
    if max(frame.shape[:2]) > 0xFFFF:
        raise ValueError(f"frame of {frame.shape[1]}x{frame.shape[0]} (65535 at most)")
    return frame


def quantize(frame: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A frame's palette, ``(n, 3)`` uint8 with ``n <= 256``, and each
    pixel's entry, ``(H, W)`` uint8 (see the module docstring)."""
    frame = _check_frame(frame)
    palette = np.zeros((256, 3), np.uint8)
    index = np.empty(frame.shape[:2], np.uint8)
    n = load_library().gif_quantize(frame.ctypes.data, index.size,
                                    1 if frame.ndim == 2 else 3, palette.ctypes.data,
                                    index.ctypes.data)
    return palette[:n], index


def palette_mapping(frame: np.ndarray) -> np.ndarray:
    """``(H, W, 3)`` uint8: the frame as ``encode_gif`` stores it."""
    palette, index = quantize(frame)
    return palette[index]


def lzw_blocks(index: np.ndarray, min_code_size: int) -> bytes:
    """The image data of a GIF frame: ``index`` (values below
    ``2 ** min_code_size``) in LZW sub-blocks, with the terminator."""
    index = np.ascontiguousarray(index, np.uint8)
    cap = 2 * index.size + 1024
    out = np.empty(cap, np.uint8)
    n = load_library().gif_lzw_encode(index.ctypes.data, index.size, min_code_size,
                                      out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError(f"LZW of {index.size} indices overflowed {cap} bytes")
    return out[:n].tobytes()


def _table_bits(n: int) -> int:
    return max(1, (n - 1).bit_length())


def _table(palette: np.ndarray, bits: int) -> bytes:
    return palette.tobytes() + bytes(3 * ((1 << bits) - len(palette)))


def _kept(frames, duration_ms: int) -> list[list]:
    """The frames ``encode_gif`` writes: ``[palette, index, shown, (y0, y1,
    x0, x1), ms]`` each, ``shown`` the mapped image, the box where it
    differs from the frame before, a repeat's delay added to that frame."""
    frames = [_check_frame(f) for f in frames]
    if not frames:
        raise ValueError("encode_gif: no frames")
    if any(f.shape != frames[0].shape for f in frames):
        raise ValueError(f"encode_gif: frames of shapes {sorted({f.shape for f in frames})}")
    h, w = frames[0].shape[:2]
    kept: list[list] = []
    for frame in frames:
        palette, index = quantize(frame)
        shown = palette[index]
        box = (0, h, 0, w)
        if kept:
            changed = np.any(shown != kept[-1][2], axis=-1)
            rows, cols = np.flatnonzero(changed.any(axis=1)), np.flatnonzero(changed.any(axis=0))
            if rows.size == 0:
                kept[-1][4] += duration_ms
                continue
            box = (rows[0], rows[-1] + 1, cols[0], cols[-1] + 1)
        kept.append([palette, index, shown, box, duration_ms])
    return kept


def shown_frames(frames) -> list[np.ndarray]:
    """``(H, W, 3)`` uint8 each: what ``decode_gif`` reads back from
    ``encode_gif(frames, ...)``, each frame's ``palette_mapping`` with
    repeats merged."""
    return [k[2] for k in _kept(frames, 0)]


def encode_gif(frames, duration_ms: int) -> bytes:
    """uint8 frames, all ``(H, W, 3)`` or all ``(H, W)``, -> GIF bytes,
    each frame shown ``duration_ms``, looping forever (see the module
    docstring)."""
    kept = _kept(frames, duration_ms)
    h, w = kept[0][2].shape[:2]
    bits0 = _table_bits(len(kept[0][0]))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x80 | (bits0 - 1), 0, 0),
           _table(kept[0][0], bits0), b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for i, (palette, index, _, (y0, y1, x0, x1), ms) in enumerate(kept):
        delay = int(ms / 10)
        if delay:
            out.append(b"!\xf9\x04\x00" + struct.pack("<HBB", delay, 0, 0))
        bits = _table_bits(len(palette))
        flags = 0 if i == 0 else 0x80 | (bits - 1)
        out.append(b"," + struct.pack("<HHHHB", x0, y0, x1 - x0, y1 - y0, flags))
        if i:
            out.append(_table(palette, bits))
        mcs = max(2, bits)
        out.append(bytes([mcs]) + lzw_blocks(index[y0:y1, x0:x1], mcs))
    out.append(b";")
    return b"".join(out)


def _palette_needed(table: bytes) -> bool:
    """PIL's ``_is_palette_needed``: False for the gray ramp 0, 1, 2, ..."""
    t = np.frombuffer(table, np.uint8).reshape(-1, 3)
    return not np.array_equal(t, _RAMP[:len(t)])


def _lookup(table: bytes) -> np.ndarray:
    """A colour table as PIL's 256-entry palette: black past it."""
    out = np.zeros((256, 3), np.uint8)
    t = np.frombuffer(table, np.uint8).reshape(-1, 3)
    out[:len(t)] = t
    return out


def decode_gif(data: bytes, name: str = "<gif>") -> tuple[list[np.ndarray], list[int],
                                                            int | None]:
    """GIF bytes -> (frames, durations in ms, loop): each frame an ``(H, W,
    3)`` uint8 image of the screen as PIL composites it (see the module
    docstring); a frame without a control extension has duration 0; loop
    is None without a NETSCAPE2.0 block."""
    data = bytes(data)
    n = len(data)

    def fail(where: str, what: str):
        raise ValueError(f"{name}: {where}: {what}")

    if n < 13 or data[:6] not in (b"GIF87a", b"GIF89a"):
        fail("header", "not a GIF file")
    sw, sh, sflags, background = struct.unpack("<HHBB", data[6:12])
    pos = 13
    global_table = None
    if sflags & 0x80:
        size = 3 << ((sflags & 7) + 1)
        if pos + size > n:
            fail("global colour table", "the file ends inside it (truncated)")
        global_table = data[pos:pos + size]
        pos += size
    else:
        background = 0  # PIL reads the background index only with a global table
    lib = load_library()
    frames: list[np.ndarray] = []
    durations: list[int] = []
    loop = None
    mode = None  # PIL's mode: "P" or "L" (an index canvas), then "RGB"
    canvas = None  # (H, W) indices in "P" and "L", (H, W, 3) in "RGB"
    core = None  # the 256-entry palette that turns the index canvas into RGB
    info_t = None  # PIL's info["transparency"]: frame 0's index until "P" -> "RGB"
    method = 0  # PIL's disposal_method: the last nonzero one
    dispose = None  # (rectangle, fill), applied before the next frame
    t = delay = None  # this frame's transparency index and duration
    while True:
        block_at = pos
        if pos >= n:
            fail(f"byte {pos}", "the file ends before its trailer (truncated)")
        intro = data[pos]
        pos += 1
        if intro == 0x3B:
            break
        if intro == 0x21:
            if pos >= n:
                fail(f"extension at byte {block_at}", "the file ends inside it (truncated)")
            label = data[pos]
            pos += 1
            blocks = []
            while True:
                if pos >= n or pos + 1 + data[pos] > n:
                    fail(f"extension 0x{label:02x} at byte {block_at}",
                         "a sub-block runs past the end of the file (truncated)")
                size = data[pos]
                if size == 0:
                    pos += 1
                    break
                blocks.append(data[pos + 1:pos + 1 + size])
                pos += 1 + size
            if label == 0xF9 and blocks:
                gce = blocks[0]
                if len(gce) < 4:
                    fail(f"graphic control extension at byte {block_at}",
                         f"{len(gce)} bytes (4 expected)")
                if gce[0] & 1:  # a later extension without the flag keeps it
                    t = gce[3]
                delay = struct.unpack("<H", gce[1:3])[0] * 10
                disposal = (gce[0] >> 2) & 7
                if disposal >= 3:
                    fail(f"graphic control extension of frame {len(frames)} at byte "
                         f"{block_at}", f"disposal method {disposal} (0, 1 and 2 are read)")
                if disposal:
                    method = disposal
            elif (label == 0xFF and not frames and blocks
                  and blocks[0].startswith(b"NETSCAPE2.0")
                  and len(blocks) > 1 and len(blocks[1]) >= 3 and blocks[1][0] == 1):
                loop = struct.unpack("<H", blocks[1][1:3])[0]
            continue
        if intro != 0x2C:
            fail(f"byte {block_at}", f"0x{intro:02x} starts no block (0x21, 0x2C or 0x3B)")
        k = len(frames)
        where = f"frame {k} at byte {block_at}"
        if pos + 10 > n:
            fail(where, "the file ends inside the image descriptor (truncated)")
        x0, y0, fw, fh, flags = struct.unpack("<HHHHB", data[pos:pos + 9])
        pos += 9
        x1, y1 = x0 + fw, y0 + fh
        if fw == 0 or fh == 0 or x1 > sw or y1 > sh:
            fail(where, f"the rectangle ({x0}, {y0}, {x1}, {y1}) is empty or outside the "
                        f"{sw}x{sh} screen")
        local_table = None
        if flags & 0x80:
            size = 3 << ((flags & 7) + 1)
            if pos + size > n:
                fail(where, "the file ends inside the local colour table (truncated)")
            local_table = data[pos:pos + size]
            pos += size
        if local_table is None and global_table is None:
            fail(where, "no colour table (neither local nor global)")
        mcs = data[pos] if pos < n else 0
        if not 2 <= mcs <= 8:
            fail(where, f"LZW minimum code size {mcs} (2 to 8)")
        index = np.empty((fh, fw), np.uint8)
        end = ctypes.c_int64(0)
        err = ctypes.create_string_buffer(160)
        if lib.gif_lzw_decode(data, n, pos + 1, mcs, fw, fh, int(bool(flags & 0x40)),
                              index.ctypes.data, ctypes.byref(end), err, len(err)):
            fail(f"{where}, image data", err.value.decode())
        pos = end.value
        durations.append(delay or 0)
        table = local_table if local_table is not None else global_table
        needed = _palette_needed(table)
        rect = (slice(y0, y1), slice(x0, x1))
        # PIL's _seek: the previous frame's disposal, the mode, this frame's disposal.
        if dispose is not None:
            canvas[dispose[0]] = dispose[1]
        if k == 0:
            mode = "P" if needed else "L"
            if local_table is not None and not needed and global_table is not None \
                    and _palette_needed(global_table):
                fail(where, "a gray-ramp local table over another global one "
                            "(PIL mixes the two)")
            if mode == "L" and t is not None:
                fail(where, "a transparency index on a gray-ramp frame 0")
            core = _lookup(table) if needed else _RAMP
        elif mode == "P":
            canvas = core[canvas]
            mode, info_t = "RGB", None
        dispose = None
        if method == 2:
            colour = info_t if info_t is not None else t
            if colour is None:
                colour = background
            if mode == "RGB":
                # PIL's _rgb: this frame's entry, entry 0 past the table's
                # end, the gray level without a table of its own colours.
                if needed:
                    colour = colour if 3 * colour + 3 <= len(table) else 0
                    colour = np.frombuffer(table, np.uint8)[3 * colour:3 * colour + 3]
                else:
                    colour = np.full(3, colour, np.uint8)
            dispose = (rect, colour)
        if k == 0:
            info_t = t
            canvas = np.full((sh, sw), 0 if t is None else t, np.uint8)
            canvas[rect] = index
            frames.append(core[canvas])
        elif mode == "L":
            # Raw indices into the gray image, whatever this frame's table.
            canvas[rect] = index if t is None else np.where(index == t, canvas[rect], index)
            if needed:
                mode = "P"  # PIL's label; the next frame converts the gray image
            frames.append(_RAMP[canvas])
        else:
            rgb = (_lookup(table) if needed else _RAMP)[index]
            keep = np.zeros_like(index, bool) if t is None else index == t
            canvas[rect] = np.where(keep[..., None], canvas[rect], rgb)
            frames.append(canvas.copy())
        t = delay = None
    if not frames:
        fail("trailer", "no image before the trailer")
    return frames, durations, loop


def read_gif(path: str) -> tuple[list[np.ndarray], list[int], int | None]:
    """``decode_gif`` of a file."""
    with io.open_file(path, "rb") as f:
        return decode_gif(f.read(), name=str(path))
