"""The JPEG fixtures of ``tests/fixtures/torch_jpeg/`` and their goldens.

    python tests/torch_jpeg_fixtures.py    # rewrite the files and goldens.json

A helper, not a test module.  PIL 12.1.0 writes most files:

- ``capture/``: an LLFF capture shipped as full-size JPEGs only, the
  port's spheres scene (``data/synthetic.forward_facing_views``) from 8
  cameras at 504x672 (hwf at that size in ``poses_bounds.npy``),
  ``quality=90`` with PIL's default 4:2:0.  ``images_8/`` is 63x84.
- ``capture_progressive/``: the same capture, each view a progressive
  JPEG (``progressive=True``: libjpeg's 10-scan script).
- ``cases/``: small odd-sized decoder cases (4:4:4, 4:2:2, 4:2:0, gray,
  optimised tables, restart markers, qualities 50 and 95, EXIF and a
  comment), and ``prog_*`` the same kinds written progressive.  PIL
  cannot write 4:4:0, so OpenCV (``cv2``) writes ``s440_q90.jpg`` and the
  ``prog_cv2_*`` files (libjpeg's progressive script through OpenCV);
  ``prog_custom_*`` are scripts libjpeg never writes, from
  ``custom_script`` below.  PIL still decodes every file for the golden.

``goldens.json`` holds the SHA-256 (and shape) of PIL's uint8
``Image.open(f).convert("RGB")`` of every file, and of PIL's LANCZOS
minify by 8 of every view of each capture (``minify``,
``minify_progressive``): what ``chip_smoke.py`` holds the port's decoder
and ``minify`` to on the card's machine (no PIL there), and what
``tests/test_torch_jpeg.py`` holds to PIL here.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_jpeg"
GOLDENS = FIXTURES / "goldens.json"
CAPTURE_VIEWS, CAPTURE_HEIGHT, CAPTURE_WIDTH = 8, 504, 672
# The focal of a factor-8 Fern view scaled to 504x672 (407.5 at 378x504).
CAPTURE_FOCAL = 407.5 * 672 / 504
FACTOR = 8

# name: (height, width, gray, PIL save options); "s440_q90" is cv2's.
CASES = {
    "s444_q90": (37, 53, False, dict(quality=90, subsampling=0)),
    "s422_q90": (53, 37, False, dict(quality=90, subsampling=1)),
    "s420_q90": (45, 61, False, dict(quality=90, subsampling=2)),
    "s440_q90": (41, 59, False, None),
    "gray_q90": (39, 57, True, dict(quality=90)),
    "s420_optimize": (43, 67, False, dict(quality=90, optimize=True)),
    "s420_restart": (47, 55, False, dict(quality=90, restart_marker_blocks=3)),
    "s422_restart_rows": (37, 71, False, dict(quality=85, subsampling=1,
                                              restart_marker_rows=1)),
    "s420_q50": (49, 53, False, dict(quality=50)),
    "s444_q95": (37, 63, False, dict(quality=95, subsampling=0)),
}

# name: (height, width, gray, how): PIL save options, or ("cv2", sampling)
# for OpenCV's progressive writer, or ("custom", sampling) for
# ``custom_script``.
PROGRESSIVE_CASES = {
    "prog_s444_q90": (37, 53, False, dict(quality=90, subsampling=0)),
    "prog_s422_q90": (53, 37, False, dict(quality=90, subsampling=1)),
    "prog_s420_q90": (45, 61, False, dict(quality=90, subsampling=2)),
    "prog_gray_q90": (39, 57, True, dict(quality=90)),
    "prog_s420_optimize": (43, 67, False, dict(quality=90, optimize=True)),
    "prog_s420_restart": (47, 55, False, dict(quality=90, restart_marker_blocks=3)),
    "prog_s422_restart_rows": (37, 71, False, dict(quality=85, subsampling=1,
                                                   restart_marker_rows=1)),
    "prog_s420_q50": (49, 53, False, dict(quality=50)),
    "prog_s444_q95": (37, 63, False, dict(quality=95, subsampling=0)),
    "prog_cv2_s420": (41, 59, False, ("cv2", "420")),
    "prog_cv2_s440_restart": (41, 59, False, ("cv2", "440")),
    "prog_custom_s420": (37, 53, False, ("custom", (2, 2))),
    "prog_custom_s422": (29, 45, False, ("custom", (2, 1))),
    "prog_custom_gray": (33, 41, True, ("custom", (1, 1))),
}


def case_image(height: int, width: int, seed: int) -> np.ndarray:
    """A seeded ``(H, W, 3)`` uint8 image with edges, gradients and noise
    (JPEG's hard cases: clipping after the IDCT, chroma at the borders)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    base = np.stack([0.5 + 0.5 * np.sin(x / 3.1 + y / 7.3),
                     (x * y / (height * width)) % 1.0,
                     ((x // 6 + y // 5) % 2).astype(np.float64)], axis=-1)
    img = 0.75 * base + 0.25 * rng.uniform(0.0, 1.0, (height, width, 3))
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def digest(img: np.ndarray) -> dict:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    return {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def pil_rgb(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def pil_minify(path, factor: int = FACTOR) -> np.ndarray:
    """What the JAX package's ``minify`` writes for one frame."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        w, h = img.size
        return np.asarray(img.resize((w // factor, h // factor), Image.LANCZOS))


def capture_files(capture: str = "capture") -> list[Path]:
    return sorted((FIXTURES / capture / "images").glob("*.jpg"))


def case_files() -> list[Path]:
    return sorted((FIXTURES / "cases").glob("*.jpg"))


def pil_goldens() -> dict:
    """The goldens as PIL computes them from the committed files."""
    import PIL

    rel = lambda p: p.relative_to(FIXTURES).as_posix()  # noqa: E731
    progressive = capture_files("capture_progressive")
    return {
        "pil": PIL.__version__,
        "decode": {rel(p): digest(pil_rgb(p))
                   for p in case_files() + capture_files() + progressive},
        "minify": {rel(p): digest(pil_minify(p)) for p in capture_files()},
        "minify_progressive": {rel(p): digest(pil_minify(p)) for p in progressive},
    }


def write_case(name: str, path: Path) -> None:
    from PIL import Image

    h, w, gray, opts = CASES[name]
    img = case_image(h, w, seed=sorted(CASES).index(name))
    if opts is None:
        import cv2

        ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, 90,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
        assert ok
        path.write_bytes(enc.tobytes())
        return
    pil = Image.fromarray(img[..., 0] if gray else img)
    pil.save(path, "JPEG", **opts)


def write_progressive_case(name: str, path: Path) -> None:
    from PIL import Image

    h, w, gray, how = PROGRESSIVE_CASES[name]
    img = case_image(h, w, seed=50 + sorted(PROGRESSIVE_CASES).index(name))
    if isinstance(how, dict):
        Image.fromarray(img[..., 0] if gray else img).save(path, "JPEG", progressive=True,
                                                           **how)
    elif how[0] == "custom":
        path.write_bytes(custom_script(img[..., 0] if gray else img, how[1]))
    else:
        import cv2

        sampling = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}[how[1]]
        ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling,
            cv2.IMWRITE_JPEG_RST_INTERVAL, 4 if "restart" in name else 0])
        assert ok
        path.write_bytes(enc.tobytes())


def write_exif_case(path: Path) -> None:
    """4:2:0 with an EXIF block (orientation 6) and a COM segment: both
    skipped, no rotation applied."""
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(case_image(41, 65, seed=99)).save(
        path, "JPEG", quality=90, exif=exif.tobytes(), comment=b"a COM segment")


# --- a progressive encoder for scan scripts PIL and OpenCV do not write --------
#
# libjpeg's encoders write one script (jpeg_simple_progression: interleaved
# DC scans, AC bands with Al 2 and 1 refined to 0).  ``progressive_jpeg``
# writes others from seeded DCT coefficients: non-interleaved DC scans, a
# DC refinement of one component, AC first scans at Al = 0 with one EOB per
# block, DHT/DQT/DRI segments between scans, and (for the refusal tests)
# scripts libjpeg rejects or warns about.  PIL decodes every file for the
# reference.

# Zigzag index -> natural position (ITU T.81 Figure A.6).
ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
          41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15,
          23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
# Flat Huffman tables: DC categories 0-11 at 4 bits, every AC run/size, EOB
# and ZRL at 8 (neither has an all-ones code).
DC_VALS = list(range(12))
AC_VALS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _dht(cls: int, ident: int, length: int, vals: list[int]) -> bytes:
    counts = [0] * 16
    counts[length - 1] = len(vals)
    return _segment(0xC4, bytes([cls << 4 | ident] + counts + vals))


def _dqt(ident: int, table: np.ndarray) -> bytes:
    return _segment(0xDB, bytes([ident]) + bytes(int(table[z]) for z in ZIGZAG))


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v: int) -> tuple[int, int]:
    size = abs(v).bit_length()
    return size, (v if v >= 0 else v + (1 << size) - 1)


def quantised_blocks(plane: np.ndarray, table: np.ndarray, rows: int, cols: int,
                     real: tuple[int, int]) -> np.ndarray:
    """``(rows, cols, 64)`` natural-order quantised DCT-II coefficients of
    ``plane`` (edge-replicated to whole blocks) over its ``real`` (rows,
    cols) blocks; the MCU padding past them stays 0."""
    n = np.arange(8)
    basis = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16) * 0.5
    basis[0] /= np.sqrt(2.0)
    h, w = real[0] * 8, real[1] * 8
    pad = np.pad(plane.astype(np.float64) - 128.0,
                 ((0, h - plane.shape[0]), (0, w - plane.shape[1])), mode="edge")
    blocks = pad.reshape(real[0], 8, real[1], 8).transpose(0, 2, 1, 3)
    dct = np.einsum("ui,abij,vj->abuv", basis, blocks, basis).reshape(real[0], real[1], 64)
    out = np.zeros((rows, cols, 64), np.int64)
    out[:real[0], :real[1]] = np.round(dct / table)
    return out


class ProgressiveWriter:
    """A JFIF frame (``sof`` 0xC2, or 0xC1 for a multi-scan sequential
    refusal) of 1 or 3 components over seeded coefficients, and its scans
    appended one by one with ``dc``, ``dc_refine``, ``ac`` and
    ``sequential``; ``segment`` puts any marker segment between scans."""

    def __init__(self, img: np.ndarray, sampling: tuple[int, int], tables: list,
                 sof: int = 0xC2):
        gray = img.ndim == 2
        height, width = img.shape[:2]
        hmax, vmax = sampling
        ycc = [img] if gray else _ycbcr(img)
        self.comps = []
        for k, plane in enumerate(ycc):
            h, v = (hmax, vmax) if k == 0 else (1, 1)
            if k:
                plane = plane[::vmax, ::hmax] if (hmax, vmax) != (1, 1) else plane
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            cw, ch = -(-width * h // hmax), -(-height * v // vmax)
            real = (-(-ch // 8), -(-cw // 8))
            plane = plane[:ch, :cw]
            coefs = quantised_blocks(plane, tables[k], mcuy * v, mcux * h, real)
            self.comps.append(dict(id=k + 1, h=h, v=v, coefs=coefs, real=real))
        self.mcux, self.mcuy = mcux, mcuy
        self.restart = 0
        head = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
        frame = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
        frame += bytes([len(self.comps)])
        for c in self.comps:
            frame += bytes([c["id"], c["h"] << 4 | c["v"], 0])
        self.data = bytearray(b"\xff\xd8" + head + _dqt(0, tables[0]) + _segment(sof, frame)
                              + _dht(0, 0, 4, DC_VALS) + _dht(1, 0, 8, AC_VALS))

    def segment(self, raw: bytes) -> None:
        self.data += raw
        if raw[1] == 0xDD:
            self.restart = int.from_bytes(raw[4:6], "big")

    def _scan(self, comps: list[int], ss: int, se: int, ah: int, al: int, encode) -> None:
        header = bytes([len(comps)])
        for k in comps:
            header += bytes([self.comps[k]["id"], 0x00])
        self.data += _segment(0xDA, header + bytes([ss, se, ah << 4 | al]))
        bits = _BitWriter()
        pred = {k: 0 for k in comps}
        if len(comps) > 1:
            order = [(my, mx) for my in range(self.mcuy) for mx in range(self.mcux)]
        else:
            rows, cols = self.comps[comps[0]]["real"]
            order = [(r, c) for r in range(rows) for c in range(cols)]
        for m, (my, mx) in enumerate(order):
            if self.restart and m and m % self.restart == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + (m // self.restart - 1) % 8])
                pred = {k: 0 for k in comps}
            for k in comps:
                c = self.comps[k]
                h, v = (c["h"], c["v"]) if len(comps) > 1 else (1, 1)
                for by in range(v):
                    for bx in range(h):
                        pred[k] = encode(bits, c["coefs"][my * v + by, mx * h + bx], pred[k])
        bits.flush()
        self.data += bits.out

    def dc(self, comps: list[int], al: int = 0) -> None:
        def encode(bits, blk, pred):
            dc = int(blk[0]) >> al
            size, mag = _magnitude(dc - pred)
            bits.put(DC_VALS.index(size), 4)
            bits.put(mag, size)
            return dc
        self._scan(comps, 0, 0, 0, al, encode)

    def dc_refine(self, comps: list[int], ah: int, al: int | None = None) -> None:
        al = ah - 1 if al is None else al
        self._scan(comps, 0, 0, ah, al,
                   lambda bits, blk, pred: bits.put((int(blk[0]) >> al) & 1, 1) or pred)

    def _ac(self, bits, blk, ss: int, se: int) -> None:
        run = 0
        for k in range(ss, se + 1):
            v = int(blk[ZIGZAG[k]])
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.put(AC_VALS.index(0xF0), 8)
                run -= 16
            size, mag = _magnitude(v)
            bits.put(AC_VALS.index(run << 4 | size), 8)
            bits.put(mag, size)
            run = 0
        if run:
            bits.put(AC_VALS.index(0x00), 8)  # EOB: a run of one block

    def ac(self, comp: list[int], ss: int, se: int) -> None:
        """An AC first scan at Al = 0 (one component, or several for the
        refusal a libjpeg decoder raises)."""
        self._scan(comp, ss, se, 0, 0, lambda bits, blk, pred: self._ac(bits, blk, ss, se)
                   or pred)

    def sequential(self, comps: list[int]) -> None:
        def encode(bits, blk, pred):
            dc = int(blk[0])
            size, mag = _magnitude(dc - pred)
            bits.put(DC_VALS.index(size), 4)
            bits.put(mag, size)
            self._ac(bits, blk, 1, 63)
            return dc
        self._scan(comps, 0, 63, 0, 0, encode)

    def finish(self) -> bytes:
        return bytes(self.data + b"\xff\xd9")


def _ycbcr(img: np.ndarray) -> list[np.ndarray]:
    rgb = img.astype(np.float64)
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    cb = 128 - 0.168736 * rgb[..., 0] - 0.331264 * rgb[..., 1] + 0.5 * rgb[..., 2]
    cr = 128 + 0.5 * rgb[..., 0] - 0.418688 * rgb[..., 1] - 0.081312 * rgb[..., 2]
    return [np.clip(np.round(p), 0, 255) for p in (y, cb, cr)]


def quant_table(scale: int) -> np.ndarray:
    """A natural-order table growing with frequency, 1..255."""
    u, v = np.mgrid[0:8, 0:8]
    return np.clip(scale * (1 + u + v) // 4 + 1, 1, 255).reshape(64)


def custom_script(img: np.ndarray, sampling=(2, 2)) -> bytes:
    """A script libjpeg never writes, for a 3-component image: Y's DC alone
    at Al = 1, a DQT that redefines table 0 (Y latched it; Cb and Cr latch
    the new one at their first scan), Cb and Cr's DC interleaved, restart
    intervals set and cleared between scans, Y's AC in two bands, Y's DC
    refined alone, each chroma AC band alone.  A gray image: DC at Al = 1,
    one AC band, DC refined."""
    luma, chroma = quant_table(6), quant_table(11)
    if img.ndim == 2:
        w = ProgressiveWriter(img, (1, 1), [luma])
        w.dc([0], al=1)
        w.segment(_segment(0xDD, (3).to_bytes(2, "big")))
        w.ac([0], 1, 63)
        w.dc_refine([0], 1)
        return w.finish()
    w = ProgressiveWriter(img, sampling, [luma, chroma, chroma])
    w.dc([0], al=1)
    w.segment(_dqt(0, chroma))
    w.dc([1, 2])
    w.segment(_segment(0xDD, (2).to_bytes(2, "big")))
    w.ac([0], 1, 5)
    w.segment(_segment(0xDD, (0).to_bytes(2, "big")))
    w.ac([0], 6, 63)
    w.dc_refine([0], 1)
    w.segment(_dht(1, 0, 8, AC_VALS))
    w.segment(_segment(0xDD, (5).to_bytes(2, "big")))
    w.ac([1], 1, 63)
    w.ac([2], 1, 63)
    return w.finish()



def write_fixtures() -> None:
    from PIL import Image

    from nerf_keras_tpu_torch.data.synthetic import forward_facing_views

    (FIXTURES / "cases").mkdir(parents=True, exist_ok=True)
    img_dir = FIXTURES / "capture" / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    for name in CASES:
        write_case(name, FIXTURES / "cases" / f"{name}.jpg")
    write_exif_case(FIXTURES / "cases" / "s420_exif_comment.jpg")
    for name in PROGRESSIVE_CASES:
        write_progressive_case(name, FIXTURES / "cases" / f"{name}.jpg")
    frames, poses_bounds = forward_facing_views(CAPTURE_VIEWS, CAPTURE_HEIGHT,
                                                CAPTURE_WIDTH, CAPTURE_FOCAL)
    buf = io.BytesIO()
    np.save(buf, poses_bounds)
    prog_dir = FIXTURES / "capture_progressive" / "images"
    prog_dir.mkdir(parents=True, exist_ok=True)
    for i, rgb in enumerate(frames):
        Image.fromarray(rgb).save(img_dir / f"img_{i:02d}.jpg", "JPEG", quality=90)
        Image.fromarray(rgb).save(prog_dir / f"img_{i:02d}.jpg", "JPEG", quality=90,
                                  progressive=True)
    for capture in ("capture", "capture_progressive"):
        (FIXTURES / capture / "poses_bounds.npy").write_bytes(buf.getvalue())
    GOLDENS.write_text(json.dumps(pil_goldens(), indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.fspath(Path(__file__).resolve().parents[1]))
    write_fixtures()
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    print(f"wrote {FIXTURES} ({total} bytes)")
