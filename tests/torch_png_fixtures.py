"""PNG writers for the port's PNG tests, and the fixtures of
``tests/fixtures/torch_png/`` with their goldens.

    python tests/torch_png_fixtures.py    # rewrite the files and goldens.json

A helper, not a test module.  ``write_png`` writes any IHDR the PNG
specification allows (every colour type and bit depth, Adam7 too) with
numpy and zlib, each row filtered as asked, where PIL cannot write the
file (PIL writes neither Adam7 nor 16-bit colour).  It is never its own
reference: PIL 12.1.0 decodes every file for the goldens.

``fixtures/torch_png/scene/`` is a Blender scene of the port's spheres
of ``data/synthetic`` at 40x40, each frame in another
layout: 16-bit RGBA, 16-bit RGBA Adam7, palette + ``tRNS`` (8 and 4 bit,
one Adam7), 16-bit gray+alpha and 8-bit RGBA Adam7.  ``goldens.json``
holds the SHA-256 (and shape) of PIL's ``convert("RGBA")`` of every frame:
what ``chip_smoke.py`` holds the port's decoder to on the card's machine
(no PIL there), and what ``tests/test_torch_png_formats.py`` holds to PIL
here.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_png"
GOLDENS = FIXTURES / "goldens.json"
SCENE = FIXTURES / "scene"
SCENE_SIZE = 40

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Every (colour type, bit depth) the PNG specification allows.
LAYOUTS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2),
           (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
# Adam7's passes: (x0, y0, dx, dy).
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2)]


def chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """``(H, stride)`` uint8 scanlines -> the filtered stream, row ``y``
    with filter ``filters[y % len(filters)]``."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        f = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            line = row
        elif f == 1:
            line = row - left
        elif f == 2:
            line = row - prev
        elif f == 3:
            line = row - (left + prev) // 2
        elif f == 4:
            line = row - np.array([_paeth(a, b, c) for a, b, c in zip(left, prev, upleft)],
                                  np.int64)
        else:
            raise ValueError(f"filter {f}")
        out.append(f)
        out += (line & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _scanlines(samples: np.ndarray, depth: int) -> np.ndarray:
    """``(H, W, C)`` samples -> ``(H, stride)`` uint8 scanlines: big-endian
    at 16 bits, packed from the high bit at 1, 2 and 4 (0 bits pad a row)."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * c).view(np.uint8).reshape(h, 2 * w * c)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    per = 8 // depth
    stride = (w * depth + 7) // 8
    vals = np.zeros((h, stride * per), np.int64)
    vals[:, :w] = samples[..., 0]
    shifts = depth * np.arange(per - 1, -1, -1)
    return (vals.reshape(h, stride, per) << shifts).sum(-1).astype(np.uint8)


def write_png(samples: np.ndarray, color: int, depth: int, *, interlace: bool = False,
              filters=(0, 1, 2, 3, 4), palette=None, trns: bytes | None = None,
              extra: list[tuple[bytes, bytes]] = (), idat_parts: int = 1) -> bytes:
    """PNG bytes of ``samples`` (``(H, W, C)`` or ``(H, W)`` integers, the
    raw sample values: indices for a palette file).  ``palette`` is an
    ``(N, 3)`` array; ``trns`` the ``tRNS`` body as it is; ``extra``
    chunks go before the first IDAT; the zlib stream is split over
    ``idat_parts`` IDAT chunks."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    assert c == CHANNELS[color], (color, c)
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            part = samples[y0::dy, x0::dx]
            if part.shape[0] and part.shape[1]:
                raw += _filter_rows(_scanlines(part, depth), bpp, filters)
    else:
        raw = _filter_rows(_scanlines(samples, depth), bpp, filters)
    z = zlib.compress(raw, 6)
    cut = [len(z) * i // idat_parts for i in range(idat_parts + 1)]
    parts = [PNG_SIG, chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                                 int(interlace)))]
    if palette is not None:
        parts.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        parts.append(chunk(b"tRNS", trns))
    parts += [chunk(k, b) for k, b in extra]
    parts += [chunk(b"IDAT", z[cut[i]:cut[i + 1]]) for i in range(idat_parts)]
    parts.append(chunk(b"IEND", b""))
    return b"".join(parts)


def random_samples(h: int, w: int, color: int, depth: int, seed: int,
                   palette_size: int | None = None) -> np.ndarray:
    """Seeded samples over the whole range of each (a palette's over its
    ``palette_size`` entries), with flat runs and ramps that the five
    filters predict differently."""
    rng = np.random.default_rng(seed)
    c = CHANNELS[color]
    top = (palette_size if color == 3 and palette_size else 1 << depth) - 1
    s = rng.integers(0, top + 1, (h, w, c), dtype=np.int64)
    y, x = np.mgrid[0:h, 0:w]
    ramp = (x * 7 + y * 3) % (top + 1)
    s[: h // 2, : w // 2] = ramp[: h // 2, : w // 2, None]
    s[h // 2:, w // 2:] = top // 2
    return s


def digest(img: np.ndarray) -> dict:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    return {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def pil_rgba(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGBA"))


# The scene's frames: (file, layout).  train: 6 frames, val: 2.
SCENE_FRAMES = {
    "train/r_0.png": "rgba16",
    "train/r_1.png": "rgba16_adam7",
    "train/r_2.png": "palette8_trns",
    "train/r_3.png": "palette4_trns_adam7",
    "train/r_4.png": "la16",
    "train/r_5.png": "rgba8_adam7",
    "val/r_0.png": "rgba16_adam7",
    "val/r_1.png": "palette8_trns",
}


def _quantise(rgba: np.ndarray, colours: int) -> tuple[np.ndarray, np.ndarray, bytes]:
    """An 8-bit RGBA frame -> (indices, palette, tRNS) over ``colours``
    entries: the most common colours, each pixel its nearest; transparent
    where the entry's alpha is below half."""
    flat = rgba.reshape(-1, 4).astype(np.int64)
    keys, counts = np.unique(flat, axis=0, return_counts=True)
    pal = keys[np.argsort(-counts, kind="stable")[:colours]]
    d = ((flat[:, None, :] - pal[None, :, :]) ** 2).sum(-1)
    idx = d.argmin(1).reshape(rgba.shape[:2])
    alpha = np.where(pal[:, 3] < 128, 0, 255).astype(np.uint8)
    return idx, pal[:, :3].astype(np.uint8), alpha.tobytes()


def scene_frame_png(rgba16: np.ndarray, layout: str) -> bytes:
    """One frame of the scene (``(H, W, 4)`` 16-bit RGBA) in ``layout``."""
    adam7 = layout.endswith("adam7")
    rgba8 = (rgba16 >> 8).astype(np.int64)
    if layout.startswith("rgba16"):
        return write_png(rgba16, 6, 16, interlace=adam7)
    if layout.startswith("rgba8"):
        return write_png(rgba8, 6, 8, interlace=adam7)
    if layout.startswith("la16"):
        gray = (rgba16[..., :3].astype(np.int64).sum(-1) // 3)
        return write_png(np.stack([gray, rgba16[..., 3]], -1), 4, 16, interlace=adam7)
    depth = 8 if layout.startswith("palette8") else 4
    idx, pal, trns = _quantise(rgba8, 1 << depth)
    return write_png(idx, 3, depth, interlace=adam7, palette=pal, trns=trns)


def scene_views() -> tuple[np.ndarray, np.ndarray, float]:
    """The scene's 8 frames as ``(N, H, W, 4)`` 16-bit RGBA, their
    camera-to-world poses and ``camera_angle_x``: the spheres of
    ``data/synthetic`` from an orbit (radius 4, elevation -30), alpha
    65535 where a ray hits, the background (0, 0, 0, 0)."""
    from nerf_keras_tpu_torch.data.pipeline import view_rays
    from nerf_keras_tpu_torch.data.synthetic import _render_analytic_spheres
    from nerf_keras_tpu_torch.ops.rays import pose_spherical

    angle_x = 0.9
    focal = 0.5 * SCENE_SIZE / np.tan(0.5 * angle_x)
    n = len(SCENE_FRAMES)
    poses = np.stack([pose_spherical(360.0 * i / n, -30.0, 4.0) for i in range(n)])
    origins, dirs = view_rays(list(poses), SCENE_SIZE, SCENE_SIZE, focal)
    frames = []
    for o, d in zip(origins, dirs):
        rgb = _render_analytic_spheres(o, d).astype(np.float64)
        hit = (rgb < 1.0).any(-1, keepdims=True)
        rgba = np.concatenate([np.where(hit, rgb, 0.0), hit.astype(np.float64)], -1)
        frames.append(np.round(rgba * 65535).astype(np.int64))
    return np.stack(frames), poses.astype(np.float32), angle_x


def pil_goldens() -> dict:
    import PIL

    return {"pil": PIL.__version__,
            "decode": {rel: digest(pil_rgba(SCENE / rel)) for rel in sorted(SCENE_FRAMES)}}


def write_fixtures() -> None:
    frames, poses, angle_x = scene_views()
    for split in ("train", "val"):
        (SCENE / split).mkdir(parents=True, exist_ok=True)
        meta = {"camera_angle_x": angle_x, "frames": []}
        for i, (rel, layout) in enumerate(SCENE_FRAMES.items()):
            if not rel.startswith(split + "/"):
                continue
            (SCENE / rel).write_bytes(scene_frame_png(frames[i], layout))
            meta["frames"].append({"file_path": "./" + rel[:-4],
                                   "transform_matrix": poses[i].tolist()})
        (SCENE / f"transforms_{split}.json").write_text(json.dumps(meta, indent=1) + "\n")
    GOLDENS.write_text(json.dumps(pil_goldens(), indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.fspath(Path(__file__).resolve().parents[1]))
    write_fixtures()
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    print(f"wrote {FIXTURES} ({total} bytes)")
