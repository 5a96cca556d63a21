"""The JPEG fixtures of ``tests/fixtures/torch_jpeg/`` and their goldens.

    python tests/torch_jpeg_fixtures.py    # rewrite the files and goldens.json

A helper, not a test module.  PIL 12.1.0 writes every file but one:

- ``capture/``: an LLFF capture shipped as full-size JPEGs only, the
  port's spheres scene (``data/synthetic.forward_facing_views``) from 8
  cameras at 504x672 (hwf at that size in ``poses_bounds.npy``),
  ``quality=90`` with PIL's default 4:2:0.  ``images_8/`` is 63x84.
- ``cases/``: small odd-sized decoder cases (4:4:4, 4:2:2, 4:2:0, gray,
  optimised tables, restart markers, qualities 50 and 95, EXIF and a
  comment).  PIL cannot write 4:4:0, so OpenCV (``cv2``)
  writes ``s440_q90.jpg``; PIL still decodes it for the golden.

``goldens.json`` holds the SHA-256 (and shape) of PIL's uint8
``Image.open(f).convert("RGB")`` of every file, and of PIL's LANCZOS
minify by 8 of every capture view: what ``chip_smoke.py`` holds the
port's decoder and ``minify`` to on the card's machine (no PIL there),
and what ``tests/test_torch_jpeg.py`` holds to PIL here.
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


def capture_files() -> list[Path]:
    return sorted((FIXTURES / "capture" / "images").glob("*.jpg"))


def case_files() -> list[Path]:
    return sorted((FIXTURES / "cases").glob("*.jpg"))


def pil_goldens() -> dict:
    """The goldens as PIL computes them from the committed files."""
    import PIL

    rel = lambda p: p.relative_to(FIXTURES).as_posix()  # noqa: E731
    return {
        "pil": PIL.__version__,
        "decode": {rel(p): digest(pil_rgb(p)) for p in case_files() + capture_files()},
        "minify": {rel(p): digest(pil_minify(p)) for p in capture_files()},
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


def write_exif_case(path: Path) -> None:
    """4:2:0 with an EXIF block (orientation 6) and a COM segment: both
    skipped, no rotation applied."""
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(case_image(41, 65, seed=99)).save(
        path, "JPEG", quality=90, exif=exif.tobytes(), comment=b"a COM segment")


def write_fixtures() -> None:
    from PIL import Image

    from nerf_keras_tpu_torch.data.synthetic import forward_facing_views

    (FIXTURES / "cases").mkdir(parents=True, exist_ok=True)
    img_dir = FIXTURES / "capture" / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    for name in CASES:
        write_case(name, FIXTURES / "cases" / f"{name}.jpg")
    write_exif_case(FIXTURES / "cases" / "s420_exif_comment.jpg")
    frames, poses_bounds = forward_facing_views(CAPTURE_VIEWS, CAPTURE_HEIGHT,
                                                CAPTURE_WIDTH, CAPTURE_FOCAL)
    for i, rgb in enumerate(frames):
        Image.fromarray(rgb).save(img_dir / f"img_{i:02d}.jpg", "JPEG", quality=90)
    buf = io.BytesIO()
    np.save(buf, poses_bounds)
    (FIXTURES / "capture" / "poses_bounds.npy").write_bytes(buf.getvalue())
    GOLDENS.write_text(json.dumps(pil_goldens(), indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.fspath(Path(__file__).resolve().parents[1]))
    write_fixtures()
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    print(f"wrote {FIXTURES} ({total} bytes)")
