"""PNG frames, videos and the per-eval panel (counterpart of
``nerf_keras_tpu/utils/viz.py``).

The JAX package draws its pred/depth/loss panel with matplotlib.  The
card's machine has neither matplotlib nor PIL, so the port composes the
panel as an array in numpy and writes it with ``utils/png.encode_png``:
one row per view, its rgb tile beside its normalised depth, and under
the rows a strip with the loss curve drawn in.  The loss values
themselves are kept in the history JSON.

Videos go through ``imageio`` with an ffmpeg backend, as in the JAX
package, where both import.  Where they do not (the card's machine has
neither imageio nor PIL), :func:`write_video` writes an animated GIF
beside the requested path, as the JAX package's PIL branch does, through
the port's own writer (``utils/gif.encode_gif``).
"""

from __future__ import annotations

import numpy as np

from nerf_keras_tpu_torch.utils import io
from nerf_keras_tpu_torch.utils.gif import encode_gif
from nerf_keras_tpu_torch.utils.image import normalize_depth, to_uint8
from nerf_keras_tpu_torch.utils.png import decode_png, encode_png

_GAP = 2  # white pixels between tiles
_INK = np.array([31, 119, 180], np.uint8)  # the curve
_FRAME = np.array([160, 160, 160], np.uint8)


def loss_strip(losses: list[float], height: int, width: int) -> np.ndarray:
    """``(height, width, 3)`` uint8: the finite values of ``losses`` as a
    polyline, first epoch at the left, the largest loss at the top, inside
    a gray frame."""
    img = np.full((height, width, 3), 255, np.uint8)
    img[[0, -1], :] = _FRAME
    img[:, [0, -1]] = _FRAME
    v = np.asarray([x for x in losses if np.isfinite(x)], np.float64)
    if v.size == 0 or height < 4 or width < 4:
        return img
    lo, hi = float(v.min()), float(v.max())
    frac = (v - lo) / (hi - lo) if hi > lo else np.full_like(v, 0.5)
    ys = np.round(1 + (1.0 - frac) * (height - 3)).astype(np.int64)
    xs = (np.round(np.linspace(1, width - 2, v.size)).astype(np.int64) if v.size > 1
          else np.array([width // 2]))
    img[ys[0], xs[0]] = _INK
    for (x0, y0), (x1, y1) in zip(zip(xs[:-1], ys[:-1]), zip(xs[1:], ys[1:])):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        img[np.round(np.linspace(y0, y1, n)).astype(np.int64),
            np.round(np.linspace(x0, x1, n)).astype(np.int64)] = _INK
    return img


def panel(rgb, depth, losses: list[float]) -> np.ndarray:
    """The panel as a uint8 ``(rows, cols, 3)`` array (see module docstring)."""
    rgbs = rgb if isinstance(rgb, list) else [rgb]
    depths = depth if isinstance(depth, list) else [depth]
    rows = []
    for im, dp in zip(rgbs, depths):
        im = to_uint8(np.clip(np.asarray(im, np.float32), 0.0, 1.0))
        dp = to_uint8(normalize_depth(dp))
        gap = np.full((im.shape[0], _GAP, 3), 255, np.uint8)
        rows.append(np.concatenate([im, gap, np.repeat(dp[..., None], 3, axis=-1)], axis=1))
    width = max(r.shape[1] for r in rows)
    strip_h = max(16, rows[0].shape[0] // 2)
    parts = []
    for r in rows + [loss_strip(losses, strip_h, width)]:
        pad = np.full((r.shape[0], width - r.shape[1], 3), 255, np.uint8)
        parts += [np.concatenate([r, pad], axis=1), np.full((_GAP, width, 3), 255, np.uint8)]
    return np.concatenate(parts[:-1], axis=0)


def save_panel(
    path: str,
    rgb: np.ndarray | list[np.ndarray],
    depth: np.ndarray | list[np.ndarray],
    losses: list[float],
    epoch: int,
    total_epochs: int,
) -> None:
    """Write the panel of one view or a list of views as a PNG at ``path``.
    ``epoch`` and ``total_epochs`` name the panel in the JAX package's
    titles; here the file name carries the epoch."""
    del epoch, total_epochs
    with io.open_file(path, "wb") as f:
        f.write(encode_png(panel(rgb, depth, losses)))


def save_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 ``(H, W, 3)`` image as a PNG."""
    with io.open_file(path, "wb") as f:
        f.write(encode_png(np.asarray(img)))


def write_video(path: str, frames: list[np.ndarray], fps: int = 30) -> str:
    """Encode frames to an mp4 at ``path`` (``imageio.mimwrite``, the
    reference's writer) and return the path written.  Without imageio or
    an ffmpeg backend, an animated GIF at ``<path stem>.gif`` instead, each
    frame shown ``max(1, int(1000 / fps))`` ms, looping, as the JAX
    package writes it; that path is returned."""
    if not frames:
        raise ValueError(f"write_video({path!r}): no frames to encode")
    frames = [to_uint8(f) for f in frames]
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, frames, fps=fps, quality=7, macro_block_size=None)
        return path
    except (ImportError, OSError, ValueError) as e:
        # No ffmpeg backend (or no imageio); an error of the GIF step below
        # surfaces.
        reason = e
    gif_path = path.rsplit(".", 1)[0] + ".gif"
    print(f"[nerf-torch] mp4 encoder unavailable ({reason}); writing GIF {gif_path}")
    data = encode_gif(frames, duration_ms=max(1, int(1000 / fps)))
    with io.open_file(gif_path, "wb") as f:
        f.write(data)
    return gif_path


def frames_to_video(image_dir: str, out_path: str, fps: int = 30) -> str:
    """Encode the PNGs of a directory, in name order, as a video (the
    training-progress video of the reference's ``visualization.py``;
    ``python -m nerf_keras_tpu_torch.visualization``) through
    :func:`write_video`; returns the path written."""
    names = [n for n in io.listdir(image_dir) if n.endswith(".png")]
    if not names:
        raise FileNotFoundError(f"no PNG frames found under {image_dir}")
    frames = []
    for name in sorted(names):
        with io.open_file(io.join(image_dir, name), "rb") as f:
            frames.append(decode_png(f.read()))
    return write_video(out_path, frames, fps=fps)
