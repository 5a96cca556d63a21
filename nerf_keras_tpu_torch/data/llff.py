"""LLFF forward-facing captures (Fern): poses, images and render paths.

Counterpart of ``nerf_keras_tpu/data/llff.py``.  A capture is

    basedir/
      poses_bounds.npy    (N, 17): per view a (3, 5) pose [down, right,
                          back, t, hwf] flattened, then its near/far bounds
      images/             the full-size frames
      images_{factor}/    the same frames minified by ``factor``

The pose math is the JAX package's numpy, line for line: the axis
reorder to NeRF's [right, up, back], the bound rescale (``bd_factor``),
recentering on the average pose, the spiral render path or the
spherified orbit, and the single-view holdout nearest the average pose.

Images decode through the port's own ``utils/png`` and ``utils/jpeg``
(the card's machine has no PIL), told apart by content as PIL does, to
PIL's ``convert("RGB")`` bit for bit: every PNG PIL opens (any colour type
and bit depth, Adam7 too) and baseline and progressive 8-bit gray/YCbCr
JPEGs; a file the port refuses raises ``ValueError`` naming it.  ``minify`` builds
``images_{factor}/`` from ``images/`` with Pillow's LANCZOS resize
(``utils/image.resize_lanczos_u8``, bit for bit) into PNGs, as the JAX
package does through PIL.  Remote (``gs://``) roots raise through
``utils/io``: the JAX package's remote minify cache is not ported.
"""

from __future__ import annotations

import os

import numpy as np

from nerf_keras_tpu_torch.data.pipeline import RayDataset, build_ray_dataset, rescale_focal
from nerf_keras_tpu_torch.utils import io
from nerf_keras_tpu_torch.utils.image import decode_image, resize_bilinear, resize_lanczos_u8
from nerf_keras_tpu_torch.utils.png import encode_png, to_rgba

# ---------------------------------------------------------------------------
# pose math (numpy; the standard LLFF recipe)
# ---------------------------------------------------------------------------


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def view_matrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Camera-to-world basis ``(3, 4)`` from a viewing direction, an up
    hint and a position."""
    z = _normalize(z)
    x = _normalize(np.cross(up, z))
    y = _normalize(np.cross(z, x))
    return np.stack([x, y, z, pos], axis=1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """The mean camera pose of ``(N, 3, 5)`` poses, ``(3, 5)`` with the
    first view's hwf column."""
    hwf = poses[0, :, 4:5]
    center = poses[:, :, 3].mean(axis=0)
    z = _normalize(poses[:, :, 2].sum(axis=0))
    up = poses[:, :, 1].sum(axis=0)
    return np.concatenate([view_matrix(z, up, center), hwf], axis=1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Transform all poses rigidly so that the average pose is the
    identity."""
    avg = average_pose(poses)
    bottom = np.array([[0, 0, 0, 1.0]], dtype=poses.dtype)
    avg44 = np.concatenate([avg[:, :4], bottom], axis=0)
    poses44 = np.concatenate(
        [poses[:, :, :4], np.broadcast_to(bottom, (poses.shape[0], 1, 4))], axis=1
    )
    fixed = np.linalg.inv(avg44) @ poses44
    out = poses.copy()
    out[:, :, :4] = fixed[:, :3, :4]
    return out


def spiral_render_path(
    c2w: np.ndarray,
    up: np.ndarray,
    rads: np.ndarray,
    focal: float,
    zrate: float,
    rots: int,
    n_frames: int,
) -> np.ndarray:
    """``n_frames`` ``(3, 5)`` poses on a spiral around the anchor pose
    ``c2w``, each looking at the point ``focal`` in front of it."""
    rads4 = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n_frames + 1)[:-1]:
        offset = np.array(
            [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
        )
        pos = c2w[:3, :4] @ (offset * rads4)
        z = _normalize(pos - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(np.concatenate([view_matrix(z, up, pos), hwf], axis=1))
    return np.stack(out).astype(np.float32)


def spherify_poses(
    poses: np.ndarray, bds: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Re-center a 360 degree capture on a unit sphere around the point
    nearest every camera axis; returns ``(poses, orbit, bds)`` with a
    120-pose orbit render path."""
    dirs = poses[:, :, 2:3]
    origins = poses[:, :, 3:4]

    # The point nearest all camera axes (least squares).
    eye = np.eye(3)
    a = eye - dirs @ np.transpose(dirs, (0, 2, 1))
    b = -a @ origins
    focus = np.squeeze(
        -np.linalg.inv((np.transpose(a, (0, 2, 1)) @ a).mean(0)) @ b.mean(0)
    )

    up = _normalize((poses[:, :, 3] - focus).mean(axis=0))
    x = _normalize(np.cross([0.1, 0.2, 0.3], up))
    y = _normalize(np.cross(up, x))
    world = np.stack([x, y, up, focus], axis=1)
    bottom = np.array([[0, 0, 0, 1.0]])
    world44 = np.concatenate([world, bottom], axis=0)

    poses44 = np.concatenate(
        [poses[:, :, :4], np.broadcast_to(bottom[None], (poses.shape[0], 1, 4))],
        axis=1,
    )
    reset = (np.linalg.inv(world44)[None] @ poses44)[:, :3, :4]

    radius = float(np.sqrt(np.mean(np.sum(reset[:, :, 3] ** 2, axis=-1))))
    scale = 1.0 / radius
    reset[:, :, 3] *= scale
    bds = bds * scale
    radius *= scale

    zh = reset[:, :, 3].mean(axis=0)[2]
    ring = np.sqrt(radius**2 - zh**2)
    orbit = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        pos = np.array([ring * np.cos(th), ring * np.sin(th), zh])
        z = _normalize(pos)
        x = _normalize(np.cross(z, np.array([0, 0, -1.0])))
        y = _normalize(np.cross(z, x))
        orbit.append(np.stack([x, y, z, pos], axis=1))
    orbit = np.stack(orbit)

    hwf = np.broadcast_to(poses[0, :, 4:5], (orbit.shape[0], 3, 1))
    orbit = np.concatenate([orbit, hwf], axis=-1).astype(np.float32)
    hwf_n = np.broadcast_to(poses[0, :, 4:5], (reset.shape[0], 3, 1))
    reset = np.concatenate([reset, hwf_n], axis=-1).astype(np.float32)
    return reset, orbit, bds


# ---------------------------------------------------------------------------
# disk loading
# ---------------------------------------------------------------------------

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".PNG", ".JPEG")


def _image_files(directory: str) -> list[str]:
    return [io.join(directory, f) for f in io.listdir(directory) if f.endswith(_IMG_EXTS)]


def _read_rgb_u8(path: str) -> np.ndarray:
    """An image file as ``(H, W, 3)`` uint8, as PIL's ``convert("RGB")``
    gives it (gray fills r, g and b; alpha and a ``tRNS`` key are
    dropped)."""
    with io.open_file(path, "rb") as f:
        return to_rgba(decode_image(f.read(), path))[..., :3]


def _read_image(path: str) -> np.ndarray:
    """A PNG or JPEG as float32 RGB in [0, 1]."""
    return _read_rgb_u8(path).astype(np.float32) / 255.0


def minify(basedir: str, factor: int) -> str:
    """The capture's ``images_{factor}/`` directory: returned as it is when
    it holds images, else made from ``images/``, each frame resized to
    ``(w // factor, h // factor)`` with Pillow's LANCZOS and written as
    ``<stem>.png``."""
    src_dir = io.join(basedir, "images")
    out_dir = io.join(basedir, f"images_{factor}")
    if io.exists(out_dir) and _image_files(out_dir):
        return out_dir
    io.makedirs(out_dir)
    for src in _image_files(src_dir):
        img = _read_rgb_u8(src)
        h, w = img.shape[:2]
        small = resize_lanczos_u8(img, w // factor, h // factor)
        stem = os.path.splitext(os.path.basename(src))[0]
        with io.open_file(io.join(out_dir, stem + ".png"), "wb") as f:
            f.write(encode_png(small))
    return out_dir


def _render_path_from_poses(
    poses: np.ndarray, bds: np.ndarray, spherify: bool, n_frames: int = 120
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The render path a rescaled, recentered capture implies: the
    spherified orbit (subsampled or repeated to ``n_frames``) or the spiral
    with the focus-depth heuristic.  Returns ``(poses, render_poses,
    bds)``: spherification changes all three."""
    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
        if len(render_poses) != n_frames:
            idx = np.linspace(0, len(render_poses) - 1, n_frames)
            render_poses = np.stack([render_poses[int(round(i))] for i in idx])
        return poses, render_poses, bds
    avg = average_pose(poses)
    up = _normalize(poses[:, :, 1].sum(axis=0))
    close, far = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close + dt / far)
    rads = np.percentile(np.abs(poses[:, :, 3]), 90, axis=0)
    render_poses = spiral_render_path(avg, up, rads, focal, zrate=0.5, rots=2,
                                      n_frames=n_frames)
    return poses, render_poses, bds


def _load_poses_bounds(basedir: str) -> tuple[np.ndarray, np.ndarray]:
    """``poses_bounds.npy`` -> raw ``(N, 3, 5)`` float64 poses and ``(N,
    2)`` bounds."""
    with io.open_file(io.join(basedir, "poses_bounds.npy"), "rb") as f:
        arr = np.load(f)
    poses = arr[:, :-2].reshape(-1, 3, 5).astype(np.float64)
    bds = arr[:, -2:].astype(np.float64)
    return poses, bds


def _to_nerf_axes(poses: np.ndarray, bds: np.ndarray, bd_factor: float | None,
                  recenter: bool) -> tuple[np.ndarray, np.ndarray]:
    """LLFF's [down, right, back] -> NeRF's [right, up, back] in float32,
    positions and bounds rescaled so that the nearest bound is
    ``1 / bd_factor``, then (``recenter``) recentered on the average
    pose."""
    poses = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], axis=2
    ).astype(np.float32)
    bds = bds.astype(np.float32)
    scale = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :, 3] *= scale
    bds = bds * scale
    if recenter:
        poses = recenter_poses(poses)
    return poses, bds


def load_llff_render_path(
    basedir: str,
    recenter: bool = True,
    bd_factor: float = 0.75,
    spherify: bool = False,
    n_frames: int = 120,
) -> np.ndarray:
    """The capture's render poses ``(n_frames, 3, 5)``, from
    ``poses_bounds.npy`` alone (no image is read): the pose math of
    :func:`load_llff_data`.  The hwf column is the raw capture's; path
    consumers use ``[:, :4]``."""
    poses, bds = _to_nerf_axes(*_load_poses_bounds(basedir), bd_factor, recenter)
    _, render_poses, _ = _render_path_from_poses(poses, bds, spherify, n_frames)
    return render_poses


def load_llff_data(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: float = 0.75,
    spherify: bool = False,
):
    """Load a capture: ``(images, poses, bds, render_poses, i_holdout)``
    with images ``(N, H, W, 3)`` float32, poses ``(N, 3, 5)`` (hwf at the
    loaded resolution), bounds ``(N, 2)``, the 120-pose render path and
    the view nearest the average pose."""
    poses, bds = _load_poses_bounds(basedir)

    img_dir = minify(basedir, factor) if factor and factor != 1 else io.join(basedir, "images")
    files = _image_files(img_dir)
    if len(files) != poses.shape[0]:
        raise ValueError(f"{len(files)} images in {img_dir} but {poses.shape[0]} poses")
    images = np.stack([_read_image(f) for f in files])

    # hwf at the loaded resolution; factor None/0 means the raw images.
    poses[:, 0, 4] = images.shape[1]
    poses[:, 1, 4] = images.shape[2]
    poses[:, 2, 4] = poses[:, 2, 4] / (factor if factor else 1)

    poses, bds = _to_nerf_axes(poses, bds, bd_factor, recenter)
    poses, render_poses, bds = _render_path_from_poses(poses, bds, spherify)

    avg = average_pose(poses)
    dists = np.sum((avg[:, 3] - poses[:, :, 3]) ** 2, axis=-1)
    i_holdout = int(np.argmin(dists))
    return images.astype(np.float32), poses, bds, render_poses, i_holdout


def default_fern_dir() -> str:
    """``$NERF_LLFF_DIR``, else the reference's local layout."""
    return os.environ.get("NERF_LLFF_DIR", "data/nerf_example_data/nerf_llff_data/fern")


def prepare_fern_data(
    target_height: int,
    target_width: int,
    basedir: str | None = None,
    factor: int = 8,
) -> tuple[RayDataset, RayDataset, tuple[float, float], float]:
    """``(train, val, (near, far), focal)`` of a capture: every view but
    the holdout trains, the holdout is the one val view; frames resized
    to the target size with the focal rescaled by the resize; near is 0.9
    of the nearest bound, far the farthest (world space: ``NDC`` configs
    map the rays with ``pipeline.dataset_to_ndc``)."""
    basedir = basedir or default_fern_dir()
    images, poses, bds, _, i_holdout = load_llff_data(
        basedir, factor=factor, recenter=True, bd_factor=0.75, spherify=False)

    focal = float(poses[0, 2, 4])
    if images.shape[1:3] != (target_height, target_width):
        src_h, src_w = images.shape[1:3]
        focal = rescale_focal(focal, src_h, src_w, target_height, target_width)
        images = resize_bilinear(images, target_height, target_width)

    near = float(bds.min()) * 0.9
    far = float(bds.max())

    idx_all = np.arange(images.shape[0])
    train_idx = idx_all[idx_all != i_holdout]
    val_idx = np.array([i_holdout])

    def build(indices: np.ndarray) -> RayDataset:
        return build_ray_dataset(images[indices], poses[indices, :, :4], target_height,
                                 target_width, focal, near, far)

    return build(train_idx), build(val_idx), (near, far), focal
