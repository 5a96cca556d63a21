"""Full Blender ``nerf_synthetic`` scenes (``transforms_*.json`` + PNGs).

Counterpart of ``nerf_keras_tpu/data/blender.py``:

    scene/
      transforms_train.json   {"camera_angle_x": a, "frames": [
      transforms_val.json        {"file_path": "./train/r_0",
      transforms_test.json        "transform_matrix": 4x4 c2w}, ...]}
      train/r_*.png  val/r_*.png  test/r_*.png

Poses pass through unchanged (the OpenGL-style camera-to-world of
``ops/rays.get_rays``); the focal is ``W/2 / tan(a/2)`` at the native
width, rescaled with the resize; alpha is composited onto a white or
black background; bounds are near=2, far=6.  Frames are decoded by the
port's ``utils/image.decode_image`` (PNG at any colour type and bit
depth, Adam7 too, or JPEG, baseline or progressive, where a
``file_path`` names one; the card's machine has no PIL) and widened to
RGBA as PIL's ``convert("RGBA")`` does: a JPEG's alpha is 255, a 16-bit
PNG gives each sample's high byte (16-bit gray clipped to 255), a palette
PNG each index's ``tRNS`` alpha, and a gray or RGB PNG's ``tRNS`` key
colour alpha 0.  A file the port refuses raises ``ValueError`` naming it.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_keras_tpu_torch.data.pipeline import RayDataset, build_ray_dataset, rescale_focal
from nerf_keras_tpu_torch.utils.image import decode_image, resize_bilinear
from nerf_keras_tpu_torch.utils.png import PNG_SIGNATURE, png_transparency, to_rgba

NEAR, FAR = 2.0, 6.0


def find_blender_scene(path: str | None = None, scene: str = "lego") -> str:
    """Locate a scene directory (one holding ``transforms_train.json``):
    ``path`` itself, ``path/{scene}``, ``path/nerf_synthetic/{scene}``,
    then ``$NERF_DATA_DIR/nerf_synthetic/{scene}``, ``$NERF_DATA_DIR/{scene}``,
    ``./data/nerf_synthetic/{scene}``, ``./data/{scene}``.  No download."""
    candidates = []
    if path:
        candidates += [path, os.path.join(path, scene),
                       os.path.join(path, "nerf_synthetic", scene)]
    root = os.environ.get("NERF_DATA_DIR")
    if root:
        candidates += [os.path.join(root, "nerf_synthetic", scene),
                       os.path.join(root, scene)]
    candidates += [os.path.join("data", "nerf_synthetic", scene),
                   os.path.join("data", scene)]
    for c in candidates:
        if c and os.path.isfile(os.path.join(c, "transforms_train.json")):
            return c
    raise FileNotFoundError(
        f"No Blender scene (transforms_train.json) found in {candidates}. "
        f"Point --data-dir or $NERF_DATA_DIR at a nerf_synthetic scene."
    )


def _read_rgba(path: str) -> np.ndarray:
    """A PNG or JPEG frame as ``(H, W, 4)`` float32 in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    img = decode_image(data, path)
    key = png_transparency(data) if data[:len(PNG_SIGNATURE)] == PNG_SIGNATURE else None
    return to_rgba(img, key).astype(np.float32) / 255.0


def _composite(rgba: np.ndarray, white_bkgd: bool) -> np.ndarray:
    """Alpha-composite ``(H, W, 4)`` onto a solid background -> ``(H, W, 3)``."""
    rgb, a = rgba[..., :3], rgba[..., 3:4]
    bkgd = 1.0 if white_bkgd else 0.0
    return rgb * a + bkgd * (1.0 - a)


def load_blender_split(
    scene_dir: str, split: str, *, white_bkgd: bool = True, every: int = 1
) -> tuple[np.ndarray, np.ndarray, float]:
    """One ``transforms_{split}.json``: ``(images (V, H, W, 3), poses
    (V, 4, 4), camera_angle_x)`` at native resolution, every ``every``-th
    frame.  A ``file_path`` without an extension means ``.png``."""
    with open(os.path.join(scene_dir, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    images, poses = [], []
    for fr in meta["frames"][::max(1, every)]:
        img_path = os.path.join(scene_dir, fr["file_path"])
        if not os.path.splitext(img_path)[1]:
            img_path += ".png"
        images.append(_composite(_read_rgba(img_path), white_bkgd))
        poses.append(np.asarray(fr["transform_matrix"], dtype=np.float32))
    return (np.stack(images).astype(np.float32), np.stack(poses),
            float(meta["camera_angle_x"]))


def prepare_blender_data(
    target_height: int,
    target_width: int,
    path: str | None = None,
    *,
    scene: str = "lego",
    white_bkgd: bool = True,
    val_split: str = "val",
    val_every: int = 8,
) -> tuple[RayDataset, RayDataset, tuple[float, float], float]:
    """``(train, val, (near, far), focal)`` of a nerf_synthetic scene.  Val
    is every ``val_every``-th frame of ``val_split``; a scene without that
    split holds out the last 20% of its train frames."""
    scene_dir = find_blender_scene(path, scene)
    train_imgs, train_poses, angle_x = load_blender_split(
        scene_dir, "train", white_bkgd=white_bkgd)
    if os.path.isfile(os.path.join(scene_dir, f"transforms_{val_split}.json")):
        # A present split must load cleanly: no silent fallback.
        val_imgs, val_poses, _ = load_blender_split(
            scene_dir, val_split, white_bkgd=white_bkgd, every=val_every)
    else:
        cut = int(train_imgs.shape[0] * 0.8)
        train_imgs, val_imgs = train_imgs[:cut], train_imgs[cut:]
        train_poses, val_poses = train_poses[:cut], train_poses[cut:]

    src_h, src_w = train_imgs.shape[1:3]
    native_focal = 0.5 * src_w / np.tan(0.5 * angle_x)
    focal = rescale_focal(float(native_focal), src_h, src_w, target_height, target_width)
    train_imgs = resize_bilinear(train_imgs, target_height, target_width)
    val_imgs = resize_bilinear(val_imgs, target_height, target_width)

    def build(imgs: np.ndarray, pose_set: np.ndarray) -> RayDataset:
        return build_ray_dataset(imgs, pose_set, target_height, target_width, focal,
                                 NEAR, FAR)

    return build(train_imgs, train_poses), build(val_imgs, val_poses), (NEAR, FAR), focal
