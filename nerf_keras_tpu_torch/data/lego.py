"""The Blender-synthetic "tiny Lego" npz (``tiny_nerf_data.npz``).

Counterpart of ``nerf_keras_tpu/data/lego.py``: images, poses and focal
from the npz, resized to the config resolution (the focal rescaled with
them), split 80/20 by index, bounds near=2, far=6.  It never downloads:
the JAX loader fetches the file when it is missing, the port looks in
the same places in the same order and raises ``FileNotFoundError``.
"""

from __future__ import annotations

import os

import numpy as np

from nerf_keras_tpu_torch.data.pipeline import RayDataset, build_ray_dataset, rescale_focal
from nerf_keras_tpu_torch.utils.image import resize_bilinear

_FILENAME = "tiny_nerf_data.npz"


def lego_candidates(path: str | None = None) -> list[str]:
    """Where the npz is looked for, in order."""
    candidates = [path] if path else []
    if os.environ.get("NERF_DATA_DIR"):
        candidates.append(os.path.join(os.environ["NERF_DATA_DIR"], _FILENAME))
    return candidates + [
        os.path.join("data", _FILENAME),
        os.path.expanduser(f"~/.keras/datasets/{_FILENAME}"),
        os.path.expanduser(f"~/.cache/nerf_keras_tpu/{_FILENAME}"),
    ]


def find_lego_npz(path: str | None = None) -> str:
    """The first existing candidate; ``FileNotFoundError`` listing them all
    when there is none (no download)."""
    candidates = lego_candidates(path)
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(
        f"{_FILENAME} not found in {candidates}; the port does not download it. "
        "Place the file under $NERF_DATA_DIR or ./data."
    )


def split_data(
    images: np.ndarray, poses: np.ndarray, split_ratio: float = 0.8
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The first ``split_ratio`` of the views for training, the rest for val."""
    split = int(images.shape[0] * split_ratio)
    return images[:split], images[split:], poses[:split], poses[split:]


def prepare_lego_data(
    target_height: int, target_width: int, path: str | None = None,
) -> tuple[RayDataset, RayDataset, tuple[float, float], float]:
    """``(train, val, (near, far), focal)`` of the tiny Lego scene."""
    with np.load(find_lego_npz(path)) as data:
        images = data["images"].astype(np.float32)
        poses = data["poses"].astype(np.float32)
        native_focal = float(data["focal"])
    src_h, src_w = images.shape[1:3]
    focal = rescale_focal(native_focal, src_h, src_w, target_height, target_width)
    images = resize_bilinear(images, target_height, target_width)
    train_imgs, val_imgs, train_poses, val_poses = split_data(images, poses)
    near, far = 2.0, 6.0

    def build(imgs: np.ndarray, pose_set: np.ndarray) -> RayDataset:
        return build_ray_dataset(imgs, pose_set, target_height, target_width, focal,
                                 near, far)

    return build(train_imgs, train_poses), build(val_imgs, val_poses), (near, far), focal
