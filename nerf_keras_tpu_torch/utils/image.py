"""Image resize and display conversions (counterpart of
``nerf_keras_tpu/utils/image.py``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(images: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of ``(N, H, W, C)`` or ``(H, W, C)`` float arrays,
    on the host.

    The JAX package resizes with ``jax.image.resize(method="bilinear")``,
    which antialiases when it shrinks (its ``antialias=True`` default: the
    triangle kernel widens by the scale factor) and uses half-pixel
    centers; ``F.interpolate(..., antialias=True, align_corners=False)``
    computes the same weights.  Without ``antialias`` a 100 -> 25 resize
    differs from the JAX one by up to ~0.4.
    """
    arr = np.asarray(images, dtype=np.float32)
    squeeze = arr.ndim == 3
    if squeeze:
        arr = arr[None]
    if arr.shape[1:3] != (height, width):
        x = torch.from_numpy(np.ascontiguousarray(arr)).permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(height, width), mode="bilinear",
                          align_corners=False, antialias=True)
        arr = x.permute(0, 2, 3, 1).contiguous().numpy()
    return arr[0] if squeeze else arr


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0,1] float -> uint8 with the reference's clip*255 and truncating
    cast.  Idempotent: uint8 input (converted on the device already)
    passes through unchanged."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return np.clip(255.0 * img, 0.0, 255.0).astype(np.uint8)


def normalize_depth(depth: np.ndarray) -> np.ndarray:
    """Scale a depth map to [0,1] for display."""
    d = np.asarray(depth, dtype=np.float32)
    lo, hi = float(d.min()), float(d.max())
    if hi - lo < 1e-8:
        return np.zeros_like(d)
    return (d - lo) / (hi - lo)
