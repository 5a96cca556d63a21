"""Display conversions (counterpart of ``nerf_keras_tpu/utils/image.py``)."""

from __future__ import annotations

import numpy as np


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
