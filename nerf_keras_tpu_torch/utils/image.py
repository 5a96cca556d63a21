"""Image resize and display conversions (counterpart of
``nerf_keras_tpu/utils/image.py``), and Pillow's LANCZOS resize of 8-bit
images, which the JAX package's LLFF ``minify`` calls through PIL."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from nerf_keras_tpu_torch.utils.jpeg import decode_jpeg, is_jpeg
from nerf_keras_tpu_torch.utils.png import PNG_SIGNATURE, decode_png


def decode_image(data: bytes, name: str) -> np.ndarray:
    """A PNG or a JPEG, told apart by its first bytes as PIL tells them
    (not by the file name), -> ``(H, W)`` or ``(H, W, C)`` uint8 (a PNG as
    ``utils/png.decode_png`` gives it).  What the port does not read (a
    JPEG ``utils/jpeg.py`` refuses, a PNG PIL refuses too, any other file)
    raises ``ValueError`` starting with ``name`` (the file)."""
    if is_jpeg(data):
        return decode_jpeg(data, name)
    if data[:len(PNG_SIGNATURE)] != PNG_SIGNATURE:
        raise ValueError(f"{name}: neither a PNG nor a JPEG (first bytes {data[:4]!r})")
    try:
        return decode_png(data)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from e


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


# Pillow's Resample.c: LANCZOS support 3, coefficients in fixed point with
# PRECISION_BITS = 32 - 8 - 2.
_LANCZOS_SUPPORT = 3.0
_PRECISION_BITS = 22


def _lanczos(x: float) -> float:
    def sinc(v: float) -> float:
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


def _lanczos_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """``precompute_coeffs`` and ``normalize_coeffs_8bpc`` of Resample.c
    for the whole input: ``(bounds (out, 2) [first, count], int32 weights
    (out, ksize), 0 past each count)``.  Scalar float64 arithmetic in C's order, with the C
    library's ``sin`` (``math.sin``), so each weight rounds as Pillow's."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    weights = np.zeros((out_size, ksize), np.int32)
    ss = 1.0 / filterscale
    one = float(1 << _PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        for x, w in enumerate(k):
            w = w / ww if ww != 0.0 else w
            # (int) truncates toward zero after the signed half is added.
            weights[xx, x] = int(-0.5 + w * one) if w < 0 else int(0.5 + w * one)
        bounds[xx] = xmin, xmax
    return bounds, weights


def _resample_axis(img: np.ndarray, axis: int, bounds: np.ndarray,
                   weights: np.ndarray) -> np.ndarray:
    """One pass of ``ImagingResample{Horizontal,Vertical}_8bpc`` along
    ``axis`` of an ``(H, W, C)`` uint8 image: int32 sums (C's ``int``)
    from 1 << 21, shifted down by 22 and clipped to uint8."""
    src = np.moveaxis(img, axis, 0).astype(np.int32)
    acc = np.full((weights.shape[0],) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    for x in range(weights.shape[1]):
        # Taps past a count weigh 0; clamp their index to stay in the image.
        idx = np.minimum(bounds[:, 0] + x, src.shape[0] - 1)
        acc += src[idx] * weights[:, x].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_lanczos_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``PIL.Image.resize((width, height), Image.LANCZOS)`` of an 8-bit
    ``(H, W, C)`` (or ``(H, W)``) image, bit for bit: the horizontal pass
    first, over the rows the vertical pass reads, into a clipped uint8
    image, then the vertical pass (``ImagingResampleInner``)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_lanczos_u8 takes uint8 images, got {img.dtype}")
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    in_h, in_w = img.shape[:2]
    if width < 1 or height < 1:
        raise ValueError(f"resize to {width}x{height}")
    bounds_h, weights_h = _lanczos_coeffs(in_w, width)
    bounds_v, weights_v = _lanczos_coeffs(in_h, height)
    if width != in_w:
        first = int(bounds_v[0, 0])
        last = int(bounds_v[-1, 0] + bounds_v[-1, 1])
        img = _resample_axis(img[first:last], 1, bounds_h, weights_h)
        bounds_v = bounds_v - np.array([first, 0])
    if height != in_h:
        img = _resample_axis(img, 0, bounds_v, weights_v)
    return img[..., 0] if squeeze else img
