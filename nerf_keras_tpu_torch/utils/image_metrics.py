"""Frame metrics: SSIM, PSNR and the accelerated render paths' gate.

Counterpart of ``nerf_keras_tpu/utils/image_metrics.py``.  ``ssim`` is
Wang et al. 2004 with ``tf.image.ssim``'s constants and window (an 11x11
Gaussian of sigma 1.5 applied as two separable sweeps, VALID padding,
k1=0.01, k2=0.03, biased moments), pinned by
``tests/fixtures/ssim_golden.npz``; ``frame_psnr`` and ``accuracy_gate``
are numpy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(size: int, sigma: float) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-0.5 * torch.square(x / sigma))
    return g / torch.sum(g)


def _filter2d(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise separable filter of ``(B, C, H, W)``, VALID padding."""
    c, k = x.shape[1], win.shape[0]
    x = F.conv2d(x, win.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, win.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ssim(a, b, max_val: float = 1.0, *, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM of ``(H, W, C)`` or ``(B, H, W, C)`` image pairs (numpy
    arrays or tensors) in ``[0, max_val]``: a 0-d tensor for one pair, ``(B,)``
    for a batch, averaged over the VALID-cropped map and the channels."""
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b).to(device=a.device, dtype=torch.float32)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.ndim not in (3, 4):
        raise ValueError(f"expected (H,W,C) or (B,H,W,C), got {tuple(a.shape)}")
    if min(a.shape[-3], a.shape[-2]) < filter_size:
        raise ValueError(f"images {tuple(a.shape)} smaller than the {filter_size}x"
                         f"{filter_size} SSIM window")
    single = a.ndim == 3
    if single:
        a, b = a[None], b[None]
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    win = _gaussian_window(filter_size, filter_sigma).to(a.device)
    mu_a, mu_b = _filter2d(a, win), _filter2d(b, win)
    var_a = _filter2d(a * a, win) - mu_a * mu_a
    var_b = _filter2d(b * b, win) - mu_b * mu_b
    cov = _filter2d(a * b, win) - mu_a * mu_b
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    luminance = (2.0 * mu_a * mu_b + c1) / (mu_a * mu_a + mu_b * mu_b + c1)
    cs = (2.0 * cov + c2) / (var_a + var_b + c2)
    out = torch.mean(luminance * cs, dim=(1, 2, 3))
    return out[0] if single else out


def frame_psnr(ref, test, max_val: float = 1.0) -> float:
    """PSNR between two rendered frames as a float: ``inf`` for identical
    frames; a NaN propagates (a NaN comparison fails the gate)."""
    ref = np.asarray(ref, np.float32)
    test = np.asarray(test, np.float32)
    mse = float(np.mean((ref - test) ** 2))
    if mse == 0.0:
        return float("inf")
    return float(20.0 * np.log10(max_val) - 10.0 * np.log10(mse))


def accuracy_gate(ref, test, gate_db: float, label: str,
                  fallback: str) -> tuple[bool, float]:
    """Accept an accelerated render when ``PSNR(test vs ref) >= gate_db``
    on the same frame; print the verdict.  Returns ``(passed, psnr_db)``."""
    value = frame_psnr(ref, test)
    if value >= gate_db:  # NaN compares False -> fail
        print(f"[nerf-torch] {label} gate PASS: {value:.1f} dB (gate {gate_db:.1f})")
        return True, value
    print(f"[nerf-torch] {label} gate FAIL: {value:.1f} dB < {gate_db:.1f}; {fallback}")
    return False, value
