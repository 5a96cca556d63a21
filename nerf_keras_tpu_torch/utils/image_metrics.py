"""Frame metrics for the accelerated render paths' accuracy gate.

Counterpart of ``frame_psnr`` and ``accuracy_gate`` in
``nerf_keras_tpu/utils/image_metrics.py`` (numpy; SSIM is not ported).
"""

from __future__ import annotations

import numpy as np


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
