"""Sinusoidal (Fourier-feature) positional encoding.

Counterpart of ``nerf_keras_tpu/ops/encoding.py``.  Feature layout is
``[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{L-1} x), cos(2^{L-1} x)]``
with blocks of width D, so the width is ``D + 2*D*L`` (63 for D=3,
L=10; 27 for D=3, L=4).  Computed in float32: the top octave's argument
is ``2^9 * |x|``, thousands of radians, where a lower precision loses the
phase.
"""

from __future__ import annotations

import torch


def encode_position(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """Fourier-encode ``(..., D)`` coordinates to ``(..., D + 2*D*L)``."""
    if num_freqs == 0:
        return x
    d = x.shape[-1]
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * freqs[:, None]  # (..., L, D)
    sincos = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    sincos = sincos.reshape(*x.shape[:-1], 2 * num_freqs * d)
    return torch.cat([x, sincos], dim=-1)


def encoded_width(d: int, num_freqs: int) -> int:
    """Output feature width for ``d``-dim input and L octaves."""
    return d + 2 * d * num_freqs
