"""Volume rendering: alpha compositing with cumulative transmittance.

Counterpart of ``nerf_keras_tpu/ops/volume.py``: sigmoid on rgb, relu on
sigma, a 1e10 terminal delta, and the epsilon inside the exclusive
product ``cumprod(1 - alpha + 1e-10)``.
"""

from __future__ import annotations

import torch

_EPS = 1e-10
_TERMINAL_DELTA = 1e10


def volume_render(
    preds: torch.Tensor, t_vals: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite raw ``(..., S, 4)`` MLP outputs (``[:3]`` rgb logits,
    ``[3]`` density) along ``(..., S)`` distances.

    Returns ``(rgb (..., 3), depth (...,), weights (..., S))``.
    """
    preds = preds.to(torch.float32)
    t_vals = t_vals.to(torch.float32)
    rgb = torch.sigmoid(preds[..., :3])
    sigma = torch.relu(preds[..., 3])

    delta = torch.diff(t_vals, dim=-1)
    delta = torch.cat(
        [delta, torch.full_like(delta[..., :1], _TERMINAL_DELTA)], dim=-1
    )
    alpha = 1.0 - torch.exp(-sigma * delta)

    trans = torch.cumprod(1.0 - alpha + _EPS, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)

    weights = alpha * trans
    rgb_out = torch.sum(weights[..., None] * rgb, dim=-2)
    depth = torch.sum(weights * t_vals, dim=-1)
    return rgb_out, depth, weights


def composite_background(
    rgb: torch.Tensor, weights: torch.Tensor, bkgd: float = 1.0
) -> torch.Tensor:
    """Compose a black-composited ray color onto a solid background:
    ``c + (1 - sum_s w_s) * bkgd``."""
    acc = torch.sum(weights, dim=-1, keepdim=True)
    return rgb + (1.0 - acc) * bkgd
