"""Coarse-to-fine frequency anneal of the position encoding, as a weight
fold.

Counterpart of ``nerf_keras_tpu/ops/freq_anneal.py`` (``FREQ_ANNEAL_STEPS``;
FreeNeRF's schedule with the Nerfies eq. 8 ease).  For the first
``FREQ_ANNEAL_STEPS`` optimizer steps the high octaves of the position
encoding are masked and eased in one by one.  The window is not applied
to the encodings: since ``relu((x_enc * w) @ W) == relu(x_enc @ (diag(w)
W))`` it scales the inputs of the matrices that read the encoding: every
input of ``trunk[0]``, and the trailing ``xyz_dim`` inputs of each trunk
layer and head (sigma, feature) that reads the ``[h, x_enc]`` skip
concat; the proposal net's first layer with ``PROP_L_XYZ`` octaves.  So
the kernels (K1/K2/K4) run unchanged on folded weights.

``nn.Linear`` keeps ``weight`` as ``(out, in)``: the JAX package's rows of
``w (in, out)`` are the port's columns.  A fold is a per-column scale
``s``; ``fold_scales`` lists ``(weight, s)`` for each folded matrix, and
``fold_train_params`` returns folded copies of the models (eval, render,
int8 calibration, distillation and the artifact digest read those; the
eval and render functions refuse anything else under an anneal).  The
train step folds in place and scales the gradients (``engine/step.py``).
Past the horizon the window is all ones and the fold the identity.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
from torch import nn

from nerf_keras_tpu_torch.models.mlp import NeRFMLP, head_input_dim, trunk_input_dims
from nerf_keras_tpu_torch.ops.proposal import chain_nets
from nerf_keras_tpu_torch.parallel.mesh import shard


def freq_window(num_freqs: int, alpha: float, device=None) -> torch.Tensor:
    """The ``(3 + 6 L,)`` float32 window over the position encoding's
    layout ``[x, sin_0, cos_0, ..., sin_{L-1}, cos_{L-1}]`` (blocks of 3):
    the identity block is 1, octave ``j`` is ``0.5 (1 - cos(pi clip(alpha
    L - j, 0, 1)))``; ``alpha >= 1`` opens every octave."""
    ident = torch.ones((3,), dtype=torch.float32, device=device)
    if num_freqs == 0:
        return ident
    j = torch.arange(num_freqs, dtype=torch.float32, device=device)
    alpha = torch.tensor(alpha, dtype=torch.float32, device=device)
    band = torch.clamp(alpha * num_freqs - j, 0.0, 1.0)
    w = 0.5 * (1.0 - torch.cos(math.pi * band))
    # Each octave is a sin block then a cos block, 3 wide each.
    return torch.cat([ident, torch.repeat_interleave(w, 6)])


def anneal_alpha(step: int, horizon: int) -> float:
    """Anneal progress in [0, 1] at optimizer ``step`` of a
    ``horizon``-step anneal (float32 arithmetic, as the JAX package)."""
    return float(np.clip(np.float32(step) / np.float32(horizon), 0.0, 1.0))


def window_is_identity(cfg, step: int) -> bool:
    """True where folding changes nothing: no anneal (``FREQ_ANNEAL_STEPS``
    0), or ``step`` at or past the horizon, where every scale is 1."""
    return cfg.freq_anneal_steps <= 0 or step >= cfg.freq_anneal_steps


def fold_nerf_params(mlp: NeRFMLP, w_xyz: torch.Tensor) -> list[tuple[nn.Parameter,
                                                                     torch.Tensor]]:
    """``(weight, column scale)`` for each matrix of one NeRF MLP that
    reads the position encoding: all of ``trunk[0]``'s inputs, and the
    trailing ``xyz_dim`` inputs of any trunk layer or sigma/feature head
    whose input is the ``hidden + xyz_dim`` skip concat.  The direction
    encoding is not annealed.  On a model rank of a split MLP a row-split
    layer's scale is its block of the inputs' (``trunk[0]`` reads the whole
    encoding: it is column-split or whole)."""
    nx = w_xyz.shape[0]
    hidden = mlp.hidden_dim
    skip_scale = torch.cat([torch.ones((hidden,), dtype=w_xyz.dtype, device=w_xyz.device),
                            w_xyz])
    widths = [*trunk_input_dims(mlp.num_layers, hidden, mlp.skip_layer, nx),
              *[head_input_dim(mlp.num_layers, hidden, mlp.skip_layer, nx)] * 2]
    layers = [*mlp.trunk, mlp.sigma, mlp.feature]
    out = [(mlp.trunk[0].weight, w_xyz)]
    for layer, kind, width in zip(layers[1:], mlp.kinds[1:], widths[1:]):
        if width == hidden + nx:
            out.append((layer.weight, shard(skip_scale, 0 if kind == "row" else None,
                                            mlp.tp)))
    return out


def fold_proposal_params(prop: nn.Module, w_xyz: torch.Tensor) -> list[
        tuple[nn.Parameter, torch.Tensor]]:
    """``(weight, column scale)`` of the first layer of each proposal net
    of a chain (every level reads the same ``PROP_L_XYZ`` encoding)."""
    return [(net.layers[0].weight, w_xyz) for net in chain_nets(prop)]


def fold_scales(cfg, models: dict[str, nn.Module], step: int) -> list[
        tuple[nn.Parameter, torch.Tensor]]:
    """Every ``(weight, column scale)`` of the window at ``step`` over
    ``{'coarse', 'fine'}`` or ``{'proposal', 'fine'}``, each net with its
    own octave count; empty where the fold is the identity
    (:func:`window_is_identity`)."""
    if window_is_identity(cfg, step):
        return []
    alpha = anneal_alpha(step, cfg.freq_anneal_steps)
    out = []
    for name, model in models.items():
        device = next(model.parameters()).device
        if name == "proposal":
            out += fold_proposal_params(model, freq_window(cfg.prop_l_xyz, alpha,
                                                           device=device))
        else:
            out += fold_nerf_params(model, freq_window(cfg.l_xyz, alpha, device=device))
    return out


class FoldedModels(dict):
    """``{name: model}`` with the window at ``step`` folded in, as
    :func:`fold_train_params` returns them.  The eval and render functions
    of ``engine/step.py`` take only these under ``FREQ_ANNEAL_STEPS``
    (:func:`require_folded`), so the fold has one owner."""

    def __init__(self, models: dict[str, nn.Module], step: int):
        super().__init__(models)
        self.step = step


def require_folded(cfg, models) -> None:
    """Refuse raw models where the config anneals: rendering them would
    silently drop the window."""
    if cfg.freq_anneal_steps > 0 and not isinstance(models, FoldedModels):
        raise ValueError(
            "FREQ_ANNEAL_STEPS > 0: render and evaluate the models that "
            "ops/freq_anneal.fold_train_params(cfg, models, step) returns"
        )


@torch.no_grad()
def fold_train_params(cfg, models: dict[str, nn.Module], step: int) -> FoldedModels:
    """Folded copies (no gradients) of ``models`` at ``step``; the models
    themselves where the fold is the identity (:func:`window_is_identity`)."""
    if window_is_identity(cfg, step):
        return FoldedModels(models, step)
    out = {k: copy.deepcopy(m).requires_grad_(False) for k, m in models.items()}
    for weight, scale in fold_scales(cfg, out, step):
        weight.mul_(scale[None, :])
    return FoldedModels(out, step)
