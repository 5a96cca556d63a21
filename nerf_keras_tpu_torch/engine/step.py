"""The render function for a flat ray batch (coarse sampler, float path).

Counterpart of ``make_render_fn`` and ``_make_fused_eval_forward`` in
``nerf_keras_tpu/engine/step.py``: coarse K1 over centered t-values,
``sample_pdf`` with deterministic u on the detached coarse weights,
``sorted_union``, fine K1 over the union, depth as ``sum(w * t)``, and
``white_bkgd`` compositing.  PyTorch runs eagerly, so there is nothing to
compile: the function is plain Python around the two K1 launches.
"""

from __future__ import annotations

from typing import Callable

import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu_torch.ops.kernels.fused_render import render_rays_fused
from nerf_keras_tpu_torch.ops.sampling import (
    generate_t_vals,
    sample_pdf,
    sorted_union,
)
from nerf_keras_tpu_torch.ops.volume import composite_background
from nerf_keras_tpu_torch.utils.checkpoint import check_render_support


def _make_fused_eval_forward(cfg: NeRFConfig) -> Callable:
    """``forward(models, origins, dirs, t_vals) -> dict`` with rgb, depth
    and weights of both passes, each pass one K1 launch on CUDA."""

    def render_pass(mlp, origins, dirs, t_vals):
        return render_rays_fused(
            mlp, origins, dirs, t_vals,
            l_xyz=cfg.l_xyz, l_dir=cfg.l_dir, skip_layer=cfg.skip_layer,
        )

    def forward(models, origins, dirs, t_vals):
        rgb_coarse, w_coarse = render_pass(models["coarse"], origins, dirs, t_vals)
        depth_coarse = torch.sum(w_coarse * t_vals, dim=-1)

        t_mid = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        t_fine = sample_pdf(t_mid, w_coarse.detach(), cfg.ns_fine,
                            deterministic=True)
        t_all = sorted_union(t_vals, t_fine).contiguous()

        rgb_fine, w_fine = render_pass(models["fine"], origins, dirs, t_all)
        depth_fine = torch.sum(w_fine * t_all, dim=-1)
        if cfg.white_bkgd:
            rgb_coarse = composite_background(rgb_coarse, w_coarse)
            rgb_fine = composite_background(rgb_fine, w_fine)
        return {
            "rgb_coarse": rgb_coarse,
            "rgb_fine": rgb_fine,
            "depth_coarse": depth_coarse,
            "depth_fine": depth_fine,
            "weights_coarse": w_coarse,
            "weights_fine": w_fine,
        }

    return forward


def make_render_fn(cfg: NeRFConfig, near: float, far: float) -> Callable:
    """``render(models, origins, dirs) -> dict`` of rgb/depth for the
    coarse and fine passes; ``models`` is ``{'coarse': NeRFMLP, 'fine':
    NeRFMLP}`` and the rays are ``(B, 3)`` tensors on one device."""
    check_render_support(cfg)
    forward = _make_fused_eval_forward(cfg)

    def render(models, origins, dirs):
        t_vals = generate_t_vals(
            near, far, origins.shape[:-1], cfg.ns_coarse, "center",
            device=origins.device,
        ).contiguous()
        out = forward(models, origins, dirs, t_vals)
        return {
            k: out[k]
            for k in ("rgb_coarse", "rgb_fine", "depth_coarse", "depth_fine")
        }

    return render
