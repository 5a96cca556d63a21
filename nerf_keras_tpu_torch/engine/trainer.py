"""Trainer: owns the coarse+fine models and renders frames from them.

Counterpart of ``nerf_keras_tpu/engine/trainer.py``, render half only:
``restore``, ``replace_params``, ``eval_params``, ``pose_rays``,
``render_rays`` and ``render_image``.  Training methods arrive in later
PRs.  One device, no mesh: ``device`` is resolved explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu_torch.engine.step import make_render_fn
from nerf_keras_tpu_torch.models.mlp import NeRFMLP
from nerf_keras_tpu_torch.ops.rays import get_rays
from nerf_keras_tpu_torch.runtime import resolve_device
from nerf_keras_tpu_torch.utils.checkpoint import (
    check_render_support,
    load_checkpoint,
)

_MODELS = ("coarse", "fine")


def rgb_to_u8(rgb: torch.Tensor) -> torch.Tensor:
    """[0,1] f32 -> uint8 on the device: clip*255 then a truncating cast,
    exactly the host-side ``utils/image.to_uint8``."""
    return torch.clamp(255.0 * rgb, 0.0, 255.0).to(torch.uint8)


class Trainer:
    """Owns the models for one (config, scene-bounds) pair on one device."""

    def __init__(
        self,
        cfg: NeRFConfig,
        near: float,
        far: float,
        device: str | torch.device | None = None,
    ):
        check_render_support(cfg)
        self.cfg = cfg
        self.near = float(near)
        self.far = float(far)
        self.device = resolve_device(None if device is None else str(device))
        self.step = 0
        gen = torch.Generator().manual_seed(cfg.seed)
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

        def build() -> dict[str, NeRFMLP]:
            return {
                name: NeRFMLP(
                    num_layers=cfg.num_layers, hidden_dim=cfg.hidden_dim,
                    skip_layer=cfg.skip_layer, l_xyz=cfg.l_xyz, l_dir=cfg.l_dir,
                    batch_norm=cfg.batch_norm, compute_dtype=dtype,
                    generator=gen, device=self.device,
                ).eval().requires_grad_(False)
                for name in _MODELS
            }

        self.params = build()
        # The EMA shadow (EMA_DECAY > 0) serves every render, as in the JAX
        # package's Trainer._eval_state.
        self.ema = build() if cfg.ema_decay > 0 else None
        if self.ema is not None:
            self._load(self.ema, self._jax_tree(self.params))
        self._render = make_render_fn(cfg, self.near, self.far)

    @staticmethod
    def _jax_tree(models: dict[str, NeRFMLP]) -> dict:
        return {name: mlp.to_jax_params() for name, mlp in models.items()}

    @staticmethod
    def _load(models: dict[str, NeRFMLP], tree: dict) -> None:
        for name in _MODELS:
            models[name].load_jax_params(tree[name])

    def restore(self, path: str) -> "Trainer":
        """Load a ``.ckpt.npz`` (JAX key format) into this trainer.  With
        EMA on, a checkpoint without a shadow seeds it from its params
        (the JAX package's forward-compat rule)."""
        ckpt = load_checkpoint(path)
        check_render_support(self.cfg, step=ckpt["step"])
        self._load(self.params, ckpt["params"])
        if self.ema is not None:
            self._load(self.ema, ckpt["ema"] if ckpt["ema"] is not None
                       else ckpt["params"])
        self.step = ckpt["step"]
        return self

    def replace_params(self, params: dict) -> "Trainer":
        """Install externally built ``{'coarse', 'fine'}`` JAX-layout
        params.  With EMA on, the shadow resets to the new params."""
        self._load(self.params, params)
        if self.ema is not None:
            self._load(self.ema, params)
        return self

    @property
    def eval_params(self) -> dict[str, NeRFMLP]:
        """Models every render consumes (the EMA shadow when enabled)."""
        return self.ema if self.ema is not None else self.params

    # ------------------------------------------------------------------
    def pose_rays(
        self, pose: np.ndarray, height: int, width: int, focal: float
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Flat ``(H*W, 3)`` ray origins and directions on the device."""
        origins, dirs = get_rays(height, width, focal, pose, device=self.device)
        return (origins.reshape(-1, 3).contiguous(),
                dirs.reshape(-1, 3).contiguous())

    @torch.inference_mode()
    def render_rays(
        self,
        origins,
        directions,
        chunk: int = 16384,
        keys: tuple[str, ...] | None = None,
        uint8_rgb: bool = False,
    ) -> dict[str, np.ndarray]:
        """Render a flat ray batch in fixed-size chunks.

        The last chunk is padded with dummy forward-facing rays so every
        chunk has one shape; their outputs are dropped.  ``keys``
        restricts the outputs kept; ``uint8_rgb`` converts rgb maps to
        uint8 on the device before the one copy to the host.
        """
        origins = torch.as_tensor(origins, dtype=torch.float32, device=self.device)
        directions = torch.as_tensor(directions, dtype=torch.float32,
                                     device=self.device)
        n = origins.shape[0]
        chunk = min(chunk, max(n, 1))
        num_chunks = (n + chunk - 1) // chunk
        total_pad = num_chunks * chunk - n
        if total_pad:
            pad_dirs = torch.zeros((total_pad, 3), dtype=torch.float32,
                                   device=self.device)
            pad_dirs[:, 2] = -1.0
            origins = torch.cat([origins, torch.zeros_like(pad_dirs)], dim=0)
            directions = torch.cat([directions, pad_dirs], dim=0)
        origins = origins.contiguous()
        directions = directions.contiguous()

        models = self.eval_params
        outs: dict[str, list] = {}
        for start in range(0, n, chunk):
            keep = min(chunk, n - start)
            res = self._render(models, origins[start:start + chunk],
                               directions[start:start + chunk])
            for k, v in res.items():
                if keys is not None and k not in keys:
                    continue
                part = v[:keep]
                if uint8_rgb and k.startswith("rgb"):
                    part = rgb_to_u8(part)
                outs.setdefault(k, []).append(part)
        return {k: torch.cat(v, dim=0).cpu().numpy() for k, v in outs.items()}

    def render_image(
        self, pose: np.ndarray, height: int, width: int, focal: float,
        chunk: int = 16384, include_coarse: bool = False,
        uint8_rgb: bool = False, need_depth: bool = True,
    ) -> dict[str, np.ndarray]:
        """Render one frame from a camera pose; returns HxW maps."""
        origins, dirs = self.pose_rays(pose, height, width, focal)
        if include_coarse:
            keys = None
        elif need_depth:
            keys = ("rgb_fine", "depth_fine")
        else:
            keys = ("rgb_fine",)
        out = self.render_rays(origins, dirs, chunk=chunk, keys=keys,
                               uint8_rgb=uint8_rgb)
        result = {"rgb": out["rgb_fine"].reshape(height, width, 3)}
        if "depth_fine" in out:
            result["depth"] = out["depth_fine"].reshape(height, width)
        if include_coarse:
            result["rgb_coarse"] = out["rgb_coarse"].reshape(height, width, 3)
            result["depth_coarse"] = out["depth_coarse"].reshape(height, width)
        return result
