"""K1, the ray megakernel: rays -> points -> encoding -> MLP -> composite.

Counterpart of ``render_rays_fused`` in
``nerf_keras_tpu/ops/pallas/fused_render.py`` (the forward of the TPU
kernel ``_fwd_encode_kernel``).  The CUDA kernel is
``csrc/fused_render_fwd.cu``; its source note says what bounds it and
how the design answers.

* :func:`render_rays_reference` is the plain PyTorch version: encode ->
  :class:`NeRFMLP` -> ``volume_render``, with the bf16 rounding where the
  kernel has it.
* :func:`render_rays_fused` takes the plain version for a tensor on the
  CPU, and only then.  For a CUDA tensor it launches the kernel or
  raises; nothing falls back.  Each launch adds one to :data:`launches`.

The kernel is forward only: its outputs carry no gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nerf_keras_tpu_torch.models.mlp import NeRFMLP
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.kernels import _build
from nerf_keras_tpu_torch.ops.rays import sample_rays
from nerf_keras_tpu_torch.ops.volume import volume_render

# Kernel launches in this process (one per successful launch).
launches = 0

# Within every 16-wide k-group, W^T columns are stored in this order so a
# thread's mma.sync B fragment (k = 2t, 2t+1, 2t+8, 2t+9) is one 8-byte load.
_K_INTERLEAVE = torch.tensor([0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15])


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class KernelPack(NamedTuple):
    """An MLP's weights as the kernel reads them."""

    w: torch.Tensor      # bf16, every layer's padded, interleaved W^T
    b: torch.Tensor      # f32, every layer's padded bias
    desc: np.ndarray     # int32 (n_dense, 5): k_pad, n, n_pad, w_off, b_off


def _dense_layers(mlp: NeRFMLP) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``(W^T (out, in), b)`` per kernel layer: the trunk, the merged
    feature+sigma head (feature columns first, sigma last), branch, rgb."""
    layers = [(layer.weight, layer.bias) for layer in mlp.trunk]
    layers.append((
        torch.cat([mlp.feature.weight, mlp.sigma.weight], dim=0),
        torch.cat([mlp.feature.bias, mlp.sigma.bias], dim=0),
    ))
    layers += [(mlp.branch.weight, mlp.branch.bias),
               (mlp.rgb.weight, mlp.rgb.bias)]
    return layers


@torch.no_grad()
def pack_weights(mlp: NeRFMLP, device: torch.device) -> KernelPack:
    """Pad and interleave the MLP's weights into the kernel's layout."""
    ws, bs, desc = [], [], []
    w_off = b_off = 0
    for wt, b in _dense_layers(mlp):
        n, k = wt.shape
        k_pad, n_pad = _round_up(k, 16), _round_up(n, 8)
        wp = torch.zeros((n_pad, k_pad), dtype=torch.float32, device=device)
        wp[:n, :k] = wt.to(device=device, dtype=torch.float32)
        wp = wp.reshape(n_pad, k_pad // 16, 16)[..., _K_INTERLEAVE.to(device)]
        bp = torch.zeros((n_pad,), dtype=torch.float32, device=device)
        bp[:n] = b.to(device=device, dtype=torch.float32)
        ws.append(wp.reshape(-1).to(torch.bfloat16))
        bs.append(bp)
        desc.append((k_pad, n, n_pad, w_off, b_off))
        w_off += n_pad * k_pad
        b_off += n_pad
    return KernelPack(
        w=torch.cat(ws).contiguous(), b=torch.cat(bs).contiguous(),
        desc=np.ascontiguousarray(np.asarray(desc, dtype=np.int32)),
    )


def kernel_pack(mlp: NeRFMLP, device: torch.device) -> KernelPack:
    """The cached pack of ``mlp`` for ``device``: built once per installed
    set of weights (a parameter written in place or replaced, or another
    device, builds a new one), not once per chunk."""
    key = (str(device), tuple((p.data_ptr(), p._version) for p in mlp.parameters()))
    cached = getattr(mlp, "_k1_pack", None)
    if cached is None or cached[0] != key:
        cached = (key, pack_weights(mlp, device))
        mlp._k1_pack = cached
    return cached[1]


def _check_args(mlp: NeRFMLP, l_xyz: int, l_dir: int, skip_layer: int) -> None:
    if (l_xyz, l_dir, skip_layer) != (mlp.l_xyz, mlp.l_dir, mlp.skip_layer):
        raise ValueError(
            f"l_xyz/l_dir/skip_layer = {(l_xyz, l_dir, skip_layer)} do not "
            f"match the MLP's {(mlp.l_xyz, mlp.l_dir, mlp.skip_layer)}"
        )


def render_rays_reference(
    mlp: NeRFMLP,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    t_vals: torch.Tensor,
    *,
    l_xyz: int = 10,
    l_dir: int = 4,
    skip_layer: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: ``(rgb (B, 3), weights (B, S))`` float32."""
    _check_args(mlp, l_xyz, l_dir, skip_layer)
    b, s = t_vals.shape
    points, _ = sample_rays(origins, dirs, t_vals)
    x_enc = encode_position(points, l_xyz)
    d_enc = encode_position(dirs, l_dir)[:, None, :].expand(b, s, -1)
    preds = mlp(x_enc, d_enc)
    rgb, _, weights = volume_render(preds, t_vals)
    return rgb, weights


def _check_tensor(name: str, x: torch.Tensor, shape: tuple, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def render_rays_fused(
    mlp: NeRFMLP,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    t_vals: torch.Tensor,
    *,
    l_xyz: int = 10,
    l_dir: int = 4,
    skip_layer: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 over raw rays: ``origins``/``dirs`` ``(B, 3)``, ``t_vals``
    ``(B, S)`` ascending -> ``(rgb (B, 3), weights (B, S))`` float32.

    CPU tensors take :func:`render_rays_reference`.  CUDA tensors launch
    the kernel (bf16 MLPs only) or raise.
    """
    global launches
    if origins.device.type == "cpu":
        return render_rays_reference(
            mlp, origins, dirs, t_vals,
            l_xyz=l_xyz, l_dir=l_dir, skip_layer=skip_layer,
        )
    if origins.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, got {origins.device}")
    _check_args(mlp, l_xyz, l_dir, skip_layer)
    if mlp.compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            f"K1 on CUDA runs bf16 MLPs only; COMPUTE_DTYPE="
            f"{mlp.compute_dtype} is not ported to the kernel yet"
        )
    device = origins.device
    if t_vals.dim() != 2:
        raise ValueError(f"t_vals must be (B, S), got {tuple(t_vals.shape)}")
    b, s = t_vals.shape
    _check_tensor("origins", origins, (b, 3), device)
    _check_tensor("dirs", dirs, (b, 3), device)
    _check_tensor("t_vals", t_vals, (b, s), device)
    for p in mlp.parameters():
        if p.device != device:
            raise ValueError(f"MLP parameters are on {p.device}, rays on {device}")
    rgb = torch.empty((b, 3), dtype=torch.float32, device=device)
    weights = torch.empty((b, s), dtype=torch.float32, device=device)
    if b == 0:
        return rgb, weights
    pack = kernel_pack(mlp, device)
    lib = _build.load()
    rc = lib.nkt_fused_render_fwd(
        origins.data_ptr(), dirs.data_ptr(), t_vals.data_ptr(),
        pack.w.data_ptr(), pack.b.data_ptr(), pack.desc.ctypes.data,
        pack.desc.shape[0], mlp.num_layers, mlp.skip_layer, mlp.hidden_dim,
        l_xyz, l_dir, b, s, rgb.data_ptr(), weights.data_ptr(),
        device.index if device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"K1 launch failed with CUDA error {rc} (B={b}, S={s}, "
            f"hidden={mlp.hidden_dim}, layers={mlp.num_layers})"
        )
    launches += 1
    return rgb, weights
