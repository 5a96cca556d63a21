"""K5, the NeRF MLP over precomputed encodings, forward and backward.

Counterpart of ``apply_nerf_mlp_pallas`` in
``nerf_keras_tpu/ops/pallas/fused_mlp.py`` (``_fwd_kernel`` and
``_bwd_kernel``).  The CUDA kernels run on Hopper's wgmma MLP
(``csrc/nerf_wgmlp.cuh``): the forward is ``csrc/fused_mlp_fwd.cu``, the
backward the rows kernel's K5 mode of ``csrc/fused_render_bwd.cu`` with
``csrc/nerf_dw.cuh``'s dW product, over chunks of samples whose workspace
holds ``DW_CHUNK_BYTES`` at most (``fused_render.launch_rows``).  They
reuse K1's weight pack and K2's transposed pack (with input gradients,
a transposed pack of every input column, cached apart) with their
per-optimizer-step cache.  Hidden widths 64, 128 and 256 only; input
gradients also need encodings that pad to the kernel's 64 x_enc and 32
d_enc gradient columns (L_XYZ 9 or 10, L_DIR 4: every shipped config).

* The plain version of the forward is :meth:`NeRFMLP.forward`, which
  rounds to bf16 where the kernel does; :func:`apply_nerf_mlp_reference_vjp`
  is the plain backward (autograd of it).
* :func:`apply_nerf_mlp_fused` takes the plain version for a tensor on the
  CPU, and only then.  For a CUDA tensor it launches K5 or raises; nothing
  falls back.  With grad enabled it is a ``torch.autograd.Function``: K5's
  forward, then K5's backward.  Each forward launch adds one to
  :data:`launches`, each backward launch one to :data:`bwd_launches`.

Cotangents come back as the JAX kernel returns them: weight gradients
rounded to bf16, bias gradients f32, encoding gradients in the encodings'
dtype.  The encodings get a gradient only with ``need_input_grads`` (the
``STOP_PDF_GRADIENT=false`` mode); the kernel then computes it for each
encoding that requires one (the coarse pass's encodings, built from
t-values with no gradient, do not, so its backward skips those products).
"""

from __future__ import annotations

import torch

from nerf_keras_tpu_torch.models.mlp import NeRFMLP
from nerf_keras_tpu_torch.ops.kernels import _build
from nerf_keras_tpu_torch.ops.kernels.fused_render import (
    _ROWS_K5,
    _check_hidden,
    check_tensor,
    device_index,
    kernel_pack,
    launch_rows,
    unpack_grads,
)

# Kernel launches in this process (one per successful launch).
launches = 0      # K5 forward
bwd_launches = 0  # K5 backward

# The gradient columns of the encodings in K5's input-gradient products
# (csrc/nerf_wgmlp.cuh: kXCols, kDCols): x_enc's padded to 8 must be 64
# wide (L_XYZ 10), d_enc's 32 (L_DIR 4).
_IG_COLS = (64, 32)


def apply_nerf_mlp_reference_vjp(
    mlp: NeRFMLP,
    x_enc: torch.Tensor,
    d_enc: torch.Tensor,
    g: torch.Tensor,
    need_input_grads: bool = True,
) -> tuple[list[torch.Tensor], torch.Tensor | None, torch.Tensor | None]:
    """Plain K5 backward: the gradients of ``<mlp(x_enc, d_enc), g>`` with
    respect to ``mlp.parameters()`` (in that order) and, with
    ``need_input_grads``, to the encodings (summed in f32, returned in the
    encodings' dtype), by autograd of :meth:`NeRFMLP.forward`."""
    params = list(mlp.parameters())
    x = x_enc.detach().float().requires_grad_(need_input_grads)
    d = d_enc.detach().float().requires_grad_(need_input_grads)
    with torch.enable_grad():
        preds = mlp(x, d)
        inputs = params + ([x, d] if need_input_grads else [])
        grads = list(torch.autograd.grad([preds], inputs, [g]))
    if not need_input_grads:
        return grads, None, None
    return grads[:-2], grads[-2].to(x_enc.dtype), grads[-1].to(d_enc.dtype)


def _check_cuda_call(mlp: NeRFMLP, x_enc: torch.Tensor, d_enc: torch.Tensor) -> None:
    device = x_enc.device
    if device.type != "cuda":
        raise ValueError(f"K5 runs on cuda or cpu tensors, got {device}")
    if mlp.compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            f"K5 on CUDA runs bf16 MLPs only; COMPUTE_DTYPE={mlp.compute_dtype} "
            "is not ported to the kernels yet"
        )
    n = x_enc.shape[0]
    check_tensor("x_enc", x_enc, (n, mlp.xyz_dim), device, torch.bfloat16)
    check_tensor("d_enc", d_enc, (n, mlp.dir_dim), device, torch.bfloat16)
    for p in mlp.parameters():
        if p.device != device:
            raise ValueError(f"MLP parameters are on {p.device}, encodings on {device}")
    _check_hidden(mlp)


def _grid(device: torch.device, n: int) -> int:
    """One block per SM at most, striding over the 128-row tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n // 128), sms))


def launch_k5_fwd(mlp: NeRFMLP, x_enc: torch.Tensor, d_enc: torch.Tensor) -> torch.Tensor:
    """One K5 forward launch over ``(N, xyz_dim)``/``(N, dir_dim)`` bf16
    encodings: raw predictions ``(N, 4)`` f32."""
    global launches
    _check_cuda_call(mlp, x_enc, d_enc)
    device = x_enc.device
    n = x_enc.shape[0]
    preds = torch.empty((n, 4), dtype=torch.float32, device=device)
    if n == 0:
        return preds
    pack = kernel_pack(mlp, device)
    rc = _build.load("fused_mlp_fwd").nkt_fused_mlp_fwd(
        x_enc.data_ptr(), d_enc.data_ptr(), pack.w.data_ptr(), pack.b.data_ptr(),
        pack.desc.ctypes.data, pack.desc.shape[0], mlp.num_layers, mlp.skip_layer,
        mlp.hidden_dim, mlp.l_xyz, mlp.l_dir, n, _grid(device, n), preds.data_ptr(),
        device_index(device), torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"K5 forward launch failed with CUDA error {rc} (N={n}, "
            f"hidden={mlp.hidden_dim}, layers={mlp.num_layers})"
        )
    launches += 1
    return preds


def launch_k5_bwd(
    mlp: NeRFMLP, x_enc: torch.Tensor, d_enc: torch.Tensor, g: torch.Tensor,
    need_dx: bool, need_dd: bool,
) -> tuple[list[torch.Tensor], torch.Tensor | None, torch.Tensor | None]:
    """One K5 backward launch: gradients in ``mlp.parameters()`` order,
    and ``dx_enc``/``dd_enc`` (bf16) where asked for, else None."""
    global bwd_launches
    _check_cuda_call(mlp, x_enc, d_enc)
    device = x_enc.device
    n = x_enc.shape[0]
    check_tensor("g", g, (n, 4), device)
    dx = torch.empty_like(x_enc) if need_dx else None
    dd = torch.empty_like(d_enc) if need_dd else None
    if n == 0:
        return [torch.zeros_like(p) for p in mlp.parameters()], dx, dd
    if (need_dx or need_dd) and (
            -(-mlp.xyz_dim // 8) * 8, -(-mlp.dir_dim // 8) * 8) != _IG_COLS:
        raise NotImplementedError(
            f"K5's input gradients on CUDA take encodings {_IG_COLS} wide padded to 8 "
            f"(L_XYZ 10, L_DIR 4); got L_XYZ={mlp.l_xyz}, L_DIR={mlp.l_dir}"
        )
    fwd, ws = launch_rows(_ROWS_K5, mlp, None, None, None, None, mlp.l_xyz, mlp.l_dir,
                          x_res=x_enc, d_enc=d_enc, g=g, dx=dx, dd=dd)
    bwd_launches += 1
    return unpack_grads(mlp, fwd, ws.layout, ws.dw, ws.db), dx, dd


class _FusedMLP(torch.autograd.Function):
    """K5 forward, K5 backward; the parameters are inputs only so that
    autograd routes their gradients."""

    @staticmethod
    def forward(ctx, mlp, need_input_grads, x_enc, d_enc, *params):
        ctx.mlp, ctx.need_input_grads = mlp, need_input_grads
        ctx.save_for_backward(x_enc, d_enc)
        return launch_k5_fwd(mlp, x_enc, d_enc)

    @staticmethod
    def backward(ctx, g):
        x_enc, d_enc = ctx.saved_tensors
        need = ctx.need_input_grads
        grads, dx, dd = launch_k5_bwd(
            ctx.mlp, x_enc, d_enc, g.contiguous(),
            need_dx=need and ctx.needs_input_grad[2],
            need_dd=need and ctx.needs_input_grad[3],
        )
        return (None, None, dx, dd, *grads)


def apply_nerf_mlp_fused(
    mlp: NeRFMLP,
    x_enc: torch.Tensor,
    d_enc: torch.Tensor,
    *,
    need_input_grads: bool,
) -> torch.Tensor:
    """K5 over encodings: ``x_enc (..., 3+6 L_XYZ)`` and ``d_enc (...,
    3+6 L_DIR)`` in the compute dtype -> raw ``(..., 4)`` float32
    ``[rgb_logits, sigma]``, differentiable in the MLP's parameters and,
    with ``need_input_grads``, in the encodings.

    CPU tensors take :meth:`NeRFMLP.forward`.  CUDA tensors launch the
    kernels (bf16 MLPs only) or raise.
    """
    if x_enc.device.type == "cpu":
        return mlp(x_enc, d_enc)
    lead = x_enc.shape[:-1]
    x2 = x_enc.reshape(-1, x_enc.shape[-1]).contiguous()
    d2 = d_enc.reshape(-1, d_enc.shape[-1]).contiguous()
    params = list(mlp.parameters())
    if torch.is_grad_enabled() and (
            any(p.requires_grad for p in params) or x2.requires_grad or d2.requires_grad):
        preds = _FusedMLP.apply(mlp, need_input_grads, x2, d2, *params)
    else:
        preds = launch_k5_fwd(mlp, x2, d2)
    return preds.reshape(*lead, 4)
