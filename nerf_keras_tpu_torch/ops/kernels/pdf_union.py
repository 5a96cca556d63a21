"""K7, inverse-CDF importance sampling fused with the sorted union.

Counterpart of ``experimental/pdf_union.py`` (``sample_pdf_union`` and
``sample_pdf_union_eval``, kernel ``_pdf_union_kernel``).  The CUDA
kernel is ``csrc/pdf_union.cu``; its source note says what bounds it and
how the design answers.  As in the JAX package it is not wired into the
engine: the render and train steps take the ``sample_pdf`` +
``sorted_union`` chain, and ``python -m nerf_keras_tpu_torch.exp_train_paths
--phases pdf`` times the two against each other.

* :func:`sample_pdf_union_reference` is the plain version: that chain,
  with the eval grid (``deterministic=True``) or the caller's sorted
  uniforms as ``sample_pdf``'s ``u``.
* :func:`sample_pdf_union_float64` is that chain evaluated in float64 on
  the same inputs: the yardstick that shows how much of a draw's error is
  float32 rounding of the cdf (K7 accumulates it in double).
* :func:`sample_pdf_union` takes the plain version for a tensor on the
  CPU, and only then.  For a CUDA tensor it launches K7 or raises; each
  launch adds one to :data:`launches`.
"""

from __future__ import annotations

import functools

import torch

from nerf_keras_tpu_torch.ops.kernels import _build
from nerf_keras_tpu_torch.ops.kernels.fused_render import check_tensor, device_index
from nerf_keras_tpu_torch.ops.sampling import sample_pdf, sorted_union

launches = 0  # K7

WEIGHT_FLOOR = 1e-5  # sample_pdf's floor on the weights
MAX_S = 256  # csrc/pdf_union.cu: kMaxS (16 lanes a ray, 16 values a lane)


def eval_grid(ns_fine: int, device) -> torch.Tensor:
    """``sample_pdf``'s deterministic ``u``, ``(ns_fine,)``."""
    return torch.linspace(0.5 / ns_fine, 1.0 - 0.5 / ns_fine, ns_fine,
                          dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=16)
def device_grid(ns_fine: int, device: torch.device) -> torch.Tensor:
    """:func:`eval_grid`, made once per ``(ns_fine, device)`` by the same
    ``torch.linspace`` call as ``sample_pdf``'s, so it is the plain
    version's ``u`` bit for bit on that device.  K7 only reads it."""
    return eval_grid(ns_fine, device)


def sample_pdf_union_reference(
    t_vals: torch.Tensor,
    weights: torch.Tensor,
    ns_fine: int,
    u_sorted: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain K7: ``sorted_union(t, sample_pdf(t_mid, w, ns_fine, u))``."""
    t_mid = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
    t_fine = sample_pdf(t_mid, weights, ns_fine, deterministic=u_sorted is None,
                        u=u_sorted)
    return sorted_union(t_vals, t_fine)


def sample_pdf_union_float64(
    t_vals: torch.Tensor,
    weights: torch.Tensor,
    ns_fine: int,
    u_sorted: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`sample_pdf_union_reference`'s chain in float64 on the same
    inputs (``u``: the float32 eval grid or ``u_sorted``, widened):
    ``(B, S + ns_fine)`` float64."""
    t = t_vals.double()
    w = weights.double() + WEIGHT_FLOOR
    cdf = torch.cumsum(w / torch.sum(w, dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    k = cdf.shape[-1]
    u = eval_grid(ns_fine, t.device) if u_sorted is None else u_sorted
    u = u.double().expand(*t.shape[:-1], ns_fine).contiguous()
    below = (torch.searchsorted(cdf, u, right=True) - 1).clamp(0, k - 1)
    above = (below + 1).clamp(max=k - 1)
    mid = 0.5 * (t[..., 1:] + t[..., :-1])
    mid = torch.cat([mid, mid[..., -1:], mid[..., -1:]], dim=-1)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    t_b, t_a = mid.gather(-1, below), mid.gather(-1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return sorted_union(t, t_b + (u - cdf_b) / denom * (t_a - t_b))


def launch_k7(t_vals: torch.Tensor, weights: torch.Tensor, ns_fine: int,
              u_sorted: torch.Tensor | None = None,
              w_floor: float = WEIGHT_FLOOR) -> torch.Tensor:
    """One K7 launch: ``(B, S + ns_fine)`` float32.  Without ``u_sorted``
    every ray reads one shared row, :func:`device_grid`.  Allocates only
    the output."""
    global launches
    device = t_vals.device
    if device.type != "cuda":
        raise ValueError(f"K7 runs on cuda or cpu tensors, got {device}")
    if t_vals.dim() != 2 or t_vals.shape[1] < 2:
        raise ValueError(f"t_vals must be (B, S >= 2), got {tuple(t_vals.shape)}")
    b, s = t_vals.shape
    if s > MAX_S:
        raise NotImplementedError(f"K7 on CUDA takes S <= {MAX_S} coarse samples, got {s}")
    check_tensor("t_vals", t_vals, (b, s), device)
    check_tensor("weights", weights, (b, s), device)
    if u_sorted is None:
        u, u_stride = device_grid(ns_fine, device), 0
    else:
        check_tensor("u_sorted", u_sorted, (b, ns_fine), device)
        u, u_stride = u_sorted, ns_fine
    out = torch.empty((b, s + ns_fine), dtype=torch.float32, device=device)
    if b == 0:
        return out
    rc = _build.load("pdf_union").nkt_pdf_union(
        t_vals.data_ptr(), weights.data_ptr(), u.data_ptr(), u_stride, b, s, ns_fine,
        w_floor, out.data_ptr(), device_index(device),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K7 launch failed with CUDA error {rc} (B={b}, S={s}, "
                           f"NF={ns_fine})")
    launches += 1
    return out


def sample_pdf_union(
    t_vals: torch.Tensor,
    weights: torch.Tensor,
    ns_fine: int,
    u_sorted: torch.Tensor | None = None,
) -> torch.Tensor:
    """The ascending union of ``t_vals (B, S)`` (ascending) and ``ns_fine``
    inverse-CDF draws from ``weights (B, S)``: ``(B, S + ns_fine)``
    float32.  The draws use the eval grid, or ``u_sorted (B, ns_fine)``,
    uniforms sorted ascending per ray (sorting iid uniforms keeps the
    multiset of draws; only the union is read).  No gradient flows.

    CPU tensors take :func:`sample_pdf_union_reference`; CUDA tensors
    launch K7 or raise.
    """
    if ns_fine == 0:
        return t_vals
    if t_vals.device.type == "cpu":
        return sample_pdf_union_reference(t_vals, weights, ns_fine, u_sorted)
    return launch_k7(t_vals.detach(), weights.detach(), ns_fine,
                     None if u_sorted is None else u_sorted.detach())


def sample_pdf_union_eval(t_vals: torch.Tensor, weights: torch.Tensor,
                          ns_fine: int) -> torch.Tensor:
    """:func:`sample_pdf_union` on the eval grid."""
    return sample_pdf_union(t_vals, weights, ns_fine)
