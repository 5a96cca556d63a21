"""Ray-interval sampling: t-values and inverse-CDF importance sampling.

Counterpart of ``nerf_keras_tpu/ops/sampling.py``.  Randomness comes from
an explicit ``torch.Generator``; the serving path is deterministic
(centered t, deterministic u) and needs none.  The JAX package's one-hot
MXU einsum is a TPU formulation of a lookup; here the lookup is a
``searchsorted`` plus a gather, with the same semantics.
"""

from __future__ import annotations

import torch


def generate_t_vals(
    near: float,
    far: float,
    batch_shape: tuple[int, ...],
    num_samples: int,
    mode: str = "center",
    generator: torch.Generator | None = None,
    device=None,
) -> torch.Tensor:
    """Sample distances along rays in ``[near, far]``: ``(*batch_shape, S)``
    float32, ascending per ray.

    ``'center'`` is the deterministic linspace; ``'stratified'`` adds
    per-ray, per-sample jitter within each bin, drawn from ``generator``.
    """
    base = torch.linspace(near, far, num_samples, dtype=torch.float32,
                          device=device)
    if mode == "center":
        return base.expand(*batch_shape, num_samples)
    if mode == "stratified":
        bin_width = (far - near) / num_samples
        noise = torch.rand(
            (*batch_shape, num_samples), generator=generator,
            dtype=torch.float32, device=device,
        ) * bin_width
        return base + noise
    raise ValueError(f"unknown sampling mode: {mode!r} (center|stratified)")


def sorted_union(t_vals: torch.Tensor, t_fine: torch.Tensor) -> torch.Tensor:
    """Ascending union of coarse and fine sample distances."""
    return torch.sort(torch.cat([t_vals, t_fine], dim=-1), dim=-1).values


def sample_pdf(
    t_vals_mid: torch.Tensor,
    weights: torch.Tensor,
    ns_fine: int,
    deterministic: bool = False,
    generator: torch.Generator | None = None,
    u: torch.Tensor | None = None,
) -> torch.Tensor:
    """Hierarchical sampling: draw ``ns_fine`` t-values in proportion to
    the coarse compositing weights (inverse CDF of a piecewise-constant
    pdf).

    Reference numerics: a +1e-5 weight floor; a cdf with 0 prepended; the
    'below' bin is the unique k with ``cdf[k] <= u < cdf[k+1]``
    (right-side searchsorted minus one, clamped); 'above' is
    ``min(k+1, K-1)``; the midpoints are extended by their last entry;
    a denominator under 1e-5 is replaced by 1.

    Args:
        t_vals_mid: ``(..., S-1)`` midpoints of the coarse intervals.
        weights: ``(..., S)`` coarse compositing weights.
        ns_fine: fine samples to draw, F.
        deterministic: evenly spaced ``u = linspace(0.5/F, 1-0.5/F, F)``
            (the render path) instead of iid uniforms from ``generator``.
        generator: source of the iid uniforms.
        u: explicit ``(..., F)`` uniforms (tests feed both frameworks the
            same draws); overrides both modes above.

    Returns:
        ``(..., F)`` fine sample distances, unsorted.
    """
    if ns_fine == 0:
        return weights.new_zeros((*weights.shape[:-1], 0), dtype=torch.float32)
    weights = weights.to(torch.float32) + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (..., K)
    k = cdf.shape[-1]

    u_shape = (*weights.shape[:-1], ns_fine)
    dev = weights.device
    if u is None:
        if deterministic:
            u = torch.linspace(0.5 / ns_fine, 1.0 - 0.5 / ns_fine, ns_fine,
                               dtype=torch.float32, device=dev)
            u = u.expand(u_shape)
        else:
            u = torch.rand(u_shape, generator=generator, device=dev)
    u = u.to(torch.float32).expand(u_shape).contiguous()

    below = torch.searchsorted(cdf.contiguous(), u, right=True) - 1
    below = below.clamp(0, k - 1)
    above = (below + 1).clamp(max=k - 1)

    pad = k - t_vals_mid.shape[-1]
    t_mid_ext = torch.cat(
        [t_vals_mid] + [t_vals_mid[..., -1:]] * pad, dim=-1
    )
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    t_below = torch.gather(t_mid_ext, -1, below)
    t_above = torch.gather(t_mid_ext, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return t_below + t * (t_above - t_below)
