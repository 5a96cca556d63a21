"""Ray-interval sampling: t-values and inverse-CDF importance sampling.

Counterpart of ``nerf_keras_tpu/ops/sampling.py``.  Randomness comes from
an explicit ``torch.Generator`` (or explicit draws, which the tests use
to replay the JAX package's); the serving path is deterministic
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
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample distances along rays in ``[near, far]``: ``(*batch_shape, S)``
    float32.

    ``'center'`` is the deterministic linspace; ``'stratified'`` adds
    per-ray, per-sample jitter within each bin; ``'shared'`` adds one
    jitter vector to every ray (a uniform shift of up to one bin per
    sample, the reference's frozen-jitter analogue).  The jitter is
    ``U * (far - near) / S`` with ``U`` uniform in [0, 1) drawn from
    ``generator``, or given as ``noise`` (``(*batch_shape, S)`` for
    stratified, ``(S,)`` for shared; tests feed both frameworks the same
    draws).
    """
    base = torch.linspace(near, far, num_samples, dtype=torch.float32,
                          device=device)
    if mode == "center":
        return base.expand(*batch_shape, num_samples)
    bin_width = (far - near) / num_samples
    if mode == "shared":
        shape = (num_samples,)
    elif mode == "stratified":
        shape = (*batch_shape, num_samples)
    else:
        raise ValueError(
            f"unknown sampling mode: {mode!r} (center|stratified|shared)")
    if noise is None:
        noise = torch.rand(shape, generator=generator, dtype=torch.float32,
                           device=device)
    noise = noise.to(device=base.device, dtype=torch.float32)
    if tuple(noise.shape) != shape:
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {shape}")
    return (base + noise * bin_width).expand(*batch_shape, num_samples)


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
    stratified: bool = False,
    noise: torch.Tensor | None = None,
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
            (the render path) instead of random draws.
        generator: source of the uniforms ``U`` of the random modes.
        u: explicit ``(..., F)`` final ``u`` values; overrides every mode.
        stratified: one draw per equal-width stratum, ``u_j = (j + U_j)/F``
            (the proposal chain's intermediate draws), instead of iid
            ``u = U``.
        noise: explicit ``(..., F)`` uniforms ``U`` for the random modes
            (tests feed both frameworks the same draws).

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
            if noise is None:
                noise = torch.rand(u_shape, generator=generator, device=dev)
            u = noise.to(device=dev, dtype=torch.float32)
            if stratified:
                base = torch.arange(ns_fine, dtype=torch.float32, device=dev) / ns_fine
                u = base + u / ns_fine
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
