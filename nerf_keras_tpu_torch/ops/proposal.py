"""Proposal samplers: tiny density nets that place the fine samples.

Counterpart of ``nerf_keras_tpu/ops/proposal.py``.  With
``TRAIN_SAMPLER=proposal`` a small MLP on Fourier-encoded positions
replaces the 8x256 coarse model: its compositing weights drive the
inverse-CDF draw of the fine samples, and it learns by distilling the
fine pass's (detached) weight histogram (:func:`interlevel_loss`).  Two
levels stack two nets (Mip-NeRF 360's chain): the second re-bins at the
union of the uniform grid and stratified draws from the first.

Offline, :func:`distill_proposal` fits one such net to a trained coarse
model's fine density after training, so that inference can place the fine
samples without the coarse MLP pass (``Trainer.build_proposal_sampler``).

The nets are plain float32 PyTorch (tiny products; the TF32 switch is off,
``runtime.py``).  Parameters carry across from the JAX layout
``{'layers': [{'w', 'b'}, ...]}`` (one level) or ``{'l1': net, 'l2': net}``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from nerf_keras_tpu_torch.models.mlp import _glorot_linear
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.rays import sample_rays
from nerf_keras_tpu_torch.ops.sampling import sample_pdf, sorted_union
from nerf_keras_tpu_torch.ops.volume import volume_render


class ProposalMLP(nn.Module):
    """``depth`` dense layers (ReLU between) on the encoded position,
    scalar output; glorot-uniform weights and zero biases, as
    ``init_proposal``.  No skip concat."""

    def __init__(self, l_xyz: int = 4, hidden: int = 64, depth: int = 3,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.l_xyz = l_xyz
        dims = [3 + 6 * l_xyz] + [hidden] * (depth - 1) + [1]
        self.layers = nn.ModuleList(
            [_glorot_linear(i, o, generator, device) for i, o in zip(dims[:-1], dims[1:])]
        )

    def forward(self, x_enc: torch.Tensor) -> torch.Tensor:
        """Raw output ``(...,)`` f32 on ``(..., 3+6L)`` encodings:
        ``apply_proposal`` with float32 products."""
        h = x_enc.to(torch.float32)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            h = h @ layer.weight.T + layer.bias
            if i < last:
                h = torch.relu(h)
        return h[..., 0]

    @torch.no_grad()
    def load_jax_params(self, params: dict) -> "ProposalMLP":
        if len(params["layers"]) != len(self.layers):
            raise ValueError(
                f"params have {len(params['layers'])} layers, the net "
                f"{len(self.layers)}"
            )
        for src, layer in zip(params["layers"], self.layers):
            w = torch.tensor(np.asarray(src["w"], np.float32))
            if tuple(w.shape) != tuple(layer.weight.shape[::-1]):
                raise ValueError(
                    f"weight shape {tuple(w.shape)} does not match the "
                    f"net's (in, out) = {tuple(layer.weight.shape[::-1])}"
                )
            layer.weight.copy_(w.T)
            layer.bias.copy_(torch.tensor(np.asarray(src["b"], np.float32)))
        return self

    @classmethod
    def from_jax_params(cls, params: dict, device=None) -> "ProposalMLP":
        """A net whose shapes come from a JAX ``{'layers': ...}`` tree."""
        ws = [np.asarray(layer["w"]) for layer in params["layers"]]
        net = cls(l_xyz=(ws[0].shape[0] - 3) // 6, hidden=ws[0].shape[1],
                  depth=len(ws), device=device)
        return net.load_jax_params(params)

    @torch.no_grad()
    def to_jax_params(self, grad: bool = False) -> dict:
        """The JAX ``{'layers': [{'w', 'b'}]}`` tree as float32 numpy; with
        ``grad`` the parameters' ``.grad`` in the same layout."""
        def val(p):
            return (p.grad if grad else p).detach().cpu().numpy()

        return {"layers": [{"w": val(layer.weight).T.copy(), "b": val(layer.bias).copy()}
                           for layer in self.layers]}


def init_proposal_chain(levels: int, l_xyz: int = 4, hidden: int = 64,
                        depth: int = 3, generator: torch.Generator | None = None,
                        device=None) -> nn.Module:
    """One :class:`ProposalMLP` for ``levels == 1``; an ``nn.ModuleDict``
    ``{'l1', 'l2'}`` for ``levels == 2``."""
    if levels == 1:
        return ProposalMLP(l_xyz, hidden, depth, generator, device)
    if levels != 2:
        raise ValueError(f"PROP_LEVELS must be 1 or 2, got {levels}")
    return nn.ModuleDict({
        f"l{i + 1}": ProposalMLP(l_xyz, hidden, depth, generator, device)
        for i in range(levels)
    })


def chain_nets(prop: nn.Module) -> list[ProposalMLP]:
    """The per-level nets of a proposal chain, in draw order."""
    if isinstance(prop, ProposalMLP):
        return [prop]
    return [prop[f"l{i + 1}"] for i in range(len(prop))]


def proposal_from_jax(tree: dict, device=None) -> nn.Module:
    """A chain module from a JAX ``{'layers'}`` or ``{'l1', 'l2'}`` tree."""
    if "layers" in tree:
        return ProposalMLP.from_jax_params(tree, device=device)
    return nn.ModuleDict({k: ProposalMLP.from_jax_params(v, device=device)
                          for k, v in sorted(tree.items())})


def proposal_to_jax(prop: nn.Module, grad: bool = False) -> dict:
    if isinstance(prop, ProposalMLP):
        return prop.to_jax_params(grad)
    return {k: net.to_jax_params(grad) for k, net in prop.items()}


def proposal_sigma(net: ProposalMLP, pts: torch.Tensor, l_xyz: int) -> torch.Tensor:
    """Density at points: ``expm1(relu(net(enc(pts))))``."""
    return torch.expm1(torch.relu(net(encode_position(pts, l_xyz))))


def proposal_weights(net: ProposalMLP, origins: torch.Tensor,
                     directions: torch.Tensor, t_vals: torch.Tensor,
                     l_xyz: int) -> torch.Tensor:
    """Compositing weights ``(B, S)`` from the proposal density alone,
    through ``volume_render`` with zero rgb (the coarse pass's numerics)."""
    pts, _ = sample_rays(origins, directions, t_vals)
    sigma = proposal_sigma(net, pts, l_xyz)
    preds = torch.cat([torch.zeros((*sigma.shape, 3), dtype=torch.float32,
                                   device=sigma.device), sigma[..., None]], dim=-1)
    _, _, weights = volume_render(preds, t_vals)
    return weights


def binned_fine_weights(t_all: torch.Tensor, w_fine: torch.Tensor,
                        t_vals: torch.Tensor) -> torch.Tensor:
    """Fine weights ``w_fine`` at ``t_all (..., S)`` summed into the bins
    of ``t_vals (..., J)``: bin ``j`` is ``[t_j, t_{j+1})``, the last bin is
    open, a sample on an edge lands in that edge's bin, a sample below the
    first edge in none.  The JAX package's exact 0/1 membership
    (two broadcast compares) contracted with the weights."""
    ge = (t_all[..., :, None] >= t_vals[..., None, :]).to(torch.float32)
    member = ge - torch.cat([ge[..., 1:], torch.zeros_like(ge[..., :1])], dim=-1)
    return torch.einsum("...sj,...s->...j", member, w_fine)


def interlevel_loss(w_prop: torch.Tensor, w_target: torch.Tensor,
                    eps: float = 1e-3) -> torch.Tensor:
    """One-sided histogram distillation: penalize the proposal where it
    under-covers the (detached) target, ``sum_j relu(t - p)^2 / (p + eps)``,
    mean over rays."""
    excess = torch.relu(w_target - w_prop)
    return torch.mean(torch.sum(excess * excess / (w_prop + eps), dim=-1))


def distill_proposal(
    sigma_fn: Callable[[torch.Tensor], torch.Tensor],
    origins: torch.Tensor,
    directions: torch.Tensor,
    near: float,
    far: float,
    *,
    l_xyz: int = 4,
    hidden: int = 64,
    depth: int = 3,
    steps: int = 1500,
    batch: int = 16384,
    lr: float = 2e-3,
    under_weight: float = 4.0,
    generator: torch.Generator | None = None,
    draws: dict | None = None,
    losses_out: list | None = None,
) -> tuple[ProposalMLP, float]:
    """Fit a :class:`ProposalMLP` to a trained model's density (the JAX
    ``distill_proposal``).

    ``sigma_fn(pts (N, 3)) -> (N,)`` raw sigma logits of the trained fine
    model.  Each step draws ``batch`` (ray, t) pairs from the given rays,
    ``t ~ U(near, far)``, and regresses ``log1p(relu(sigma))`` (the
    compressed density) with ``mean(w * err^2)``, ``w = under_weight``
    where the net under-predicts: missing mass starves the surface of
    fine samples, excess mass only wastes a few.  Adam at optax's
    defaults (eps 1e-8, not the training optimizer's 1e-7).

    ``generator`` (on the rays' device) draws the init and every step's
    rays and t-values, all on the device before the loop, so the loop
    never waits for the host.  ``draws = {'idx': (steps, batch) int64,
    't': (steps, batch) f32, 'init': JAX-layout proposal tree}`` replaces
    them (tests replay the JAX package's ``jax.random`` draws).
    ``losses_out``, when given, receives every step's loss.  Returns
    ``(net, final_loss)``, the loss of the last step.
    """
    from nerf_keras_tpu_torch.config import NeRFConfig
    from nerf_keras_tpu_torch.engine.step import Adam  # the engine imports this module

    dev = origins.device
    origins = origins.to(torch.float32).reshape(-1, 3).contiguous()
    directions = directions.to(device=dev, dtype=torch.float32).reshape(-1, 3).contiguous()
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        init_gen = torch.Generator().manual_seed(generator.initial_seed())
        net = ProposalMLP(l_xyz, hidden, depth, generator=init_gen, device=dev)
        idx = torch.randint(0, origins.shape[0], (steps, batch), generator=generator,
                            device=dev)
        t = torch.rand((steps, batch), generator=generator, device=dev) * (far - near) + near
    else:
        net = ProposalMLP.from_jax_params(draws["init"], device=dev)
        idx = torch.tensor(np.asarray(draws["idx"], np.int64), device=dev)
        t = torch.tensor(np.asarray(draws["t"], np.float32), device=dev)
        if tuple(idx.shape) != (steps, batch) or tuple(t.shape) != (steps, batch):
            raise ValueError(f"draws are {tuple(idx.shape)}/{tuple(t.shape)}, the "
                             f"run needs ({steps}, {batch})")
    params = list(net.parameters())
    opt = Adam(params, NeRFConfig(learning_rate=lr), eps=1e-8)
    losses = []
    for s in range(steps):
        ray = idx[s]
        pts = origins[ray] + directions[ray] * t[s][:, None]
        with torch.no_grad():
            target = torch.log1p(torch.relu(sigma_fn(pts)))
        err = net(encode_position(pts, net.l_xyz)) - target
        w = torch.where(err < 0, under_weight, 1.0)
        loss = torch.mean(w * err * err)
        opt.step(list(torch.autograd.grad(loss, params)))
        losses.append(loss.detach())
    losses = torch.stack(losses).cpu()
    if losses_out is not None:
        losses_out.extend(losses.tolist())
    return net.requires_grad_(False), float(losses[-1])


def anneal_exponent(step: int, anneal_steps: int) -> float:
    """The sampling anneal's ``b = 10f / (1 + 9f)``, ``f = clip(step / N)``,
    in float32 as the JAX step computes it."""
    f = np.clip(np.float32(step) / np.float32(anneal_steps), np.float32(0), np.float32(1))
    return float(np.float32(10.0) * f / (np.float32(1.0) + np.float32(9.0) * f))


def make_chain_sampler(cfg, l_xyz: int, union: bool, levels: int,
                       prop_samples: int, train: bool) -> Callable:
    """The proposal sampling chain of the train step, the eval step and the
    proposal render (``make_chain_sampler`` of the JAX package).

    ``chain(prop, origins, dirs, t_vals, step=0, generator=None,
    noise=None) -> (t_all, [(w_prop, t_partition), ...])``.  Level 1
    evaluates its net on ``t_vals``; with two levels the second net
    re-bins at the union of ``t_vals`` and ``prop_samples`` stratified
    draws from the first histogram.  ``t_all`` is the fine pass's sample
    positions: with ``union`` the sorted union of ``t_vals`` with the final
    ``ns_fine`` draws; without it (Mip-NeRF 360's layout) the final draws
    alone, sorted, so the fine pass sees ``ns_fine`` samples a ray.  An
    intermediate level's partition is always its draws' union with
    ``t_vals`` (the grid keeps ``[near, far]`` covered).  ``train=True`` draws
    from ``generator`` (or the per-level uniforms ``noise``) and shapes
    each draw with the sampling anneal ``(w + 1e-5)^b`` and the
    exploration floor; ``train=False`` draws at midpoint ``u`` from the
    raw weights.  Draws always consume detached weights.
    """
    n2 = prop_samples or cfg.ns_coarse

    def shape_draw(w: torch.Tensor, step: int) -> torch.Tensor:
        w_draw = w.detach()
        if not train:
            return w_draw
        if cfg.prop_anneal_steps > 0:
            w_draw = torch.pow(w_draw + 1e-5, anneal_exponent(step, cfg.prop_anneal_steps))
        if cfg.prop_explore > 0.0:
            e = cfg.prop_explore
            w_draw = (1.0 - e) * w_draw + e * torch.mean(w_draw, dim=-1, keepdim=True)
        return w_draw

    def chain(prop, origins, dirs, t_vals, step: int = 0, generator=None, noise=None):
        nets = chain_nets(prop)
        if len(nets) != levels:
            raise ValueError(
                f"proposal params carry {len(nets)} level(s) but the "
                f"config says PROP_LEVELS={levels}"
            )
        level_outs = []
        t_part = t_vals
        t_all = None
        for i, net in enumerate(nets):
            w = proposal_weights(net, origins, dirs, t_part, l_xyz)
            level_outs.append((w, t_part))
            last = i == len(nets) - 1
            n_draw = cfg.ns_fine if last else n2
            t_mid = 0.5 * (t_part[..., 1:] + t_part[..., :-1])
            if train:
                t_draw = sample_pdf(
                    t_mid, shape_draw(w, step), n_draw, generator=generator,
                    stratified=not last, noise=None if noise is None else noise[i],
                )
            else:
                t_draw = sample_pdf(t_mid, shape_draw(w, step), n_draw,
                                    deterministic=True)
            if last:
                t_all = (sorted_union(t_vals, t_draw) if union
                         else torch.sort(t_draw, dim=-1).values)
            else:
                t_part = sorted_union(t_vals, t_draw)
        return t_all, level_outs

    return chain
