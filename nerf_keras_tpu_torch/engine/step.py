"""Train, eval and render functions for a flat ray batch.

Counterpart of ``nerf_keras_tpu/engine/step.py``:

* the coarse+fine render (``make_render_fn``, ``_make_fused_eval_forward``):
  coarse K1 over centered t-values, ``sample_pdf`` with deterministic u on
  the detached coarse weights, ``sorted_union``, fine K1 over the union;
* the online-proposal train step (the proposal branch of
  ``make_train_step``), its eval step and the proposal render: the
  proposal chain (``ops/proposal.py``) places the fine samples, one fine
  pass renders them (K1 forward and K2 backward on the card), and one Adam
  step updates both nets;
* ``make_optimizer`` (optax's Adam, eps 1e-7, optional exponential decay),
  ``mse`` and ``psnr``.

PyTorch runs eagerly, so there is nothing to compile: each function is
plain Python around the kernel launches.  Parameters are updated in place
(the optimizer and the EMA), where the JAX step returns a new state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from nerf_keras_tpu.config import NeRFConfig
from nerf_keras_tpu_torch.ops.kernels.fused_render import render_rays_fused
from nerf_keras_tpu_torch.ops.proposal import (
    binned_fine_weights,
    interlevel_loss,
    make_chain_sampler,
)
from nerf_keras_tpu_torch.ops.sampling import (
    generate_t_vals,
    sample_pdf,
    sorted_union,
)
from nerf_keras_tpu_torch.ops.volume import composite_background, distortion_loss
from nerf_keras_tpu_torch.utils.checkpoint import check_render_support

_LATER = "arrives in a later slice of the port (ROADMAP.md queue 1)"


def check_train_support(cfg: NeRFConfig, device: torch.device | None = None) -> None:
    """Raise ``NotImplementedError`` for training knobs this port does not
    run yet; ``ValueError`` for an unresolved anneal horizon."""
    if cfg.train_sampler != "proposal":
        raise NotImplementedError(
            f"TRAIN_SAMPLER={cfg.train_sampler!r} training (the coarse+fine "
            f"parity step) {_LATER}; TRAIN_SAMPLER='proposal' trains"
        )
    unported = {
        "PROP_UNION=false": not cfg.prop_union,
        "PROP_AUX_SAMPLES": cfg.prop_aux_samples > 0,
        "PROP_UNION_EVERY": cfg.prop_union_every > 0,
        "FREQ_ANNEAL_STEPS>0": cfg.freq_anneal_steps != 0,
        "BATCH_NORM": cfg.batch_norm,
        "NDC": cfg.ndc,
    }
    for knob, on in unported.items():
        if on:
            raise NotImplementedError(f"{knob} {_LATER}")
    if device is not None and device.type == "cuda" and cfg.compute_dtype != "bfloat16":
        raise NotImplementedError(
            f"COMPUTE_DTYPE={cfg.compute_dtype} on CUDA: the kernels run bf16 "
            f"MLPs only; float32 kernels {_LATER}"
        )
    if cfg.prop_anneal_steps < 0:
        raise ValueError(
            "PROP_ANNEAL_STEPS=-1 (auto) must be resolved to a step count "
            "before building the train step; direct callers pass an "
            "explicit count"
        )


class Adam:
    """``optax.adam(lr, eps=1e-7)`` over a list of tensors, in place:
    ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu + (1-b2) g^2``, bias-corrected
    with the incremented count, ``p += -lr * mu_hat / (sqrt(nu_hat) + eps)``.
    With ``LR_FINAL`` the learning rate is optax's ``exponential_decay``
    read at the count before the update (0 for the first), clipped at
    ``LR_FINAL``."""

    b1, b2, eps = 0.9, 0.999, 1e-7

    def __init__(self, params: list[torch.Tensor], cfg: NeRFConfig):
        if cfg.lr_final is not None and cfg.lr_decay_steps <= 0:
            raise ValueError(
                "LR_FINAL is set but LR_DECAY_STEPS is unresolved (0): direct "
                "callers must pass an explicit positive horizon"
            )
        self.params = params
        self.cfg = cfg
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def learning_rate(self, count: int) -> float:
        cfg = self.cfg
        f32 = np.float32
        init = f32(cfg.learning_rate)
        if cfg.lr_final is None or count <= 0:
            return float(init)
        p = f32(count) / f32(cfg.lr_decay_steps)
        value = init * np.power(f32(cfg.lr_final / cfg.learning_rate), p)
        return float(max(value, f32(cfg.lr_final)))

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        f32 = np.float32
        lr = self.learning_rate(self.count)
        self.count += 1
        bc1 = float(f32(1) - np.power(f32(self.b1), f32(self.count)))
        bc2 = float(f32(1) - np.power(f32(self.b2), f32(self.count)))
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        mu_hat = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)


def make_optimizer(cfg: NeRFConfig, params: list[torch.Tensor]) -> Adam:
    return Adam(params, cfg)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    return 20.0 * float(np.log10(max_val)) - 10.0 * torch.log10(mse(a, b))


@dataclasses.dataclass
class TrainState:
    """What one train step reads and updates in place."""

    params: dict[str, nn.Module]        # {'proposal', 'fine'}
    opt: Adam | None                    # None: a render-only state
    ema: dict[str, nn.Module] | None    # EMA shadow (EMA_DECAY > 0)
    step: int = 0


def _make_pass_fn(cfg: NeRFConfig, weights_grad: bool = False) -> Callable:
    """One MLP render pass ``(mlp, origins, dirs, t_vals) -> (rgb,
    weights)``: K1 (and K2 under autograd) on the card, the plain version
    on the CPU.  ``weights_grad`` keeps the weights output differentiable
    (a weight-space loss consumes it)."""

    def render_pass(mlp, origins, dirs, t_vals):
        return render_rays_fused(
            mlp, origins, dirs, t_vals, l_xyz=cfg.l_xyz, l_dir=cfg.l_dir,
            skip_layer=cfg.skip_layer, weights_grad=weights_grad,
        )

    return render_pass


def params_of(models: dict[str, nn.Module]) -> list[torch.Tensor]:
    return [p for name in sorted(models) for p in models[name].parameters()]


def make_loss_fn(cfg: NeRFConfig, near: float, far: float,
                 render_pass: Callable | None = None) -> Callable:
    """The proposal train step's loss.

    ``loss_fn(params, images, origins, dirs, t_vals, step, generator=None,
    noise=None) -> (loss, (loss_prop, loss_fine, rgb_fine))``: the chain
    places the fine samples (draws from ``generator`` or the per-level
    uniforms ``noise``), one fine pass renders them, and the loss is
    MSE(fine rgb) + PROP_LOSS_MULT x the interlevel loss of each level
    against the detached fine weights binned into its partition (blurred
    ``[1/4, 1/2, 1/4]`` per the JAX blur rule) + DISTORTION_LOSS_MULT x
    the distortion of the fine weights.  ``render_pass`` replaces the
    fine pass (K1/K2 on the card, the plain version on the CPU); it gets
    ``weights_grad`` as a keyword.
    """
    check_train_support(cfg)
    union = cfg.prop_union
    chain = make_chain_sampler(cfg, cfg.prop_l_xyz, union, cfg.prop_levels,
                               cfg.prop_samples, train=True)
    weights_grad = cfg.distortion_loss_mult > 0.0 or cfg.white_bkgd
    if render_pass is None:
        fine_pass = _make_pass_fn(cfg, weights_grad=weights_grad)
    else:
        def fine_pass(mlp, origins, dirs, t_vals):
            return render_pass(mlp, origins, dirs, t_vals, weights_grad=weights_grad)

    def blur_level(i: int) -> bool:
        if cfg.prop_target_blur is not None:
            return cfg.prop_target_blur
        return (not union) or i > 0

    def distill_target(t_all, w_fine_sg, t_part, blur):
        target = binned_fine_weights(t_all, w_fine_sg, t_part)
        if blur:
            left = torch.cat([target[..., :1], target[..., :-1]], dim=-1)
            right = torch.cat([target[..., 1:], target[..., -1:]], dim=-1)
            target = 0.25 * left + 0.5 * target + 0.25 * right
        return target

    def loss_fn(params, images, origins, dirs, t_vals, step, generator=None,
                noise=None):
        t_all, levels = chain(params["proposal"], origins, dirs, t_vals, step,
                              generator, noise)
        rgb_fine, w_fine = fine_pass(params["fine"], origins, dirs, t_all)
        if cfg.white_bkgd:
            rgb_fine = composite_background(rgb_fine, w_fine)
        loss_fine = mse(images, rgb_fine)
        w_fine_sg = w_fine.detach()
        loss_prop = torch.zeros((), dtype=torch.float32, device=images.device)
        for i, (w_prop, t_part) in enumerate(levels):
            loss_prop = loss_prop + interlevel_loss(
                w_prop, distill_target(t_all, w_fine_sg, t_part, blur_level(i)))
        loss = loss_fine + cfg.prop_loss_mult * loss_prop
        if cfg.distortion_loss_mult > 0.0:
            loss = loss + cfg.distortion_loss_mult * distortion_loss(
                t_all, w_fine, near, far)
        return loss, (loss_prop, loss_fine, rgb_fine)

    return loss_fn


def draw_t_vals(cfg: NeRFConfig, near: float, far: float, batch_shape: tuple,
                device, generator=None, noise=None) -> torch.Tensor:
    """The train step's t-values (``SAMPLING_MODE`` stratified or shared)."""
    return generate_t_vals(
        near, far, tuple(batch_shape), cfg.ns_coarse, cfg.sampling_mode,
        generator=generator, device=device, noise=noise,
    ).contiguous()


def make_train_step(cfg: NeRFConfig, near: float, far: float) -> Callable:
    """The online-proposal train step.

    ``train_step(state, batch, draws=None, generator=None) -> metrics``
    with ``batch = (images, origins, dirs)`` ``(B, 3)`` tensors on one
    device.  t-values and the chain's draws come from ``generator``, or
    from ``draws = {'t': U, 'chain': [U_level1, ...]}`` (uniforms in
    [0, 1); tests replay the JAX package's).  The loss is
    :func:`make_loss_fn`'s.  Gradients land in each parameter's ``.grad``
    (kept after the step), then Adam and the EMA update the state in
    place.  Metrics (0-d device tensors, the JAX meanings):
    ``loss_coarse`` the interlevel loss, ``loss`` the fine MSE, ``psnr``
    of the fine rgb.
    """
    loss_fn = make_loss_fn(cfg, near, far)

    def train_step(state: TrainState, batch, draws: dict | None = None,
                   generator: torch.Generator | None = None) -> dict:
        images, origins, dirs = batch
        draws = draws or {}
        t_vals = draw_t_vals(cfg, near, far, images.shape[:-1], images.device,
                             generator, draws.get("t"))
        params = params_of(state.params)
        for p in params:
            p.grad = None
        loss, (loss_prop, loss_fine, rgb_fine) = loss_fn(
            state.params, images, origins, dirs, t_vals, state.step, generator,
            draws.get("chain"))
        loss.backward()
        state.opt.step([p.grad for p in params])
        if state.ema is not None:
            d = cfg.ema_decay
            ema = params_of(state.ema)
            with torch.no_grad():
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, params, alpha=1.0 - d)
        state.step += 1
        return {
            "loss_coarse": loss_prop.detach(),
            "loss": loss_fine.detach(),
            "psnr": psnr(images, rgb_fine.detach()),
        }

    return train_step


def make_eval_step(cfg: NeRFConfig, near: float, far: float) -> Callable:
    """The proposal eval step ``eval_step(models, batch) -> metrics``:
    centered t-values, midpoint draws, no gradients.  ``loss_coarse`` is
    the interlevel loss summed over levels, ``loss`` and ``psnr`` those of
    the fine rgb."""
    if cfg.train_sampler != "proposal":
        raise NotImplementedError(f"the coarse+fine eval step {_LATER}")
    check_render_support(cfg)
    fine_pass = _make_pass_fn(cfg)
    chain = make_chain_sampler(cfg, cfg.prop_l_xyz, cfg.prop_union,
                               cfg.prop_levels, cfg.prop_samples, train=False)

    @torch.no_grad()
    def eval_step(models, batch) -> dict:
        images, origins, dirs = batch
        t_vals = generate_t_vals(near, far, tuple(images.shape[:-1]), cfg.ns_coarse,
                                 "center", device=images.device).contiguous()
        t_all, levels = chain(models["proposal"], origins, dirs, t_vals)
        rgb_fine, w_fine = fine_pass(models["fine"], origins, dirs, t_all)
        if cfg.white_bkgd:
            rgb_fine = composite_background(rgb_fine, w_fine)
        distill = torch.zeros((), dtype=torch.float32, device=images.device)
        for w_prop, t_part in levels:
            distill = distill + interlevel_loss(
                w_prop, binned_fine_weights(t_all, w_fine, t_part))
        return {"loss_coarse": distill, "loss": mse(images, rgb_fine),
                "psnr": psnr(images, rgb_fine)}

    return eval_step


def make_proposal_render_fn(
    cfg: NeRFConfig, near: float, far: float, prop_l_xyz: int = 4,
    union: bool = True, levels: int = 1, prop_samples: int = 0,
) -> Callable:
    """``render(prop, fine, origins, dirs) -> {'rgb_fine', 'depth_fine'}``:
    the proposal chain at midpoint draws over ``ns_coarse`` centered
    t-values, then one fine K1 pass over their union with the ``ns_fine``
    draws."""
    fine_pass = _make_pass_fn(cfg)
    chain = make_chain_sampler(cfg, prop_l_xyz, union, levels, prop_samples,
                               train=False)

    def render(prop, fine, origins, dirs):
        t_vals = generate_t_vals(near, far, tuple(origins.shape[:-1]), cfg.ns_coarse,
                                 "center", device=origins.device).contiguous()
        t_all, _ = chain(prop, origins, dirs, t_vals)
        rgb_fine, w_fine = fine_pass(fine, origins, dirs, t_all)
        depth_fine = torch.sum(w_fine * t_all, dim=-1)
        if cfg.white_bkgd:
            rgb_fine = composite_background(rgb_fine, w_fine)
        return {"rgb_fine": rgb_fine, "depth_fine": depth_fine}

    return render


def _make_fused_eval_forward(cfg: NeRFConfig) -> Callable:
    """``forward(models, origins, dirs, t_vals) -> dict`` with rgb, depth
    and weights of both passes, each pass one K1 launch on CUDA."""
    render_pass = _make_pass_fn(cfg)

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
    """``render(models, origins, dirs) -> dict`` of rgb/depth maps; the
    rays are ``(B, 3)`` tensors on one device.  ``models`` is ``{'coarse',
    'fine'}`` (coarse and fine passes reported) or, for
    ``TRAIN_SAMPLER=proposal``, ``{'proposal', 'fine'}`` (fine only)."""
    check_render_support(cfg)
    if cfg.train_sampler == "proposal":
        inner = make_proposal_render_fn(
            cfg, near, far, prop_l_xyz=cfg.prop_l_xyz, union=cfg.prop_union,
            levels=cfg.prop_levels, prop_samples=cfg.prop_samples,
        )

        def render_proposal(models, origins, dirs):
            return inner(models["proposal"], models["fine"], origins, dirs)

        return render_proposal

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
