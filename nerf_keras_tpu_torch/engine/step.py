"""Train, eval and render functions for a flat ray batch.

Counterpart of ``nerf_keras_tpu/engine/step.py``:

* the coarse+fine parity train step (the ``TRAIN_SAMPLER=coarse`` branch
  of ``make_train_step``): a coarse pass over stratified t-values,
  ``sample_pdf`` on the coarse weights, ``sorted_union``, a fine pass over
  the union; loss ``mse(coarse) + mse(fine)`` (+ ``DISTORTION_LOSS_MULT``
  x the distortion of the fine weights).  With ``STOP_PDF_GRADIENT`` (the
  default) the coarse weights are detached before the draw and each pass
  is one K1 launch forward and one K2 launch backward
  (``_make_fused_train_forward``); without it the fine samples' t-values
  stay differentiable through ``sample_pdf`` into the coarse MLP, so the
  encodings are computed outside the MLP and each pass is one K5 launch
  forward and one backward with input gradients (``make_forward_pass``);
* the coarse+fine eval step and render (``make_render_fn``,
  ``_make_fused_eval_forward``: coarse K1 over centered t-values,
  deterministic ``sample_pdf``, ``sorted_union``, fine K1), and the full
  render (``full=True``: weights and raw predictions of both passes,
  through ``make_forward_pass`` and K5's forward);
* the online-proposal train step (the proposal branch of
  ``make_train_step``), its eval step and the proposal render: the
  proposal chain (``ops/proposal.py``) places the fine samples, one fine
  pass renders them (K1 forward and K2 backward on the card), and one Adam
  step updates both nets;
* the int8 renders (``make_quant_render_fn``, and
  ``make_proposal_render_fn(quant=True)``): every MLP pass is one K4
  launch on the card, over qparams from ``ops/quant.py``;
* ``make_optimizer`` (optax's Adam, eps 1e-7, optional exponential decay),
  ``mse`` and ``psnr``.

The port does not read ``USE_PALLAS``: on the card the kernels always run
(K1/K2 where the JAX package takes its fused megakernel, K5 where it
takes ``apply_nerf_mlp_pallas``), and on the CPU each kernel's plain
version does.  PyTorch runs eagerly, so there is nothing to compile: each
function is plain Python around the kernel launches.  Parameters are
updated in place (the optimizer and the EMA), where the JAX step returns
a new state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from nerf_keras_tpu_torch.config import NeRFConfig
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.kernels.fused_mlp import apply_nerf_mlp_fused
from nerf_keras_tpu_torch.ops.kernels.fused_render import render_rays_fused
from nerf_keras_tpu_torch.ops.kernels.quant_render import render_rays_fused_quant
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
from nerf_keras_tpu_torch.ops.rays import sample_rays
from nerf_keras_tpu_torch.ops.volume import (
    composite_background,
    distortion_loss,
    volume_render,
)
from nerf_keras_tpu_torch.utils.checkpoint import check_render_support

_LATER = "arrives in a later slice of the port (ROADMAP.md queue 1)"


def check_train_support(cfg: NeRFConfig, device: torch.device | None = None) -> None:
    """Raise ``NotImplementedError`` for training knobs this port does not
    run yet; ``ValueError`` for an unresolved anneal horizon."""
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

    params: dict[str, nn.Module]        # {'coarse', 'fine'} or {'proposal', 'fine'}
    opt: Adam | None                    # None: a render-only state
    ema: dict[str, nn.Module] | None    # EMA shadow (EMA_DECAY > 0)
    step: int = 0


def _make_pass_fn(cfg: NeRFConfig, weights_grad: bool = False,
                  quant: bool = False) -> Callable:
    """One MLP render pass ``(mlp, origins, dirs, t_vals) -> (rgb,
    weights)``: K1 (and K2 under autograd) on the card, the plain version
    on the CPU.  ``weights_grad`` keeps the weights output differentiable
    (a weight-space loss consumes it).  With ``quant`` the first argument
    is one MLP's qparams and the pass is K4 (inference only)."""
    if quant:
        def render_pass_q(qp, origins, dirs, t_vals):
            return render_rays_fused_quant(qp, origins, dirs, t_vals, l_xyz=cfg.l_xyz,
                                           l_dir=cfg.l_dir, skip_layer=cfg.skip_layer)

        return render_pass_q

    def render_pass(mlp, origins, dirs, t_vals):
        return render_rays_fused(
            mlp, origins, dirs, t_vals, l_xyz=cfg.l_xyz, l_dir=cfg.l_dir,
            skip_layer=cfg.skip_layer, weights_grad=weights_grad,
        )

    return render_pass


def params_of(models: dict[str, nn.Module]) -> list[torch.Tensor]:
    return [p for name in sorted(models) for p in models[name].parameters()]


def _mlp_fn(cfg: NeRFConfig) -> Callable:
    """The MLP over encodings ``(mlp, x_enc, d_enc) -> raw (..., 4)``: K5
    on the card, :meth:`NeRFMLP.forward` on the CPU.  Gradients reach the
    encodings only in the ``STOP_PDF_GRADIENT=false`` mode, the one where
    they are differentiable (through ``sample_pdf``)."""
    need_input_grads = not cfg.stop_pdf_gradient

    def run(mlp, x_enc, d_enc):
        return apply_nerf_mlp_fused(mlp, x_enc, d_enc, need_input_grads=need_input_grads)

    return run


def make_forward_pass(cfg: NeRFConfig, return_t_fine: bool = False,
                      mlp_fn: Callable | None = None) -> Callable:
    """The coarse->fine forward pass with the encodings computed outside the
    MLP (stored in the compute dtype, as the JAX package stores them).

    ``forward(models, origins, dirs, t_vals, deterministic=False,
    generator=None, noise=None)`` -> ``((rgb_coarse, rgb_fine),
    (depth_coarse, depth_fine), (weights_coarse, weights_fine),
    (preds_coarse, preds_fine))``; with ``return_t_fine`` the pair
    ``(outputs, t_all)``, the fine pass's sorted t-union (the distortion
    loss pairs it with ``weights_fine``).  The fine samples follow the
    coarse weights: ``sample_pdf`` with evenly spaced u (``deterministic``,
    the render) or with uniforms from ``generator`` or ``noise`` ``(B,
    NS_FINE)`` (training).  The coarse weights are detached before the draw
    only under ``STOP_PDF_GRADIENT``; otherwise the fine t-values, and so
    the fine pass's position encodings, carry gradients into the coarse
    MLP.  ``mlp_fn`` replaces the MLP (default :func:`_mlp_fn`).
    """
    mlp = _mlp_fn(cfg) if mlp_fn is None else mlp_fn
    enc_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

    def run_mlp(model, origins, dirs, t):
        points, _ = sample_rays(origins, dirs, t)
        x_enc = encode_position(points, cfg.l_xyz).to(enc_dtype)
        # Every sample of a ray shares its direction's encoding.
        d_enc = encode_position(dirs, cfg.l_dir).to(enc_dtype)
        return mlp(model, x_enc, d_enc[..., None, :].expand(*t.shape, -1))

    def forward(models, origins, dirs, t_vals, deterministic=False,
                generator=None, noise=None):
        preds_coarse = run_mlp(models["coarse"], origins, dirs, t_vals)
        rgb_coarse, depth_coarse, w_coarse = volume_render(preds_coarse, t_vals)
        t_mid = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        w_pdf = w_coarse.detach() if cfg.stop_pdf_gradient else w_coarse
        t_fine = sample_pdf(t_mid, w_pdf, cfg.ns_fine, deterministic=deterministic,
                            generator=generator, noise=noise)
        t_all = sorted_union(t_vals, t_fine)
        preds_fine = run_mlp(models["fine"], origins, dirs, t_all)
        rgb_fine, depth_fine, w_fine = volume_render(preds_fine, t_all)
        if cfg.white_bkgd:
            rgb_coarse = composite_background(rgb_coarse, w_coarse)
            rgb_fine = composite_background(rgb_fine, w_fine)
        outputs = ((rgb_coarse, rgb_fine), (depth_coarse, depth_fine),
                   (w_coarse, w_fine), (preds_coarse, preds_fine))
        return (outputs, t_all) if return_t_fine else outputs

    return forward


def _make_fused_train_forward(cfg: NeRFConfig, want_weights: bool = False,
                              render_pass: Callable | None = None) -> Callable:
    """The parity step's training forward under ``STOP_PDF_GRADIENT``: each
    pass is one :func:`render_rays_fused` (K1 with its residuals forward,
    K2 backward on the card).

    ``forward(models, origins, dirs, t_vals, generator=None, noise=None)``
    -> ``(rgb_coarse, rgb_fine)``, or with ``want_weights`` (the distortion
    loss) ``(rgb_coarse, rgb_fine, t_all, w_fine)``.  The weights output of
    a pass carries a gradient only where a loss reads it: the coarse pass's
    under ``WHITE_BKGD`` (its ``1 - acc`` term), the fine pass's under
    distortion or ``WHITE_BKGD``; the draw always takes the detached coarse
    weights.  ``render_pass`` replaces :func:`render_rays_fused` (it gets
    ``weights_grad`` as a keyword).
    """
    def make(weights_grad: bool) -> Callable:
        if render_pass is None:
            return _make_pass_fn(cfg, weights_grad=weights_grad)
        return lambda mlp, o, d, t: render_pass(mlp, o, d, t, weights_grad=weights_grad)

    render = make(cfg.white_bkgd)
    render_fine = make(want_weights or cfg.white_bkgd)

    def forward(models, origins, dirs, t_vals, generator=None, noise=None):
        rgb_coarse, w_coarse = render(models["coarse"], origins, dirs, t_vals)
        if cfg.white_bkgd:
            rgb_coarse = composite_background(rgb_coarse, w_coarse)
        t_mid = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        t_fine = sample_pdf(t_mid, w_coarse.detach(), cfg.ns_fine,
                            generator=generator, noise=noise)
        t_all = sorted_union(t_vals, t_fine).contiguous()
        rgb_fine, w_fine = render_fine(models["fine"], origins, dirs, t_all)
        if cfg.white_bkgd:
            rgb_fine = composite_background(rgb_fine, w_fine)
        if want_weights:
            return rgb_coarse, rgb_fine, t_all, w_fine
        return rgb_coarse, rgb_fine

    return forward


def make_loss_fn(cfg: NeRFConfig, near: float, far: float,
                 render_pass: Callable | None = None,
                 mlp_fn: Callable | None = None) -> Callable:
    """The train step's loss, ``loss_fn(params, images, origins, dirs,
    t_vals, step, generator=None, noise=None) -> (loss, (loss_coarse_slot,
    loss_fine, rgb_fine))``.

    ``TRAIN_SAMPLER=coarse`` (:func:`_make_coarse_loss_fn`): ``noise`` is
    the ``(B, NS_FINE)`` uniforms of the fine draw.  ``proposal``
    (:func:`_make_proposal_loss_fn`): the per-level uniforms of the chain.
    ``render_pass`` replaces the K1/K2 render passes and ``mlp_fn`` the K5
    MLP (a check on the card runs the plain versions through them).
    """
    check_train_support(cfg)
    if cfg.train_sampler == "proposal":
        return _make_proposal_loss_fn(cfg, near, far, render_pass)
    return _make_coarse_loss_fn(cfg, near, far, render_pass, mlp_fn)


def _make_coarse_loss_fn(cfg: NeRFConfig, near: float, far: float,
                         render_pass: Callable | None,
                         mlp_fn: Callable | None) -> Callable:
    """The parity step's loss: ``mse(coarse rgb) + mse(fine rgb)`` (+
    ``DISTORTION_LOSS_MULT`` x the distortion of the fine weights, which
    the regularizer applies to the final level only).  Under
    ``STOP_PDF_GRADIENT`` it runs :func:`_make_fused_train_forward` (K1/K2),
    otherwise :func:`make_forward_pass` (K5).  The metric slot
    ``loss_coarse`` is the coarse MSE."""
    want_dist = cfg.distortion_loss_mult > 0.0
    if cfg.stop_pdf_gradient:
        fused = _make_fused_train_forward(cfg, want_dist, render_pass)

        def run(params, origins, dirs, t_vals, generator, noise):
            res = fused(params, origins, dirs, t_vals, generator, noise)
            return res[0], res[1], res[2:] if want_dist else None
    else:
        forward = make_forward_pass(cfg, return_t_fine=want_dist, mlp_fn=mlp_fn)

        def run(params, origins, dirs, t_vals, generator, noise):
            res = forward(params, origins, dirs, t_vals, generator=generator, noise=noise)
            outputs = res[0] if want_dist else res
            rgb_coarse, rgb_fine = outputs[0]
            return rgb_coarse, rgb_fine, (res[1], outputs[2][1]) if want_dist else None

    def loss_fn(params, images, origins, dirs, t_vals, step, generator=None, noise=None):
        del step  # the sampling anneal is proposal-mode only
        rgb_coarse, rgb_fine, dist = run(params, origins, dirs, t_vals, generator, noise)
        loss_coarse = mse(images, rgb_coarse)
        loss_fine = mse(images, rgb_fine)
        loss = loss_coarse + loss_fine
        if dist is not None:
            loss = loss + cfg.distortion_loss_mult * distortion_loss(dist[0], dist[1], near, far)
        return loss, (loss_coarse, loss_fine, rgb_fine)

    return loss_fn


def _make_proposal_loss_fn(cfg: NeRFConfig, near: float, far: float,
                           render_pass: Callable | None = None) -> Callable:
    """The proposal train step's loss, ``(loss, (loss_prop, loss_fine,
    rgb_fine))``: the chain places the fine samples (draws from
    ``generator`` or the per-level uniforms ``noise``), one fine pass
    renders them, and the loss is MSE(fine rgb) + PROP_LOSS_MULT x the
    interlevel loss of each level against the detached fine weights binned
    into its partition (blurred ``[1/4, 1/2, 1/4]`` per the JAX blur rule)
    + DISTORTION_LOSS_MULT x the distortion of the fine weights.
    ``render_pass`` replaces the fine pass (K1/K2 on the card, the plain
    version on the CPU); it gets ``weights_grad`` as a keyword.
    """
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


def make_train_step(cfg: NeRFConfig, near: float, far: float,
                    render_pass: Callable | None = None) -> Callable:
    """The train step: the coarse+fine parity step or the online-proposal
    step, by ``TRAIN_SAMPLER``.  ``render_pass`` replaces the K1 render
    passes (:func:`make_loss_fn`); ``exp_train_paths`` times the parity
    step's other training paths through it.

    ``train_step(state, batch, draws=None, generator=None) -> metrics``
    with ``batch = (images, origins, dirs)`` ``(B, 3)`` tensors on one
    device.  t-values and the fine draws come from ``generator``, or from
    ``draws`` (uniforms in [0, 1); tests replay the JAX package's):
    ``{'t': U, 'pdf': U (B, NS_FINE)}`` for the parity step, ``{'t': U,
    'chain': [U_level1, ...]}`` for the proposal step.  The loss is
    :func:`make_loss_fn`'s.  Gradients land in each parameter's ``.grad``
    (kept after the step), then Adam and the EMA update the state in
    place.  Metrics (0-d device tensors, the JAX meanings): ``loss_coarse``
    the coarse MSE (proposal: the interlevel loss), ``loss`` the fine MSE,
    ``psnr`` of the fine rgb.
    """
    loss_fn = make_loss_fn(cfg, near, far, render_pass=render_pass)
    noise_key = "chain" if cfg.train_sampler == "proposal" else "pdf"

    def train_step(state: TrainState, batch, draws: dict | None = None,
                   generator: torch.Generator | None = None) -> dict:
        images, origins, dirs = batch
        draws = draws or {}
        t_vals = draw_t_vals(cfg, near, far, images.shape[:-1], images.device,
                             generator, draws.get("t"))
        params = params_of(state.params)
        for p in params:
            p.grad = None
        loss, (loss_coarse, loss_fine, rgb_fine) = loss_fn(
            state.params, images, origins, dirs, t_vals, state.step, generator,
            draws.get(noise_key))
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
            "loss_coarse": loss_coarse.detach(),
            "loss": loss_fine.detach(),
            "psnr": psnr(images, rgb_fine.detach()),
        }

    return train_step


def make_eval_step(cfg: NeRFConfig, near: float, far: float) -> Callable:
    """The eval step ``eval_step(models, batch) -> metrics``: centered
    t-values, deterministic draws, no gradients.  ``loss`` and ``psnr`` are
    those of the fine rgb; ``loss_coarse`` the coarse MSE (the coarse+fine
    render, one K1 launch per pass) or, for ``TRAIN_SAMPLER=proposal``, the
    interlevel loss summed over levels."""
    check_render_support(cfg)
    if cfg.train_sampler != "proposal":
        forward = _make_fused_eval_forward(cfg)

        @torch.no_grad()
        def eval_step_coarse(models, batch) -> dict:
            images, origins, dirs = batch
            t_vals = generate_t_vals(near, far, tuple(images.shape[:-1]), cfg.ns_coarse,
                                     "center", device=images.device).contiguous()
            out = forward(models, origins, dirs, t_vals)
            return {"loss_coarse": mse(images, out["rgb_coarse"]),
                    "loss": mse(images, out["rgb_fine"]),
                    "psnr": psnr(images, out["rgb_fine"])}

        return eval_step_coarse
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
    quant: bool = False, want_weights: bool = False,
) -> Callable:
    """``render(prop, fine, origins, dirs) -> {'rgb_fine', 'depth_fine'}``:
    the proposal chain at midpoint draws over ``ns_coarse`` centered
    t-values, then one fine K1 pass over their union with the ``ns_fine``
    draws.  With ``quant`` ``fine`` is the fine model's qparams and the
    fine pass is K4; the proposal nets stay float.  ``want_weights`` adds
    the fine pass's compositing weights ``weights_fine (B, S)`` and the
    sorted t-values they weight, ``t_fine``."""
    fine_pass = _make_pass_fn(cfg, quant=quant)
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
        out = {"rgb_fine": rgb_fine, "depth_fine": depth_fine}
        if want_weights:
            out["weights_fine"] = w_fine
            out["t_fine"] = t_all
        return out

    return render


def make_quant_render_fn(cfg: NeRFConfig, near: float, far: float) -> Callable:
    """``render(qparams, origins, dirs) -> dict`` of rgb/depth for the
    coarse and fine passes, as :func:`make_render_fn`'s common path, with
    both MLP passes through K4 over ``qparams = {'coarse', 'fine'}``
    (``ops/quant.quantize_render_params``).  The pdf draw, the union and
    the compositing stay float32."""
    render_pass = _make_pass_fn(cfg, quant=True)

    def render(qparams, origins, dirs):
        t_vals = generate_t_vals(near, far, tuple(origins.shape[:-1]), cfg.ns_coarse,
                                 "center", device=origins.device).contiguous()
        rgb_coarse, w_coarse = render_pass(qparams["coarse"], origins, dirs, t_vals)
        depth_coarse = torch.sum(w_coarse * t_vals, dim=-1)
        t_mid = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        t_fine = sample_pdf(t_mid, w_coarse, cfg.ns_fine, deterministic=True)
        t_all = sorted_union(t_vals, t_fine).contiguous()
        rgb_fine, w_fine = render_pass(qparams["fine"], origins, dirs, t_all)
        depth_fine = torch.sum(w_fine * t_all, dim=-1)
        if cfg.white_bkgd:
            rgb_coarse = composite_background(rgb_coarse, w_coarse)
            rgb_fine = composite_background(rgb_fine, w_fine)
        return {"rgb_coarse": rgb_coarse, "rgb_fine": rgb_fine,
                "depth_coarse": depth_coarse, "depth_fine": depth_fine}

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


def make_render_fn(cfg: NeRFConfig, near: float, far: float,
                   full: bool = False, want_weights: bool = False) -> Callable:
    """``render(models, origins, dirs) -> dict`` of rgb/depth maps; the
    rays are ``(B, 3)`` tensors on one device.  ``models`` is ``{'coarse',
    'fine'}`` (coarse and fine passes reported) or, for
    ``TRAIN_SAMPLER=proposal``, ``{'proposal', 'fine'}`` (fine only).

    ``full=True`` (coarse+fine only) adds the reference's other four
    tensors: ``weights_coarse``/``weights_fine`` ``(B, S)`` and the raw
    predictions ``preds_coarse``/``preds_fine`` ``(B, S, 4)``, rendered
    through :func:`make_forward_pass` (K5's forward on the card); the
    rgb/depth-only render stays on K1, which keeps them on chip.
    ``want_weights`` (proposal only) adds ``weights_fine`` and ``t_fine``
    (:func:`make_proposal_render_fn`)."""
    check_render_support(cfg)
    if cfg.train_sampler == "proposal":
        if full:
            raise ValueError(
                "full=True is unavailable for TRAIN_SAMPLER='proposal' "
                "checkpoints: there is no coarse pass, and the proposal "
                "render emits rgb/depth fine only"
            )
        inner = make_proposal_render_fn(
            cfg, near, far, prop_l_xyz=cfg.prop_l_xyz, union=cfg.prop_union,
            levels=cfg.prop_levels, prop_samples=cfg.prop_samples,
            want_weights=want_weights,
        )

        def render_proposal(models, origins, dirs):
            return inner(models["proposal"], models["fine"], origins, dirs)

        return render_proposal

    def center_t(origins):
        return generate_t_vals(near, far, origins.shape[:-1], cfg.ns_coarse, "center",
                               device=origins.device).contiguous()

    if full:
        forward_full = make_forward_pass(cfg)

        def render_full(models, origins, dirs):
            rgb, depth, weights, preds = forward_full(
                models, origins, dirs, center_t(origins), deterministic=True)
            return {
                "rgb_coarse": rgb[0], "rgb_fine": rgb[1],
                "depth_coarse": depth[0], "depth_fine": depth[1],
                "weights_coarse": weights[0], "weights_fine": weights[1],
                "preds_coarse": preds[0], "preds_fine": preds[1],
            }

        return render_full

    forward = _make_fused_eval_forward(cfg)

    def render(models, origins, dirs):
        out = forward(models, origins, dirs, center_t(origins))
        return {
            k: out[k]
            for k in ("rgb_coarse", "rgb_fine", "depth_coarse", "depth_fine")
        }

    return render
