"""Trainer: owns the models, trains them and renders frames from them.

Counterpart of ``nerf_keras_tpu/engine/trainer.py``.  One device, no mesh:
``device`` is resolved explicitly.

The models are ``{'coarse', 'fine'}`` (``TRAIN_SAMPLER=coarse``, the
parity step) or ``{'proposal', 'fine'}``, initialized from ``cfg.seed``,
with the Adam state, the EMA shadow (EMA_DECAY > 0, a copy of the params
at init), the step count and a ``torch.Generator`` on the device (seeded
from ``cfg.seed``) that draws the t-values and the fine draws.
``train_step``, ``train_epoch``, ``evaluate`` and the renders
(``render_rays(full=True)`` adds the weights and raw predictions of the
coarse+fine render).  The train and eval steps are built at first use, so
a trainer that only serves never checks the training knobs.

int8 inference: ``quantize_for_inference`` calibrates the eval weights on
given rays and installs the int8 tables; ``render_rays(quant=True)`` and
``render_image(quant=True)`` then run every MLP pass through K4.  The
tables are a snapshot of the weights: ``restore``, ``replace_params`` and
``train_step`` drop them (``quant_ready`` turns false).

``restore``/``save`` read and write the JAX package's ``.ckpt.npz`` key
format: ``save`` writes params, EMA, step and the Adam state (so the JAX
package's ``Trainer.restore`` loads it); ``restore`` reads them back, so
a resumed run carries on Adam's moments and its count (which the
``LR_FINAL`` decay reads).  A checkpoint without the Adam state restores
with a fresh Adam.
"""

from __future__ import annotations

import copy
from typing import Iterable

import numpy as np
import torch
from torch import nn

from nerf_keras_tpu_torch.config import NeRFConfig
from nerf_keras_tpu_torch.engine.step import (
    TrainState,
    check_train_support,
    make_eval_step,
    make_optimizer,
    make_proposal_render_fn,
    make_quant_render_fn,
    make_render_fn,
    make_train_step,
    params_of,
)
from nerf_keras_tpu_torch.models.mlp import NeRFMLP
from nerf_keras_tpu_torch.ops.proposal import (
    chain_nets,
    init_proposal_chain,
    proposal_to_jax,
)
from nerf_keras_tpu_torch.ops.quant import (
    calibrate_render,
    calibrate_render_proposal,
    mlp_tree,
    quantize_render_params,
)
from nerf_keras_tpu_torch.ops.rays import get_rays
from nerf_keras_tpu_torch.runtime import resolve_device
from nerf_keras_tpu_torch.utils.checkpoint import (
    check_render_support,
    load_checkpoint,
    save_params_npz,
)


def rgb_to_u8(rgb: torch.Tensor) -> torch.Tensor:
    """[0,1] f32 -> uint8 on the device: clip*255 then a truncating cast,
    exactly the host-side ``utils/image.to_uint8``."""
    return torch.clamp(255.0 * rgb, 0.0, 255.0).to(torch.uint8)


def _to_jax(models: dict[str, nn.Module], grad: bool = False) -> dict:
    """``{name: JAX-layout tree}`` of the models' parameters (or grads)."""
    return {name: (proposal_to_jax(m, grad) if name == "proposal" else m.to_jax_params(grad))
            for name, m in models.items()}


def _load(models: dict[str, nn.Module], tree: dict) -> None:
    """Copy a ``{name: JAX-layout tree}`` into the models, in place."""
    for name, m in models.items():
        if name != "proposal":
            m.load_jax_params(tree[name])
            continue
        nets = chain_nets(m)
        sub = tree[name]
        trees = [sub] if "layers" in sub else [sub[f"l{i + 1}"] for i in range(len(sub))]
        if len(trees) != len(nets):
            raise ValueError(f"checkpoint has {len(trees)} proposal level(s), "
                             f"the config {len(nets)}")
        for net, t in zip(nets, trees):
            net.load_jax_params(t)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device).contiguous()


def _realize_means(acc: dict[str, list[torch.Tensor]]) -> dict[str, float]:
    """Per-metric means with one device-to-host copy."""
    keys = list(acc)
    vec = torch.stack([torch.stack(acc[k]).mean() for k in keys]).cpu().numpy()
    return {k: float(v) for k, v in zip(keys, vec)}


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
        self.proposal = cfg.train_sampler == "proposal"
        gen = torch.Generator().manual_seed(cfg.seed)
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

        def nerf() -> NeRFMLP:
            return NeRFMLP(
                num_layers=cfg.num_layers, hidden_dim=cfg.hidden_dim,
                skip_layer=cfg.skip_layer, l_xyz=cfg.l_xyz, l_dir=cfg.l_dir,
                batch_norm=cfg.batch_norm, compute_dtype=dtype,
                generator=gen, device=self.device,
            )

        if self.proposal:
            self.params = {
                "proposal": init_proposal_chain(
                    cfg.prop_levels, cfg.prop_l_xyz, cfg.prop_hidden,
                    cfg.prop_depth, generator=gen, device=self.device),
                "fine": nerf(),
            }
        else:
            self.params = {name: nerf() for name in ("coarse", "fine")}
        # The EMA shadow (EMA_DECAY > 0) serves every render and eval, as
        # in the JAX package's Trainer._eval_state.
        self.ema = None
        if cfg.ema_decay > 0:
            self.ema = {k: copy.deepcopy(m).requires_grad_(False)
                        for k, m in self.params.items()}
        self.state = TrainState(self.params, self._new_optimizer(), self.ema)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._train_step = self._eval_step = self._render_full = None
        self._render = make_render_fn(cfg, self.near, self.far)
        self._qparams = self._render_q = None

    def _new_optimizer(self):
        return make_optimizer(self.cfg, params_of(self.params))

    @property
    def step(self) -> int:
        return self.state.step

    @step.setter
    def step(self, value: int) -> None:
        self.state.step = value

    def _invalidate_derived(self) -> None:
        """Drop the weight-derived int8 tables: they were calibrated for
        the weights they were built from, and a server must never render
        stale scales after new weights arrive."""
        self._qparams = self._render_q = None

    def restore(self, path: str) -> "Trainer":
        """Load a ``.ckpt.npz`` (JAX key format) into this trainer.  With
        EMA on, a checkpoint without a shadow seeds it from its params
        (the JAX package's forward-compat rule).  Adam's count and moments
        come from the checkpoint when it has them, else Adam restarts."""
        ckpt = load_checkpoint(path)
        check_render_support(self.cfg, step=ckpt["step"])
        _load(self.params, ckpt["params"])
        if self.ema is not None:
            _load(self.ema, ckpt["ema"] if ckpt["ema"] is not None else ckpt["params"])
        self.step = ckpt["step"]
        self.state.opt = self._new_optimizer()
        if ckpt["opt_state"] is not None:
            self._load_adam(ckpt["opt_state"])
        self._invalidate_derived()
        return self

    def _load_adam(self, opt_state: dict) -> None:
        """Install Adam's count and moments (JAX-layout trees, as the
        params) into the optimizer, in ``params_of`` order."""
        opt = self.state.opt
        for values, tree in ((opt.mu, opt_state["mu"]), (opt.nu, opt_state["nu"])):
            shadow = {k: copy.deepcopy(m) for k, m in self.params.items()}
            with torch.no_grad():
                _load(shadow, tree)
                for v, p in zip(values, params_of(shadow)):
                    v.copy_(p)
        opt.count = int(opt_state["count"])

    def save(self, path: str, scene: dict | None = None) -> None:
        """Write params, EMA, step and the Adam state in the JAX key format."""
        opt = self.state.opt

        def moments(values: list[torch.Tensor]) -> dict:
            shadow = {k: copy.deepcopy(m) for k, m in self.params.items()}
            with torch.no_grad():
                for p, v in zip(params_of(shadow), values):
                    p.copy_(v)
            return _to_jax(shadow)

        save_params_npz(path, _to_jax(self.params), self.cfg, scene=scene,
                        step=self.step,
                        ema=_to_jax(self.ema) if self.ema is not None else None,
                        opt_state={"count": opt.count, "mu": moments(opt.mu),
                                   "nu": moments(opt.nu)})

    def replace_params(self, params: dict) -> "Trainer":
        """Install externally built JAX-layout params (``{'coarse',
        'fine'}`` or ``{'proposal', 'fine'}``).  With EMA on, the shadow
        resets to the new params.  Adam's state is kept, as the JAX
        ``Trainer.replace_params`` keeps ``opt_state``."""
        _load(self.params, params)
        if self.ema is not None:
            _load(self.ema, params)
        self._invalidate_derived()
        return self

    def params_tree(self, grad: bool = False) -> dict:
        """The params (or, with ``grad``, the last step's gradients) as
        ``{name: JAX-layout tree}`` of numpy arrays."""
        return _to_jax(self.params, grad)

    def ema_tree(self) -> dict | None:
        return None if self.ema is None else _to_jax(self.ema)

    @property
    def eval_params(self) -> dict[str, nn.Module]:
        """Models every eval and render consumes (the EMA shadow when on)."""
        return self.ema if self.ema is not None else self.params

    # ------------------------------------------------------------------
    def put_batch(self, batch) -> tuple[torch.Tensor, ...]:
        """``(images, origins, dirs)`` as contiguous f32 tensors on the device."""
        return tuple(torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                                     dtype=torch.float32, device=self.device).contiguous()
                     for x in batch)

    def train_step(self, batch, draws: dict | None = None) -> dict:
        """One optimization step; metrics as 0-d device tensors (no host
        sync).  ``draws`` replaces the generator's uniforms (tests; see
        :func:`make_train_step`)."""
        if self._train_step is None:
            check_train_support(self.cfg, self.device)
            self._train_step = make_train_step(self.cfg, self.near, self.far)
        self._invalidate_derived()
        return self._train_step(self.state, self.put_batch(batch), draws,
                                self.generator)

    def train_epoch(self, batches: Iterable) -> dict:
        """Run all batches; epoch-mean metrics as floats, fetched from the
        device once at the end."""
        acc: dict[str, list] = {}
        for batch in batches:
            for k, v in self.train_step(batch).items():
                acc.setdefault(k, []).append(v)
        return _realize_means(acc)

    def eval_step(self, batch) -> dict:
        if self._eval_step is None:
            check_train_support(self.cfg, self.device)
            self._eval_step = make_eval_step(self.cfg, self.near, self.far)
        return self._eval_step(self.eval_params, self.put_batch(batch))

    def evaluate(self, batches: Iterable) -> dict:
        """Mean eval metrics over batches, fetched once."""
        acc: dict[str, list] = {}
        for batch in batches:
            for k, v in self.eval_step(batch).items():
                acc.setdefault(k, []).append(v)
        return _realize_means(acc)

    # ------------------------------------------------------------------
    def quantize_for_inference(self, origins, directions, calib_rays: int = 2048,
                               seed: int = 0) -> "Trainer":
        """Calibrate the int8 render on representative rays (``(N, 3)``
        numpy arrays or tensors) and install its tables.  More than
        ``calib_rays`` rays are subsampled without replacement by
        ``np.random.default_rng(seed)``, as the JAX package does.  The
        eval weights (the EMA shadow when on) are calibrated: coarse and
        fine, or the fine MLP at the t-unions of the float proposal chain
        for ``TRAIN_SAMPLER=proposal``.  Gate the result against the float
        render (PSNR) before serving it, as the server does."""
        if self.cfg.batch_norm:
            raise ValueError("int8 inference has no BatchNorm variant; use the float "
                             "path for BN configs")

        def host(x):
            if torch.is_tensor(x):
                x = x.detach().cpu()
            return np.asarray(x, np.float32).reshape(-1, 3)

        origins, directions = host(origins), host(directions)
        if origins.shape[0] > calib_rays:
            idx = np.random.default_rng(seed).choice(origins.shape[0], calib_rays,
                                                     replace=False)
            origins, directions = origins[idx], directions[idx]
        o = torch.tensor(origins, device=self.device)
        d = torch.tensor(directions, device=self.device)
        models = self.eval_params
        trees = {k: mlp_tree(m) for k, m in models.items() if k != "proposal"}
        with torch.no_grad():
            if self.proposal:
                stats = calibrate_render_proposal(
                    {"proposal": models["proposal"], **trees}, self.cfg, self.near,
                    self.far, o, d)
            else:
                stats = calibrate_render(trees, self.cfg, self.near, self.far, o, d)
            self.install_quant(quantize_render_params(trees, stats, self.cfg.skip_layer))
        return self

    def install_quant(self, qparams: dict) -> "Trainer":
        """Install int8 tables (``{'coarse', 'fine'}``, or ``{'fine'}`` for
        a proposal-trained model; tensors, e.g. ``ops/quant.qparams_from_jax``
        of the JAX package's) and build the int8 render."""
        names = ("fine",) if self.proposal else ("coarse", "fine")
        self._qparams = _tree_to({k: qparams[k] for k in names}, self.device)
        cfg = self.cfg
        if self.proposal:
            inner = make_proposal_render_fn(
                cfg, self.near, self.far, prop_l_xyz=cfg.prop_l_xyz,
                union=cfg.prop_union, levels=cfg.prop_levels,
                prop_samples=cfg.prop_samples, quant=True)
            qfine = self._qparams["fine"]
            self._render_q = lambda models, o, d: inner(models["proposal"], qfine, o, d)
        else:
            render = make_quant_render_fn(cfg, self.near, self.far)
            qp = self._qparams
            self._render_q = lambda models, o, d: render(qp, o, d)
        return self

    @property
    def quant_ready(self) -> bool:
        """True when the int8 render is calibrated for the current weights."""
        return self._qparams is not None

    @property
    def qparams(self) -> dict | None:
        """The installed int8 tables, or None."""
        return self._qparams

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
        full: bool = False,
        quant: bool = False,
    ) -> dict[str, np.ndarray]:
        """Render a flat ray batch in fixed-size chunks.

        The last chunk is padded with dummy forward-facing rays so every
        chunk has one shape; their outputs are dropped.  ``keys``
        restricts the outputs kept; ``uint8_rgb`` converts rgb maps to
        uint8 on the device before the one copy to the host.  ``full``
        (coarse+fine only) adds ``weights_*`` and ``preds_*`` (see
        :func:`make_render_fn`); asking ``keys`` for one of them implies it.
        A proposal-trained model has no coarse pass: ``keys`` may ask for
        ``weights_fine`` and ``t_fine`` (the fine pass's compositing
        weights and their sorted t-values), as the JAX ``Trainer`` gives.
        ``quant`` renders through the int8 tables
        (:meth:`quantize_for_inference` first; rgb/depth only).
        """
        requested = set(keys or ())
        want_weights = self.proposal and bool(requested & {"weights_fine", "t_fine"})
        if self.proposal and (full or requested - {"rgb_fine", "depth_fine",
                                                   "weights_fine", "t_fine"}):
            raise ValueError(
                "TRAIN_SAMPLER='proposal' checkpoints have no coarse pass: "
                "rgb_fine, depth_fine, weights_fine and t_fine are the only outputs"
            )
        full = full or (not self.proposal
                        and any(k.startswith(("weights_", "preds_")) for k in requested))
        if quant and want_weights:
            raise ValueError("quant=True supports rgb/depth outputs only (weights_fine/t_fine "
                             "are not on the int8 render path)")
        if quant:
            if full:
                raise ValueError("quant=True supports rgb/depth outputs only (the int8 "
                                 "kernel does not emit weights/raw preds)")
            if self._render_q is None:
                raise RuntimeError("call quantize_for_inference(...) before rendering "
                                   "with quant=True")
            render = self._render_q
        elif full or want_weights:
            if self._render_full is None:
                self._render_full = make_render_fn(self.cfg, self.near, self.far,
                                                   full=full, want_weights=want_weights)
            render = self._render_full
        else:
            render = self._render
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
            res = render(models, origins[start:start + chunk],
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
        uint8_rgb: bool = False, need_depth: bool = True, quant: bool = False,
    ) -> dict[str, np.ndarray]:
        """Render one frame from a camera pose; returns HxW maps (the
        proposal render has no coarse maps).  ``quant``: every MLP pass
        through the int8 tables."""
        if include_coarse and self.proposal:
            raise ValueError("TRAIN_SAMPLER=proposal renders no coarse pass")
        origins, dirs = self.pose_rays(pose, height, width, focal)
        if include_coarse:
            keys = None
        elif need_depth:
            keys = ("rgb_fine", "depth_fine")
        else:
            keys = ("rgb_fine",)
        out = self.render_rays(origins, dirs, chunk=chunk, keys=keys,
                               uint8_rgb=uint8_rgb, quant=quant)
        result = {"rgb": out["rgb_fine"].reshape(height, width, 3)}
        if "depth_fine" in out:
            result["depth"] = out["depth_fine"].reshape(height, width)
        if include_coarse:
            result["rgb_coarse"] = out["rgb_coarse"].reshape(height, width, 3)
            result["depth_coarse"] = out["depth_coarse"].reshape(height, width)
        return result
