"""Trainer: owns the models, trains them and renders frames from them.

Counterpart of ``nerf_keras_tpu/engine/trainer.py``.  ``device`` is
resolved explicitly.  Parallelism (``mesh``, ``parallel/mesh.py``): one
process per device on a ``(data, model)`` mesh; by default the mesh comes
from the config's ``MESH_DATA``/``MESH_MODEL`` when a process group is
initialized (``parallel.distributed.maybe_initialize``), and without one
the config must ask for a world of 1.  Under a mesh ``train_step`` takes
this rank's rows of the global batch (``put_batch``: its data rank's,
the same on every model rank) and makes one gradient all-reduce over the
data group; ``eval_step``/``evaluate`` take batches every rank holds
whole (``put_global_batch``) and give the global metrics through one
all-reduce a batch; the renders split each chunk over the data ranks and
all-gather the maps, with no all-reduce over the data group.  The
parameters, the EMA shadow and the BatchNorm statistics are broadcast
over each data group from its first rank after init and after
``restore``.

With a model axis (``MESH_MODEL > 1``) the NeRF MLPs are initialised
whole from the seed, as in one process, and each rank keeps its blocks
(``models/mlp.py``); the Adam moments and the EMA shadow are blocks of
the same leaves (Adam is elementwise), the proposal nets whole.  Every
float pass runs the split MLP (``engine/step.py``).  Whatever reads whole
trees gathers them over the model group on every rank first: ``save``,
``params_tree``/``ema_tree``/``bn_tree``, ``infer_digest`` (so an
``.infer.npz`` written under a model axis is one process's), the int8
calibration and the proposal distillation; ``restore`` and
``replace_params`` slice whole trees.

What is derived from the weights after training is built on rank 0 alone
and shared (``parallel/mesh.share_from_main``), as the JAX package builds
it on one device and replicates it: ``quantize_for_inference`` calibrates
on rank 0's rays, ``build_proposal_sampler`` distills on them (and prints
there), and ``load_inference_artifacts`` reads the file and checks its
digest on rank 0, so every rank installs the same tables and net, bit for
bit, or raises the same error; ``save_inference_artifacts`` writes from
rank 0.  Every rank then renders its rows of each chunk through them, as
for the float render.  The checks that refuse a call depend on the config
and the model alone, so every rank refuses it before any collective.

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
``render_image(quant=True)`` then run every MLP pass through K4.

The distilled proposal sampler (coarse-trained models):
``build_proposal_sampler`` fits a tiny density net to the eval fine
model's density (``ops/proposal.distill_proposal``) on given rays;
``render_rays(sampler='proposal')`` then places the fine samples with it
and renders one fine pass (K1, or K4 with ``quant``), with no coarse pass.
On a proposal-trained model every render already uses its own proposal
nets, and ``sampler='proposal'`` changes nothing.

The int8 tables and the distilled net are snapshots of the weights:
``restore``, ``replace_params`` and ``train_step`` drop them
(``quant_ready``/``proposal_ready`` turn false).  ``save_inference_
artifacts`` and ``load_inference_artifacts`` keep them in an
``.infer.npz`` keyed by ``infer_digest`` (``utils/infer_cache.py``, the
JAX package's format), so another process skips the rebuild.

``restore``/``save`` read and write the JAX package's ``.ckpt.npz`` key
format: ``save`` writes params, EMA, BatchNorm statistics, step and the
Adam state (so the JAX package's ``Trainer.restore`` loads it);
``restore`` reads them back, so a resumed run carries on Adam's moments
and its count (which the ``LR_FINAL`` decay reads).  A checkpoint
without the Adam state restores with a fresh Adam.

With ``FREQ_ANNEAL_STEPS`` every eval, render, int8 calibration,
proposal distillation and ``infer_digest`` reads the eval weights with the
window at the current step folded in (``_folded_eval_params``, built once
per step); the masked octaves' columns hold init values that the trained
paths never see.  NDC models (``NDC``) take NDC rays from ``pose_rays``,
which refuses a camera that is not forward-facing.

``BATCH_NORM`` models keep their running statistics as module buffers;
the EMA shadow carries the training models' statistics (the JAX eval
state pairs the EMA params with the trained ``bn``).
"""

from __future__ import annotations

import copy
import time
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
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.freq_anneal import FoldedModels, fold_train_params
from nerf_keras_tpu_torch.ops.proposal import (
    ProposalMLP,
    chain_nets,
    distill_proposal,
    init_proposal_chain,
    proposal_to_jax,
)
from nerf_keras_tpu_torch.ops.quant import (
    calibrate_render,
    calibrate_render_proposal,
    mlp_tree,
    qparams_from_jax,
    qparams_to_jax,
    quantize_render_params,
)
from nerf_keras_tpu_torch.ops.rays import NDC_NEAR_PLANE, get_rays, ndc_rays
from nerf_keras_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    broadcast_,
    config_mesh,
    is_main,
    local_rows,
    share_from_main,
    split_model,
)
from nerf_keras_tpu_torch.runtime import resolve_device
from nerf_keras_tpu_torch.utils import io
from nerf_keras_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    models_bn,
    models_to_jax,
    save_checkpoint,
)
from nerf_keras_tpu_torch.utils.infer_cache import (
    StaleArtifactsError,
    load_artifacts,
    params_digest,
    save_artifacts,
)


def rgb_to_u8(rgb: torch.Tensor) -> torch.Tensor:
    """[0,1] f32 -> uint8 on the device: clip*255 then a truncating cast,
    exactly the host-side ``utils/image.to_uint8``."""
    return torch.clamp(255.0 * rgb, 0.0, 255.0).to(torch.uint8)


def _load(models: dict[str, nn.Module], tree: dict, bn: dict | None = None) -> None:
    """Copy a ``{name: JAX-layout tree}`` (and, when given, the BatchNorm
    models' ``{name: bn_state}``) into the models, in place."""
    for name, m in models.items():
        if name != "proposal":
            m.load_jax_params(tree[name])
            if bn is not None and m.batch_norm:
                m.load_bn_state(bn[name])
            continue
        nets = chain_nets(m)
        sub = tree[name]
        trees = [sub] if "layers" in sub else [sub[f"l{i + 1}"] for i in range(len(sub))]
        if len(trees) != len(nets):
            raise ValueError(f"checkpoint has {len(trees)} proposal level(s), "
                             f"the config {len(nets)}")
        for net, t in zip(nets, trees):
            net.load_jax_params(t)


def _subsample(origins, directions, n: int, seed: int):
    """At most ``n`` rays (numpy or tensors on any device) as ``(N, 3)``
    float32 numpy, drawn without replacement by
    ``np.random.default_rng(seed)`` as the JAX package draws them."""
    origins, directions = (
        np.asarray(x.detach().cpu() if torch.is_tensor(x) else x, np.float32).reshape(-1, 3)
        for x in (origins, directions))
    if origins.shape[0] > n:
        idx = np.random.default_rng(seed).choice(origins.shape[0], n, replace=False)
        origins, directions = origins[idx], directions[idx]
    return origins, directions


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
    """Owns the models for one (config, scene-bounds) pair on one device
    (this rank's, under a mesh)."""

    def __init__(
        self,
        cfg: NeRFConfig,
        near: float,
        far: float,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
    ):
        if mesh is None:
            mesh = config_mesh(cfg.mesh_data, cfg.mesh_model)
        if mesh is not None and cfg.batch_size % mesh.data:
            raise ValueError(f"batch_size={cfg.batch_size} must be divisible by the data "
                             f"mesh axis ({mesh.data} ranks)")
        self.mesh = mesh
        self.tp = split_model(mesh)
        self.cfg = cfg
        self.near = float(near)
        self.far = float(far)
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(None if device is None else str(device))
        self.proposal = cfg.train_sampler == "proposal"
        gen = torch.Generator().manual_seed(cfg.seed)
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

        def nerf() -> NeRFMLP:
            return NeRFMLP(
                num_layers=cfg.num_layers, hidden_dim=cfg.hidden_dim,
                skip_layer=cfg.skip_layer, l_xyz=cfg.l_xyz, l_dir=cfg.l_dir,
                batch_norm=cfg.batch_norm, compute_dtype=dtype,
                generator=gen, device=self.device, mesh=mesh,
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
        # Every rank seeds the same generator: the train step draws at the
        # global batch shape and keeps its rows (step.rank_draws).
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._train_step = self._eval_step = self._render_full = None
        self._render = make_render_fn(cfg, self.near, self.far)
        self._invalidate_derived()
        self._broadcast_state()

    def _new_optimizer(self):
        return make_optimizer(self.cfg, params_of(self.params))

    def state_tensors(self) -> list[torch.Tensor]:
        """The parameters and buffers (BatchNorm statistics) of the models,
        then of the EMA shadow: the state every rank must hold alike."""
        return [t for models in (self.params, self.ema or {}) for k in sorted(models)
                for t in (*models[k].parameters(), *models[k].buffers())]

    def _broadcast_state(self) -> None:
        """Under a mesh, the :meth:`state_tensors` of data rank 0 of this
        rank's model index on each rank of its data group (one broadcast;
        global rank ``model_rank`` is that rank)."""
        if self.mesh is not None:
            broadcast_([t.data for t in self.state_tensors()], self.mesh,
                       src=self.mesh.model_rank, axis="data")

    @property
    def step(self) -> int:
        return self.state.step

    @step.setter
    def step(self, value: int) -> None:
        self.state.step = value

    def _invalidate_derived(self) -> None:
        """Drop the weight-derived int8 tables and distilled proposal net:
        each is a function of the weights it was built from, and a server
        must never render stale ones after new weights arrive."""
        self._qparams = self._render_q = None
        self._folded = None
        self._pparams = self._render_p = self._render_pq = None
        self._prop_l_xyz = self._distill_loss = None
        self.distill_losses: list[float] = []

    def restore(self, path: str) -> "Trainer":
        """Load a ``.ckpt.npz`` (JAX key format) into this trainer.  With
        EMA on, a checkpoint without a shadow seeds it from its params
        (the JAX package's forward-compat rule).  Adam's count and moments
        come from the checkpoint when it has them, else Adam restarts."""
        ckpt = load_checkpoint(path)
        if self.cfg.batch_norm and ckpt["bn"] is None:
            raise KeyError(f"checkpoint at {path} has no BatchNorm statistics (.bn) "
                           "for this BATCH_NORM config")
        _load(self.params, ckpt["params"], ckpt["bn"])
        if self.ema is not None:
            _load(self.ema, ckpt["ema"] if ckpt["ema"] is not None else ckpt["params"],
                  ckpt["bn"])
        self.step = ckpt["step"]
        self.state.opt = self._new_optimizer()
        if ckpt["opt_state"] is not None:
            self._load_adam(ckpt["opt_state"])
        self._invalidate_derived()
        self._broadcast_state()
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
        """Write params, EMA, BatchNorm statistics, step and the Adam state
        in the JAX key format (:func:`save_checkpoint`).  Under a mesh every
        rank calls it (a model axis gathers the trees) and rank 0 writes."""
        save_checkpoint(path, self.state, self.cfg, scene=scene,
                        write=is_main(self.mesh))

    def replace_params(self, params: dict, bn: dict | None = None) -> "Trainer":
        """Install externally built JAX-layout params (``{'coarse',
        'fine'}`` or ``{'proposal', 'fine'}``, and ``bn`` ``{'coarse',
        'fine'}`` running statistics for BatchNorm models).  With EMA on,
        the shadow resets to the new params.  Adam's state is kept, as the
        JAX ``Trainer.replace_params`` keeps ``opt_state``."""
        _load(self.params, params, bn)
        if self.ema is not None:
            _load(self.ema, params, bn)
        self._invalidate_derived()
        return self

    def params_tree(self, grad: bool = False) -> dict:
        """The params (or, with ``grad``, the last step's gradients) as
        ``{name: JAX-layout tree}`` of whole numpy arrays (a collective of
        every model rank under a model axis, as are :meth:`ema_tree` and
        :meth:`bn_tree`)."""
        return models_to_jax(self.params, grad)

    def ema_tree(self) -> dict | None:
        return None if self.ema is None else models_to_jax(self.ema)

    def bn_tree(self) -> dict | None:
        """The BatchNorm running statistics, ``{name: bn_state}``, or None."""
        return models_bn(self.params)

    @property
    def eval_params(self) -> dict[str, nn.Module]:
        """The raw eval models: the EMA shadow when on, else the params."""
        return self.ema if self.ema is not None else self.params

    def _folded_eval_params(self) -> FoldedModels:
        """The models every eval, render and derived artifact consumes:
        :attr:`eval_params` with the frequency-anneal window at the current
        step folded in (``fold_train_params``: copies, rebuilt when the step
        or the weights change; the eval models themselves where the fold
        is the identity, no anneal or past its horizon)."""
        if self._folded is None or self._folded.step != self.step:
            # Normal tensors even when asked inside render_rays'
            # inference mode: the kernels' pack caches read versions.
            with torch.inference_mode(False):
                self._folded = fold_train_params(self.cfg, self.eval_params, self.step)
        return self._folded

    def _whole_eval_params(self) -> FoldedModels:
        """:meth:`_folded_eval_params` whole: under a model axis, each NeRF
        MLP gathered (on every model rank) into an unsplit copy, which a
        rank may then use alone."""
        models = self._folded_eval_params()
        if self.tp is None:
            return models
        return FoldedModels({k: m if k == "proposal" else NeRFMLP.from_jax_params(
            m.to_jax_params(), skip_layer=m.skip_layer, compute_dtype=m.compute_dtype,
            device=self.device, bn_state=m.bn_state()) for k, m in models.items()},
            models.step)

    # ------------------------------------------------------------------
    def put_batch(self, batch) -> tuple[torch.Tensor, ...]:
        """``(images, origins, dirs)`` as contiguous f32 tensors on the
        device; under a mesh the caller's own rows of the global batch
        (``BATCH_SIZE / data`` each, in data rank order)."""
        return tuple(torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                                     dtype=torch.float32, device=self.device).contiguous()
                     for x in batch)

    def put_global_batch(self, batch) -> tuple[torch.Tensor, ...]:
        """This rank's contiguous rows of a batch every rank holds whole
        (val batches); the whole batch on one process."""
        if self.mesh is None:
            return self.put_batch(batch)
        return self.put_batch(tuple(x[local_rows(x.shape[0], self.mesh)] for x in batch))

    def train_step(self, batch, draws: dict | None = None) -> dict:
        """One optimization step; metrics as 0-d device tensors (no host
        sync).  ``draws`` replaces the generator's uniforms (tests; see
        :func:`make_train_step`; global-shaped under a mesh)."""
        if self._train_step is None:
            check_train_support(self.cfg)
            if self.tp is not None:
                print(f"[nerf-torch] MESH_MODEL={self.tp.model}: every float pass runs the "
                      f"split MLP (NeRFMLP.forward), no K1/K2/K5: the JAX package resolves "
                      f"use_pallas=False under tensor parallelism", flush=True)
            self._train_step = make_train_step(self.cfg, self.near, self.far, mesh=self.mesh)
        self._invalidate_derived()
        return self._train_step(self.state, self.put_batch(batch), draws,
                                self.generator)

    def train_epoch(self, batches: Iterable, log_every: int = 0) -> dict:
        """Run all batches; epoch-mean metrics as floats, fetched from the
        device once at the end.  ``log_every > 0`` prints the step's
        metrics every N steps (each print waits for the device)."""
        acc: dict[str, list] = {}
        count = 0
        for batch in batches:
            metrics = self.train_step(batch)
            for k, v in metrics.items():
                acc.setdefault(k, []).append(v)
            count += 1
            if log_every and count % log_every == 0:
                print(f"  step {self.step}: loss={float(metrics['loss']):.5f} "
                      f"loss_coarse={float(metrics['loss_coarse']):.5f} "
                      f"psnr={float(metrics['psnr']):.2f}")
        return _realize_means(acc)

    def eval_step(self, batch) -> dict:
        """Metrics of the eval models on ``batch`` (under a mesh a batch
        every rank holds whole: each evaluates its rows, one all-reduce)."""
        if self._eval_step is None:
            check_train_support(self.cfg)
            self._eval_step = make_eval_step(self.cfg, self.near, self.far, mesh=self.mesh)
        return self._eval_step(self._folded_eval_params(), self.put_global_batch(batch))

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
        fine, or the fine MLP at the t-values the float proposal chain
        places for ``TRAIN_SAMPLER=proposal`` (its union with the grid, or
        the draws alone under ``PROP_UNION=false``).  Gate the result
        against the float render (PSNR) before serving it, as the server
        does.  Under a mesh rank 0 calibrates on its rays (the other
        ranks' are not read; a model axis first gathers the weights on every
        rank) and every rank installs its tables."""
        if self.cfg.batch_norm:
            raise ValueError("int8 inference has no BatchNorm variant; use the float "
                             "path for BN configs")
        models = self._whole_eval_params()
        return self.install_quant(share_from_main(
            lambda: (None, self._calibrate(models, origins, directions, calib_rays, seed)),
            self.mesh)[1])

    def calibrate_int8(self, origins, directions, calib_rays: int = 2048,
                       seed: int = 0) -> dict:
        """The int8 tables this process calibrates on the rays, neither
        installed nor shared: what :meth:`quantize_for_inference` computes
        (on rank 0 under a mesh; every model rank calls it)."""
        return self._calibrate(self._whole_eval_params(), origins, directions, calib_rays,
                               seed)

    def _calibrate(self, models: dict, origins, directions, calib_rays: int,
                   seed: int) -> dict:
        o, d = (torch.tensor(x, device=self.device)
                for x in _subsample(origins, directions, calib_rays, seed))
        trees = {k: mlp_tree(m) for k, m in models.items() if k != "proposal"}
        with torch.no_grad():
            if self.proposal:
                stats = calibrate_render_proposal(
                    {"proposal": models["proposal"], **trees}, self.cfg, self.near,
                    self.far, o, d)
            else:
                stats = calibrate_render(trees, self.cfg, self.near, self.far, o, d)
            return quantize_render_params(trees, stats, self.cfg.skip_layer)

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

    @property
    def proposal_net(self) -> ProposalMLP | None:
        """The installed distilled proposal net, or None."""
        return self._pparams

    # ------------------------------------------------------------------
    def build_proposal_sampler(
        self, origins, directions, *, calib_rays: int = 65536, steps: int = 1500,
        batch: int = 16384, hidden: int = 64, depth: int = 3, l_xyz: int = 4,
        lr: float = 2e-3, under_weight: float = 4.0, seed: int = 0,
    ) -> "Trainer":
        """Distill the eval fine model's density (the EMA shadow when on)
        into a proposal net (:func:`distill_proposal`) and install it for
        ``render_rays(sampler='proposal')``.  Pass rays from several poses
        of the render path: a frustum the net never saw is one it can only
        extrapolate into.  More than ``calib_rays`` rays are subsampled as
        :meth:`quantize_for_inference` does.  Gate the result against the
        coarse sampler (PSNR) before serving it, as the CLIs do.  Under a
        mesh rank 0 distills on its rays and every rank installs its net,
        its final loss and :attr:`distill_losses`."""
        if self.proposal:
            raise ValueError(
                "TRAIN_SAMPLER='proposal' checkpoints already carry their proposal net "
                "in the train state, and every render uses it; post-training "
                "distillation is only for coarse-trained models")
        if self.cfg.batch_norm:
            raise ValueError("the proposal sampler has no BatchNorm variant; use the "
                             "coarse sampler for BN configs")
        if self.cfg.ns_fine <= 0:
            raise ValueError("the proposal sampler places fine samples; ns_fine must "
                             "be positive")

        fine = self._whole_eval_params()["fine"]

        def distill():
            o, d = (torch.tensor(x, device=self.device)
                    for x in _subsample(origins, directions, calib_rays, seed))
            cdt = fine.compute_dtype

            def sigma_fn(pts):
                return fine.sigma_logits(encode_position(pts, self.cfg.l_xyz).to(cdt))

            losses: list[float] = []
            t0 = time.perf_counter()
            net, final_loss = distill_proposal(
                sigma_fn, o, d, self.near, self.far, l_xyz=l_xyz, hidden=hidden,
                depth=depth, steps=steps, batch=batch, lr=lr, under_weight=under_weight,
                generator=torch.Generator(device=self.device).manual_seed(seed),
                losses_out=losses)
            print(f"[nerf-torch] distilled the proposal net: {steps} steps of {batch} "
                  f"points in {time.perf_counter() - t0:.3f} s, loss {losses[0]:.6g} -> "
                  f"{final_loss:.6g}")
            return {"loss": final_loss, "losses": losses}, dict(net.state_dict())

        meta, tensors = share_from_main(distill, self.mesh)
        net = ProposalMLP(l_xyz=l_xyz, hidden=hidden, depth=depth, device=self.device)
        net.load_state_dict(tensors)
        self._install_proposal(net, l_xyz)
        self._distill_loss = meta["loss"]
        self.distill_losses = meta["losses"]
        return self

    def _install_proposal(self, pparams, l_xyz: int) -> None:
        """Install a distilled net (a :class:`ProposalMLP` or its JAX-layout
        tree) and build the proposal render; the int8 one is built at its
        first use."""
        if not isinstance(pparams, ProposalMLP):
            pparams = ProposalMLP.from_jax_params(pparams, device=self.device)
        if pparams.l_xyz != l_xyz:
            raise ValueError(f"the proposal net encodes L_XYZ {pparams.l_xyz}, not {l_xyz}")
        self._pparams = pparams.to(self.device).requires_grad_(False)
        self._prop_l_xyz = l_xyz
        self._render_pq = None
        self._render_p = make_proposal_render_fn(self.cfg, self.near, self.far,
                                                 prop_l_xyz=l_xyz)

    @property
    def online_proposal(self) -> bool:
        """True for ``TRAIN_SAMPLER='proposal'`` models: the proposal nets
        live in the train state and every render uses them."""
        return self.proposal

    @property
    def proposal_ready(self) -> bool:
        """True when proposal-sampled renders are available: always for a
        proposal-trained model, else once a net is distilled from (or
        loaded for) the current weights."""
        return self.proposal or self._pparams is not None

    def infer_digest(self) -> str:
        """The digest of the eval weights and the config fields the int8
        tables and the distilled net depend on (the JAX package's, so one
        checkpoint gives the same hex string in both).  The weights are the
        folded ones: inside a frequency-anneal window the artifacts are
        functions of the window too.  Under a model axis the weights are
        gathered whole (every model rank calls it), so the digest is one
        process's."""
        return params_digest(models_to_jax(self._folded_eval_params()), extra={
            "skip_layer": self.cfg.skip_layer, "l_xyz": self.cfg.l_xyz,
            "l_dir": self.cfg.l_dir, "compute_dtype": self.cfg.compute_dtype})

    def save_inference_artifacts(self, path: str) -> "Trainer":
        """Write whatever int8 tables and distilled net are installed,
        keyed to the current weights (:func:`save_artifacts`); under a
        mesh rank 0 writes and the other ranks, which hold the same bits,
        write nothing."""
        if self._qparams is None and self._pparams is None:
            raise RuntimeError("nothing to save: run quantize_for_inference and/or "
                               "build_proposal_sampler first")
        digest = self.infer_digest()
        if not is_main(self.mesh):
            return self
        save_artifacts(
            path, digest,
            pparams=None if self._pparams is None else proposal_to_jax(self._pparams),
            prop_l_xyz=self._prop_l_xyz, distill_loss=self._distill_loss,
            qparams=None if self._qparams is None else qparams_to_jax(self._qparams))
        return self

    def load_inference_artifacts(self, path: str) -> "Trainer":
        """Install what :meth:`save_inference_artifacts` wrote (by either
        package).  Raises ``FileNotFoundError`` when there is no file and
        ``StaleArtifactsError`` when it was derived from other weights or
        config: a stale acceleration is never installed; a BatchNorm config
        refuses a file with ``ValueError``.  Under a mesh rank 0 alone
        reads the file and checks the digest; its verdict (absent,
        stale with its message, or fresh with the tables and the net)
        reaches every rank, which installs them or raises the same error."""
        digest = None if self.cfg.batch_norm else self.infer_digest()

        def read():
            if not io.exists(path):
                return {"verdict": "absent"}, None
            if self.cfg.batch_norm:  # refused below, on every rank
                return {"verdict": "present"}, None
            try:
                art = load_artifacts(path, digest)
            except StaleArtifactsError as e:
                return {"verdict": "stale", "message": str(e)}, None
            meta = {"verdict": "fresh", "prop_l_xyz": art.get("prop_l_xyz"),
                    "distill_loss": art.get("distill_loss")}
            tree = {k: qparams_from_jax(art[k], self.device) for k in ("qparams", "pparams")
                    if k in art}
            return meta, tree

        meta, tree = share_from_main(read, self.mesh)
        if meta["verdict"] == "absent":
            raise FileNotFoundError(f"no inference artifacts at {path}")
        if self.cfg.batch_norm:
            raise ValueError("inference artifacts have no BatchNorm variant; use the "
                             "float coarse path for BN configs")
        if meta["verdict"] == "stale":
            raise StaleArtifactsError(meta["message"])
        if "qparams" in tree:
            self.install_quant(tree["qparams"])
        if "pparams" in tree:
            if self.cfg.ns_fine <= 0:
                raise ValueError("the proposal sampler places fine samples; ns_fine "
                                 "must be positive")
            self._install_proposal(_tree_to(tree["pparams"], "cpu"), meta["prop_l_xyz"])
            self._distill_loss = meta["distill_loss"]
        return self

    def _proposal_render_fn(self, quant: bool):
        """The distilled-sampler render for :meth:`render_rays`: the fine
        pass through K1 on the eval fine model, or through K4 on the int8
        tables with ``quant``."""
        if self._pparams is None:
            raise RuntimeError("call build_proposal_sampler(...) before rendering with "
                               "sampler='proposal'")
        prop = self._pparams
        if not quant:
            return lambda models, o, d: self._render_p(prop, models["fine"], o, d)
        if self._qparams is None:
            raise RuntimeError("call quantize_for_inference(...) before rendering with "
                               "sampler='proposal' and quant=True")
        if self._render_pq is None:
            self._render_pq = make_proposal_render_fn(
                self.cfg, self.near, self.far, prop_l_xyz=self._prop_l_xyz, quant=True)
        qfine = self._qparams["fine"]
        return lambda models, o, d: self._render_pq(prop, qfine, o, d)

    def pose_rays(
        self, pose: np.ndarray, height: int, width: int, focal: float
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Flat ``(H*W, 3)`` ray origins and directions on the device, in
        the space the renderer expects: NDC for ``NDC`` models, which needs
        a forward-facing camera (every ray ``d_z < 0``; a sideways pose
        would divide by ~0 and render NaN frames) and raises
        ``ValueError`` otherwise."""
        origins, dirs = get_rays(height, width, focal, pose, device=self.device)
        if self.cfg.ndc:
            max_dz = float(dirs[..., 2].max())
            if not max_dz < 0:
                raise ValueError(
                    "NDC rendering requires a forward-facing camera "
                    f"(all ray d_z < 0; got max d_z = {max_dz:.4f}). "
                    "Use the capture-implied path (inference.py --path "
                    "spiral) for NDC-trained checkpoints."
                )
            origins, dirs = ndc_rays(height, width, focal, NDC_NEAR_PLANE, origins, dirs)
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
        sampler: str = "coarse",
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
        ``sampler='proposal'`` places the fine samples with the distilled
        net (:meth:`build_proposal_sampler` first; fine rgb/depth only,
        with or without ``quant``); on a proposal-trained model it is the
        default render.  Under a mesh every rank passes the same rays: the
        chunk is rounded up to a multiple of the data axis size, each data
        rank renders its rows of every chunk (its model ranks together,
        through the split MLP) and one all-gather per kept map over the
        data group rebuilds it, so every rank returns the whole result.
        """
        if sampler not in ("coarse", "proposal"):
            raise ValueError(f"sampler must be 'coarse' or 'proposal', got {sampler!r}")
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
        if sampler == "proposal" and not self.proposal:
            if full or "t_fine" in requested:
                raise ValueError("sampler='proposal' renders rgb/depth fine only (the "
                                 "weights/preds maps are not wired for the distilled sampler)")
            if any(k.endswith("_coarse") for k in requested):
                raise ValueError("sampler='proposal' has no coarse outputs (the proposal "
                                 "net replaces the coarse MLP pass)")
            render = self._proposal_render_fn(quant)
        elif quant:
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
        if self.mesh is not None:
            chunk = -(-chunk // self.mesh.data) * self.mesh.data
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

        models = self._folded_eval_params()
        outs: dict[str, list] = {}
        rows = slice(None) if self.mesh is None else local_rows(chunk, self.mesh)
        for start in range(0, n, chunk):
            keep = min(chunk, n - start)
            res = render(models, origins[start:start + chunk][rows],
                         directions[start:start + chunk][rows])
            for k, v in res.items():
                if keys is not None and k not in keys:
                    continue
                if uint8_rgb and k.startswith("rgb"):
                    v = rgb_to_u8(v)
                if self.mesh is not None:
                    v = all_gather_rows(v, self.mesh)
                outs.setdefault(k, []).append(v[:keep])
        return {k: torch.cat(v, dim=0).cpu().numpy() for k, v in outs.items()}

    def render_image(
        self, pose: np.ndarray, height: int, width: int, focal: float,
        chunk: int = 16384, include_coarse: bool = False,
        uint8_rgb: bool = False, need_depth: bool = True, quant: bool = False,
        sampler: str = "coarse",
    ) -> dict[str, np.ndarray]:
        """Render one frame from a camera pose; returns HxW maps (the
        proposal render has no coarse maps).  ``quant``: every MLP pass
        through the int8 tables; ``sampler``: as :meth:`render_rays`."""
        if include_coarse and self.proposal:
            raise ValueError("TRAIN_SAMPLER=proposal renders no coarse pass")
        if include_coarse and sampler == "proposal":
            raise ValueError("no coarse outputs: the proposal sampler replaces the "
                             "coarse pass")
        origins, dirs = self.pose_rays(pose, height, width, focal)
        if include_coarse:
            keys = None
        elif need_depth:
            keys = ("rgb_fine", "depth_fine")
        else:
            keys = ("rgb_fine",)
        out = self.render_rays(origins, dirs, chunk=chunk, keys=keys,
                               uint8_rgb=uint8_rgb, quant=quant, sampler=sampler)
        result = {"rgb": out["rgb_fine"].reshape(height, width, 3)}
        if "depth_fine" in out:
            result["depth"] = out["depth_fine"].reshape(height, width)
        if include_coarse:
            result["rgb_coarse"] = out["rgb_coarse"].reshape(height, width, 3)
            result["depth_coarse"] = out["depth_coarse"].reshape(height, width)
        return result
