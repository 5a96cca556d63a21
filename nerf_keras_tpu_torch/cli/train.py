"""The training program behind the port's ``train_*`` entry points.

Counterpart of ``nerf_keras_tpu/cli/train.py``: load the config, prepare
the data, resolve the schedule horizons, train epoch by epoch (batches
from the native C++ batcher, or the numpy iterator without a toolchain),
and every ``--eval-every`` epochs evaluate on the val split (loss, PSNR,
SSIM), write the panel PNG, the checkpoint (and ``best.*`` when val PSNR
improves) and the history JSON.  ``--resume`` continues the step, the
Adam state, the batch order and the history; a non-finite loss writes an
emergency checkpoint and raises ``FloatingPointError``; SIGTERM ends the
run at the next epoch boundary with a checkpoint.

Parallelism: launched as N processes (the ``NERF_*`` trio or torchrun's
environment; ``parallel/distributed.py``), each rank drives one device
on the ``(MESH_DATA, MESH_MODEL)`` mesh (``parallel/mesh.py``).  Each
data group reads its contiguous shard of the training rays (every model
rank of a group the same, batched with the shared seed), feeds
``BATCH_SIZE / data`` rows of every global batch and makes one gradient
all-reduce per step; a model axis splits the MLPs.  The metrics and the
Krays/s are the global batch's.  Every rank takes part in each
checkpoint (a model axis gathers the weights); rank 0 alone writes
checkpoints, ``best.*``, the history, panels, the emergency checkpoint
and the ``--profile`` trace.  SIGTERM sets a flag in the process it
reaches, as in the JAX CLI: a launcher must signal every rank.

Unlike the JAX CLI: ``--device`` (default ``cuda``; the CPU only with
``--device cpu``) replaces ``--platform``; one process drives one device
(JAX drives every local device from one process), so ``MESH_DATA x
MESH_MODEL`` must be the process count;
local paths only, so a ``WITH_GCS`` config needs ``--run-dir``;
``--profile`` writes a ``torch.profiler`` Chrome trace; there is no
compilation cache to enable.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import inspect
import itertools
import math
import signal
import time
from typing import Callable

import numpy as np

from nerf_keras_tpu_torch.config import NeRFConfig, config_name, load_config
from nerf_keras_tpu_torch.data.pipeline import RayDataset, dataset_to_ndc, iterate_batches
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.parallel.distributed import (
    barrier,
    maybe_initialize,
    process_info,
    shard_dataset_for_process,
    shutdown,
)
from nerf_keras_tpu_torch.parallel.mesh import config_mesh
from nerf_keras_tpu_torch.runtime import resolve_device
from nerf_keras_tpu_torch.utils import io, profiling
from nerf_keras_tpu_torch.utils.checkpoint import (
    _numeric_sort_key,
    checkpoint_name,
    save_checkpoint,
)
from nerf_keras_tpu_torch.utils.image_metrics import ssim
from nerf_keras_tpu_torch.utils.metrics import History
from nerf_keras_tpu_torch.utils.viz import save_panel

# Auto-resolved schedule horizons (LR decay, proposal anneal) cap at this
# many epochs' worth of steps unless --no-pin-schedules: the JAX
# package's measured long-run rule (docs/TRAINING.md).
VALIDATED_HORIZON_EPOCHS = 80

# An eval this many dB below the run's best val PSNR prints the collapse
# warning.
COLLAPSE_WARN_DB = 2.0

# The hierarchical-chain recipe (PROP_LEVELS >= 2) is validated for runs
# of at least this many epochs.
CHAIN_MIN_EPOCHS = 150

LOG = "[nerf-torch]"


def build_arg_parser(default_config: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=default_config)
    p.add_argument("--data-dir", type=str, default=None, help="dataset root override")
    p.add_argument("--scene", type=str, default=None,
                   help="scene name within the dataset root (loaders that support "
                        "multi-scene roots, e.g. nerf_synthetic)")
    p.add_argument("--views", type=int, default=None,
                   help="number of capture views (loaders that generate their "
                        "capture, e.g. the procedural synthetic scene)")
    p.add_argument("--run-dir", type=str, default=None, help="output run directory")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint to resume from (params+optimizer+step)")
    p.add_argument("--epochs", type=int, default=None, help="override config EPOCHS")
    p.add_argument("--eval-every", type=int, default=None,
                   help="epochs between eval/checkpoint/panel")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace (DIR/trace.json) of the "
                        "first --profile-steps train steps, then train on")
    p.add_argument("--no-pin-schedules", action="store_true",
                   help="let auto-resolved schedule horizons (LR_FINAL decay, "
                        "PROP_ANNEAL_STEPS=-1) stretch to the full run instead of "
                        "capping at the validated ~80-epoch step count")
    p.add_argument("--profile-steps", type=int, default=20,
                   help="train steps inside the --profile window (default 20)")
    return p


def resolve_eval_every(cli_value: int | None, cfg: NeRFConfig, default: int) -> int:
    """CLI flag > explicit EVAL_EVERY in the config > the entry point's default."""
    if cli_value is not None:
        if cli_value < 1:
            raise SystemExit(f"--eval-every must be >= 1, got {cli_value}")
        return cli_value
    if cfg.eval_every is not None:
        return cfg.eval_every
    return default


def warn_chain_horizon(cfg: NeRFConfig) -> bool:
    """Warn when the hierarchical-chain recipe runs shorter than it is
    validated for; True when the warning fired."""
    if cfg.train_sampler == "proposal" and cfg.prop_levels >= 2 \
            and cfg.epochs < CHAIN_MIN_EPOCHS:
        print(f"{LOG} WARNING: PROP_LEVELS={cfg.prop_levels} (the hierarchical-chain "
              f"quality recipe) is validated for LONG runs: at 80 epochs it can trail "
              f"the coarse baseline on some seeds and only wins at every seed by "
              f"160-200 pinned epochs.  EPOCHS={cfg.epochs} < {CHAIN_MIN_EPOCHS}: "
              f"consider --epochs 200 (schedules auto-pin at the validated ~80-epoch "
              f"horizon)")
        return True
    return False


def resolve_eval_batch(test_bs: int, n_val: int, data_div: int = 1,
                       proc_count: int = 1) -> int:
    """The eval batch: ``min(test_bs, n_val)`` rounded down to a multiple of
    ``lcm(data_div, proc_count)`` (the port passes its data axis alone:
    each data rank evaluates its rows, its model ranks together)."""
    div = math.lcm(data_div, proc_count)
    if n_val < div:
        raise ValueError(
            f"val split has {n_val} rays but eval batches must divide by "
            f"lcm(data axis {data_div}, processes {proc_count}) = {div}; "
            f"shrink the mesh or enlarge the val split")
    return max(div, (min(test_bs, n_val) // div) * div)


def resolve_run_dirs(cfg: NeRFConfig, name: str, run_dir: str | None) -> tuple[str, str]:
    """``(run_dir, viz_dir)``: ``--run-dir`` and its ``images``, else a
    stamped local ``models/`` directory.  A ``WITH_GCS`` config without
    ``--run-dir`` raises: the JAX CLI would write to ``gs://``, and the
    port has no remote storage."""
    if run_dir is not None:
        return run_dir, io.join(run_dir, "images")
    if cfg.with_gcs:
        raise NotImplementedError(
            "WITH_GCS=true: the JAX CLI writes this run to gs://, and remote "
            "storage is not ported; pass --run-dir DIR")
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    return (io.join("models", f"{name}-{stamp}"),
            io.join("images", "models", f"{name}-{stamp}"))


def resolve_horizons(cfg: NeRFConfig, steps_per_epoch: int,
                     no_pin_schedules: bool = False) -> NeRFConfig:
    """Schedule horizons in steps: epoch-unit horizons (``*_EPOCHS``) times
    ``steps_per_epoch``; then the auto ones (``LR_FINAL`` with
    ``LR_DECAY_STEPS=0``, ``PROP_ANNEAL_STEPS=-1``) over the run, capped at
    :data:`VALIDATED_HORIZON_EPOCHS` unless ``no_pin_schedules``;
    ``FREQ_ANNEAL_STEPS=-1`` over the whole run."""
    repl = {}
    if cfg.lr_decay_epochs > 0:
        repl.update(lr_decay_steps=cfg.lr_decay_epochs * steps_per_epoch, lr_decay_epochs=0)
    if cfg.prop_anneal_epochs > 0:
        repl.update(prop_anneal_steps=cfg.prop_anneal_epochs * steps_per_epoch,
                    prop_anneal_epochs=0)
    if cfg.freq_anneal_epochs > 0:
        repl.update(freq_anneal_steps=cfg.freq_anneal_epochs * steps_per_epoch,
                    freq_anneal_epochs=0)
    if repl:
        cfg = dataclasses.replace(cfg, **repl)
        for key, what in (("lr_decay_steps", "lr decay horizon"),
                          ("prop_anneal_steps", "proposal anneal"),
                          ("freq_anneal_steps", "frequency anneal")):
            if key in repl:
                print(f"{LOG} {what} pinned: {getattr(cfg, key)} steps")

    horizon_epochs = cfg.epochs if no_pin_schedules else min(cfg.epochs,
                                                              VALIDATED_HORIZON_EPOCHS)
    pinned = horizon_epochs < cfg.epochs
    if cfg.lr_final is not None and cfg.lr_decay_steps == 0:
        cfg = dataclasses.replace(cfg, lr_decay_steps=horizon_epochs * steps_per_epoch)
        print(f"{LOG} lr decay: {cfg.learning_rate} -> {cfg.lr_final} over "
              f"{cfg.lr_decay_steps} steps"
              + (f" (pinned to the validated {VALIDATED_HORIZON_EPOCHS}-epoch horizon; "
                 f"--no-pin-schedules to stretch to {cfg.epochs} epochs)" if pinned else ""))
    if cfg.prop_anneal_steps == -1:
        cfg = dataclasses.replace(cfg, prop_anneal_steps=horizon_epochs * steps_per_epoch)
        print(f"{LOG} proposal anneal over {cfg.prop_anneal_steps} steps"
              + (" (pinned; --no-pin-schedules to stretch)" if pinned else ""))
    if cfg.freq_anneal_steps == -1:
        cfg = dataclasses.replace(cfg, freq_anneal_steps=cfg.epochs * steps_per_epoch)
        print(f"{LOG} frequency anneal over {cfg.freq_anneal_steps} steps")
    return cfg


def load_history(run_dir: str, history_name: str) -> History | None:
    """The run's history JSON to continue on resume: ``history_name``, else
    the newest ``history_*.json`` (natural order) when ``--epochs``
    changed the name; None when the run dir holds none."""
    if not io.exists(run_dir):
        return None
    candidates = [history_name] + sorted(
        (n for n in io.listdir(run_dir) if n.startswith("history_") and n.endswith(".json")),
        key=_numeric_sort_key, reverse=True)
    for cand in candidates:
        if io.exists(io.join(run_dir, cand)):
            history = History.load(io.join(run_dir, cand))
            print(f"{LOG} continuing history from {cand} "
                  f"({len(history.losses)} epochs recorded)")
            return history
    return None


def run_training(
    prepare_data: Callable[..., tuple[RayDataset, RayDataset, tuple, float]],
    default_config: str,
    default_eval_every: int,
    argv: list[str] | None = None,
) -> Trainer:
    """The whole training program; returns the Trainer (for tests).  Under
    a launch environment it joins the process group first and leaves it at
    the end."""
    args = build_arg_parser(default_config).parse_args(argv)
    cfg = load_config(args.config)
    maybe_initialize(args.device)
    try:
        trainer = _train(args, cfg, prepare_data, default_eval_every)
        barrier()
        return trainer
    finally:
        shutdown()


def _train(args, cfg: NeRFConfig, prepare_data, default_eval_every: int) -> Trainer:
    """:func:`run_training` after the process group is joined."""
    mesh = config_mesh(cfg.mesh_data, cfg.mesh_model)
    rank, world = process_info()
    data = 1 if mesh is None else mesh.data
    device = mesh.device if mesh is not None else resolve_device(args.device)
    if cfg.batch_size % data:
        raise ValueError(f"BATCH_SIZE={cfg.batch_size} must be divisible by the data axis "
                         f"({data} ranks)")
    local_bs = cfg.batch_size // data
    is_main = rank == 0
    if args.epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    eval_every = resolve_eval_every(args.eval_every, cfg, default_eval_every)
    warn_chain_horizon(cfg)
    name = config_name(args.config)
    run_dir, viz_dir = resolve_run_dirs(cfg, name, args.run_dir)
    print(f"{LOG} rank {rank}/{world} config={name} device={device} dtype={cfg.compute_dtype}")

    # Entry points adapt each loader to (h, w, data_dir=None); loaders
    # whose preprocessing follows the config (the Blender background)
    # take a ``config`` keyword.
    prepare_kwargs = {"data_dir": args.data_dir}
    prepare_params = inspect.signature(prepare_data).parameters
    if "config" in prepare_params:
        prepare_kwargs["config"] = cfg
    for flag, value, param in (("--scene", args.scene, "scene"),
                               ("--views", args.views, "num_views")):
        if value is not None:
            if param not in prepare_params:
                raise SystemExit(f"{flag} is not supported by this entry point's loader")
            prepare_kwargs[param] = value
    train_ds, val_ds, (near, far), focal = prepare_data(cfg.height, cfg.width,
                                                        **prepare_kwargs)
    if cfg.ndc:
        # Forward-facing captures: rays into the NDC cube, t in [0, 1].
        train_ds, val_ds = dataset_to_ndc(train_ds), dataset_to_ndc(val_ds)
        near, far = 0.0, 1.0
    train_ds = shard_dataset_for_process(train_ds, mesh)
    print(f"{LOG} rays: train={len(train_ds)} val={len(val_ds)} "
          f"near={near:.3f} far={far:.3f} focal={focal:.2f}")

    if len(train_ds) < local_bs:
        # Drop-remainder batching would yield no batch at all.
        raise ValueError(f"BATCH_SIZE={cfg.batch_size} exceeds the train set "
                         f"({len(train_ds)} rays on each of {data} data rank(s)) — lower "
                         f"BATCH_SIZE or enlarge the dataset")
    steps_per_epoch = len(train_ds) // local_bs
    cfg = resolve_horizons(cfg, steps_per_epoch, args.no_pin_schedules)

    trainer = Trainer(cfg, near, far, device=device, mesh=mesh)
    if args.resume:
        trainer.restore(args.resume)
        print(f"{LOG} resumed from {args.resume} at step {trainer.step}")

    scene = {"near": near, "far": far, "focal": focal, "ndc": cfg.ndc}
    history_name = (f"history_l{cfg.num_layers}_d{cfg.hidden_dim}"
                    f"_n{cfg.ns_coarse + cfg.ns_fine}_ep{cfg.epochs}.json")
    history = (load_history(run_dir, history_name) if args.resume else None) or History()
    losses_for_plot = list(history.losses)
    # Resuming must not take its first eval for a record: the pre-resume
    # peak counts.
    best_val = {"psnr": max(history.val["psnrs"]) if history.val["psnrs"] else None}

    test_bs = cfg.test_batch_size or cfg.batch_size
    eval_bs = resolve_eval_batch(test_bs, len(val_ds), data)
    if len(val_ds) % eval_bs:
        print(f"{LOG} val: {len(val_ds) % eval_bs} of {len(val_ds)} rays excluded from "
              f"metrics (eval batch {eval_bs}, drop-remainder — matches the reference "
              f"pipeline)")
    start_epoch = trainer.step // steps_per_epoch

    # The native batcher (a C++ thread, 4 batches ahead) overlaps batch
    # assembly with the device's step; without a toolchain, numpy.
    native_batcher = None
    try:
        from nerf_keras_tpu_torch.data.native import NativeRayBatcher

        native_batcher = NativeRayBatcher(train_ds, local_bs, seed=cfg.seed,
                                          start_epoch=start_epoch)
        print(f"{LOG} batches: native batcher")
    except (RuntimeError, OSError) as e:
        print(f"{LOG} native batcher unavailable ({e}); using numpy")

    def epoch_batches(epoch: int):
        if native_batcher is not None:
            return (next(native_batcher) for _ in range(steps_per_epoch))
        return iterate_batches(train_ds, local_bs, shuffle=True, seed=cfg.seed,
                               epoch=epoch)

    # SIGTERM (preemption): only set a flag; the loop checkpoints at the
    # epoch boundary and returns.  signal.signal works in the main thread
    # only.
    stop_requested = {"sig": None}

    def _request_stop(signum, frame):
        stop_requested["sig"] = signum

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _request_stop)
    except ValueError:  # not the main thread
        prev_sigterm = None
    try:
        _run_epochs(cfg, trainer, run_dir, viz_dir, scene, history, history_name, val_ds,
                    start_epoch, steps_per_epoch, eval_every, eval_bs, test_bs,
                    losses_for_plot, epoch_batches, stop_requested, best_val, is_main,
                    profile_dir=args.profile, profile_steps=args.profile_steps)
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
        if native_batcher is not None:
            native_batcher.close()
    if best_val["psnr"] is not None:
        if io.exists(io.join(run_dir, "best." + checkpoint_name(cfg))):
            print(f"{LOG} best val PSNR {best_val['psnr']:.2f} retained in "
                  f"best.{checkpoint_name(cfg)} (serving resolves to it by default)")
        else:
            print(f"{LOG} best val PSNR {best_val['psnr']:.2f} (from pre-resume history; "
                  f"no best.* checkpoint written this run — serving resolves to latest)")
    print(f"{LOG} done; run dir: {run_dir}")
    return trainer


def _profiled_first_epoch(cfg, trainer, batches, steps_per_epoch, profile_dir,
                          profile_steps, is_main):
    """The first epoch with its first ``profile_steps`` steps inside a
    ``torch.profiler`` window; the rest of the epoch runs outside it, and
    the two partial means are weighted back into one by their step counts.
    Rank 0 alone traces."""
    n_head = max(1, min(profile_steps, steps_per_epoch))
    counts = {"head": 0, "tail": 0}

    def counted(it, slot):
        for b in it:
            counts[slot] += 1
            yield b

    gen = iter(batches)
    ctx = profiling.trace(profile_dir, trainer.device) if is_main else contextlib.nullcontext()
    with ctx:
        head = trainer.train_epoch(counted(itertools.islice(gen, n_head), "head"),
                                   log_every=cfg.log_every)
    if is_main:
        print(f"{LOG} profiler trace of {counts['head']} steps -> "
              f"{io.join(profile_dir, profiling.TRACE_FILE)}")
    try:
        first_tail = next(gen)
    except StopIteration:
        return head
    tail = trainer.train_epoch(counted(itertools.chain([first_tail], gen), "tail"),
                               log_every=cfg.log_every)
    total = counts["head"] + counts["tail"]
    return {k: (head[k] * counts["head"] + tail[k] * counts["tail"]) / total for k in head}


def _run_epochs(cfg, trainer, run_dir, viz_dir, scene, history, history_name, val_ds,
                start_epoch, steps_per_epoch, eval_every, eval_bs, test_bs,
                losses_for_plot, epoch_batches, stop_requested, best_val, is_main=True,
                profile_dir=None, profile_steps=20):
    """The epoch loop of :func:`run_training`; only ``is_main`` writes."""
    if profile_dir is not None and start_epoch >= cfg.epochs:
        print(f"{LOG} WARNING: --profile {profile_dir} captured nothing — the restored "
              f"checkpoint is already at epoch {start_epoch} >= EPOCHS ({cfg.epochs}); "
              f"raise --epochs to trace steps")
    fvc_warned = False
    ckpt_name = checkpoint_name(cfg)
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.perf_counter()
        if profile_dir is not None and epoch == start_epoch:
            metrics = _profiled_first_epoch(cfg, trainer, epoch_batches(epoch),
                                            steps_per_epoch, profile_dir, profile_steps,
                                            is_main)
        else:
            metrics = trainer.train_epoch(epoch_batches(epoch), log_every=cfg.log_every)
        dt = time.perf_counter() - t0  # train_epoch ends in a host read of the means
        # The global batch: every data rank fed BATCH_SIZE / data of each step's rays.
        rays_per_sec = steps_per_epoch * cfg.batch_size / dt if dt > 0 else 0.0

        # The metrics are the global batch's, so every rank raises together.
        if not np.isfinite(metrics["loss"]):
            crash_path = io.join(run_dir, "emergency." + ckpt_name)
            if is_main:
                io.makedirs(run_dir)
            save_checkpoint(crash_path, trainer.state, cfg, scene=scene, write=is_main)
            raise FloatingPointError(
                f"non-finite train loss {metrics['loss']} at epoch {epoch + 1} "
                f"(step {trainer.step}); state saved to {crash_path}")
        print(f"epoch {epoch + 1}/{cfg.epochs} loss={metrics['loss']:.5f} "
              f"loss_coarse={metrics['loss_coarse']:.5f} psnr={metrics['psnr']:.2f} "
              f"({rays_per_sec / 1e3:.1f} Krays/s, {dt * 1e3 / steps_per_epoch:.2f} "
              f"ms/step)", flush=True)
        losses_for_plot.append(metrics["loss"])

        if (epoch + 1) % eval_every == 0 or epoch + 1 == cfg.epochs:
            val_metrics = trainer.evaluate(iterate_batches(val_ds, eval_bs, shuffle=False))
            # The first two val views for the panel and SSIM.
            rgbs, depths = [], []
            for view in range(min(2, val_ds.num_images)):
                o, d = val_ds.image_rays(view)
                out = trainer.render_rays(o, d, chunk=max(test_bs, 4096))
                rgbs.append(out["rgb_fine"].reshape(val_ds.height, val_ds.width, 3))
                depths.append(out["depth_fine"].reshape(val_ds.height, val_ds.width))
            if min(val_ds.height, val_ds.width) >= 11:  # the SSIM window must fit
                val_metrics["ssim"] = float(np.mean(
                    [float(ssim(r, val_ds.image(i))) for i, r in enumerate(rgbs)]))
            ssim_txt = f" ssim={val_metrics['ssim']:.4f}" if "ssim" in val_metrics else ""
            print(f"  val: loss={val_metrics['loss']:.5f} "
                  f"psnr={val_metrics['psnr']:.2f}{ssim_txt}", flush=True)
            history.append(metrics, val_metrics)

            # Best-val retention and the collapse guard: the latest
            # checkpoint alone would lose a run's peak to a late decay.
            vp = val_metrics["psnr"]
            is_best = best_val["psnr"] is None or vp > best_val["psnr"]
            if is_best:
                best_val["psnr"] = vp
            elif vp <= best_val["psnr"] - COLLAPSE_WARN_DB:
                print(f"{LOG} WARNING: val PSNR {vp:.2f} is {best_val['psnr'] - vp:.2f} dB "
                      f"below this run's best ({best_val['psnr']:.2f}) — late-decay "
                      f"signature; the best.* checkpoint retains the peak weights")
            if not fvc_warned and history.few_view_collapse():
                fvc_warned = True
                print(f"{LOG} WARNING: few-view collapse signature — val PSNR is flat and "
                      f"low while train PSNR keeps rising (the model is memorizing the "
                      f"training views).  Sampler tuning does NOT fix this.  Measured "
                      f"remedies: ADD TRAINING VIEWS, or FREQ_ANNEAL_STEPS=-1 as a last "
                      f"resort")

            if is_main:
                io.makedirs(run_dir)
                io.makedirs(viz_dir)
                save_panel(io.join(viz_dir, f"{epoch:03d}.png"), rgbs, depths,
                           losses_for_plot, epoch, cfg.epochs)
            # Every rank: a model axis gathers the weights; rank 0 writes.
            save_checkpoint(io.join(run_dir, ckpt_name), trainer.state, cfg, scene=scene,
                            write=is_main)
            if is_best:
                save_checkpoint(io.join(run_dir, "best." + ckpt_name), trainer.state, cfg,
                                scene=scene, write=is_main)
            if is_main:
                history.save(io.join(run_dir, history_name))
        else:
            history.append(metrics)

        if stop_requested["sig"] is not None:
            ckpt_path = io.join(run_dir, ckpt_name)
            if is_main:
                io.makedirs(run_dir)
            save_checkpoint(ckpt_path, trainer.state, cfg, scene=scene, write=is_main)
            print(f"{LOG} signal {stop_requested['sig']} at epoch {epoch + 1}: checkpoint "
                  f"saved to {ckpt_path}; resume with --resume")
            break
