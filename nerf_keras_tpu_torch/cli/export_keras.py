"""Export a trained checkpoint to the reference's Keras ``.weights.h5``.

    python -m nerf_keras_tpu_torch.cli.export_keras --config config/lego_batch_h256_tpu.json \
        --checkpoint <run-dir> --out lego.weights.h5

Counterpart of ``nerf_keras_tpu/cli/export_keras.py``, the inverse of
``cli.infer --reference-weights``: the file loads in the reference's own
tooling (``NeRFTrainer.load_weights``).  A run directory resolves to its
checkpoint as every inference path resolves it (``best.*``, else the
latest), and the checkpoint's sidecar config wins over the passed one.
An EMA checkpoint exports the EMA shadow, the weights every other
inference path reads.  A ``TRAIN_SAMPLER='proposal'`` checkpoint has no
coarse model and cannot be exported.

Unlike the JAX CLI: ``--device`` (default ``cuda``, which raises without a
card; ``--device cpu`` for the CPU) replaces ``--platform``.  The file is
written by the port's own HDF5 writer (``utils/h5.py``), not h5py.
"""

from __future__ import annotations

import argparse

from nerf_keras_tpu_torch.cli.train import LOG
from nerf_keras_tpu_torch.config import load_config
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.runtime import resolve_device
from nerf_keras_tpu_torch.utils.checkpoint import (
    models_to_jax,
    resolve_checkpoint,
    resolve_infer_config,
)
from nerf_keras_tpu_torch.utils.keras_export import export_reference_weights


def run_export(argv: list[str] | None = None) -> str:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True,
                   help="a .ckpt.npz file or a run dir (best.*, else the latest)")
    p.add_argument("--out", type=str, required=True,
                   help="output path (.weights.h5 by the reference's convention)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda | cuda:N | cpu (default: cuda; without a card, pass "
                        "--device cpu)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    ckpt = args.checkpoint
    if not ckpt.endswith(".npz"):
        found = resolve_checkpoint(ckpt)
        if found is None:
            raise FileNotFoundError(f"no .ckpt.npz under {ckpt}")
        ckpt = found
    cfg, notes = resolve_infer_config(load_config(args.config), ckpt)
    for note in notes:
        print(f"{LOG} {note}")
    if cfg.train_sampler == "proposal":
        raise SystemExit("TRAIN_SAMPLER='proposal' checkpoints have no coarse MLP; the "
                         "reference format requires the coarse+fine pair — retrain with "
                         "the parity step to export")

    trainer = Trainer(cfg, 2.0, 6.0, device=device).restore(ckpt)
    export_reference_weights(args.out, models_to_jax(trainer.eval_params), cfg,
                             bn_state=trainer.bn_tree())
    print(f"{LOG} exported {ckpt} -> {args.out} (reference .weights.h5 layout)")
    return args.out


if __name__ == "__main__":
    run_export()
