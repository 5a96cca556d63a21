"""Score a trained checkpoint on a dataset split.

    python -m nerf_keras_tpu_torch.cli.evaluate --config config/lego_batch_h256_tpu.json \
        --checkpoint <run-dir> --data synthetic --split val \
        [--quant int8] [--sampler proposal] [--infer-cache <path>] [--save-images <dir>]

Counterpart of ``nerf_keras_tpu/cli/evaluate.py``: every view of the split
is rendered from the checkpoint and scored against its ground truth, with
per-view MSE, PSNR and SSIM (when the 11x11 window fits) and their split
means, written as JSON (by default ``<checkpoint dir>/eval_<split>.json``).
The accelerated paths (``--quant int8``: both MLP passes through K4;
``--sampler proposal``: a distilled proposal net places the fine samples,
no coarse pass) are scored ungated, since the report itself measures
them; their int8 tables and proposal net are fit on up to 8 train views,
never on the scored split, and ``--infer-cache`` reuses them across runs.

``--data llff`` scores the holdout view of an LLFF capture
(``--data-dir``, ``data/llff.py``); an ``NDC`` checkpoint is scored in NDC
ray space with bounds [0, 1], as it was trained, and its int8 tables and
distilled net are fit on train views in that space too.

Launched as N ranks (``torchrun``, or the ``NERF_*`` trio; see
``parallel/distributed.py``), every rank scores every view, each rendering
its rows of every chunk (``Trainer.render_rays``); the int8 tables and
the distilled net are built, or read from ``--infer-cache``, on rank 0 and
shared.  Rank 0 alone prints the report and writes the JSON, the
``--save-images`` PNGs and the cache.  Without a launch environment it
runs as one process.

Unlike the JAX CLI: ``--device`` (default ``cuda``, which raises without a
card; ``--device cpu`` for the CPU) replaces ``--platform``, and there is
no compilation cache.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from nerf_keras_tpu_torch.cli.train import LOG
from nerf_keras_tpu_torch.config import load_config
from nerf_keras_tpu_torch.data.pipeline import dataset_to_ndc
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.parallel.distributed import launched, process_info
from nerf_keras_tpu_torch.utils import io
from nerf_keras_tpu_torch.utils.checkpoint import (
    load_checkpoint_scene,
    resolve_checkpoint,
    resolve_infer_config,
)
from nerf_keras_tpu_torch.utils.image import to_uint8
from nerf_keras_tpu_torch.utils.image_metrics import ssim
from nerf_keras_tpu_torch.utils.infer_cache import load_if_fresh
from nerf_keras_tpu_torch.utils.viz import save_png


def _prepare(data: str, height: int, width: int, data_dir: str | None, *,
             white_bkgd: bool = False, split: str = "val", scene: str | None = None):
    """``(train_ds, val_ds, (near, far), focal)`` of the named dataset.
    ``scene`` is the Blender scene directory (default ``lego``) or the
    procedural variant (default ``sphere``): a checkpoint trained on
    ``--scene spheres`` is scored against that variant's ground truth."""
    if data == "synthetic":
        from nerf_keras_tpu_torch.data.synthetic import prepare_synthetic_data

        return prepare_synthetic_data(height, width, scene=scene or "sphere")
    if data == "lego":
        from nerf_keras_tpu_torch.data.lego import prepare_lego_data

        return prepare_lego_data(height, width, path=data_dir)
    if data == "blender":
        from nerf_keras_tpu_torch.data.blender import prepare_blender_data

        # The published numbers score the whole test split; val stays
        # subsampled so a routine eval is cheap.
        kw = {"val_split": "test", "val_every": 1} if split == "test" else {}
        return prepare_blender_data(height, width, path=data_dir, scene=scene or "lego",
                                    white_bkgd=white_bkgd, **kw)
    if data == "llff":
        from nerf_keras_tpu_torch.data.llff import prepare_fern_data

        return prepare_fern_data(height, width, basedir=data_dir)
    raise SystemExit(f"unknown --data {data!r}")


def evaluate_views(trainer: Trainer, ds, chunk: int = 16384, quant: bool = False,
                   sampler: str = "coarse", save_dir: str | None = None,
                   split: str = "val") -> dict:
    """Render every view of ``ds`` and score it against its ground truth:
    ``{"views": [{view, mse, psnr, ssim?}, ...], "mean": {...}}``.  With
    ``save_dir`` each pred/gt pair is written as PNGs as it is scored, so
    no split is ever held in host memory whole."""
    views = []
    with_ssim = min(ds.height, ds.width) >= 11
    if save_dir is not None:
        io.makedirs(save_dir)
    for i in range(ds.num_images):
        o, d = ds.image_rays(i)
        out = trainer.render_rays(o, d, chunk=chunk, keys=("rgb_fine",), quant=quant,
                                  sampler=sampler)
        pred = np.asarray(out["rgb_fine"], np.float32).reshape(ds.height, ds.width, 3)
        gt = ds.image(i)
        mse = float(np.mean((pred - gt) ** 2))
        row = {"view": i, "mse": mse,
               "psnr": float("inf") if mse == 0 else float(-10.0 * np.log10(mse))}
        if with_ssim:
            row["ssim"] = float(ssim(pred, gt))
        views.append(row)
        if save_dir is not None:
            save_png(io.join(save_dir, f"{split}_{i:03d}_pred.png"), to_uint8(pred))
            save_png(io.join(save_dir, f"{split}_{i:03d}_gt.png"), to_uint8(gt))
    mean = {k: float(np.mean([v[k] for v in views])) for k in views[0] if k != "view"}
    return {"views": views, "mean": mean}


def run_evaluation(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True,
                   help="checkpoint file or run directory")
    p.add_argument("--data", type=str, default="synthetic",
                   choices=("synthetic", "lego", "blender", "llff"))
    p.add_argument("--data-dir", type=str, default=None,
                   help="dataset root (lego/blender/llff)")
    p.add_argument("--scene", type=str, default=None,
                   help="dataset-relative scene: a directory under a nerf_synthetic "
                        "root (--data blender, default 'lego') or a procedural variant "
                        "(--data synthetic: 'sphere'/'spheres', default 'sphere')")
    p.add_argument("--split", type=str, default="val", choices=("val", "train", "test"),
                   help="'test' = the full Blender test split (--data blender only)")
    p.add_argument("--chunk", type=int, default=16384)
    p.add_argument("--out", type=str, default=None,
                   help="metrics JSON path (default: <checkpoint dir>/eval_<split>.json)")
    p.add_argument("--save-images", type=str, default=None,
                   help="directory for per-view pred/gt PNG pairs")
    p.add_argument("--quant", type=str, default="none", choices=("none", "int8"),
                   help="score the int8 path (K4; activation scales calibrated on "
                        "held-out TRAIN views)")
    p.add_argument("--sampler", type=str, default="coarse", choices=("coarse", "proposal"),
                   help="score the distilled-proposal path (no coarse pass)")
    p.add_argument("--proposal-steps", type=int, default=1500)
    p.add_argument("--infer-cache", type=str, default=None,
                   help="weight-keyed .infer.npz artifact cache, loaded when fresh, "
                        "rebuilt and saved when stale or absent")
    p.add_argument("--device", type=str, default=None,
                   help="cuda | cuda:N | cpu (default: cuda; without a card, pass "
                        "--device cpu)")
    args = p.parse_args(argv)
    if args.split == "test" and args.data != "blender":
        raise SystemExit("--split test requires --data blender")
    with launched(args.device) as device:
        return _evaluate(args, device)


def _evaluate(args, device) -> dict:
    """:func:`run_evaluation` on ``device``, after the process group (if
    any) is joined."""
    rank, world = process_info()
    main = rank == 0
    cfg = load_config(args.config)
    ckpt = args.checkpoint
    if not ckpt.endswith(".npz"):
        found = resolve_checkpoint(ckpt)
        if found is None:
            raise FileNotFoundError(f"no .ckpt.npz under {ckpt}")
        ckpt = found
    scene = load_checkpoint_scene(ckpt) or {}
    cfg, notes = resolve_infer_config(cfg, ckpt)
    for note in notes:
        print(f"{LOG} {note}")

    train_ds, val_ds, (near, far), _ = _prepare(
        args.data, cfg.height, cfg.width, args.data_dir, white_bkgd=cfg.white_bkgd,
        split=args.split, scene=args.scene)
    ds = train_ds if args.split == "train" else val_ds
    near = scene.get("near", near)
    far = scene.get("far", far)
    if cfg.ndc:
        # Score in the ray space the checkpoint was trained in: world rays
        # would render garbage without an error.
        ds = dataset_to_ndc(ds)
        near, far = 0.0, 1.0
    trainer = Trainer(cfg, near, far, device=device).restore(ckpt)
    print(f"{LOG} rank {rank}/{world}: loaded {ckpt}; scoring {ds.num_images} "
          f"{args.split} views at {ds.height}x{ds.width} on {device}")

    load_if_fresh(trainer, args.infer_cache)

    def calib_rays():
        # Fit the weight-derived state on up to 8 TRAIN views spread over
        # the split, never on the scored one: self-calibration would bias
        # the reported PSNR upwards.
        # NDC checkpoints calibrate in NDC ray space, as they score.
        cds = dataset_to_ndc(train_ds) if cfg.ndc else train_ds
        idx = list(range(0, cds.num_images, max(1, cds.num_images // 8)))[:8]
        pairs = [cds.image_rays(i) for i in idx]
        return (np.concatenate([q[0] for q in pairs], axis=0),
                np.concatenate([q[1] for q in pairs], axis=0))

    cache_pre = (trainer.quant_ready, trainer.proposal_ready)
    if args.quant == "int8" and not trainer.quant_ready:
        trainer.quantize_for_inference(*calib_rays())
    sampler = args.sampler
    if sampler == "proposal" and trainer.online_proposal:
        sampler = "coarse"  # renders already use the in-state proposal nets
    elif sampler == "proposal" and not trainer.proposal_ready:
        trainer.build_proposal_sampler(*calib_rays(), steps=args.proposal_steps)
    if args.infer_cache and (trainer.quant_ready, trainer.proposal_ready) != cache_pre:
        trainer.save_inference_artifacts(args.infer_cache)
        if main:
            print(f"{LOG} saved inference artifacts to {args.infer_cache}")

    report = evaluate_views(trainer, ds, chunk=args.chunk, quant=args.quant == "int8",
                            sampler=sampler, save_dir=args.save_images if main else None,
                            split=args.split)
    report["split"] = args.split
    report["checkpoint"] = ckpt
    report["quant"] = args.quant
    report["sampler"] = args.sampler
    if not main:
        return report

    out_path = args.out or io.join(ckpt.rsplit("/", 1)[0] if "/" in ckpt else ".",
                                   f"eval_{args.split}.json")
    with io.open_file(out_path, "w") as f:
        json.dump(report, f, indent=1)
    m = report["mean"]
    ssim_txt = f" ssim={m['ssim']:.4f}" if "ssim" in m else ""
    print(f"{LOG} {args.split}: psnr={m['psnr']:.2f}{ssim_txt} ({ds.num_images} views) "
          f"-> {out_path}")
    return report


if __name__ == "__main__":
    run_evaluation()
