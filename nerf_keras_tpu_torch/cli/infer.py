"""Render a camera path from a trained checkpoint to a video.

    python -m nerf_keras_tpu_torch.cli.infer --config config/lego_batch_h256_tpu.json \
        --checkpoint <run-dir> --frames 30 \
        [--quant int8] [--sampler proposal] [--infer-cache <path>] [--depth-video] \
        [--profile <dir>]

``--reference-weights <file>.weights.h5`` takes the place of
``--checkpoint``: a Keras checkpoint of the TF reference (or one that
``cli.export_keras`` wrote), imported by ``utils/keras_import.py`` into the
coarse and fine models.  It has no sidecar, so near, far and focal are the
Lego scene's unless the flags set them, and a ``TRAIN_SAMPLER='proposal'``
config cannot take it (it has no coarse model).  Every other flag works on
the imported weights as on a checkpoint.

Counterpart of ``nerf_keras_tpu/cli/infer.py`` (the reference's
``inference.py``): the Blender-style orbit (theta in [-45, 45), phi -30,
radius 4; ``--full-orbit`` for 360 degrees) rendered through the fine
model, each frame on the card (K1, or K4 with int8), written as an mp4
(``<config>_rgb_video_gpu.mp4`` by default; a directory of PNG frames
where no mp4 encoder is installed, see ``utils/viz.write_video``).

The accelerations are gated on the first frame, and each falls back with
a printed line, as in the JAX package:

* ``--quant int8``: int8 tables calibrated on poses spread over the path;
  below ``--quant-gate-db`` PSNR against the float frame, the float path;
* ``--sampler proposal``: a proposal net distilled from the fine model on
  ``--proposal-calib-poses`` poses places the fine samples (no coarse
  pass); gated against the coarse sampler at the quant setting already
  decided, below ``--sampler-gate-db`` the coarse sampler.

``--infer-cache`` keeps both artifacts in an ``.infer.npz`` keyed to the
weights.  ``--profile DIR`` writes a ``torch.profiler`` Chrome trace of
one steady frame (``DIR/trace.json``) after an untraced one.

``--path spiral --data-dir <capture>`` renders the LLFF capture's own
path instead (the spiral around its average pose, or with ``--spherify``
the spherified orbit), from its ``poses_bounds.npy`` alone.  An ``NDC``
checkpoint renders NDC rays and so needs that path: on the orbit it raises
the forward-facing ``ValueError``.

Unlike the JAX CLI: ``--device`` (default ``cuda``, which raises without a
card) replaces ``--platform``, and there is no compilation cache.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from nerf_keras_tpu_torch.cli.train import LOG
from nerf_keras_tpu_torch.config import config_name, load_config
from nerf_keras_tpu_torch.data.llff import load_llff_render_path
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.ops.rays import pose_spherical
from nerf_keras_tpu_torch.runtime import resolve_device
from nerf_keras_tpu_torch.utils import profiling
from nerf_keras_tpu_torch.utils.checkpoint import (
    load_checkpoint_scene,
    resolve_checkpoint,
    resolve_infer_config,
)
from nerf_keras_tpu_torch.utils.image import normalize_depth, to_uint8
from nerf_keras_tpu_torch.utils.image_metrics import accuracy_gate
from nerf_keras_tpu_torch.utils.infer_cache import load_if_fresh
from nerf_keras_tpu_torch.utils.keras_import import import_reference_weights
from nerf_keras_tpu_torch.utils.viz import write_video



def spherical_poses(n_frames: int = 30, full_orbit: bool = False, phi: float = -30.0,
                    radius: float = 4.0) -> list[np.ndarray]:
    """The reference's render path: theta in [-45, 45), or a whole orbit."""
    lo, hi = (0.0, 360.0) if full_orbit else (-45.0, 45.0)
    return [pose_spherical(float(theta), phi, radius)
            for theta in np.linspace(lo, hi, n_frames, endpoint=False)]


def spiral_poses_from_capture(data_dir: str, n_frames: int,
                              spherify: bool = False) -> list[np.ndarray]:
    """``n_frames`` ``(3, 4)`` camera-to-world poses taken evenly from an
    LLFF capture's 120-pose render path (the spiral, or with ``spherify``
    the spherified orbit), read from ``poses_bounds.npy`` alone."""
    render_poses = load_llff_render_path(data_dir, recenter=True, spherify=spherify)
    idx = np.linspace(0, len(render_poses) - 1, n_frames)
    return [render_poses[int(round(i))][:, :4] for i in idx]


def _rays_of(trainer: Trainer, poses, cfg, focal) -> tuple[torch.Tensor, torch.Tensor]:
    """The rays of ``poses`` at the config's frame size, concatenated."""
    rays = [trainer.pose_rays(p, cfg.height, cfg.width, focal) for p in poses]
    return torch.cat([r[0] for r in rays]), torch.cat([r[1] for r in rays])


def quant_gate(trainer: Trainer, poses, cfg, focal, chunk: int, gate_db: float,
               calib_rays: int) -> bool:
    """Calibrate int8 tables on up to 4 poses spread over the path (unless
    the cache gave them; the gate's pose alone would calibrate the gate
    itself) and gate the first frame against the float one."""
    if not trainer.quant_ready:
        step = max(1, len(poses) // 4)
        trainer.quantize_for_inference(*_rays_of(trainer, poses[::step][:4], cfg, focal),
                                       calib_rays=calib_rays)
    ref = trainer.render_image(poses[0], cfg.height, cfg.width, focal, chunk=chunk)["rgb"]
    q = trainer.render_image(poses[0], cfg.height, cfg.width, focal, chunk=chunk,
                             quant=True)["rgb"]
    return accuracy_gate(ref, q, gate_db, "int8", "falling back to the float path")[0]


def proposal_gate(trainer: Trainer, poses, cfg, focal, chunk: int, gate_db: float,
                  steps: int, calib_poses: int, use_quant: bool) -> bool:
    """Distill the proposal net on ``calib_poses`` poses along the path
    (unless the cache gave it) and gate the first frame against the
    coarse sampler's at the decided quant setting."""
    if not trainer.proposal_ready:
        step = max(1, len(poses) // calib_poses)
        trainer.build_proposal_sampler(
            *_rays_of(trainer, poses[::step][:calib_poses], cfg, focal), steps=steps)
    kw = dict(chunk=chunk, quant=use_quant)
    ref = trainer.render_image(poses[0], cfg.height, cfg.width, focal, **kw)["rgb"]
    p = trainer.render_image(poses[0], cfg.height, cfg.width, focal, sampler="proposal",
                             **kw)["rgb"]
    return accuracy_gate(ref, p, gate_db, "proposal",
                         "falling back to the coarse sampler")[0]


def run_inference(argv: list[str] | None = None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default="config/fern_batch_h256.json")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint file or run directory")
    p.add_argument("--reference-weights", type=str, default=None,
                   help="a Keras .weights.h5 of the TF reference (or of cli.export_keras), "
                        "imported into the coarse and fine models in place of "
                        "--checkpoint")
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--path", type=str, default="orbit", choices=("orbit", "spiral"),
                   help="'orbit' = the Blender-style spherical sweep; 'spiral' = the "
                        "LLFF path of --data-dir's capture")
    p.add_argument("--data-dir", type=str, default=None,
                   help="LLFF capture directory (for --path spiral)")
    p.add_argument("--spherify", action="store_true",
                   help="with --path spiral: the spherified 360 orbit")
    p.add_argument("--full-orbit", action="store_true",
                   help="render a 360 degree orbit instead of the [-45, 45) sweep")
    p.add_argument("--phi", type=float, default=-30.0, help="orbit elevation in degrees")
    p.add_argument("--radius", type=float, default=4.0, help="orbit camera radius")
    p.add_argument("--chunk", type=int, default=16384)
    p.add_argument("--near", type=float, default=None,
                   help="near bound (default: checkpoint sidecar, else 2.0)")
    p.add_argument("--far", type=float, default=None,
                   help="far bound (default: checkpoint sidecar, else 6.0)")
    p.add_argument("--focal", type=float, default=None,
                   help="focal length in pixels (default: checkpoint sidecar, else "
                        "1.2*max(H,W))")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--depth-video", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="cuda | cuda:N | cpu (default: cuda; without a card, pass "
                        "--device cpu)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace (DIR/trace.json) of ONE "
                        "steady frame, after one untraced frame")
    p.add_argument("--ns-coarse", type=int, default=None,
                   help="override coarse samples/ray for rendering")
    p.add_argument("--ns-fine", type=int, default=None,
                   help="override fine samples/ray for rendering (0: coarse only)")
    p.add_argument("--quant", type=str, default="none", choices=("none", "int8"),
                   help="int8: both MLP passes through K4, gated by --quant-gate-db")
    p.add_argument("--quant-gate-db", type=float, default=30.0,
                   help="below this PSNR(int8 vs float) on the first frame the run "
                        "falls back to the float path")
    p.add_argument("--quant-calib-rays", type=int, default=2048,
                   help="rays subsampled for the activation-scale calibration")
    p.add_argument("--sampler", type=str, default="coarse", choices=("coarse", "proposal"),
                   help="proposal: a density net distilled from the fine model places "
                        "the fine samples (no coarse pass), gated by --sampler-gate-db")
    p.add_argument("--sampler-gate-db", type=float, default=30.0,
                   help="below this PSNR(proposal vs coarse) on the first frame the run "
                        "falls back to the coarse sampler")
    p.add_argument("--proposal-steps", type=int, default=1500,
                   help="distillation steps for --sampler proposal")
    p.add_argument("--proposal-calib-poses", type=int, default=8,
                   help="poses (evenly spaced along the path) whose rays form the "
                        "distillation set")
    p.add_argument("--infer-cache", type=str, default=None,
                   help="an .infer.npz of int8 tables and the distilled proposal net: "
                        "reloaded when it matches the checkpoint's weights (sha256), "
                        "else rebuilt and saved there")
    args = p.parse_args(argv)
    if (args.checkpoint is None) == (args.reference_weights is None):
        raise SystemExit("exactly one of --checkpoint / --reference-weights is required")
    device = resolve_device(args.device)

    cfg = load_config(args.config)
    name = config_name(args.config)
    if args.ns_coarse is not None or args.ns_fine is not None:
        # Sample counts are a render-time knob (the weights do not depend on
        # them); --ns-fine 0 (coarse only) is a valid value.
        cfg = dataclasses.replace(
            cfg, ns_coarse=cfg.ns_coarse if args.ns_coarse is None else args.ns_coarse,
            ns_fine=cfg.ns_fine if args.ns_fine is None else args.ns_fine).validate()
    ckpt = args.checkpoint
    if ckpt is not None and not ckpt.endswith(".npz"):
        found = resolve_checkpoint(ckpt)
        if found is None:
            raise FileNotFoundError(f"no .ckpt.npz under {ckpt}")
        ckpt = found
    # Scene geometry: flag > checkpoint sidecar > the Lego scene's.
    scene = (load_checkpoint_scene(ckpt) if ckpt else None) or {}
    near = args.near if args.near is not None else scene.get("near", 2.0)
    far = args.far if args.far is not None else scene.get("far", 6.0)
    focal = (args.focal if args.focal is not None
             else scene.get("focal", 1.2 * max(cfg.height, cfg.width)))
    cfg, notes = resolve_infer_config(cfg, ckpt)
    for note in notes:
        print(f"{LOG} {note}")
    print(f"{LOG} scene: near={near:.3f} far={far:.3f} focal={focal:.2f}"
          + ("" if scene else " (no sidecar; Lego-scene defaults)"))

    if ckpt is None and cfg.train_sampler == "proposal":
        raise SystemExit("--reference-weights carries a coarse+fine pair; it cannot load "
                         "into a TRAIN_SAMPLER='proposal' config (no coarse model) — use "
                         "the default coarse config for parity renders")
    trainer = Trainer(cfg, near, far, device=device)
    if ckpt is not None:
        trainer.restore(ckpt)
        print(f"{LOG} loaded {ckpt} on {device}")
    else:
        trainer.replace_params(*import_reference_weights(args.reference_weights, cfg))
        print(f"{LOG} imported reference weights {args.reference_weights} on {device}")
    if args.path == "spiral":
        if not args.data_dir:
            raise SystemExit("--path spiral requires --data-dir "
                             "(LLFF capture with poses_bounds.npy)")
        poses = spiral_poses_from_capture(args.data_dir, args.frames,
                                          spherify=args.spherify)
    else:
        poses = spherical_poses(args.frames, full_orbit=args.full_orbit, phi=args.phi,
                                radius=args.radius)
    load_if_fresh(trainer, args.infer_cache)
    cache_pre = (trainer.quant_ready, trainer.proposal_ready)
    use_quant = args.quant == "int8" and quant_gate(
        trainer, poses, cfg, focal, args.chunk, args.quant_gate_db, args.quant_calib_rays)
    use_sampler = "coarse"
    if args.sampler == "proposal" and trainer.online_proposal:
        print(f"{LOG} proposal-trained checkpoint: renders already use the in-state "
              "proposal nets")
    elif args.sampler == "proposal" and proposal_gate(
            trainer, poses, cfg, focal, args.chunk, args.sampler_gate_db,
            args.proposal_steps, args.proposal_calib_poses, use_quant):
        use_sampler = "proposal"
    post = (trainer.quant_ready, trainer.proposal_ready)
    if args.infer_cache and post != cache_pre and any(post):
        trainer.save_inference_artifacts(args.infer_cache)
        print(f"{LOG} saved inference artifacts to {args.infer_cache}")

    def render(pose):
        return trainer.render_image(pose, cfg.height, cfg.width, focal, chunk=args.chunk,
                                    quant=use_quant, sampler=use_sampler, uint8_rgb=True,
                                    need_depth=args.depth_video)

    frames, depth_frames = [], []
    for i, pose in enumerate(poses):
        if args.profile is not None and i == 0:
            render(pose)  # untraced first, so the trace holds a steady frame
            with profiling.trace(args.profile, device):
                out = render(pose)
            print(f"{LOG} profiler trace of one {cfg.height}x{cfg.width} frame -> "
                  f"{os.path.join(args.profile, profiling.TRACE_FILE)}")
            timing = "traced"
        else:
            t0 = time.perf_counter()
            out = render(pose)  # ends in the copy to the host
            timing = f"{(time.perf_counter() - t0) * 1e3:.2f} ms"
        frames.append(to_uint8(out["rgb"]))
        if args.depth_video:
            depth_frames.append(to_uint8(normalize_depth(out["depth"])))
        print(f"  frame {i + 1}/{args.frames} ({timing})")

    out_path = args.out or f"{name}_rgb_video_gpu.mp4"
    written = write_video(out_path, frames, fps=30)
    print(f"{LOG} video saved to {written}")
    if depth_frames:
        base, ext = os.path.splitext(out_path)
        dpath = write_video(f"{base}_depth{ext or '.mp4'}", depth_frames, fps=30)
        print(f"{LOG} depth video saved to {dpath}")
    return written


if __name__ == "__main__":
    run_inference()
