"""Step time of the data-parallel parity step over the GPUs of one host.

    python -m nerf_keras_tpu_torch.profile_dp [--world 4]
    python -m nerf_keras_tpu_torch.profile_dp --device cpu --world 4 --tiny
    python -m nerf_keras_tpu_torch.profile_dp --world 4 --frames 5
    python -m nerf_keras_tpu_torch.profile_dp --world 4 --model

Runs the parity step at ``config/lego_batch_h256_tpu.json``'s widths
(8x256, 64 + 128, bf16; random weights with nonzero biases) as real
ranks (``parallel/audit.run_ranks``, NCCL on the card, one GPU a rank):
a world of 1 at batch 4,096; ``--world`` ranks at the same global batch
(each rank 4,096 / world rays); and ``--world`` ranks at 4,096 rays a
rank.  For each it prints one JSON line: the step's median ms on each
rank (CUDA events over 10 warm steps; the world of 1 also without the
mesh, in the same process), the global rays/s, the kernel
launches and collectives of a step, the NCCL all-reduces of a step in a
``torch.profiler`` window of 3 steps (host calls and device kernels), and
whether the ranks' parameters stayed bit-identical; the same-batch
worlds also report the reduced gradients against the world of 1
(largest per-leaf relative L2: the bf16 weight gradients are rounded per
rank before the sum, as each rank's partial of ``w.astype(bf16)``'s
cotangent is in the JAX package).  ``--tiny`` shrinks the model for a
CPU rehearsal (gloo; no times).

``--frames N`` times frames instead: at worlds 1, 2, 4, ... up to
``--world``, int8 tables calibrated on rank 0 (4 orbit views of 100x100)
and shared, every rank renders its rows of each 16,384-ray chunk of an
800x800 frame (``Trainer.render_rays``, uint8 rgb, as a served rgb frame
before its PNG encode), float and int8: the median of N warm frames on
each rank (host clock; each frame ends in its copy to the host), the
speedup over the world of 1, a frame's launches and collectives.

``--model`` is the data-vs-model A/B instead: the parity step at the
global batch of 4,096 on ``--world`` ranks as the meshes ``(world, 1)``,
``(world / 2, 2)`` and ``(1, world)`` (``MESH_DATA`` x ``MESH_MODEL``;
a model axis runs the split MLP, no K1/K2): per mesh one JSON line with
each rank's median step ms, the global rays/s, the collectives of a step
by axis with their bytes (float32 elements x 4), each rank's peak
memory over the timed steps, the loss, and the first step's gradients
against the ``(world, 1)`` mesh's (largest per-leaf relative L2).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import numpy as np
import torch

from nerf_keras_tpu_torch.config import NeRFConfig
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import random_params
from nerf_keras_tpu_torch.ops.rays import pose_spherical
from nerf_keras_tpu_torch.parallel.audit import run_ranks, tree_rel_l2
from nerf_keras_tpu_torch.profile_train import bench_batch, parity_config
from nerf_keras_tpu_torch.runtime import card_string

TIME_STEPS, PROFILE_STEPS = 10, 3


def run(world: int, batch_size: int, cfg: NeRFConfig, device: str,
        model: int = 1) -> list[dict]:
    cfg = dataclasses.replace(cfg, batch_size=batch_size, mesh_model=model)
    spec = {"device": device, "backend": None, "cfg": cfg, "near": 2.0, "far": 6.0,
            "batch": bench_batch(batch_size, seed=5), "params": random_params(cfg, seed=7),
            "steps": 2}
    if device == "cuda":
        spec.update(time_steps=TIME_STEPS, profile=PROFILE_STEPS)
    return run_ranks(world, spec, timeout=600.0)


FRAME = 800


def time_frames(world: int, cfg: NeRFConfig, device: str, frames: int, size: int) -> dict:
    """One JSON line of ``--frames`` at ``world`` ranks."""
    host = Trainer(cfg, 2.0, 6.0, device="cpu")

    def rays(theta, n):
        return [t.numpy() for t in host.pose_rays(pose_spherical(theta, -30.0, 4.0), n, n,
                                                  1.2 * n)]

    views = [rays(theta, 100) for theta in (0.0, 90.0, 180.0, 270.0)]
    spec = {"device": device, "backend": None, "cfg": cfg, "near": 2.0, "far": 6.0,
            "params": random_params(cfg, seed=7), "infer": {
                "calib": [np.concatenate([v[i] for v in views]) for i in (0, 1)],
                "rays": rays(30.0, size), "time_frames": frames,
                "render_kw": {"keys": ("rgb_fine",), "uint8_rgb": True}}}
    ranks = [r["infer"] for r in run_ranks(world, spec, timeout=600.0)]
    kinds = ("float", "int8")
    line = {"world": world, "frame": [size, size],
            "rays_per_rank_per_chunk": -(-min(16384, size * size) // world),
            "frames_timed": frames,
            "launches_per_frame": {k: ranks[0]["steps"][k]["launches"] for k in kinds},
            "collectives_per_frame": {k: {c: n for c, n in
                                          ranks[0]["steps"][k]["collectives"].items() if n}
                                      for k in kinds},
            "digests_equal": len({r["digests"]["qparams"] for r in ranks}) == 1,
            "frames_equal": all(np.array_equal(r["frames"][k]["rgb_fine"],
                                               ranks[0]["frames"][k]["rgb_fine"])
                                for r in ranks for k in kinds)}
    for k in kinds:
        line[f"{k}_frame_s"] = max(statistics.median(r["frame_s"][k]) for r in ranks)
    return line


def model_ab(world: int, cfg: NeRFConfig, device: str, batch: int, card: str) -> None:
    """The ``--model`` lines (module docstring)."""
    ref = None
    for model in sorted({1, min(2, world), world}):
        ranks = run(world, batch, cfg, device, model)
        audit = ranks[0]["audit"]
        by_axis = {axis: {k: v for k, v in counts.items() if v}
                   for axis, counts in audit["by_axis"].items()}
        line = {"mesh": [world // model, model], "global_batch": batch,
                "rays_per_data_rank": batch // (world // model),
                "backend": ranks[0]["backend"], "collectives_per_step": by_axis,
                "collective_bytes_per_step": {
                    axis: 4 * (c.get("all_reduce_elements", 0) + c.get("all_gather_elements", 0))
                    for axis, c in by_axis.items()},
                "launches_per_step": ranks[0]["launches"][-1],
                "loss": ranks[0]["metrics"][-1]["loss"], "card": card}
        if device == "cuda":
            step_ms = [r["step_ms"] for r in ranks]
            line.update(step_ms=step_ms, rays_per_s=batch / (max(step_ms) / 1e3),
                        peak_mib=[r["peak_mib"] for r in ranks])
        if ref is None:
            ref = ranks[0]["grads"]
        else:
            line["grads_rel_l2_vs_data_mesh"] = tree_rel_l2(ranks[0]["grads"], ref)
        print(json.dumps(line), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="2x16 MLP, 8 + 8 samples, batch 64 (a CPU rehearsal)")
    p.add_argument("--model", action="store_true",
                   help="the data-vs-model A/B: the meshes (world, 1), (world/2, 2) and "
                        "(1, world) at one global batch, instead of the worlds")
    p.add_argument("--frames", type=int, default=0,
                   help="time N warm 800x800 frames (float and int8) at worlds 1, 2, "
                        "4, ... up to --world, instead of train steps")
    args = p.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        raise RuntimeError(f"--world {args.world} needs {args.world} GPUs, "
                           f"found {torch.cuda.device_count()}")
    cfg = parity_config()
    base = 4096
    if args.tiny:
        cfg = dataclasses.replace(cfg, num_layers=2, hidden_dim=16, ns_coarse=8, ns_fine=8,
                                  compute_dtype="float32")
        base = 64
    card = card_string() if args.device == "cuda" else "cpu"
    if args.model:
        model_ab(args.world, cfg, args.device, base, card)
        return
    if args.frames:
        first, world = None, 1
        while world <= args.world:
            line = time_frames(world, cfg, args.device, args.frames,
                               40 if args.tiny else FRAME)
            first = first or line
            for k in ("float", "int8"):
                line[f"{k}_speedup"] = first[f"{k}_frame_s"] / line[f"{k}_frame_s"]
            print(json.dumps(dict(line, card=card)), flush=True)
            if not (line["digests_equal"] and line["frames_equal"]):
                raise RuntimeError(f"world {world}: the ranks' tables or frames differ")
            world *= 2
        return
    cells = [(1, base), (args.world, base), (args.world, base * args.world)]
    ref = None
    for world, b in cells:
        ranks = run(world, b, cfg, args.device)
        line = {"world": world, "global_batch": b, "rays_per_rank": b // world,
                "backend": ranks[0]["backend"], "devices": [r["device"] for r in ranks],
                "launches_per_step": ranks[0]["launches"][-1],
                "collectives": ranks[0]["audit"]["collectives"],
                "params_identical": len({r["digest"] for r in ranks}) == 1,
                "loss": ranks[0]["metrics"][-1]["loss"], "card": card}
        if args.device == "cuda":
            step_ms = [r["step_ms"] for r in ranks]
            nccl = ranks[0]["nccl_all_reduce"]
            if world == 1:
                line["no_mesh_step_ms"] = ranks[0]["no_mesh_step_ms"]
            line.update(step_ms=step_ms, rays_per_s=b / (max(step_ms) / 1e3),
                        nccl_all_reduce_per_step={
                            "host_calls": nccl["host_calls"] / PROFILE_STEPS,
                            "device_kernels": nccl["device_kernels"] / PROFILE_STEPS,
                            "kernel_names": nccl["nccl_kernel_names"]})
        if b == base:
            if world == 1:
                ref = ranks[0]["grads"]
            else:
                line["grads_rel_l2_vs_world_1"] = tree_rel_l2(ranks[0]["grads"], ref)
        print(json.dumps(line), flush=True)
        if not line["params_identical"]:
            raise RuntimeError(f"world {world}: the ranks' parameters diverged")


if __name__ == "__main__":
    main()
