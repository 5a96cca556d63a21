"""The parity step's three training paths, and K6 and K7 alone, on one
NVIDIA card.

    python -m nerf_keras_tpu_torch.exp_train_paths [--steps 8] [--rounds 1]
        [--phases steps,kernels,pdf]

The port of three scripts of the JAX package:

* ``steps`` (``scripts/exp_train_paths.py``): a same-process A/B of full
  parity train steps (forward, backward, Adam) through three render
  paths, each a ``render_pass`` of :func:`make_train_step`:

  - (b) the engine's default: K1 writing its residuals, K2 backward;
  - (c) :func:`recompute_render_pass`: K1 writing only its predictions,
    K3 backward (``render_rays_fused(..., bwd_mode="recompute")``);
  - (a) :func:`encodings_in_render_pass`: points and encodings in plain
    torch (f32, cast to bf16), then K6 forward and backward.

  Each round visits them in the order b, c, a, a, c, b and times
  ``--steps`` steps per visit on the host clock, each step ending in a
  synchronise.  Per variant: median step ms, rays/s, launches per step by
  the counters, the step's peak device memory over what was allocated
  before it, and the memory the loss's forward holds for its backward.
* ``kernels`` (``scripts/profile_train.py`` section 4b, :147-190): K6
  forward at (B, 64) and (B, 192), and forward + backward at (B, 192),
  with the plain versions' times, CUDA events.
* ``pdf`` (``scripts/exp_render_r3.py``'s ``pdf`` phase): K7 against the
  ``sample_pdf`` + ``sorted_union`` chain at its three main shapes
  (:data:`K7_SHAPES`), timed as :func:`k7_times` says; then a 200x200
  frame rendered with K7 in place of the chain (:func:`render_rays_union`)
  against the engine's render.

The configuration is ``profile_train.parity_config()`` (lego widths 8x256,
skip 4, L 10/4, 64 + 128 samples, batch 4096, bf16, STOP_PDF_GRADIENT),
the batch ``profile_train.bench_batch``, and every variant starts from the
same seeded weights with the same random biases.  Each line is one JSON
object carrying the card string.  Without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable

import numpy as np
import torch

from nerf_keras_tpu_torch import runtime
from nerf_keras_tpu_torch.runtime import cuda_ms, device_ms_by_kernel
from nerf_keras_tpu_torch.config import NeRFConfig
from nerf_keras_tpu_torch.engine.step import make_loss_fn, make_render_fn, make_train_step
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import randomize_biases_
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.kernels import fused_mlp as k5
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.kernels import pdf_union as k7
from nerf_keras_tpu_torch.ops.kernels import quant_render as k4
from nerf_keras_tpu_torch.ops.rays import get_rays, pose_spherical, sample_rays
from nerf_keras_tpu_torch.ops.sampling import generate_t_vals, sample_pdf
from nerf_keras_tpu_torch.ops.volume import composite_background
from nerf_keras_tpu_torch.profile_train import bench_batch, parity_config

NEAR, FAR = 2.0, 6.0
PHASES = ("steps", "kernels", "pdf")
# K7's main shapes (B, S, NF, sorted uniforms): the render chunk on the eval
# grid, the parity step (64 + 128) and the bench recipe (64 + 96) on sorted
# uniforms.
K7_SHAPES = ((16384, 64, 128, False), (4096, 64, 128, True), (4096, 64, 96, True))


def recompute_render_pass(cfg: NeRFConfig) -> Callable:
    """Variant c: ``render_rays_fused(..., bwd_mode="recompute")`` (K1
    with its predictions only, K3 backward)."""
    def render_pass(mlp, origins, dirs, t_vals, weights_grad=False):
        return k1.render_rays_fused(mlp, origins, dirs, t_vals, l_xyz=cfg.l_xyz,
                                    l_dir=cfg.l_dir, skip_layer=cfg.skip_layer,
                                    weights_grad=weights_grad, bwd_mode="recompute")
    return render_pass


def encodings_in_render_pass(cfg: NeRFConfig) -> Callable:
    """Variant a: points and encodings in plain torch (f32, then the
    compute dtype), per sample, then :func:`apply_nerf_render_fused` (K6).
    K6's weights carry no gradient, so a loss that reads them (distortion,
    ``WHITE_BKGD``) cannot take this path."""
    enc_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

    def render_pass(mlp, origins, dirs, t_vals, weights_grad=False):
        if weights_grad:
            raise ValueError("the encodings-in path (K6) gives its weights no gradient")
        points, dirs_s = sample_rays(origins, dirs, t_vals)
        x_enc = encode_position(points, cfg.l_xyz).to(enc_dtype)
        d_enc = encode_position(dirs_s, cfg.l_dir).to(enc_dtype)
        return k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t_vals)
    return render_pass


# (name, what it runs, the function making its render_pass, or None for the engine's default)
VARIANTS = (
    ("b", "K1 with residuals, K2", None),
    ("c", "K1 with predictions only, K3", recompute_render_pass),
    ("a", "encodings in torch, K6 forward and backward", encodings_in_render_pass),
)


def variant_pass(cfg: NeRFConfig, name: str) -> Callable | None:
    build = dict((v[0], v[2]) for v in VARIANTS)[name]
    return None if build is None else build(cfg)


def render_rays_union(cfg: NeRFConfig, models: dict, origins: torch.Tensor,
                      dirs: torch.Tensor, near: float = NEAR, far: float = FAR) -> dict:
    """The coarse+fine render of one chunk with K7 in place of the
    ``sample_pdf`` + ``sorted_union`` chain: a K1 coarse pass, K7 on its
    weights, a K1 fine pass over the union.  ``{'rgb_fine', 'depth_fine'}``."""
    with torch.no_grad():
        t_vals = generate_t_vals(near, far, origins.shape[:-1], cfg.ns_coarse, "center",
                                 device=origins.device).contiguous()
        args = dict(l_xyz=cfg.l_xyz, l_dir=cfg.l_dir, skip_layer=cfg.skip_layer)
        _, w_coarse = k1.render_rays_fused(models["coarse"], origins, dirs, t_vals, **args)
        t_all = k7.sample_pdf_union_eval(t_vals, w_coarse, cfg.ns_fine)
        rgb, w_fine = k1.render_rays_fused(models["fine"], origins, dirs, t_all, **args)
        if cfg.white_bkgd:
            rgb = composite_background(rgb, w_fine)
        return {"rgb_fine": rgb, "depth_fine": torch.sum(w_fine * t_all, dim=-1)}


def counts() -> dict:
    """Every kernel wrapper's launch count in this process."""
    return {"k1_fwd": k1.launches - k1.train_launches, "k1_train": k1.train_launches,
            "k2": k1.bwd_launches, "k3": k1.recompute_launches, "k5_fwd": k5.launches,
            "k5_bwd": k5.bwd_launches, "k4": k4.launches, "k6_fwd": k1.enc_launches,
            "k6_bwd": k1.enc_bwd_launches, "k7": k7.launches}


def make_trainer(cfg: NeRFConfig, device: str = "cuda") -> Trainer:
    """The seeded trainer with seeded random biases (every variant the same)."""
    trainer = Trainer(cfg, NEAR, FAR, device=device)
    for m in trainer.params.values():
        randomize_biases_(m, torch.Generator().manual_seed(3))
    return trainer


def requested_bytes() -> int:
    """Device bytes the live tensors asked for (not the allocator's
    blocks, which it may round up by as much as 1 MiB)."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def held_bytes(cfg: NeRFConfig, trainer: Trainer, batch, render_pass) -> int:
    """Device bytes the parity loss's forward holds for its backward (the
    graph's saved tensors and its outputs), then the backward is run."""
    loss_fn = make_loss_fn(cfg, NEAR, FAR, render_pass=render_pass)
    t_vals = generate_t_vals(NEAR, FAR, (cfg.batch_size,), cfg.ns_coarse, "stratified",
                             generator=trainer.generator, device=trainer.device).contiguous()
    torch.cuda.synchronize()
    before = requested_bytes()
    loss, _ = loss_fn(trainer.params, *batch, t_vals, 0, generator=trainer.generator)
    torch.cuda.synchronize()
    held = requested_bytes() - before
    loss.backward()
    for m in trainer.params.values():
        m.zero_grad(set_to_none=True)
    return held


def phase_steps(card: str, steps: int, rounds: int) -> dict:
    cfg = parity_config()
    names = [v[0] for v in VARIANTS]
    trainers = {n: make_trainer(cfg) for n in names}
    step_fns = {n: make_train_step(cfg, NEAR, FAR, render_pass=variant_pass(cfg, n))
                for n in names}
    batch = trainers["b"].put_batch(bench_batch(cfg.batch_size))

    def run(n):
        tr = trainers[n]
        return step_fns[n](tr.state, batch, None, tr.generator)

    report = {}
    for n in names:  # warm-up, launches and memory of one step each
        run(n)
        torch.cuda.synchronize()
        before = counts()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        float(run(n)["loss"])
        peak = torch.cuda.max_memory_allocated() - base
        per_step = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        report[n] = {"launches_per_step": per_step, "peak_step_mb": peak / 2**20,
                     "held_mb": held_bytes(cfg, trainers[n], batch, variant_pass(cfg, n))
                     / 2**20, "ms": []}
    for _ in range(rounds):
        for n in (*names, *reversed(names)):
            for _ in range(steps):
                t0 = time.perf_counter()
                float(run(n)["loss"])  # synchronises
                report[n]["ms"].append((time.perf_counter() - t0) * 1e3)
    for n, what, _ in VARIANTS:
        r = report[n]
        med = statistics.median(r["ms"])
        r.update(what=what, median_step_ms=med, rays_per_s=cfg.batch_size / (med / 1e3))
        print(json.dumps({"phase": "steps", "variant": n, **r, "card": card}), flush=True)
    return report


def phase_kernels(card: str) -> dict:
    """K6 forward at (B, 64) and (B, 192), forward + backward at (B, 192)."""
    cfg = parity_config()
    trainer = make_trainer(cfg)
    _, origins, dirs = trainer.put_batch(bench_batch(cfg.batch_size))
    b = cfg.batch_size
    report = {}
    for name, s in (("coarse", cfg.ns_coarse), ("fine", cfg.ns_coarse + cfg.ns_fine)):
        mlp = trainer.params[name]
        t = generate_t_vals(NEAR, FAR, (b,), s, "center", device=trainer.device).contiguous()
        points, dirs_s = sample_rays(origins, dirs, t)
        x_enc = encode_position(points, cfg.l_xyz).to(torch.bfloat16).contiguous()
        d_enc = encode_position(dirs_s, cfg.l_dir).to(torch.bfloat16).contiguous()
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t))
            plain_ms = cuda_ms(lambda: k1.apply_nerf_render_reference(mlp, x_enc, d_enc, t))
        row = {"phase": "kernels", "kernel": "K6-fwd", "B": b, "S": s, "ms": fwd_ms,
               "plain_ms": plain_ms}
        if name == "fine":
            def fwd_bwd(fn):
                rgb, _ = fn(mlp, x_enc, d_enc, t)
                torch.autograd.grad([rgb.sum()], list(mlp.parameters()))
            row.update(fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(k1.apply_nerf_render_fused)),
                       fwd_bwd_plain_ms=cuda_ms(
                           lambda: fwd_bwd(k1.apply_nerf_render_reference)))
        report[s] = row
        print(json.dumps({**row, "card": card}), flush=True)
    return report


def pdf_inputs(b: int, s: int, seed: int = 0, device="cuda"):
    """Sorted t in [2, 6] and weights U^3 (``exp_render_r3.py``'s)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(2.0, 6.0, (b, s)).astype(np.float32), axis=-1)
    w = (rng.uniform(0, 1, (b, s)) ** 3).astype(np.float32)
    return torch.as_tensor(t, device=device), torch.as_tensor(w, device=device)


def union_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    diff = (got - want).abs().nan_to_num(nan=float("inf"))
    return {"max_abs_err": float(diff.max()), "above_1e-5": int((diff > 1e-5).sum())}


def k7_u(b: int, nf: int, sorted_u: bool, seed: int = 8) -> torch.Tensor | None:
    """Sorted uniforms ``(b, nf)`` on the card, or None (the eval grid)."""
    if not sorted_u:
        return None
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.sort(torch.rand((b, nf), generator=gen, device="cuda"), dim=-1).values


def k7_times(t: torch.Tensor, w: torch.Tensor, nf: int, u: torch.Tensor | None,
             reps: int = 20) -> dict:
    """K7 beside the chain at one shape, in ms: the call of
    ``sample_pdf_union`` (CUDA events around the Python call, median of
    50) and its kernel's device time (``torch.profiler``, mean of ``reps``
    launches); the chain's call and device time (all its kernels); and the
    device time of two yardsticks the port never calls: one ``torch.sort``
    of the ``(B, S + NF)`` concatenation (K7's union half) and one
    ``torch.searchsorted`` of ``u`` in the cdf (its bin-lookup half)."""
    def dev_ms(fn, names=()):
        r = device_ms_by_kernel(lambda: [fn() for _ in range(reps)], {"k": names})
        return (r["k"] if names else r["all"]) / reps

    run = lambda: k7.sample_pdf_union(t, w, nf, u)  # noqa: E731
    chain = lambda: k7.sample_pdf_union_reference(t, w, nf, u)  # noqa: E731
    t_fine = sample_pdf(0.5 * (t[:, 1:] + t[:, :-1]), w, nf, deterministic=u is None, u=u)
    both = torch.cat([t, t_fine], dim=-1)
    pdf = (w + k7.WEIGHT_FLOOR) / torch.sum(w + k7.WEIGHT_FLOOR, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
    uu = (k7.device_grid(nf, t.device) if u is None else u).expand(t.shape[0], nf).contiguous()
    return {"ms": cuda_ms(run, reps=50), "device_ms": dev_ms(run, ("pdf_union_kernel",)),
            "chain_ms": cuda_ms(chain, reps=50), "chain_device_ms": dev_ms(chain),
            "sort_device_ms": dev_ms(lambda: torch.sort(both, dim=-1)),
            "searchsorted_device_ms": dev_ms(lambda: torch.searchsorted(cdf, uu, right=True))}


def phase_pdf(card: str) -> dict:
    report = {}
    for b, s, nf, sorted_u in K7_SHAPES:
        t, w = pdf_inputs(b, s)
        u = k7_u(b, nf, sorted_u, seed=1)
        got = k7.sample_pdf_union(t, w, nf, u)
        want = k7.sample_pdf_union_reference(t, w, nf, u)
        row = {"phase": "pdf", "B": b, "S": s, "NF": nf, "u": "sorted" if sorted_u else "eval",
               **union_errors(got, want), **k7_times(t, w, nf, u)}
        report[(b, nf)] = row
        print(json.dumps({**row, "card": card}), flush=True)
    # A 200x200 frame with K7 in place of the chain, against the engine's.
    cfg = parity_config()
    trainer = make_trainer(cfg)
    origins, dirs = get_rays(200, 200, 240.0, pose_spherical(30.0, -30.0, 4.0),
                             device=trainer.device)
    origins, dirs = origins.reshape(-1, 3).contiguous(), dirs.reshape(-1, 3).contiguous()
    render = make_render_fn(cfg, NEAR, FAR)
    errs = {"rgb": 0.0, "depth": 0.0}
    with torch.no_grad():
        for i in range(0, origins.shape[0], 16384):
            o, d = origins[i:i + 16384], dirs[i:i + 16384]
            got = render_rays_union(cfg, trainer.params, o, d)
            want = render(trainer.params, o, d)
            for k in errs:
                errs[k] = max(errs[k], float((got[f"{k}_fine"] - want[f"{k}_fine"]).abs().max()))
    report["frame"] = errs
    print(json.dumps({"phase": "pdf_frame", "size": 200, "rgb_max_abs_err": errs["rgb"],
                      "depth_max_abs_err": errs["depth"], "card": card}), flush=True)
    return report


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=8, help="timed steps per visit")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--phases", default=",".join(PHASES))
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    runtime.configure_numerics()
    card = runtime.card_string()
    if "steps" in phases:
        phase_steps(card, args.steps, args.rounds)
    if "kernels" in phases:
        phase_kernels(card)
    if "pdf" in phases:
        phase_pdf(card)


if __name__ == "__main__":
    main()
