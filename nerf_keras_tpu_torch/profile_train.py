"""Where a train step's time goes, on one NVIDIA card.

    python -m nerf_keras_tpu_torch.profile_train [--steps 20]
        [--train-sampler proposal|coarse] [--no-stop-pdf-gradient]
    python -m nerf_keras_tpu_torch.profile_train --arm all|ARM [ARM ...] [--steps 20]

Builds a trainer on the card with its seeded initial weights and one
fixed batch of random rays and colours (:func:`bench_batch`, as
``bench.py`` makes it):

* ``--train-sampler proposal`` (default): the bench recipe
  (:func:`bench_config`: online proposal, union layout, 64 uniform + 96
  placed samples, batch 4096, 8x256 bf16, distortion 1e-4, sampling
  anneal 1000 steps);
* ``--train-sampler coarse``: the coarse+fine parity step at
  ``config/lego_batch_h256_tpu.json``'s widths (:func:`parity_config`:
  8x256, skip 4, 64 coarse + 128 fine, batch 4096, bf16), with
  ``STOP_PDF_GRADIENT`` (K1/K2) or, with ``--no-stop-pdf-gradient``,
  without it (K5).

Then:

1. times ``--steps`` warm steps on the host clock, each ending in a
   device synchronise: median step ms and rays/s;
2. traces one more step with ``torch.profiler``: device ms by kernel,
   each kernel's share, the traced wall time and the device's idle share
   ``1 - (union of kernel intervals) / wall``.

``--arm`` takes union-free arms instead (:data:`ARMS`, :func:`arm_config`:
the bench recipe at 64 + 128 with ``PROP_UNION=false`` and
``PROP_EXPLORE`` 0.1; ``auxfree-128+32`` adds a 32-sample aux pass,
``il4-128`` a union step every 4th step), or ``all`` of them.  It builds
the bench recipe and each arm in one process and takes ``--steps``
synchronised steps of each in turn, :data:`ROUNDS` times, then traces each
over one interleave period (``il4-128``: four steps; the others one).

Each measurement is one JSON line carrying the card string.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from nerf_keras_tpu_torch.config import NeRFConfig
from nerf_keras_tpu_torch import runtime
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.profile_render import union_us

# Device kernels by the port's kernel they belong to (a name matches the
# templated kernels, e.g. k5_rows_kernel<256, true>).  The dW product and
# its reduce (nerf_dw.cuh) are the last stages of the K2, K3, K5 or K6
# backward, whichever ran.
KERNELS = {
    "k1": ("fused_render_fwd_kernel",),
    "k2_vjp": ("composite_vjp_kernel",),
    "k2_rows": ("k2_rows_kernel",),
    "k3_rows": ("k3_rows_kernel",),
    "k5_fwd": ("fused_mlp_fwd_kernel",),
    "k5_rows": ("k5_rows_kernel",),
    "k6_fwd": ("fused_render_enc_kernel",),
    "k6_rows": ("k6_rows_kernel",),
    "dw": ("mlp_dw_kernel",),
    "reduce": ("mlp_reduce_kernel",),
}


def bench_config(batch_size: int = 4096) -> NeRFConfig:
    """The train step ``bench.py`` times for ``--train-sampler proposal``."""
    return NeRFConfig(
        batch_size=batch_size, ns_coarse=64, ns_fine=96, num_layers=8,
        hidden_dim=256, compute_dtype="bfloat16", train_sampler="proposal",
        distortion_loss_mult=1e-4, prop_anneal_steps=1000,
    ).validate()


# The shipped union recipe, under its name in the JAX package's
# scripts/exp_coverage_step_ab.py:56-57, and the knobs each union-free arm
# adds to the bench recipe at 64 + 128.  auxfree-128+32 and il4-128 are
# that script's arms (:58-65, over its common widths at :48-53);
# nounion-128 is docs/TRAINING.md:90's throughput recipe (PROP_UNION false,
# PROP_EXPLORE 0.1) at the script's widths, with neither knob.
UNION_ARM = "official-64+96"
ARMS = {
    "nounion-128": {},
    "auxfree-128+32": {"prop_aux_samples": 32},
    "il4-128": {"prop_union_every": 4},
}
ROUNDS = 5  # rounds of --steps steps of each arm in turn


def arm_config(arm: str, batch_size: int = 4096) -> NeRFConfig:
    """:func:`bench_config` itself for :data:`UNION_ARM`; else with 128
    placed samples in the union-free layout (``PROP_EXPLORE`` 0.1, the
    layout's documented floor) and the arm's knob."""
    if arm == UNION_ARM:
        return bench_config(batch_size)
    return dataclasses.replace(
        bench_config(batch_size), ns_fine=128, prop_union=False, prop_explore=0.1,
        **ARMS[arm]).validate()


def parity_config(batch_size: int = 4096, stop_pdf_gradient: bool = True) -> NeRFConfig:
    """The coarse+fine parity step at ``config/lego_batch_h256_tpu.json``'s
    widths: 8x256 skip 4, L 10/4, 64 coarse + 128 fine, bf16."""
    return NeRFConfig(
        batch_size=batch_size, ns_coarse=64, ns_fine=128, num_layers=8,
        hidden_dim=256, skip_layer=4, l_xyz=10, l_dir=4, compute_dtype="bfloat16",
        train_sampler="coarse", stop_pdf_gradient=stop_pdf_gradient,
    ).validate()


def bench_batch(b: int, seed: int = 0) -> tuple[np.ndarray, ...]:
    """Random colours and unit directions from the origin (0, 0, 4)."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.tile(np.array([0, 0, 4.0], np.float32), (b, 1))
    return images, origins, dirs


def time_steps(trainer: Trainer, batch, steps: int) -> dict:
    """Host-clock ms of ``steps`` train steps, each synchronised."""
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(ms)
    return {"step_ms": ms, "median_step_ms": med,
            "rays_per_s": trainer.cfg.batch_size / (med / 1e3)}


def trace_step(trainer: Trainer, batch, steps: int = 1) -> dict:
    """Device kernels of ``steps`` warm train steps, from
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler saw no device kernels in the step")
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    total = lambda names: sum(sum(v) for n, v in by_name.items()  # noqa: E731
                              if any(k in n for k in names)) / 1e3
    busy_ms = union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    device_ms = sum(sum(v) for v in by_name.values()) / 1e3
    top = sorted(((sum(v) / 1e3, n[:80], len(v)) for n, v in by_name.items()),
                 reverse=True)[:14]
    ours = [n for names in KERNELS.values() for n in names]
    return {"steps": steps, "wall_ms": wall_ms, "device_ms": device_ms,
            **{f"{k}_ms": total(names) for k, names in KERNELS.items()},
            "other_ms": device_ms - total(ours),
            "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": len(kernels), "top": top}


def compare_arms(arms, steps: int) -> dict:
    """Median step ms of :data:`UNION_ARM` and ``arms``, trained in one
    process on one fixed batch, ``steps`` synchronised steps of each in
    turn for :data:`ROUNDS` rounds (``steps`` a multiple of 4 keeps the
    interleave's share of union steps), after 4 warm-up steps each; then
    one traced interleave period of each.  Returns ``{arm: {...}}``."""
    arms = (UNION_ARM, *arms)
    trainers = {a: Trainer(arm_config(a), 2.0, 6.0, device="cuda") for a in arms}
    batch = trainers[UNION_ARM].put_batch(bench_batch(4096))
    for t in trainers.values():
        time_steps(t, batch, 4)
    step_ms = {a: [] for a in arms}
    for _ in range(ROUNDS):
        for a, t in trainers.items():
            step_ms[a] += time_steps(t, batch, steps)["step_ms"]
    out = {}
    for a, t in trainers.items():
        med = statistics.median(step_ms[a])
        out[a] = {"median_step_ms": med, "rays_per_s": 4096 / (med / 1e3),
                  "step_ms": step_ms[a],
                  "trace": trace_step(t, batch, t.cfg.prop_union_every or 1)}
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--train-sampler", choices=("proposal", "coarse"),
                        default="proposal")
    parser.add_argument("--no-stop-pdf-gradient", action="store_true",
                        help="coarse: the reference-faithful mode (K5)")
    parser.add_argument("--arm", nargs="+", choices=("all", *sorted(ARMS)), default=None,
                        help="union-free arms, timed in turn beside the union recipe")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    card = runtime.card_string()
    if args.arm is not None:
        arms = list(ARMS) if "all" in args.arm else list(dict.fromkeys(args.arm))
        for arm, rec in compare_arms(arms, args.steps).items():
            print(json.dumps({"phase": "arms", "arm": arm, "rounds": ROUNDS,
                              "steps_per_round": args.steps, **rec, "card": card}),
                  flush=True)
        return
    if args.train_sampler == "proposal":
        cfg = bench_config()
    else:
        cfg = parity_config(stop_pdf_gradient=not args.no_stop_pdf_gradient)
    trainer = Trainer(cfg, 2.0, 6.0, device="cuda")
    batch = trainer.put_batch(bench_batch(cfg.batch_size))
    time_steps(trainer, batch, 3)  # warm-up: packs, allocator, kernel build
    print(json.dumps({"phase": "steps", "train_sampler": cfg.train_sampler,
                      "stop_pdf_gradient": cfg.stop_pdf_gradient,
                      **time_steps(trainer, batch, args.steps), "card": card}), flush=True)
    print(json.dumps({"phase": "trace", **trace_step(trainer, batch), "card": card}),
          flush=True)


if __name__ == "__main__":
    main()
