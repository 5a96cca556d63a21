"""Where a train step's time goes, on one NVIDIA card.

    python -m nerf_keras_tpu_torch.profile_train [--steps 20]
        [--train-sampler proposal|coarse] [--no-stop-pdf-gradient]

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

Each measurement is one JSON line carrying the card string.
"""

from __future__ import annotations

import argparse
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


def trace_step(trainer: Trainer, batch) -> dict:
    """Device kernels of one warm train step, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
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
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            **{f"{k}_ms": total(names) for k, names in KERNELS.items()},
            "other_ms": device_ms - total(ours),
            "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": len(kernels), "top": top}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--train-sampler", choices=("proposal", "coarse"),
                        default="proposal")
    parser.add_argument("--no-stop-pdf-gradient", action="store_true",
                        help="coarse: the reference-faithful mode (K5)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    card = runtime.card_string()
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
