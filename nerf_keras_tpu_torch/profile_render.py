"""Where a served frame's time goes, on one NVIDIA card.

    python -m nerf_keras_tpu_torch.profile_render [--quant int8]

Writes a checkpoint of random weights (glorot weights, random biases,
seed 0) for ``config/lego_batch_h256_tpu.json``, installs it in a
:class:`RenderService` on the card (with ``--quant int8`` the server
calibrates and gates its int8 tables and every frame runs through K4),
and for each square frame size in :data:`FRAMES`:

1. times ``render_png`` over warm requests on the host clock: the
   request's seconds and the ``render_image`` part of them (the service's
   own render counter; the rest is the host PNG encode);
2. traces one more request with ``torch.profiler`` and reports K1's and
   K4's device time and launches, the other device kernels, the traced
   wall time and the device's idle share, ``1 - (union of kernel
   intervals) / wall``.

Each measurement is one JSON line carrying the card string.  Nothing is
served over HTTP here: ``chip_smoke.py`` drives the HTTP path.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import torch

from nerf_keras_tpu_torch import load_config, runtime
from nerf_keras_tpu_torch.models.mlp import random_params
from nerf_keras_tpu_torch.serving import RenderService
from nerf_keras_tpu_torch.utils.checkpoint import save_params_npz

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "config", "lego_batch_h256_tpu.json")
FRAMES = ((200, 12), (800, 4))  # (frame size, warm requests timed)
KERNELS = {"k1": "fused_render_fwd_kernel", "k4": "quant_render_fwd_kernel"}
POSE = dict(theta=30.0, phi=-30.0, radius=4.0)


def union_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def time_requests(service: RenderService, size: int, n: int) -> dict:
    """Host-clock seconds of ``n`` warm ``render_png`` calls."""
    service.render_png(**POSE, height=size, width=size)  # warm-up
    request_s, render_s = [], []
    for _ in range(n):
        before = service.total_render_s
        t0 = time.perf_counter()
        service.render_png(**POSE, height=size, width=size)
        request_s.append(time.perf_counter() - t0)
        render_s.append(service.total_render_s - before)
    return {"request_s": request_s, "render_image_s": render_s,
            "median_request_s": statistics.median(request_s),
            "median_render_image_s": statistics.median(render_s)}


def trace_request(service: RenderService, size: int) -> dict:
    """Device kernels of one warm request, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        service.render_png(**POSE, height=size, width=size)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler saw no device kernels in the request")
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name.setdefault(e.name, []).append(us)
    out = {"wall_ms": wall_ms}
    for key, kname in KERNELS.items():
        mine = [us for name, v in by_name.items() if kname in name for us in v]
        out[f"{key}_ms"], out[f"{key}_launches"] = sum(mine) / 1e3, len(mine)
    other = [us for name, v in by_name.items()
             if not any(k in name for k in KERNELS.values()) for us in v]
    busy_ms = union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    top = sorted(((sum(v) / 1e3, name[:80], len(v)) for name, v in by_name.items()),
                 reverse=True)[:8]
    return {**out, "other_ms": sum(other) / 1e3, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "top": top}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--quant", type=str, default="none", choices=("none", "int8"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    card = runtime.card_string()
    cfg = load_config(CONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "random.ckpt.npz")
        save_params_npz(ckpt, random_params(cfg, seed=0), cfg,
                        scene={"near": 2.0, "far": 6.0})
        service = RenderService(cfg, ckpt, device="cuda", quant=args.quant == "int8")
        if args.quant == "int8" and not service.use_quant:
            raise RuntimeError(f"the int8 gate failed: {service.quant_gate_psnr} dB")
        print(json.dumps({"quant": args.quant, "gate_psnr_db": service.quant_gate_psnr,
                          "card": card}), flush=True)
        for size, n in FRAMES:
            print(json.dumps({"size": size, **time_requests(service, size, n),
                              "card": card}), flush=True)
            print(json.dumps({"size": size, **trace_request(service, size),
                              "card": card}), flush=True)


if __name__ == "__main__":
    main()
