"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python chip_smoke.py

Phases (each prints one line; a failed phase raises and the script exits
nonzero — nothing falls back to the CPU or to a plain path):

1. the card, its power limit, torch/CUDA versions and the TF32 flags;
2. build the CUDA kernels from ``nerf_keras_tpu_torch/csrc`` with nvcc;
3. K1 against its plain PyTorch version at full width (8x256, B=4096,
   S=64 and S=192), with errors and CUDA-event times;
4. serve: write a random-weight checkpoint for
   ``config/lego_batch_h256_tpu.json``, start the port's HTTP server on
   127.0.0.1, issue /healthz, three 200x200 /render and /stats, decode
   the PNGs, and check from the launch counter that K1 rendered them.

The line before the last is the kernel report
``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from nerf_keras_tpu_torch import load_config, runtime
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import (
    NeRFMLP,
    random_params,
    randomize_biases_,
)
from nerf_keras_tpu_torch.ops.kernels import _build
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.rays import get_rays, pose_spherical
from nerf_keras_tpu_torch.ops.sampling import generate_t_vals
from nerf_keras_tpu_torch.serving import RenderService, serve
from nerf_keras_tpu_torch.utils.checkpoint import save_params_npz
from nerf_keras_tpu_torch.utils.png import decode_png

# K1 vs plain at full width.  Both take bf16-rounded operands and
# accumulate in f32; they differ in summation order, which can flip the
# bf16 rounding of a hidden activation, and in the order of the
# transmittance product.  On an H100 with these weights (random biases)
# that is max |diff| 1.7e-4 and mean 2.7e-6 for rgb/weights, in [0, 1];
# the gates sit ~30x above.  A pack with zeroed or shifted biases errs by
# 0.57+ (max) and 0.019+ (mean).
TOL_MAX = 5e-3
TOL_MEAN = 1e-4
# A frame served on the card against the plain path on the CPU: the fine
# samples follow the coarse weights, so a small weight difference moves
# them a little (on an H100, 24x24: rgb 1.5e-4, depth 1.6e-3).
FRAME_TOL_RGB = 5e-3
FRAME_TOL_DEPTH = 2e-2

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "config", "lego_batch_h256_tpu.json")
K1_SOURCE = "nerf_keras_tpu_torch/csrc/fused_render_fwd.cu"
K1_REPLACES = "nerf_keras_tpu/ops/pallas/fused_render.py:709"


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    fn()  # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    runtime.configure_numerics()
    card = runtime.card_string()
    print(card, flush=True)
    say("card", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return card


def phase_build() -> None:
    seconds = _build.build()
    ptxas = [line.strip() for line in _build.build_log.splitlines()
             if "registers" in line or "spill" in line]
    k1_lib = _build.load()  # noqa: F841  (loads the library, declares argtypes)
    say("build", seconds=seconds, library=str(_build.library_path().name),
        ptxas=ptxas)


def phase_kernel(card: str) -> dict:
    """K1 vs render_rays_reference at the main path's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    mlp = randomize_biases_(
        NeRFMLP(num_layers=8, hidden_dim=256, skip_layer=4, l_xyz=10,
                l_dir=4, compute_dtype=torch.bfloat16, generator=gen,
                device=dev),
        gen,
    )
    origins, dirs = get_rays(64, 64, 1.2 * 64, pose_spherical(30.0, -30.0, 4.0),
                             device=dev)
    origins = origins.reshape(-1, 3).contiguous()
    dirs = dirs.reshape(-1, 3).contiguous()
    b = origins.shape[0]
    report = {"max_abs_err": 0.0}
    with torch.inference_mode():
        for s in (64, 192):
            t = generate_t_vals(2.0, 6.0, (b,), s, "stratified",
                                generator=gen).to(dev).contiguous()
            args = (mlp, origins, dirs, t)
            rgb_k, w_k = k1.render_rays_fused(*args)
            torch.cuda.synchronize()
            rgb_p, w_p = k1.render_rays_reference(*args)
            torch.cuda.synchronize()
            d_rgb = (rgb_k - rgb_p).abs()
            d_w = (w_k - w_p).abs()
            errs = {
                "rgb_max": d_rgb.max().item(), "rgb_mean": d_rgb.mean().item(),
                "w_max": d_w.max().item(), "w_mean": d_w.mean().item(),
            }
            finite = bool(torch.isfinite(rgb_k).all() and torch.isfinite(w_k).all())
            ms = cuda_ms(lambda: k1.render_rays_fused(*args))
            plain_ms = cuda_ms(lambda: k1.render_rays_reference(*args))
            say("k1", B=b, S=s, **errs, tol_max=TOL_MAX, tol_mean=TOL_MEAN,
                finite=finite, ms=ms, plain_ms=plain_ms, card=card)
            if not finite:
                raise RuntimeError(f"K1 produced non-finite values at S={s}")
            if (errs["rgb_max"] > TOL_MAX or errs["w_max"] > TOL_MAX
                    or errs["rgb_mean"] > TOL_MEAN or errs["w_mean"] > TOL_MEAN):
                raise RuntimeError(f"K1 disagrees with the plain version at S={s}: {errs}")
            report["max_abs_err"] = max(report["max_abs_err"],
                                        errs["rgb_max"], errs["w_max"])
            report[f"ms_s{s}"] = ms
            report[f"plain_ms_s{s}"] = plain_ms
    return report


def _get(url: str) -> tuple[bytes, float]:
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=300) as resp:
        body = resp.read()
    return body, time.perf_counter() - t0


def phase_serve(card: str, tmp: str) -> int:
    """Serve random weights at full width over HTTP; returns the K1
    launches the requests made."""
    cfg = load_config(CONFIG)
    ckpt = os.path.join(tmp, "random.ckpt.npz")
    save_params_npz(ckpt, random_params(cfg, seed=0), cfg,
                    scene={"near": 2.0, "far": 6.0})
    service = RenderService(cfg, ckpt, device="cuda")
    server = serve(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    size, chunk = 200, 16384
    n_chunks = -(-size * size // chunk)
    requests = [("rgb", 30.0), ("rgb", 120.0), ("depth", 30.0)]
    try:
        body, _ = _get(f"{base}/healthz")
        if body != b"ok":
            raise RuntimeError(f"/healthz answered {body!r}")
        k1.launches = 0  # count only the main path's launches from here
        for map_name, theta in requests:
            before = k1.launches
            png, seconds = _get(
                f"{base}/render?theta={theta}&phi=-30&radius=4&width={size}"
                f"&height={size}&chunk={chunk}&map={map_name}"
            )
            grew = k1.launches - before
            img = decode_png(png)
            shape = (size, size, 3) if map_name == "rgb" else (size, size)
            say("serve", map=map_name, theta=theta, latency_s=seconds,
                shape=list(img.shape), png_bytes=len(png), k1_launches=grew,
                std=float(img.std()), card=card)
            if img.shape != shape:
                raise RuntimeError(f"/render {map_name}: shape {img.shape} != {shape}")
            if map_name == "rgb" and img.std() == 0:
                raise RuntimeError("/render rgb returned a constant image")
            if grew != 2 * n_chunks:
                raise RuntimeError(
                    f"K1 launched {grew} times for one frame, expected "
                    f"2 x {n_chunks} chunks"
                )
        launches = k1.launches
        stats = json.loads(_get(f"{base}/stats")[0])
        say("stats", **stats)
        if stats["requests"] != len(requests):
            raise RuntimeError(f"/stats counts {stats['requests']} requests")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    # The served path on the card (K1) against the plain path on the CPU,
    # same checkpoint, on a small frame.
    pose = pose_spherical(30.0, -30.0, 4.0)
    gpu = service.trainer.render_image(pose, 24, 24, 28.8)
    cpu = Trainer(service.cfg, 2.0, 6.0, device="cpu").restore(ckpt)
    ref = cpu.render_image(pose, 24, 24, 28.8)
    d_rgb = float(np.abs(gpu["rgb"] - ref["rgb"]).max())
    d_depth = float(np.abs(gpu["depth"] - ref["depth"]).max())
    say("frame_vs_plain", size=24, rgb_max=d_rgb, depth_max=d_depth,
        tol_rgb=FRAME_TOL_RGB, tol_depth=FRAME_TOL_DEPTH)
    if not (np.isfinite(gpu["rgb"]).all() and np.isfinite(gpu["depth"]).all()):
        raise RuntimeError("non-finite frame from the card")
    if d_rgb > FRAME_TOL_RGB or d_depth > FRAME_TOL_DEPTH:
        raise RuntimeError("card frame disagrees with the plain CPU frame")
    return launches


def main() -> None:
    card = phase_card()
    phase_build()
    kernel = phase_kernel(card)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_serve(card, tmp)
    if launches == 0:
        raise RuntimeError("the served frames never launched K1")
    print(json.dumps({"kernels": [{
        "name": "K1 fused_render_fwd", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms_s192"], "plain_ms": kernel["plain_ms_s192"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
