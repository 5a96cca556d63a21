"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python chip_smoke.py

Phases (each prints one line; a failed phase raises and the script exits
nonzero — nothing falls back to the CPU or to a plain path):

1. the card, its power limit, torch/CUDA versions and the TF32 flags;
2. build the CUDA kernels from ``nerf_keras_tpu_torch/csrc`` with nvcc
   (one compiler per source, started together);
3. K1 against its plain PyTorch version at full width (8x256, B=4096,
   S=64 and S=192), with errors and CUDA-event times;
4. K1 in training mode and K2 against their plain versions at the bench
   step's shapes (8x256, B=4096, S=160, random biases): per-leaf gradient
   errors against autograd of the plain K1, within a gate that a dropped
   weights cotangent misses by 10x or more; CUDA-event times;
5. serve: write a random-weight checkpoint for
   ``config/lego_batch_h256_tpu.json``, start the port's HTTP server on
   127.0.0.1, issue /healthz, three 200x200 /render and /stats, decode
   the PNGs, and check from the launch counter that K1 rendered them;
6. train: the bench recipe's proposal trainer (batch 4096, 64 + 96
   samples) takes 20 steps on one fixed batch: one K1 and one K2 launch
   per step by the counters, a falling loss, one step's gradients on the
   kernel path against the plain path with the same draws, the median
   step time; then ``evaluate`` and a 200x200 frame from the trained
   proposal state.

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
from nerf_keras_tpu_torch.engine.step import params_of, draw_t_vals, make_loss_fn
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import (
    NeRFMLP,
    random_params,
    randomize_biases_,
)
from nerf_keras_tpu_torch.ops.kernels import _build
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.rays import get_rays, pose_spherical
from nerf_keras_tpu_torch.ops.sampling import generate_t_vals
from nerf_keras_tpu_torch.profile_train import bench_batch, bench_config
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

# K2 against autograd of the plain K1, per parameter leaf: relative L2
# error (||kernel - plain|| / ||plain||).  Both take bf16 operands with f32
# accumulation but round the cotangents at other places and sum in
# another order, so the error grows down the trunk: on an H100 at B=4096,
# S=160 (random biases) 8.8e-3 at trunk.0.weight, 3.3e-3 at trunk.7,
# < 2.2e-3 in the heads.  A kernel that drops the weights cotangent reads
# 21.6 against this gate (checked every run: it must miss by 10x).
K2_TOL_REL = 2e-2
# K1's raw-prediction residual against the plain MLP on its encodings
# (rgb logits and sigma, unbounded): 5.0e-3 max |diff| on an H100.
PREDS_TOL = 5e-2
# One train step's gradients, kernel path against plain path on the card
# with the same draws (per leaf, relative L2): 7.8e-3 on an H100.
STEP_TOL_REL = 2e-2

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "config", "lego_batch_h256_tpu.json")
K1_SOURCE = "nerf_keras_tpu_torch/csrc/fused_render_fwd.cu"
K1_REPLACES = "nerf_keras_tpu/ops/pallas/fused_render.py:709"
K2_SOURCE = "nerf_keras_tpu_torch/csrc/fused_render_bwd.cu"
K2_REPLACES = "nerf_keras_tpu/ops/pallas/fused_render.py:453"


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
             if line.startswith("==") or "registers" in line or "spill" in line]
    for src in _build._sources():
        _build.load(src.stem)  # loads the library, declares argtypes
    say("build", seconds=seconds,
        libraries=[_build.library_path(s).name for s in _build._sources()],
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


def _leaf_errors(got: list, want: list) -> tuple[float, float]:
    """(max |diff| over all leaves, max per-leaf relative L2 error)."""
    max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = max(float(torch.linalg.vector_norm(g - w)
                    / torch.linalg.vector_norm(w).clamp_min(1e-30))
              for g, w in zip(got, want))
    return max_abs, rel


def phase_k2(card: str) -> dict:
    """K1 in training mode and K2 against their plain versions at the
    bench step's shapes (B=4096 rays, S=160 = 64 + 96)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    mlp = randomize_biases_(
        NeRFMLP(num_layers=8, hidden_dim=256, skip_layer=4, l_xyz=10, l_dir=4,
                compute_dtype=torch.bfloat16, generator=gen, device=dev),
        gen,
    )
    images, origins, dirs = (torch.as_tensor(x, device=dev) for x in bench_batch(4096))
    b, s = origins.shape[0], 160
    t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
    # Cotangents of comparable size for rgb and weights, so that either one
    # dropped moves the gradients far beyond the gate.
    g_rgb = (torch.randn((b, 3), generator=gen) * 1e-3).to(dev)
    g_w = (torch.randn((b, s), generator=gen) * 1e-3).to(dev)
    params = list(mlp.parameters())
    with torch.no_grad():
        rgb_t, w_t, x_enc, preds = k1.launch_k1(mlp, origins, dirs, t, 10, 4, train=True)
        rgb_f, w_f, _, _ = k1.launch_k1(mlp, origins, dirs, t, 10, 4, train=False)
        got = k1.launch_k2(mlp, x_enc, dirs, t, preds, g_rgb, g_w, 10, 4)
        torch.cuda.synchronize()
    if not (torch.equal(rgb_t, rgb_f) and torch.equal(w_t, w_f)):
        raise RuntimeError("K1 in training mode changed its rgb/weights")
    with torch.enable_grad():
        rgb_p, w_p = k1.render_rays_reference(mlp, origins, dirs, t)
    with torch.no_grad():
        pts = origins[:, None, :] + dirs[:, None, :] * t[..., None]
        x_plain = encode_position(pts, 10).reshape(b * s, -1).to(torch.bfloat16)
        enc_err = float((x_enc.float() - x_plain.float()).abs().max())
        d_enc = encode_position(dirs, 4)[:, None, :].expand(b, s, -1).reshape(b * s, -1)
        preds_err = float((preds - mlp(x_enc.float(), d_enc)).abs().max())
        del x_plain, d_enc, pts
    want = list(torch.autograd.grad([rgb_p, w_p], params, [g_rgb, g_w], retain_graph=True))
    want_no_gw = list(torch.autograd.grad([rgb_p], params, [g_rgb], retain_graph=True))
    max_abs, rel = _leaf_errors(got, want)
    _, rel_dropped = _leaf_errors(got, want_no_gw)
    finite = all(bool(torch.isfinite(g).all()) for g in got) and bool(torch.isfinite(preds).all())
    with torch.no_grad():
        k1_train_ms = cuda_ms(lambda: k1.launch_k1(mlp, origins, dirs, t, 10, 4, train=True))
        k1_plain_ms = cuda_ms(lambda: k1.render_rays_reference(mlp, origins, dirs, t))
        k2_ms = cuda_ms(lambda: k1.launch_k2(mlp, x_enc, dirs, t, preds, g_rgb, g_w, 10, 4))
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        [rgb_p, w_p], params, [g_rgb, g_w], retain_graph=True))
    leaves = {name: _leaf_errors([g], [w])[1]
              for (name, _), g, w in zip(mlp.named_parameters(), got, want)}
    say("k2", B=b, S=s, max_abs_err=max_abs, max_rel_l2=rel, tol_rel=K2_TOL_REL,
        rel_l2_vs_plain_without_gw=rel_dropped, x_enc_max_err=enc_err,
        preds_max_err=preds_err, finite=finite, k1_train_ms=k1_train_ms,
        k1_plain_fwd_ms=k1_plain_ms, k2_ms=k2_ms, plain_bwd_ms=plain_bwd_ms,
        rel_l2_by_leaf=leaves, card=card)
    if not finite:
        raise RuntimeError("K1 residuals or K2 gradients are not finite")
    if enc_err > 1e-2 or preds_err > PREDS_TOL:
        raise RuntimeError(f"K1's residuals disagree with the plain encode/MLP: "
                           f"x_enc {enc_err}, preds {preds_err}")
    if rel > K2_TOL_REL:
        raise RuntimeError(f"K2 disagrees with the plain backward: rel L2 {rel}")
    if rel_dropped < 10 * K2_TOL_REL:
        raise RuntimeError(
            f"the gate cannot see a dropped weights cotangent: {rel_dropped} "
            f"< 10 x {K2_TOL_REL}")
    del rgb_p, w_p
    return {"max_abs_err": max_abs, "ms": k2_ms, "plain_ms": plain_bwd_ms}


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


def phase_train(card: str) -> tuple[int, int]:
    """The bench recipe's proposal trainer on the card; returns the K1 and
    K2 launches its 20 steps made."""
    cfg = bench_config()
    trainer = Trainer(cfg, 2.0, 6.0, device="cuda")
    batch = trainer.put_batch(bench_batch(cfg.batch_size))
    b = cfg.batch_size

    # One step's gradients, kernel path against plain path, same draws.
    gen = torch.Generator(device="cuda").manual_seed(2)
    t_vals = draw_t_vals(cfg, 2.0, 6.0, (b,), trainer.device,
                         noise=torch.rand((b, cfg.ns_coarse), generator=gen, device="cuda"))
    noise = [torch.rand((b, cfg.ns_fine), generator=gen, device="cuda")]

    def plain_pass(mlp, o, d, t, weights_grad):
        rgb, w = k1.render_rays_reference(mlp, o, d, t, l_xyz=cfg.l_xyz,
                                          l_dir=cfg.l_dir, skip_layer=cfg.skip_layer)
        return rgb, w if weights_grad else w.detach()

    params = params_of(trainer.params)
    grads, losses = [], []
    for render_pass in (None, plain_pass):
        loss_fn = make_loss_fn(cfg, 2.0, 6.0, render_pass=render_pass)
        for p in params:
            p.grad = None
        loss, _ = loss_fn(trainer.params, *batch, t_vals, 0, noise=noise)
        loss.backward()
        grads.append([p.grad.clone() for p in params])
        losses.append(float(loss.detach()))
    for p in params:
        p.grad = None
    max_abs, rel = _leaf_errors(grads[0], grads[1])
    say("train_grads_vs_plain", loss_kernel=losses[0], loss_plain=losses[1],
        max_abs_err=max_abs, max_rel_l2=rel, tol_rel=STEP_TOL_REL, card=card)
    if rel > STEP_TOL_REL:
        raise RuntimeError(f"kernel-path gradients disagree with the plain path: {rel}")
    del grads
    torch.cuda.empty_cache()

    # The main path: 20 steps, one K1 and one K2 launch each.
    k1.launches = k1.bwd_launches = 0
    step_ms, loss_curve = [], []
    for i in range(20):
        before = (k1.launches, k1.bwd_launches)
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        loss_curve.append(float(metrics["loss"]))  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
        grew = (k1.launches - before[0], k1.bwd_launches - before[1])
        if grew != (1, 1):
            raise RuntimeError(f"step {i} launched K1/K2 {grew} times, expected (1, 1)")
    launches = (k1.launches, k1.bwd_launches)
    warm = statistics.median(step_ms[2:])
    ev = trainer.evaluate([batch])
    frame = trainer.render_image(pose_spherical(30.0, -30.0, 4.0), 200, 200, 240.0)
    rgb = frame["rgb"]
    say("train", steps=20, loss_first=loss_curve[0], loss_last=loss_curve[-1],
        loss_curve=loss_curve, step_ms=step_ms, median_step_ms=warm,
        rays_per_s=b / (warm / 1e3), k1_launches=launches[0], k2_launches=launches[1],
        eval=ev, frame_shape=list(rgb.shape), frame_std=float(rgb.std()), card=card)
    if not loss_curve[-1] < loss_curve[0]:
        raise RuntimeError(f"the loss did not fall: {loss_curve}")
    if not all(np.isfinite(v) for v in ev.values()):
        raise RuntimeError(f"non-finite eval metrics {ev}")
    if not (np.isfinite(rgb).all() and np.isfinite(frame["depth"]).all()):
        raise RuntimeError("non-finite frame from the trained proposal state")
    if rgb.shape != (200, 200, 3) or rgb.std() == 0:
        raise RuntimeError("the trained proposal state rendered a constant frame")
    return launches


def main() -> None:
    card = phase_card()
    phase_build()
    kernel = phase_kernel(card)
    k2 = phase_k2(card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        serve_launches = phase_serve(card, tmp)
    if serve_launches == 0:
        raise RuntimeError("the served frames never launched K1")
    train_k1, train_k2 = phase_train(card)
    if train_k1 == 0 or train_k2 == 0:
        raise RuntimeError("the train steps never launched K1 or K2")
    print(json.dumps({"kernels": [{
        "name": "K1 fused_render_fwd", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": serve_launches + train_k1,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms_s192"], "plain_ms": kernel["plain_ms_s192"],
    }, {
        "name": "K2 fused_render_bwd", "route": "cuda", "source": K2_SOURCE,
        "replaces": K2_REPLACES, "launches": train_k2,
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
