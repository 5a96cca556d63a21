"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python chip_smoke.py

Phases (each prints one line; a failed phase raises and the script exits
nonzero — nothing falls back to the CPU or to a plain path):

1. the card, its power limit, torch/CUDA versions and the TF32 flags;
2. build the CUDA kernels from ``nerf_keras_tpu_torch/csrc`` with nvcc
   (one compiler per source, started together); report ptxas's registers,
   spills and any wgmma serialization warning;
3. K1 against its plain PyTorch version at full width (8x256, B=4096,
   S=64 and S=192), with errors and CUDA-event times; the products'
   library yardstick (one bf16 ``torch.matmul`` per padded layer at
   M = B*S, never called by the port);
4. K1 in training mode and K2 against their plain versions at the bench
   step's shapes (8x256, B=4096, S=160, random biases): per-leaf gradient
   errors against autograd of the plain K1, within a gate that a dropped
   weights cotangent misses by 10x or more; CUDA-event times;
   4b. K2 over chunks of whole rays (its workspace holds one chunk): the
   default 640 MiB budget and two smaller ones (>= 3 chunks, a ragged last
   one) within K2's gate of one chunk holding the whole batch; two runs
   bit-identical; K3 equal to K2 bit for bit at the smallest budget; time
   and per-kernel device ms at each budget; the dW product's library
   yardstick (``torch.matmul`` of each layer's A^T D, never called by the
   port);
5. K5 (the MLP over encodings) forward and backward against their plain
   versions at the parity step's shapes (8x256, N = 786,432 fine, 262,144
   coarse, and a ragged N): raw predictions, per-leaf gradients, the
   encodings' gradients, within gates that a K5 dropping the skip part of
   dx_enc, or fed a wrong layer-0 pack, misses by 10x or more;
   CUDA-event times at both passes' N;
   5b. K5's backward over chunks of samples (its workspace holds one
   chunk) at N = 786,432 with input gradients: the default 640 MiB budget
   and a smaller one (>= 3 chunks, a ragged last one) within K5's gate of
   one chunk holding the whole batch; two runs bit-identical; time and the
   device ms of the rows kernel and the dW product at each budget; the dW
   product's library yardstick;
6. serve: write a random-weight checkpoint for
   ``config/lego_batch_h256_tpu.json``, start the port's HTTP server on
   127.0.0.1, issue /healthz, three 200x200 /render and /stats, decode
   the PNGs, and check from the launch counter that K1 rendered them;
7. proposal train: the bench recipe's proposal trainer (batch 4096, 64 +
   96 samples) takes 10 steps on one fixed batch: one K1 and one K2
   launch per step by the counters, a falling loss, one step's gradients
   on the kernel path against the plain path with the same draws, the
   median step time, the step's peak memory (<= 1,536 MiB); then
   ``evaluate`` and a 200x200 frame;
8. parity train, STOP_PDF_GRADIENT=true (the default recipe at
   ``lego_batch_h256_tpu`` widths: batch 4096, 64 + 128 samples): 20
   steps, two K1 and two K2 launches per step and no K5, a falling loss,
   one step's gradients kernel path vs plain path, median step time and
   peak memory (<= 1,536 MiB); then
   ``evaluate`` and a 200x200 frame;
9. parity train, STOP_PDF_GRADIENT=false: 5 steps, two K5 forward and two
   K5 backward launches per step and no K1/K2, finite losses, one step's
   gradients kernel path vs plain path (the coarse leaves, whose gradient
   runs through sample_pdf, reported on their own), the median step time
   and peak memory (<= 1,536 MiB);
10. full render: a 200x200 frame with ``full=True`` from the phase-8
    state (two K5 launches per chunk), all eight maps checked against the
    port's CPU path on the same checkpoint (a strided subset of rays);
11. K4 (the int8 ray megakernel) against its plain version at full width
    (random weights and biases, int8 tables calibrated on orbit rays):
    B=4096 with S=64, 160 and 192, a ragged B, and the server's chunk
    (B=16384, S=64 and 192), within gates that two broken packs (the skip
    layer's x_enc rows zeroed, the fs head's sigma column dropped) miss by
    10x or more; CUDA-event times; the products' library yardstick (one
    ``torch._int_mm`` per padded int8 layer at M = B*S, never called by
    the port) at B=4096 and 16384, S=192;
12. int8 serving: the phase-6 checkpoint behind ``RenderService(quant=
    True)`` over HTTP: the PSNR gate must pass, three 200x200 /render
    with two K4 launches per chunk and no K1 launch, /stats says int8, and
    one frame is held against the port's CPU int8 path on the same tables;
13. the proposal-trained int8 render: phase 7's trainer calibrates int8
    tables and renders a 200x200 frame, one K4 launch per chunk, no K1;
14. K3 (the recompute backward) against K2 on the same K1 predictions at
    B=4096 with S=64, 160 and 192 and a ragged B, with and without the
    weights cotangent: dW/db bit-equal; at S=160 against autograd of the
    plain K1 within K2's gate, which a K3 whose encode stops an octave
    short misses by 10x; the memory a recompute forward holds for its
    backward (bounded by B (20 S + 40) bytes + 1 MB) beside the residual
    forward's; CUDA-event times;
15. K6 (the MLP and compositing over per-sample encodings) forward and
    backward against their plain versions at B=4096, S=64 and 192 and a
    ragged B, within K1's and K2's gates, which a K6 reading the
    direction encodings per ray misses by 10x; a loss on its weights adds
    exactly nothing to the gradients; K6 against K1 on the same rays;
16. K7 (inverse-CDF draw fused with the sorted union) against the
    ``sample_pdf`` + ``sorted_union`` chain at its three main shapes (the
    render chunk B=16384, S=64, NF=128 on the eval grid; B=4096, S=64 with
    sorted uniforms at NF=128 and 96), with all-zero, single-spike,
    front-loaded and repeated-coarse-value rows: the coarse t-values
    bit-exact in every row, every row ascending, the same bits on a second
    run, max |diff| <= 1e-3 (and the count above 1e-5), against the chain
    in float64 no further (max, count above 1e-5) than the float32 chain,
    a K7 without the 1e-5 weight floor missing by 10x; the call time and
    the device time (``torch.profiler``) of K7 and of the chain, the
    ``torch.sort`` and ``torch.searchsorted`` yardsticks, the byte bound;
17. the parity step's three training paths
    (``nerf_keras_tpu_torch.exp_train_paths``): one step's gradients of
    the recompute path (K1 + K3) and of the encodings-in path (K6)
    against the default path (K1 + K2), then 5 steps of each with their
    launch counts (two K1 + two K3 and no K2; two K6 forward + two K6
    backward and no K1) and the memory each forward holds;
18. a 200x200 frame from the phase-8 checkpoint rendered with K7 in place
    of the chain (one K7 launch per chunk), against the engine's render.

Each main path runs with the launch counters set to 0 just before it and
read just after.  The line before the last is the kernel report
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

from nerf_keras_tpu_torch import exp_train_paths, load_config, runtime
from nerf_keras_tpu_torch.engine.step import (
    draw_t_vals,
    make_loss_fn,
    make_render_fn,
    make_train_step,
    params_of,
)
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.models.mlp import (
    NeRFMLP,
    is_skip,
    random_params,
    randomize_biases_,
)
from nerf_keras_tpu_torch.ops.encoding import encode_position
from nerf_keras_tpu_torch.ops.kernels import _build
from nerf_keras_tpu_torch.ops.kernels import fused_mlp as k5
from nerf_keras_tpu_torch.ops import quant
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.ops.kernels import pdf_union as k7
from nerf_keras_tpu_torch.ops.kernels import quant_render as k4
from nerf_keras_tpu_torch.ops.rays import get_rays, pose_spherical, sample_rays
from nerf_keras_tpu_torch.ops.sampling import generate_t_vals
from nerf_keras_tpu_torch.exp_train_paths import counts
from nerf_keras_tpu_torch.profile_train import bench_batch, bench_config, parity_config
from nerf_keras_tpu_torch.runtime import cuda_ms, device_ms_by_kernel
from nerf_keras_tpu_torch.serving import RenderService, serve
from nerf_keras_tpu_torch.utils.checkpoint import save_params_npz
from nerf_keras_tpu_torch.utils.image_metrics import frame_psnr
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
# A frame rendered on the card against the plain path on the CPU: the fine
# samples follow the coarse weights, so a small weight difference moves
# them a little (on an H100, 24x24: rgb 1.5e-4, depth 1.6e-3).
FRAME_TOL_RGB = 5e-3
FRAME_TOL_DEPTH = 2e-2
# The full render's weights (in [0, 1]) and raw predictions against the
# CPU path: on an H100 (1,000 rays of a 200x200 frame) weights 7.7e-5,
# raw predictions 2.6e-3 (coarse) and 6.2e-3 (fine, whose samples follow
# the coarse weights); the raw predictions take K5's own gate.
FRAME_TOL_WEIGHTS = 5e-3

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
# K5's raw predictions against the plain MLP on the same bf16 encodings:
# the products are K1's, so K1's residual gate (PREDS_TOL) holds for the
# max, and the mean is held 50x tighter.
K5_PREDS_MAX = PREDS_TOL
K5_PREDS_MEAN = 1e-3
# K5's gradients against autograd of the plain MLP, per leaf and for
# dx_enc/dd_enc: relative L2.  The same bf16 operands, cotangents rounded
# at other places (as K2): K2's gate.
K5_TOL_REL = K2_TOL_REL
# STOP_PDF_GRADIENT=false: the coarse leaves' gradient runs through
# sample_pdf's 1/denominator (floored at 1e-5), which amplifies the fine
# pass's bf16 rounding differences (K5's dx_enc against the plain one) by
# up to 1e5 on a few rays.  On an H100 at batch 4096: 0.16 in the coarse
# sigma head, 0.009-0.02 in the other coarse leaves, against 3.5e-3 in the
# fine leaves; the coarse gate sits 3x above.
PDF_COARSE_TOL_REL = 0.5

# K4 against its plain version on the same int8 tables: the integer
# pipeline is the same, so what is left is the compositing's order (and an
# encoding that a sin/cos ulp could carry across an int8 boundary).  On an
# H100 at B=4096, S=64/192: max |diff| 3.6e-7, mean 6.3e-8 (rgb); the gates
# sit ~3000x and ~150x above, and broken packs must miss them by 10x.
K4_TOL_MAX = 1e-3
K4_TOL_MEAN = 1e-5
# The int8 PSNR gate against the float render (the server's default).
QUANT_GATE_DB = 30.0

# Peak device memory over a train step (max_memory_allocated over what was
# allocated before it): the backward's workspace (K2's, K5's) holds one
# chunk (ops/kernels/fused_render.py: DW_CHUNK_BYTES), so the step stays
# below this at batch 4096 whatever the samples per ray (on an H100: 942
# MiB proposal, 831 MiB parity; 7.6-7.9 GB before the chunks, 8,039 MiB
# for STOP_PDF_GRADIENT=false while K5 held the whole batch's workspace).
STEP_PEAK_MIB = 1536

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
PEAK_INT8 = 1979e12  # H100 SXM dense int8 tensor-core OP/s (data sheet)
HBM_BYTES_S = 3.35e12  # H100 SXM device memory bytes/s (data sheet)

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "config", "lego_batch_h256_tpu.json")
SOURCES = {
    "K1": ("nerf_keras_tpu_torch/csrc/fused_render_fwd.cu",
           "nerf_keras_tpu/ops/pallas/fused_render.py:709"),
    "K2": ("nerf_keras_tpu_torch/csrc/fused_render_bwd.cu",
           "nerf_keras_tpu/ops/pallas/fused_render.py:453"),
    "K5f": ("nerf_keras_tpu_torch/csrc/fused_mlp_fwd.cu",
            "nerf_keras_tpu/ops/pallas/fused_mlp.py:148"),
    "K5b": ("nerf_keras_tpu_torch/csrc/fused_render_bwd.cu",
            "nerf_keras_tpu/ops/pallas/fused_mlp.py:260"),
    "K4": ("nerf_keras_tpu_torch/csrc/quant_render_fwd.cu",
           "nerf_keras_tpu/ops/pallas/quant_render.py:66"),
    "K3": ("nerf_keras_tpu_torch/csrc/fused_render_bwd.cu",
           "nerf_keras_tpu/ops/pallas/fused_render.py:425"),
    "K6f": ("nerf_keras_tpu_torch/csrc/fused_render_fwd.cu",
            "nerf_keras_tpu/ops/pallas/fused_render.py:336"),
    "K6b": ("nerf_keras_tpu_torch/csrc/fused_render_bwd.cu",
            "nerf_keras_tpu/ops/pallas/fused_render.py:350"),
    "K7": ("nerf_keras_tpu_torch/csrc/pdf_union.cu", "experimental/pdf_union.py:54"),
}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def full_mlp(dev: torch.device, seed: int) -> NeRFMLP:
    gen = torch.Generator().manual_seed(seed)
    return randomize_biases_(
        NeRFMLP(num_layers=8, hidden_dim=256, skip_layer=4, l_xyz=10, l_dir=4,
                compute_dtype=torch.bfloat16, generator=gen, device=dev),
        gen,
    )


# ---------------------------------------------------------------------------
# The least time the card could take for a kernel's work: the larger of its
# products at the bf16 tensor-core peak and its bytes (each input read once,
# each output written once) at the memory rate.

def mlp_macs(mlp: NeRFMLP) -> int:
    """Multiply-adds of one forward of the MLP per sample (every weight once)."""
    return sum(layer.weight.numel() for layer in (*mlp.trunk, *mlp.heads().values()))


def mlp_dx_macs(mlp: NeRFMLP, input_grads: bool) -> int:
    """Multiply-adds of the backward's dX products per sample: every weight
    with input gradients; without, less layer 0, the skip columns and the
    branch's direction columns (whose gradients nothing reads)."""
    total = mlp_macs(mlp)
    if input_grads:
        return total
    hid = mlp.hidden_dim
    skip = sum(mlp.xyz_dim * hid for i in range(mlp.num_layers) if is_skip(i, mlp.skip_layer))
    return total - mlp.trunk[0].weight.numel() - skip - mlp.dir_dim * mlp.branch.weight.shape[0]


def param_bytes(mlp: NeRFMLP) -> int:
    return sum(p.numel() for p in mlp.parameters()) * 4


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound(mlp, b, s, train):
    n = b * s
    nbytes = b * (24 + 12) + n * (4 + 4) + param_bytes(mlp) // 2
    if train:
        nbytes += n * (mlp.xyz_dim * 2 + 16)
    return bound(2.0 * mlp_macs(mlp) * n, nbytes)


def k2_bound(mlp, b, s):
    n = b * s
    flops = 2.0 * (mlp_macs(mlp) + mlp_dx_macs(mlp, False)) * n
    nbytes = n * (mlp.xyz_dim * 2 + 16 + 4 + 4) + b * (12 + 12) + 3 * param_bytes(mlp)
    return bound(flops, nbytes)


def k4_bound(mlp, b, s):
    """int8 products at the int8 peak; rays and t in, rgb and weights out,
    the int8 pack and its f32 scale/bias/requant rows read once."""
    n = b * s
    outs = sum(layer.weight.shape[0] for layer in (*mlp.trunk, *mlp.heads().values()))
    nbytes = b * (24 + 12) + n * (4 + 4) + mlp_macs(mlp) + outs * 12
    return bound(2.0 * mlp_macs(mlp) * n, nbytes, PEAK_INT8)


def k5_bounds(mlp, n, input_grads):
    enc = (mlp.xyz_dim + mlp.dir_dim) * 2
    fwd = bound(2.0 * mlp_macs(mlp) * n, n * (enc + 16) + param_bytes(mlp) // 2)
    flops = 2.0 * (mlp_macs(mlp) + mlp_dx_macs(mlp, input_grads)) * n
    nbytes = n * (enc + 16 + (enc if input_grads else 0)) + 3 * param_bytes(mlp)
    return fwd, bound(flops, nbytes)


def k3_bound(mlp, b, s):
    """K2's products; it reads the rays instead of the x_enc residual."""
    n = b * s
    flops = 2.0 * (mlp_macs(mlp) + mlp_dx_macs(mlp, False)) * n
    nbytes = n * (16 + 4 + 4) + b * (12 + 12 + 12) + 3 * param_bytes(mlp)
    return bound(flops, nbytes)


def k6_bounds(mlp, b, s):
    """K6's forward (encodings, t in; rgb, weights out) and its backward
    (encodings, predictions, t, the rgb cotangent in; dW/db out)."""
    n = b * s
    enc = (mlp.xyz_dim + mlp.dir_dim) * 2
    fwd = bound(2.0 * mlp_macs(mlp) * n, n * (enc + 4 + 4) + b * 12 + param_bytes(mlp) // 2)
    flops = 2.0 * (mlp_macs(mlp) + mlp_dx_macs(mlp, False)) * n
    bwd = bound(flops, n * (enc + 16 + 4) + b * 12 + 3 * param_bytes(mlp))
    return fwd, bwd


def k7_bound(b, s, nf, u_given):
    """Bytes: t and w in, (u in), the union out; a few hundred f32
    operations per ray, far below."""
    return bound(0.0, b * (s * 8 + (s + nf) * 4 + (nf * 4 if u_given else 0)))


def kernel_entry(name, key, launches, max_abs_err, ms, plain_ms, bnd,
                 library_ms=None) -> dict:
    source, replaces = SOURCES[key]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": library_ms}


def reset_counts() -> None:
    k1.launches = k1.train_launches = k1.bwd_launches = k1.recompute_launches = 0
    k1.enc_launches = k1.enc_bwd_launches = 0
    k5.launches = k5.bwd_launches = 0
    k4.launches = k7.launches = 0




# ---------------------------------------------------------------------------

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
             if line.startswith("==") or "registers" in line or "spill" in line
             or "serialized" in line]
    for src in _build._sources():
        _build.load(src.stem)  # loads the library, declares argtypes
    say("build", seconds=seconds,
        libraries=[_build.library_path(s).name for s in _build._sources()],
        ptxas=ptxas)


def library_products_ms(desc: np.ndarray, m: int, dtype: torch.dtype, dev) -> float:
    """The products alone as one PyTorch call per layer at M = ``m`` rows,
    on the padded (k_pad, n_pad) shapes of a pack's descriptors:
    ``torch._int_mm`` (s32 out) for int8, ``torch.matmul`` for bf16.  A
    yardstick timed here and used nowhere in the port."""
    gen = torch.Generator(device=dev).manual_seed(0)
    if dtype == torch.int8:
        def rand(*shape):
            return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device=dev)
        mm = torch._int_mm
    else:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        mm = torch.matmul
    acts = {k: rand(m, k) for k in sorted({int(k) for k in desc[:, 0]})}
    # B column-major, cuBLAS's native layout for int8.
    mats = [(acts[int(k)], rand(int(n), int(k)).t()) for k, _, n, _, _ in desc]
    ms = cuda_ms(lambda: [mm(a, w) for a, w in mats])
    del acts, mats
    torch.cuda.empty_cache()
    return ms


def phase_kernel(card: str) -> dict:
    """K1 vs render_rays_reference at the main path's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    mlp = full_mlp(dev, 0)
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
            bnd = k1_bound(mlp, b, s, train=False)
            say("k1", B=b, S=s, **errs, tol_max=TOL_MAX, tol_mean=TOL_MEAN,
                finite=finite, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                bound_by=bnd[1], card=card)
            if not finite:
                raise RuntimeError(f"K1 produced non-finite values at S={s}")
            if (errs["rgb_max"] > TOL_MAX or errs["w_max"] > TOL_MAX
                    or errs["rgb_mean"] > TOL_MEAN or errs["w_mean"] > TOL_MEAN):
                raise RuntimeError(f"K1 disagrees with the plain version at S={s}: {errs}")
            report["max_abs_err"] = max(report["max_abs_err"],
                                        errs["rgb_max"], errs["w_max"])
            report[f"ms_s{s}"] = ms
            report[f"plain_ms_s{s}"] = plain_ms
            report[f"bound_s{s}"] = bnd
    report["library_ms_s192"] = library_products_ms(k1.kernel_pack(mlp, dev).desc, b * 192,
                                                    torch.bfloat16, dev)
    say("k1_library", B=b, S=192, library_ms=report["library_ms_s192"], card=card)
    return report


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want.float())
                 / torch.linalg.vector_norm(want.float()).clamp_min(1e-30))


def _leaf_errors(got: list, want: list) -> tuple[float, float]:
    """(max |diff| over all leaves, max per-leaf relative L2 error)."""
    max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return max_abs, max(_rel_l2(g, w) for g, w in zip(got, want))


def _k2_inputs(dev):
    """The bench step's shapes (B=4096 rays, S=160 = 64 + 96): the MLP,
    rays, t-values and cotangents of comparable size for rgb and weights,
    so that either one dropped moves the gradients far beyond the gate."""
    gen = torch.Generator().manual_seed(1)
    mlp = full_mlp(dev, 1)
    _, origins, dirs = (torch.as_tensor(x, device=dev) for x in bench_batch(4096))
    b, s = origins.shape[0], 160
    t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
    g_rgb = (torch.randn((b, 3), generator=gen) * 1e-3).to(dev)
    g_w = (torch.randn((b, s), generator=gen) * 1e-3).to(dev)
    return mlp, origins, dirs, t, g_rgb, g_w


def phase_k2(card: str) -> dict:
    """K1 in training mode and K2 against their plain versions at the
    bench step's shapes (B=4096 rays, S=160 = 64 + 96)."""
    dev = torch.device("cuda")
    mlp, origins, dirs, t, g_rgb, g_w = _k2_inputs(dev)
    b, s = t.shape
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
    k1t_bnd, k2_bnd = k1_bound(mlp, b, s, train=True), k2_bound(mlp, b, s)
    say("k2", B=b, S=s, max_abs_err=max_abs, max_rel_l2=rel, tol_rel=K2_TOL_REL,
        rel_l2_vs_plain_without_gw=rel_dropped, x_enc_max_err=enc_err,
        preds_max_err=preds_err, finite=finite, k1_train_ms=k1_train_ms,
        k1_plain_fwd_ms=k1_plain_ms, k1_train_bound_ms=k1t_bnd[0], k2_ms=k2_ms,
        plain_bwd_ms=plain_bwd_ms, k2_bound_ms=k2_bnd[0], rel_l2_by_leaf=leaves, card=card)
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
    return {"max_abs_err": max_abs, "ms": k2_ms, "plain_ms": plain_bwd_ms, "bound": k2_bnd,
            "k1_train_err": preds_err, "k1_train_ms": k1_train_ms,
            "k1_train_plain_ms": k1_plain_ms, "k1_train_bound": k1t_bnd}


# K2's kernels, by the names the profiler reports.
K2_STAGES = {"vjp": ("composite_vjp_kernel",), "rows": ("k2_rows_kernel",),
             "dw": ("mlp_dw_kernel",), "reduce": ("mlp_reduce_kernel",)}
# Workspace budgets of K2's chunks (bytes): the default, and two that force
# several chunks with a ragged last one; the smallest keeps a chunk's A/D
# (~40 MB at 10,112 B per sample) inside the 50 MB L2 between the rows
# kernel and the dW product.
K2_BUDGETS = {"mid": 160 << 20, "l2": 40 << 20}


def phase_k2_chunks(card: str) -> dict:
    """K2 over chunks of whole rays at the bench step's shapes: the default
    budget and two that force several chunks with a ragged last one, each
    within K2's gate of one chunk holding the whole batch; run twice at the
    default (identical bits); K3 against K2 bit for bit at the smallest budget;
    times and the per-kernel breakdown at each budget; the dW product's
    library yardstick (``torch.matmul`` of A^T D per layer over the batch,
    never called by the port)."""
    dev = torch.device("cuda")
    mlp, origins, dirs, t, g_rgb, g_w = _k2_inputs(dev)
    b, s = t.shape
    default = k1.DW_CHUNK_BYTES
    fwd, bwd = k1.kernel_pack(mlp, dev), k1.kernel_pack_bwd(mlp, dev)
    bps = k1.DwBuffers.bytes_per_sample(fwd, bwd)
    fields = {}
    with torch.no_grad():
        _, _, x_enc, preds = k1.launch_k1(mlp, origins, dirs, t, 10, 4, train=True)
        run = lambda: k1.launch_k2(mlp, x_enc, dirs, t, preds, g_rgb, g_w, 10, 4)  # noqa: E731
        base = run()
        again = run()
        torch.cuda.synchronize()
        deterministic = all(torch.equal(x, y) for x, y in zip(base, again))
        try:
            k1.DW_CHUNK_BYTES = 1 << 40  # one chunk: the whole batch's workspace
            one = run()
            torch.cuda.synchronize()
            one_ms = cuda_ms(run)
            fields["one_chunk"] = {"ms": one_ms, "device_ms": device_ms_by_kernel(run, K2_STAGES),
                                   "rel_l2_vs_default": _leaf_errors(base, one)[1]}
            base = one
            del one
            for name, budget in {"default": default, **K2_BUDGETS}.items():
                k1.DW_CHUNK_BYTES = budget
                plan = k1.chunk_plan(b, s, bps)
                got = run()
                torch.cuda.synchronize()
                max_abs, rel = _leaf_errors(got, base)
                fields[name] = {
                    "budget_mib": budget / 2**20, "chunks": len(plan),
                    "rays_per_chunk": plan[0][1], "last_chunk_rays": plan[-1][1],
                    "max_abs_vs_one_chunk": max_abs, "rel_l2_vs_one_chunk": rel,
                    "ms": cuda_ms(run), "device_ms": device_ms_by_kernel(run, K2_STAGES)}
                if name == "l2":
                    k3 = k1.launch_k3(mlp, origins, dirs, t, preds, g_rgb, g_w, 10, 4)
                    fields["k3_bit_equal_k2_at_l2"] = all(
                        torch.equal(x, y) for x, y in zip(k3, got))
                    del k3
                del got
        finally:
            k1.DW_CHUNK_BYTES = default
        del base, again, x_enc, preds
        torch.cuda.empty_cache()
        library_ms = _dw_library_ms(mlp, dev, b * s)
    say("k2_chunks", B=b, S=s, bytes_per_sample=bps, deterministic=deterministic,
        dw_library_ms=library_ms, tol_rel=K2_TOL_REL, **fields, card=card)
    if not deterministic:
        raise RuntimeError("K2 run twice gave different bits")
    if not fields["k3_bit_equal_k2_at_l2"]:
        raise RuntimeError("K3 differs from K2 at the chunked size")
    for name in K2_BUDGETS:
        f = fields[name]
        if f["chunks"] < 3 or f["last_chunk_rays"] >= f["rays_per_chunk"]:
            raise RuntimeError(f"budget {name} did not give >= 3 chunks with a ragged last one")
        if f["rel_l2_vs_one_chunk"] > K2_TOL_REL:
            raise RuntimeError(f"K2 in chunks ({name}) disagrees with one chunk: "
                               f"{f['rel_l2_vs_one_chunk']}")
    return {"library_ms": library_ms, "budgets": fields}


def _k5_inputs(dev, n, seed):
    """bf16 encodings of N points along random rays between near and far,
    unit directions, and a cotangent for the raw predictions."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    o = torch.randn((n, 3), generator=gen, device=dev) * 0.3 + torch.tensor([0.0, 0.0, 4.0], device=dev)
    d = torch.randn((n, 3), generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.rand((n, 1), generator=gen, device=dev) * 4.0 + 2.0
    x_enc = encode_position(o + d * t, 10).to(torch.bfloat16).contiguous()
    d_enc = encode_position(d, 4).to(torch.bfloat16).contiguous()
    g = torch.randn((n, 4), generator=gen, device=dev) * 1e-2
    return x_enc, d_enc, g


def _broken_pack(mlp: NeRFMLP, dev, what: str) -> k1.KernelPack:
    """K5's input-gradient pack (wgmma layout) with the skip rows zeroed
    (``skip``: dx_enc loses the skip part) or layer 0's rows zeroed
    (``layer0``: it loses the layer-0 product); every other product is
    unchanged."""
    mats = [m.detach().clone() for m, _ in k1._bwd_layers(mlp, input_grads=True)]
    hid = mlp.hidden_dim
    if what == "layer0":
        mats[0].zero_()
    else:
        for i in range(1, mlp.num_layers + 1):
            if is_skip(i - 1, mlp.skip_layer):
                mats[i][hid:] = 0.0
    return k1._pack_wg([(m, None) for m in mats], dev)


# K5's backward kernels, by the names the profiler reports.
K5_STAGES = {"rows": ("k5_rows_kernel",), "dw": ("mlp_dw_kernel",),
             "reduce": ("mlp_reduce_kernel",)}
# A workspace budget that splits K5's fine pass (N = 786,432) into >= 3
# chunks of samples with a ragged last one.
K5_SMALL_BUDGET = 160 << 20


def _dw_library_ms(mlp: NeRFMLP, dev, n: int) -> float:
    """The dW stage's library yardstick: one ``torch.matmul`` of A^T D per
    layer over ``n`` samples (bf16 operands of the workspace's widths),
    never called by the port."""
    layout = k1.workspace_layout(k1.kernel_pack(mlp, dev), k1.kernel_pack_bwd(mlp, dev))
    pairs = [(torch.randn((n, int(a)), device=dev, dtype=torch.bfloat16),
              torch.randn((n, int(d)), device=dev, dtype=torch.bfloat16))
             for a, d in zip(layout[:, 1], layout[:, 3])]
    ms = cuda_ms(lambda: [torch.matmul(a.t(), d) for a, d in pairs])
    del pairs
    torch.cuda.empty_cache()
    return ms


def phase_k5_chunks(card: str) -> dict:
    """K5's backward over chunks of samples at the fine pass's N = 786,432
    with input gradients: one chunk (the whole batch's workspace), the
    default budget and one that forces >= 3 chunks with a ragged last one,
    each within K5's gate of one chunk; run twice at the default (identical
    bits); times and the device ms of the rows kernel and the dW product at
    each budget; the dW stage's library yardstick."""
    dev = torch.device("cuda")
    mlp = full_mlp(dev, 5)
    n = 4096 * 192
    x_enc, d_enc, g = _k5_inputs(dev, n, seed=n)
    default = k1.DW_CHUNK_BYTES
    bps = k1.DwBuffers.bytes_per_sample(k1.kernel_pack(mlp, dev), k1.kernel_pack_bwd(mlp, dev))
    fields = {}
    run = lambda: k5.launch_k5_bwd(mlp, x_enc, d_enc, g, True, True)  # noqa: E731
    flat = lambda r: [*r[0], r[1], r[2]]  # noqa: E731
    with torch.no_grad():
        base = flat(run())
        deterministic = all(torch.equal(a, b) for a, b in zip(base, flat(run())))
        try:
            k1.DW_CHUNK_BYTES = 1 << 40
            one = flat(run())
            torch.cuda.synchronize()
            fields["one_chunk"] = {"ms": cuda_ms(run),
                                   "device_ms": device_ms_by_kernel(run, K5_STAGES)}
            for name, budget in (("default", default), ("small", K5_SMALL_BUDGET)):
                k1.DW_CHUNK_BYTES = budget
                plan = k1.chunk_plan(n, 1, bps)
                got = flat(run())
                torch.cuda.synchronize()
                fields[name] = {
                    "budget_mib": budget / 2**20, "chunks": len(plan),
                    "samples_per_chunk": plan[0][1], "last_chunk_samples": plan[-1][1],
                    "rel_l2_vs_one_chunk": max(_rel_l2(a, b) for a, b in zip(got, one)),
                    "ms": cuda_ms(run), "device_ms": device_ms_by_kernel(run, K5_STAGES)}
                del got
        finally:
            k1.DW_CHUNK_BYTES = default
        del base, one
    del x_enc, d_enc, g
    torch.cuda.empty_cache()
    library_ms = _dw_library_ms(mlp, dev, n)
    say("k5_chunks", N=n, input_grads=True, bytes_per_sample=bps,
        deterministic=deterministic, dw_library_ms=library_ms, tol_rel=K5_TOL_REL,
        **fields, card=card)
    if not deterministic:
        raise RuntimeError("K5's backward run twice gave different bits")
    small = fields["small"]
    if small["chunks"] < 3 or small["last_chunk_samples"] >= small["samples_per_chunk"]:
        raise RuntimeError("K5's small budget did not give >= 3 chunks with a ragged last one")
    for name in ("default", "small"):
        if fields[name]["rel_l2_vs_one_chunk"] > K5_TOL_REL:
            raise RuntimeError(f"K5 in chunks ({name}) disagrees with one chunk: "
                               f"{fields[name]['rel_l2_vs_one_chunk']}")
    return {"library_ms": library_ms, "budgets": fields}


def phase_k5(card: str) -> dict:
    """K5 vs its plain versions at the parity step's shapes: the fine pass
    (N = 4096 x 192, with input gradients, as STOP_PDF_GRADIENT=false runs
    it), the coarse pass (N = 4096 x 64, without: its encodings carry no
    gradient) and a ragged N."""
    dev = torch.device("cuda")
    mlp = full_mlp(dev, 5)
    params = list(mlp.parameters())
    report = {"fwd_max_abs_err": 0.0, "bwd_max_abs_err": 0.0}
    for n, need in ((4096 * 192, True), (4096 * 64, False), (100_003, True)):
        x_enc, d_enc, g = _k5_inputs(dev, n, seed=n)
        with torch.no_grad():
            out = k5.launch_k5_fwd(mlp, x_enc, d_enc)
            got, dx, dd = k5.launch_k5_bwd(mlp, x_enc, d_enc, g, need, need)
            torch.cuda.synchronize()
            want_out = mlp(x_enc, d_enc)
        diff = (out - want_out).abs()
        fwd = {"max": float(diff.max()), "mean": float(diff.mean())}
        del want_out, diff
        want, want_dx, want_dd = k5.apply_nerf_mlp_reference_vjp(mlp, x_enc, d_enc, g, need)
        max_abs, rel = _leaf_errors(got, want)
        leaves = {name: _rel_l2(a, b) for (name, _), a, b in zip(mlp.named_parameters(), got, want)}
        finite = bool(torch.isfinite(out).all()) and all(bool(torch.isfinite(a).all()) for a in got)
        fields = {}
        if need:
            finite = finite and bool(torch.isfinite(dx.float()).all() and torch.isfinite(dd.float()).all())
            fields["dx_rel_l2"] = _rel_l2(dx, want_dx)
            fields["dd_rel_l2"] = _rel_l2(dd, want_dd)
            orig = k1.kernel_pack_bwd
            for what in ("skip", "layer0"):
                broken = _broken_pack(mlp, dev, what)
                k1.kernel_pack_bwd = lambda m, d, input_grads=False, b=broken: b  # noqa: E731
                try:
                    _, bdx, _ = k5.launch_k5_bwd(mlp, x_enc, d_enc, g, True, True)
                finally:
                    k1.kernel_pack_bwd = orig
                fields[f"dx_rel_l2_{what}_broken"] = _rel_l2(bdx, want_dx)
        timing = {}
        if n == 4096 * 64:  # the coarse pass: times only
            with torch.no_grad():
                timing["fwd_ms"] = cuda_ms(lambda: k5.launch_k5_fwd(mlp, x_enc, d_enc))
                timing["bwd_ms"] = cuda_ms(
                    lambda: k5.launch_k5_bwd(mlp, x_enc, d_enc, g, False, False))
        if n == 4096 * 192:
            with torch.no_grad():
                timing["fwd_ms"] = cuda_ms(lambda: k5.launch_k5_fwd(mlp, x_enc, d_enc))
                timing["fwd_plain_ms"] = cuda_ms(lambda: mlp(x_enc, d_enc))
                timing["bwd_ms"] = cuda_ms(
                    lambda: k5.launch_k5_bwd(mlp, x_enc, d_enc, g, True, True))
            xl = x_enc.float().requires_grad_()
            dl = d_enc.float().requires_grad_()
            with torch.enable_grad():
                preds = mlp(xl, dl)
            timing["bwd_plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
                [preds], params + [xl, dl], [g], retain_graph=True))
            del preds, xl, dl
            fwd_bnd, bwd_bnd = k5_bounds(mlp, n, input_grads=True)
            timing.update(fwd_bound_ms=fwd_bnd[0], fwd_bound_by=fwd_bnd[1],
                          bwd_bound_ms=bwd_bnd[0], bwd_bound_by=bwd_bnd[1])
            report.update(timing, fwd_bound=fwd_bnd, bwd_bound=bwd_bnd)
        say("k5", N=n, input_grads=need, preds_max=fwd["max"], preds_mean=fwd["mean"],
            tol_preds_max=K5_PREDS_MAX, tol_preds_mean=K5_PREDS_MEAN,
            grad_max_abs=max_abs, grad_max_rel_l2=rel, tol_rel=K5_TOL_REL, **fields,
            finite=finite, rel_l2_by_leaf=leaves, **timing, card=card)
        if not finite:
            raise RuntimeError(f"K5 produced non-finite values at N={n}")
        if fwd["max"] > K5_PREDS_MAX or fwd["mean"] > K5_PREDS_MEAN:
            raise RuntimeError(f"K5's forward disagrees with the plain MLP at N={n}: {fwd}")
        bad = [k for k in ("dx_rel_l2", "dd_rel_l2") if fields.get(k, 0.0) > K5_TOL_REL]
        if rel > K5_TOL_REL or bad:
            raise RuntimeError(f"K5's backward disagrees with the plain one at N={n}: "
                               f"{rel} {fields}")
        for what in ("skip", "layer0"):
            if need and fields[f"dx_rel_l2_{what}_broken"] < 10 * K5_TOL_REL:
                raise RuntimeError(f"the dx_enc gate cannot see a K5 with a broken {what} "
                                   f"pack: {fields} < 10 x {K5_TOL_REL}")
        report["fwd_max_abs_err"] = max(report["fwd_max_abs_err"], fwd["max"])
        report["bwd_max_abs_err"] = max(report["bwd_max_abs_err"], max_abs)
        del x_enc, d_enc, g, got, dx, dd, want, want_dx, want_dd, out
        torch.cuda.empty_cache()
    return report


def _orbit_rays(dev, size: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """The rays of 8 poses around the object (theta every 45 degrees, phi
    -30, radius 4), ``size`` x ``size`` each, as the server calibrates."""
    rays = [get_rays(size, size, 1.2 * size, pose_spherical(theta, -30.0, 4.0), device=dev)
            for theta in range(0, 360, 45)]
    return (torch.cat([o.reshape(-1, 3) for o, _ in rays]),
            torch.cat([d.reshape(-1, 3) for _, d in rays]))


def _calibrated_qparams(mlp: NeRFMLP, dev) -> dict:
    """``mlp``'s int8 tables, calibrated on 2048 orbit rays at 192 centred
    samples each."""
    o, d = _orbit_rays(dev)
    idx = torch.as_tensor(np.random.default_rng(0).choice(o.shape[0], 2048, replace=False),
                          device=dev)
    o, d = o[idx], d[idx]
    t = generate_t_vals(2.0, 6.0, (o.shape[0],), 192, "center", device=dev)
    pts = o[:, None, :] + d[:, None, :] * t[..., None]
    d_enc = encode_position(d, mlp.l_dir)[:, None, :].expand(*t.shape, -1)
    tree = quant.mlp_tree(mlp)
    stats = quant.mlp_calibration_absmax(tree, encode_position(pts, mlp.l_xyz), d_enc,
                                         mlp.skip_layer)
    return quant.quantize_mlp(tree, stats, mlp.skip_layer)


def _broken_qparams(qp: dict, hidden: int, skip_layer: int, what: str) -> dict:
    """A copy of ``qp`` with the skip layer's x_enc rows zeroed (``skip``)
    or the fs head's sigma column dropped (``sigma``)."""
    bad = {**qp, "trunk": [dict(lyr) for lyr in qp["trunk"]], "fs": dict(qp["fs"])}
    if what == "skip":
        i = next(i for i in range(1, len(bad["trunk"])) if is_skip(i - 1, skip_layer))
        bad["trunk"][i]["wq"] = bad["trunk"][i]["wq"].clone()
        bad["trunk"][i]["wq"][hidden:] = 0
    else:
        for key in ("wq", "scale", "b"):
            bad["fs"][key] = bad["fs"][key].clone()
            bad["fs"][key][..., hidden] = 0
    return bad


def _errs(got: tuple, want: tuple) -> dict:
    d_rgb, d_w = (got[0] - want[0]).abs(), (got[1] - want[1]).abs()
    return {"rgb_max": d_rgb.max().item(), "rgb_mean": d_rgb.mean().item(),
            "w_max": d_w.max().item(), "w_mean": d_w.mean().item()}


def _miss(errs: dict) -> float:
    """How far errors are beyond K4's gates (1 = at the gate)."""
    return max(errs["rgb_max"] / K4_TOL_MAX, errs["w_max"] / K4_TOL_MAX,
               errs["rgb_mean"] / K4_TOL_MEAN, errs["w_mean"] / K4_TOL_MEAN)


def phase_k4(card: str) -> dict:
    """K4 vs render_rays_reference_quant at full width: B=4096 (one 64x64
    pose) with S=64, 160 (the proposal fine pass) and 192, a ragged B
    (several rays per block, a part-filled last block), and the chunk the
    server launches it on (B=16384 rays of a 128x128 pose, S=64 coarse and
    192 fine); two broken packs at S=192 must miss the gates by 10x."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    mlp = full_mlp(dev, 4)
    qp = _calibrated_qparams(mlp, dev)
    rays = {}
    for size in (64, 128):
        o, d = get_rays(size, size, 1.2 * size, pose_spherical(30.0, -30.0, 4.0), device=dev)
        rays[size * size] = (o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous())
    report = {"max_abs_err": 0.0}
    for b, s in ((4096, 64), (4096, 160), (4096, 192), (1001, 24), (16384, 64), (16384, 192)):
        origins, dirs = rays[16384 if b > 4096 else 4096]
        o, d = origins[:b].contiguous(), dirs[:b].contiguous()
        t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
        args = (qp, o, d, t)
        got = k4.render_rays_fused_quant(*args)
        torch.cuda.synchronize()
        want = k4.render_rays_reference_quant(*args)
        errs = _errs(got, want)
        finite = bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
        fields = {}
        if s == 192:
            for what in ("skip", "sigma"):
                bad = _broken_qparams(qp, mlp.hidden_dim, mlp.skip_layer, what)
                fields[f"miss_{what}_broken"] = _miss(_errs(k4.launch_k4(bad, o, d, t, 10, 4, 4),
                                                            want))
        if b in (4096, 16384):
            bnd = k4_bound(mlp, b, s)
            fields.update(ms=cuda_ms(lambda: k4.render_rays_fused_quant(*args)),
                          plain_ms=cuda_ms(lambda: k4.render_rays_reference_quant(*args)),
                          bound_ms=bnd[0], bound_by=bnd[1])
            key = f"b{b}_s{s}"
            report[f"ms_{key}"], report[f"plain_ms_{key}"] = fields["ms"], fields["plain_ms"]
            report[f"bound_{key}"] = bnd
        say("k4", B=b, S=s, **errs, tol_max=K4_TOL_MAX, tol_mean=K4_TOL_MEAN, finite=finite,
            **fields, card=card)
        if not finite:
            raise RuntimeError(f"K4 produced non-finite values at B={b}, S={s}")
        if _miss(errs) > 1.0:
            raise RuntimeError(f"K4 disagrees with the plain version at B={b}, S={s}: {errs}")
        for what in ("skip", "sigma"):
            if s == 192 and fields[f"miss_{what}_broken"] < 10.0:
                raise RuntimeError(f"K4's gates cannot see a broken {what} pack: {fields}")
        report["max_abs_err"] = max(report["max_abs_err"], errs["rgb_max"], errs["w_max"])
    desc = k4.kernel_pack(qp, dev).desc
    for b in (4096, 16384):
        report[f"library_ms_b{b}_s192"] = library_products_ms(desc, b * 192, torch.int8, dev)
        say("k4_library", B=b, S=192, library_ms=report[f"library_ms_b{b}_s192"], card=card)
    return report


def _get(url: str) -> tuple[bytes, float]:
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=300) as resp:
        body = resp.read()
    return body, time.perf_counter() - t0


def phase_serve(card: str, tmp: str) -> dict:
    """Serve random weights at full width over HTTP; returns the launches
    the requests made."""
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
        reset_counts()  # count only the main path's launches from here
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
        launches = counts()
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


def phase_serve_int8(card: str, tmp: str) -> dict:
    """The phase-6 checkpoint served with ``--quant int8``: the gate must
    pass, and every frame must render through K4 alone (two launches per
    chunk); one frame against the port's CPU int8 path on the same
    tables."""
    cfg = load_config(CONFIG)
    ckpt = os.path.join(tmp, "random.ckpt.npz")
    service = RenderService(cfg, ckpt, device="cuda", quant=True, quant_gate_db=QUANT_GATE_DB)
    say("int8_gate", psnr_db=service.quant_gate_psnr, gate_db=QUANT_GATE_DB,
        use_quant=service.use_quant, size=[cfg.height, cfg.width], card=card)
    if not (service.use_quant and service.trainer.quant_ready):
        raise RuntimeError(f"the int8 gate failed: {service.quant_gate_psnr} dB")
    server = serve(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    size, chunk = 200, 16384
    n_chunks = -(-size * size // chunk)
    requests = [("rgb", 30.0), ("rgb", 120.0), ("depth", 30.0)]
    try:
        reset_counts()  # count only the main path's launches from here
        for map_name, theta in requests:
            before = counts()
            png, seconds = _get(
                f"{base}/render?theta={theta}&phi=-30&radius=4&width={size}"
                f"&height={size}&chunk={chunk}&map={map_name}"
            )
            grew = {k: v - before[k] for k, v in counts().items()}
            img = decode_png(png)
            shape = (size, size, 3) if map_name == "rgb" else (size, size)
            say("serve_int8", map=map_name, theta=theta, latency_s=seconds,
                shape=list(img.shape), png_bytes=len(png), launches=grew,
                std=float(img.std()), card=card)
            if img.shape != shape:
                raise RuntimeError(f"/render {map_name}: shape {img.shape} != {shape}")
            if map_name == "rgb" and img.std() == 0:
                raise RuntimeError("/render rgb returned a constant image")
            if grew != dict(ZERO, k4=2 * n_chunks):
                raise RuntimeError(f"an int8 frame launched {grew}, expected "
                                   f"2 x {n_chunks} K4 launches and nothing else")
        launches = counts()
        stats = json.loads(_get(f"{base}/stats")[0])
        say("stats_int8", **stats)
        if stats["quant"] != "int8" or stats["requests"] != len(requests):
            raise RuntimeError(f"/stats: {stats}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    # One served frame on the card against the plain int8 path on the CPU,
    # same tables, on every 40th ray.
    gpu = service.trainer
    origins, dirs = gpu.pose_rays(pose_spherical(30.0, -30.0, 4.0), size, size, 240.0)
    out = gpu.render_rays(origins, dirs, quant=True)
    idx = torch.arange(0, origins.shape[0], 40)
    cpu = Trainer(cfg, 2.0, 6.0, device="cpu").restore(ckpt).install_quant(gpu.qparams)
    ref = cpu.render_rays(origins[idx].cpu(), dirs[idx].cpu(), quant=True)
    errs, bad = {}, []
    for k in sorted(ref):
        got = out[k][idx.numpy()]
        if not np.isfinite(out[k]).all():
            bad.append(f"{k}: non-finite")
            continue
        errs[k] = float(np.abs(got - ref[k]).max())
        tol = FRAME_TOL_RGB if k.startswith("rgb") else FRAME_TOL_DEPTH
        if errs[k] > tol:
            bad.append(f"{k}: {errs[k]} > {tol}")
    say("int8_frame_vs_plain", size=size, rays_checked=len(idx), max_abs_err=errs,
        tol_rgb=FRAME_TOL_RGB, tol_depth=FRAME_TOL_DEPTH, card=card)
    if len(errs) != 4 or bad:
        raise RuntimeError(f"the int8 frame disagrees with the CPU int8 path: {bad}")
    return launches


def phase_proposal_int8(card: str, trainer: Trainer) -> dict:
    """Phase 7's proposal-trained state: calibrate int8 tables on a 200x200
    pose, then a 200x200 frame through the float proposal chain and one K4
    fine pass per chunk."""
    pose = pose_spherical(30.0, -30.0, 4.0)
    trainer.quantize_for_inference(*trainer.pose_rays(pose, 200, 200, 240.0))
    reset_counts()
    frame = trainer.render_image(pose, 200, 200, 240.0, quant=True)
    launches = counts()
    n_chunks = -(-200 * 200 // 16384)
    rgb = frame["rgb"]
    flt = trainer.render_image(pose, 200, 200, 240.0)["rgb"]
    say("proposal_int8", size=200, launches=launches, psnr_vs_float_db=frame_psnr(flt, rgb),
        card=card)
    if launches != dict(ZERO, k4=n_chunks):
        raise RuntimeError(f"the proposal int8 frame launched {launches}, expected "
                           f"{n_chunks} K4 launches and nothing else")
    if not (np.isfinite(rgb).all() and np.isfinite(frame["depth"]).all()):
        raise RuntimeError("proposal int8: non-finite frame")
    if rgb.shape != (200, 200, 3) or rgb.std() == 0:
        raise RuntimeError("proposal int8: a constant frame")
    return launches


def _plain_render_pass(cfg):
    def plain_pass(mlp, o, d, t, weights_grad):
        rgb, w = k1.render_rays_reference(mlp, o, d, t, l_xyz=cfg.l_xyz,
                                          l_dir=cfg.l_dir, skip_layer=cfg.skip_layer)
        return rgb, w if weights_grad else w.detach()
    return plain_pass


def _grads_kernel_vs_plain(cfg, trainer, batch, noise_shapes, seed):
    """One step's gradients, kernel path against plain path (the plain K1
    for the render passes, the plain MLP for K5), with the same draws.
    Returns (loss_kernel, loss_plain, per-leaf relative L2 by model)."""
    b = cfg.batch_size
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t_vals = draw_t_vals(cfg, 2.0, 6.0, (b,), trainer.device,
                         noise=torch.rand((b, cfg.ns_coarse), generator=gen, device="cuda"))
    noise = [torch.rand(s, generator=gen, device="cuda") for s in noise_shapes]
    noise = noise if cfg.train_sampler == "proposal" else noise[0]
    params = params_of(trainer.params)
    grads, losses = [], []
    for plain in (False, True):
        loss_fn = make_loss_fn(cfg, 2.0, 6.0,
                               render_pass=_plain_render_pass(cfg) if plain else None,
                               mlp_fn=(lambda mlp, x, d: mlp(x, d)) if plain else None)
        for p in params:
            p.grad = None
        loss, _ = loss_fn(trainer.params, *batch, t_vals, 0, noise=noise)
        loss.backward()
        grads.append([p.grad.clone() for p in params])
        losses.append(float(loss.detach()))
    for p in params:
        p.grad = None
    by_model, i = {}, 0
    for name in sorted(trainer.params):
        k = len(list(trainer.params[name].parameters()))
        by_model[name] = [_rel_l2(a, b) for a, b in zip(grads[0][i:i + k], grads[1][i:i + k])]
        i += k
    max_abs = max(float((a - b).abs().max()) for a, b in zip(*grads))
    del grads
    torch.cuda.empty_cache()
    return losses, by_model, max_abs


def _train_steps(trainer, batch, steps, per_step: dict, step_fn=None) -> dict:
    """``steps`` train steps (``trainer.train_step``, or ``step_fn(state,
    batch, draws, generator)`` on the trainer's state) with the counters
    reset just before; each must launch exactly ``per_step``."""
    reset_counts()
    step_ms, loss_curve, peak = [], [], 0
    for i in range(steps):
        before = counts()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if step_fn is None:
            metrics = trainer.train_step(batch)
        else:
            metrics = step_fn(trainer.state, batch, None, trainer.generator)
        loss_curve.append(float(metrics["loss"]))  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
        grew = {k: v - before[k] for k, v in counts().items()}
        if grew != per_step:
            raise RuntimeError(f"step {i} launched {grew}, expected {per_step}")
    warm = statistics.median(step_ms[2:]) if steps > 2 else statistics.median(step_ms)
    return {"launches": counts(), "loss_curve": loss_curve, "step_ms": step_ms,
            "median_step_ms": warm, "rays_per_s": trainer.cfg.batch_size / (warm / 1e3),
            "peak_step_mib": peak / 2**20}


def _eval_and_frame(trainer, batch, what: str) -> tuple[dict, dict]:
    """``evaluate`` and a 200x200 frame, counted as forward-only launches."""
    reset_counts()
    ev = trainer.evaluate([batch])
    frame = trainer.render_image(pose_spherical(30.0, -30.0, 4.0), 200, 200, 240.0)
    rgb = frame["rgb"]
    if not all(np.isfinite(v) for v in ev.values()):
        raise RuntimeError(f"{what}: non-finite eval metrics {ev}")
    if not (np.isfinite(rgb).all() and np.isfinite(frame["depth"]).all()):
        raise RuntimeError(f"{what}: non-finite frame")
    if rgb.shape != (200, 200, 3) or rgb.std() == 0:
        raise RuntimeError(f"{what}: a constant frame")
    return ev, counts()


ZERO = {"k1_fwd": 0, "k1_train": 0, "k2": 0, "k3": 0, "k5_fwd": 0, "k5_bwd": 0, "k4": 0,
        "k6_fwd": 0, "k6_bwd": 0, "k7": 0}


def phase_train(card: str) -> tuple[list[dict], Trainer]:
    """The bench recipe's proposal trainer on the card (10 steps); returns
    the launch counts and the trainer."""
    cfg = bench_config()
    trainer = Trainer(cfg, 2.0, 6.0, device="cuda")
    batch = trainer.put_batch(bench_batch(cfg.batch_size))
    losses, by_model, max_abs = _grads_kernel_vs_plain(
        cfg, trainer, batch, [(cfg.batch_size, cfg.ns_fine)], seed=2)
    rel = max(max(v) for v in by_model.values())
    say("train_grads_vs_plain", loss_kernel=losses[0], loss_plain=losses[1],
        max_abs_err=max_abs, max_rel_l2=rel, tol_rel=STEP_TOL_REL, card=card)
    if rel > STEP_TOL_REL:
        raise RuntimeError(f"kernel-path gradients disagree with the plain path: {rel}")
    run = _train_steps(trainer, batch, 10, dict(ZERO, k1_train=1, k2=1))
    ev, after = _eval_and_frame(trainer, batch, "proposal")
    say("train", steps=10, **run, eval=ev, eval_frame_launches=after, card=card)
    if not run["loss_curve"][-1] < run["loss_curve"][0]:
        raise RuntimeError(f"the loss did not fall: {run['loss_curve']}")
    if run["peak_step_mib"] > STEP_PEAK_MIB:
        raise RuntimeError(f"a proposal step peaked at {run['peak_step_mib']} MiB")
    return [run["launches"], after], trainer


def phase_parity(card: str, stop: bool, tmp: str) -> tuple[list[dict], str | None]:
    """The coarse+fine parity step at lego_batch_h256_tpu widths (batch
    4096, 64 + 128): with STOP_PDF_GRADIENT 20 steps over K1/K2, then
    evaluate, a frame and a checkpoint; without it 5 steps over K5."""
    cfg = parity_config(stop_pdf_gradient=stop)
    trainer = Trainer(cfg, 2.0, 6.0, device="cuda")
    for m in trainer.params.values():
        randomize_biases_(m, torch.Generator().manual_seed(3))
    batch = trainer.put_batch(bench_batch(cfg.batch_size))
    losses, by_model, max_abs = _grads_kernel_vs_plain(
        cfg, trainer, batch, [(cfg.batch_size, cfg.ns_fine)], seed=4)
    rel_fine, rel_coarse = max(by_model["fine"]), max(by_model["coarse"])
    tol_coarse = STEP_TOL_REL if stop else PDF_COARSE_TOL_REL
    say("parity_grads_vs_plain", stop_pdf_gradient=stop, loss_kernel=losses[0],
        loss_plain=losses[1], max_abs_err=max_abs, max_rel_l2_fine=rel_fine,
        max_rel_l2_coarse=rel_coarse, rel_l2_coarse_by_leaf=by_model["coarse"],
        tol_rel_fine=STEP_TOL_REL, tol_rel_coarse=tol_coarse, card=card)
    if not (rel_fine <= STEP_TOL_REL and rel_coarse <= tol_coarse):
        raise RuntimeError(f"kernel-path gradients disagree with the plain path: "
                           f"fine {rel_fine}, coarse {rel_coarse}")
    steps = 20 if stop else 5
    per_step = dict(ZERO, k1_train=2, k2=2) if stop else dict(ZERO, k5_fwd=2, k5_bwd=2)
    run = _train_steps(trainer, batch, steps, per_step)
    name = "parity_train" if stop else "parity_train_pdf_grad"
    if not all(np.isfinite(x) for x in run["loss_curve"]):
        raise RuntimeError(f"{name}: non-finite losses {run['loss_curve']}")
    if stop and not run["loss_curve"][-1] < run["loss_curve"][0]:
        raise RuntimeError(f"{name}: the loss did not fall: {run['loss_curve']}")
    if run["peak_step_mib"] > STEP_PEAK_MIB:
        raise RuntimeError(f"{name}: a step peaked at {run['peak_step_mib']} MiB")
    if not stop:
        say(name, steps=steps, **run, card=card)
        return [run["launches"]], None
    ev, after = _eval_and_frame(trainer, batch, name)
    say(name, steps=steps, **run, eval=ev, eval_frame_launches=after, card=card)
    ckpt = os.path.join(tmp, "parity.ckpt.npz")
    trainer.save(ckpt, scene={"near": 2.0, "far": 6.0})
    return [run["launches"], after], ckpt


def phase_full_render(card: str, ckpt: str) -> dict:
    """A 200x200 frame with full=True through K5 (two launches per chunk),
    all eight maps held against the port's CPU path on a strided subset of
    its rays (rays render independently)."""
    cfg = parity_config()
    gpu = Trainer(cfg, 2.0, 6.0, device="cuda").restore(ckpt)
    origins, dirs = gpu.pose_rays(pose_spherical(30.0, -30.0, 4.0), 200, 200, 240.0)
    chunk = 16384
    reset_counts()
    out = gpu.render_rays(origins, dirs, chunk=chunk, full=True)
    launches = counts()
    n_chunks = -(-origins.shape[0] // chunk)
    expected = dict(ZERO, k5_fwd=2 * n_chunks)
    if launches != expected:
        raise RuntimeError(f"the full render launched {launches}, expected {expected}")
    idx = torch.arange(0, origins.shape[0], 40)
    cpu = Trainer(cfg, 2.0, 6.0, device="cpu").restore(ckpt)
    ref = cpu.render_rays(origins[idx].cpu(), dirs[idx].cpu(), full=True)
    tols = {"rgb": FRAME_TOL_RGB, "depth": FRAME_TOL_DEPTH, "weights": FRAME_TOL_WEIGHTS,
            "preds": K5_PREDS_MAX}
    errs, bad = {}, []
    for k in sorted(ref):
        got = out[k][idx.numpy()]
        if got.shape != ref[k].shape or not np.isfinite(out[k]).all():
            bad.append(f"{k}: shape {got.shape} vs {ref[k].shape} or non-finite")
            continue
        errs[k] = float(np.abs(got - ref[k]).max())
        tol = tols.get(k, tols.get(k.split("_")[0]))
        if errs[k] > tol:
            bad.append(f"{k}: {errs[k]} > {tol}")
    say("full_render", size=200, chunks=n_chunks, launches=launches, rays_checked=len(idx),
        max_abs_err=errs, tolerances=tols, keys=sorted(out), card=card)
    if len(out) != 8 or bad:
        raise RuntimeError(f"the full render disagrees with the CPU path: {bad} {sorted(out)}")
    return launches


def _held_between(fn) -> tuple[int, tuple]:
    """Device bytes allocated by ``fn()`` and still held when it returns
    (its outputs and what its autograd graph saved), and its result."""
    torch.cuda.synchronize()
    before = exp_train_paths.requested_bytes()
    out = fn()
    torch.cuda.synchronize()
    return exp_train_paths.requested_bytes() - before, out


def phase_k3(card: str) -> dict:
    """K3 against K2 on the same K1 predictions, bit for bit; at S=160 also
    against autograd of the plain K1, with a broken K3 (its encode one
    octave short: l_xyz 9, zeros in the top octave's columns); the memory
    each backward mode holds between forward and backward."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    mlp = full_mlp(dev, 6)
    params = list(mlp.parameters())
    _, origins, dirs = (torch.as_tensor(x, device=dev) for x in bench_batch(4096))
    report = {}
    for b, s in ((4096, 64), (4096, 160), (4096, 192), (1001, 24)):
        o, d = origins[:b].contiguous(), dirs[:b].contiguous()
        t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
        g_rgb = (torch.randn((b, 3), generator=gen) * 1e-3).to(dev)
        g_w = (torch.randn((b, s), generator=gen) * 1e-3).to(dev)
        with torch.no_grad():
            _, _, x_enc, preds = k1.launch_k1(mlp, o, d, t, 10, 4, train=True)
            _, _, none, preds_only = k1.launch_k1(mlp, o, d, t, 10, 4, train=True,
                                                 emit_xenc=False)
        if none is not None or not torch.equal(preds, preds_only):
            raise RuntimeError("K1 with predictions only wrote other predictions")
        equal = {}
        for tag, gw in (("with_gw", g_w), ("without_gw", None)):
            with torch.no_grad():
                _, ws2 = k1.launch_rows(k1._ROWS_K2, mlp, t, preds, g_rgb, gw, 10, 4,
                                        x_res=x_enc, dirs=d)
                _, ws3 = k1.launch_rows(k1._ROWS_K3, mlp, t, preds_only, g_rgb, gw, 10, 4,
                                        origins=o, dirs=d)
                torch.cuda.synchronize()
            equal[tag] = bool(torch.equal(ws2.dw, ws3.dw) and torch.equal(ws2.db, ws3.db))
            equal[f"{tag}_max_abs"] = float(max((ws2.dw - ws3.dw).abs().max(),
                                                (ws2.db - ws3.db).abs().max()))
            del ws2, ws3
        fields = {}
        if (b, s) == (4096, 160):
            with torch.enable_grad():
                rgb_p, w_p = k1.render_rays_reference(mlp, o, d, t)
            want = list(torch.autograd.grad([rgb_p, w_p], params, [g_rgb, g_w],
                                            retain_graph=True))
            with torch.no_grad():
                got = k1.launch_k3(mlp, o, d, t, preds_only, g_rgb, g_w, 10, 4)
                fwd, wsb = k1.launch_rows(k1._ROWS_K3, mlp, t, preds_only, g_rgb, g_w, 9, 4,
                                          origins=o, dirs=d)
                broken = k1.unpack_grads(mlp, fwd, wsb.layout, wsb.dw, wsb.db)
                del wsb
            max_abs, rel = _leaf_errors(got, want)
            _, rel_broken = _leaf_errors(broken, want)
            with torch.no_grad():
                k3_ms = cuda_ms(lambda: k1.launch_k3(mlp, o, d, t, preds_only, g_rgb, g_w,
                                                     10, 4))
                k2_ms = cuda_ms(lambda: k1.launch_k2(mlp, x_enc, d, t, preds, g_rgb, g_w,
                                                     10, 4))
            plain_ms = cuda_ms(lambda: torch.autograd.grad(
                [rgb_p, w_p], params, [g_rgb, g_w], retain_graph=True))
            del rgb_p, w_p
            bnd = k3_bound(mlp, b, s)
            fields = dict(max_abs_err=max_abs, max_rel_l2=rel, tol_rel=K2_TOL_REL,
                          rel_l2_top_octave_dropped=rel_broken, ms=k3_ms, k2_ms=k2_ms,
                          plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1])
            report.update(max_abs_err=max_abs, ms=k3_ms, plain_ms=plain_ms, bound=bnd)
        if b == 4096 and s in (64, 192):
            held = {}
            for mode in k1.BWD_MODES:
                def fwd_pass(mode=mode):
                    return k1.render_rays_fused(mlp, o, d, t, bwd_mode=mode)
                torch.autograd.grad([fwd_pass()[0].sum()], params)  # packs built
                held[mode], (rgb, _) = _held_between(fwd_pass)
                torch.autograd.grad([rgb.sum()], params)
                del rgb
            fields.update(held_bytes_recompute=held["recompute"],
                          held_bytes_residual=held["residual"],
                          held_bound_bytes=b * (s * 20 + 40) + 2**20)
            report[f"held_s{s}"] = held
        say("k3", B=b, S=s, k2_bit_equal=equal, **fields, card=card)
        if not (equal["with_gw"] and equal["without_gw"]):
            if fields.get("max_rel_l2", 0.0) > K2_TOL_REL:
                raise RuntimeError(f"K3 disagrees with K2 and with the plain backward at "
                                   f"B={b}, S={s}: {equal} {fields}")
            raise RuntimeError(f"K3's dW/db are not K2's bit for bit at B={b}, S={s}: {equal}")
        if fields.get("max_rel_l2", 0.0) > K2_TOL_REL:
            raise RuntimeError(f"K3 disagrees with the plain backward: {fields}")
        if "rel_l2_top_octave_dropped" in fields and \
                fields["rel_l2_top_octave_dropped"] < 10 * K2_TOL_REL:
            raise RuntimeError(f"the gate cannot see K3's encode one octave short: {fields}")
        if "held_bytes_recompute" in fields and \
                fields["held_bytes_recompute"] > fields["held_bound_bytes"]:
            raise RuntimeError(f"K3's forward holds more than its bound: {fields}")
        del x_enc, preds, preds_only
    torch.cuda.empty_cache()
    return report


def _k6_inputs(dev, gen, o, d, s, per_sample_dirs: bool):
    """Stratified t, the bf16 position encodings of the rays' points and the
    direction encodings: of the rays (``per_sample_dirs`` false) or of a
    random unit direction per sample, so that a kernel reading them per ray
    cannot pass."""
    b = o.shape[0]
    t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
    points, dirs_s = sample_rays(o, d, t)
    if per_sample_dirs:
        dirs_s = torch.randn((b, s, 3), generator=gen).to(dev)
        dirs_s = dirs_s / dirs_s.norm(dim=-1, keepdim=True)
    x_enc = encode_position(points, 10).to(torch.bfloat16).contiguous()
    d_enc = encode_position(dirs_s, 4).to(torch.bfloat16).contiguous()
    return t, x_enc, d_enc


def phase_k6(card: str) -> dict:
    """K6 forward and backward against their plain versions (per-sample
    directions), a K6 fed per-ray direction encodings against the gates, a
    loss on the weights, and K6 against K1 on the same rays."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    mlp = full_mlp(dev, 7)
    params = list(mlp.parameters())
    images, origins, dirs = (torch.as_tensor(x, device=dev) for x in bench_batch(4096))
    report = {"fwd_max_abs_err": 0.0, "bwd_max_abs_err": 0.0}
    for b, s in ((4096, 64), (4096, 192), (1001, 24)):
        o, d = origins[:b].contiguous(), dirs[:b].contiguous()
        t, x_enc, d_enc = _k6_inputs(dev, gen, o, d, s, per_sample_dirs=True)
        with torch.no_grad():
            got = k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t)
            torch.cuda.synchronize()
            want = k1.apply_nerf_render_reference(mlp, x_enc, d_enc, t)
            per_ray = d_enc[:, :1].expand(-1, s, -1).contiguous()
            broken = k1.apply_nerf_render_fused(mlp, x_enc, per_ray, t)
        errs = _errs(got, want)
        miss = max(errs["rgb_max"] / TOL_MAX, errs["w_max"] / TOL_MAX,
                   errs["rgb_mean"] / TOL_MEAN, errs["w_mean"] / TOL_MEAN)
        _e = _errs(broken, want)
        miss_broken = max(_e["rgb_max"] / TOL_MAX, _e["rgb_mean"] / TOL_MEAN)
        g_rgb = (torch.randn((b, 3), generator=gen) * 1e-3).to(dev)
        with torch.no_grad():
            _, _, preds = k1.launch_k6_fwd(mlp, x_enc, d_enc, t, train=True)
            grads = k1.launch_k6_bwd(mlp, x_enc, d_enc, t, preds, g_rgb)
        want_g = k1.apply_nerf_render_reference_vjp(mlp, x_enc, d_enc, t, g_rgb)
        max_abs, rel = _leaf_errors(grads, want_g)
        finite = bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()) and \
            all(bool(torch.isfinite(g).all()) for g in grads)
        fields = {}
        if (b, s) == (4096, 192):
            # The weights carry no gradient: a loss on them adds nothing.
            target = images[:b]
            rgb, w = k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t)
            g_rgb_only = torch.autograd.grad([((rgb - target) ** 2).mean()], params)
            rgb, w = k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t)
            g_both = torch.autograd.grad([((rgb - target) ** 2).mean() + (w ** 2).sum()],
                                         params)
            fields["weights_loss_adds_nothing"] = (not w.requires_grad) and all(
                torch.equal(a, c) for a, c in zip(g_rgb_only, g_both))
            # K6 against K1 on the same rays (direction encodings per ray).
            t1, x1, d1 = _k6_inputs(dev, gen, o, d, s, per_sample_dirs=False)
            with torch.no_grad():
                fields["vs_k1"] = _errs(k1.apply_nerf_render_fused(mlp, x1, d1, t1),
                                        k1.render_rays_fused(mlp, o, d, t1))
                fwd_ms = cuda_ms(lambda: k1.apply_nerf_render_fused(mlp, x_enc, d_enc, t))
                fwd_plain_ms = cuda_ms(
                    lambda: k1.apply_nerf_render_reference(mlp, x_enc, d_enc, t))
                bwd_ms = cuda_ms(lambda: k1.launch_k6_bwd(mlp, x_enc, d_enc, t, preds, g_rgb))
            with torch.enable_grad():
                rgb_p, _ = k1.apply_nerf_render_reference(mlp, x_enc, d_enc, t)
            bwd_plain_ms = cuda_ms(lambda: torch.autograd.grad([rgb_p], params, [g_rgb],
                                                               retain_graph=True))
            del rgb_p
            fwd_bnd, bwd_bnd = k6_bounds(mlp, b, s)
            fields.update(fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms, fwd_bound_ms=fwd_bnd[0],
                          bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, bwd_bound_ms=bwd_bnd[0])
            report.update(fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms, fwd_bound=fwd_bnd,
                          bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, bwd_bound=bwd_bnd)
        say("k6", B=b, S=s, **errs, tol_max=TOL_MAX, tol_mean=TOL_MEAN,
            miss_dirs_per_ray=miss_broken, grad_max_abs=max_abs, grad_max_rel_l2=rel,
            tol_rel=K2_TOL_REL, finite=finite, **fields, card=card)
        if not finite:
            raise RuntimeError(f"K6 produced non-finite values at B={b}, S={s}")
        if miss > 1.0:
            raise RuntimeError(f"K6's forward disagrees with the plain version: {errs}")
        if rel > K2_TOL_REL:
            raise RuntimeError(f"K6's backward disagrees with the plain one: {rel}")
        if miss_broken < 10.0:
            raise RuntimeError(f"the gates cannot see a K6 reading directions per ray: "
                               f"{miss_broken}")
        if fields.get("weights_loss_adds_nothing") is False:
            raise RuntimeError("a loss on K6's weights moved the gradients")
        report["fwd_max_abs_err"] = max(report["fwd_max_abs_err"], errs["rgb_max"],
                                        errs["w_max"])
        report["bwd_max_abs_err"] = max(report["bwd_max_abs_err"], max_abs)
        del x_enc, d_enc, preds, grads, want_g
    torch.cuda.empty_cache()
    return report


K7_TOL = 1e-3  # hard gate on any union value; the count above 1e-5 is reported


def phase_k7(card: str) -> dict:
    """K7 against the chain at its three main shapes, with adversarial rows:
    the gates, the float64 check, and call and device times beside the
    byte bound and the yardsticks."""
    report = {"max_abs_err": 0.0}
    for b, s, nf, sorted_u in exp_train_paths.K7_SHAPES:
        t, w = exp_train_paths.pdf_inputs(b, s, seed=b)
        w[0] = 0.0  # uniform pdf through the floor
        w[1] = 0.0
        w[1, s // 2] = 5.0  # a single spike: plateaus in the cdf
        w[2] = 0.0
        w[2, :2] = 1.0  # front-loaded mass
        t[3, s // 2:s // 2 + 4] = t[3, s // 2]  # a repeated coarse value, and the
        w[3] = 0.0  # mass between its equal midpoints: draws tie with it
        w[3, s // 2 + 1:s // 2 + 3] = 1.0
        u = exp_train_paths.k7_u(b, nf, sorted_u)
        got = k7.sample_pdf_union(t, w, nf, u)
        torch.cuda.synchronize()
        same_bits = bool(torch.equal(k7.sample_pdf_union(t, w, nf, u), got))
        want = k7.sample_pdf_union_reference(t, w, nf, u)
        errs = exp_train_paths.union_errors(got, want)
        exact = k7.sample_pdf_union_float64(t, w, nf, u)
        vs64 = {"k7": exp_train_paths.union_errors(got.double(), exact),
                "chain": exp_train_paths.union_errors(want.double(), exact)}
        idx = torch.searchsorted(got, t).clamp(max=s + nf - 1)
        coarse_exact = bool(torch.equal(got.gather(1, idx), t))
        ascending = bool((got.diff(dim=-1) >= 0).all())
        ties = int((got[3] == t[3, s // 2]).sum()) - 4
        broken = exp_train_paths.union_errors(k7.launch_k7(t, w, nf, u, w_floor=0.0), want)
        times = exp_train_paths.k7_times(t, w, nf, u)
        bnd = k7_bound(b, s, nf, sorted_u)
        say("k7", B=b, S=s, NF=nf, u="sorted" if sorted_u else "eval", **errs, tol=K7_TOL,
            vs_float64=vs64, coarse_bit_exact=coarse_exact, ascending=ascending,
            same_bits=same_bits, draws_on_repeated_value=ties,
            miss_without_floor=broken["max_abs_err"] / K7_TOL, **times, bound_ms=bnd[0],
            bound_by=bnd[1], card=card)
        if not (coarse_exact and ascending and same_bits) or ties <= 0:
            raise RuntimeError(f"K7 lost a coarse value, is not ascending, changed between "
                               f"runs or drew nothing on the repeated value at B={b}, NF={nf}")
        if errs["max_abs_err"] > K7_TOL:
            raise RuntimeError(f"K7 disagrees with the chain at B={b}, NF={nf}: {errs}")
        if (vs64["k7"]["max_abs_err"] > vs64["chain"]["max_abs_err"]
                or vs64["k7"]["above_1e-5"] > vs64["chain"]["above_1e-5"]):
            raise RuntimeError(f"K7 is further from the float64 chain than the float32 chain "
                               f"at B={b}, NF={nf}: {vs64}")
        if broken["max_abs_err"] < 10 * K7_TOL:
            raise RuntimeError(f"the gate cannot see a K7 without the weight floor: {broken}")
        report["max_abs_err"] = max(report["max_abs_err"], errs["max_abs_err"])
        if "ms" not in report:
            # The render chunk stands for K7 in the kernel line, in device time:
            # a call of a few microseconds is timed mostly on the host.
            report.update(ms=times["device_ms"], plain_ms=times["chain_device_ms"], bound=bnd)
    return report


def phase_paths(card: str) -> list[dict]:
    """The parity step's three training paths: one step's gradients of
    paths c and a against path b on the same draws, then 5 steps of each
    with their launch counts and the memory each forward holds."""
    cfg = parity_config()
    per_step = {"b": dict(ZERO, k1_train=2, k2=2), "c": dict(ZERO, k1_train=2, k3=2),
                "a": dict(ZERO, k6_fwd=2, k6_bwd=2)}
    trainers = {n: exp_train_paths.make_trainer(cfg) for n in per_step}
    batch = trainers["b"].put_batch(bench_batch(cfg.batch_size))
    gen = torch.Generator(device="cuda").manual_seed(9)
    t_vals = draw_t_vals(cfg, 2.0, 6.0, (cfg.batch_size,), "cuda",
                         noise=torch.rand((cfg.batch_size, cfg.ns_coarse), generator=gen,
                                          device="cuda"))
    noise = torch.rand((cfg.batch_size, cfg.ns_fine), generator=gen, device="cuda")
    grads = {}
    for n, tr in trainers.items():
        loss_fn = make_loss_fn(cfg, 2.0, 6.0, render_pass=exp_train_paths.variant_pass(cfg, n))
        params = params_of(tr.params)
        loss, _ = loss_fn(tr.params, *batch, t_vals, 0, noise=noise)
        grads[n] = torch.autograd.grad([loss], params)
    c_equal = all(torch.equal(x, y) for x, y in zip(grads["c"], grads["b"]))
    rel = {n: max(_rel_l2(x, y) for x, y in zip(grads[n], grads["b"])) for n in ("c", "a")}
    say("paths_grads_vs_default", c_bit_equal_b=c_equal, max_rel_l2=rel, tol_rel=STEP_TOL_REL,
        card=card)
    del grads
    if not (c_equal or rel["c"] <= STEP_TOL_REL) or rel["a"] > STEP_TOL_REL:
        raise RuntimeError(f"a training path's gradients disagree with the default: {rel}")
    runs = []
    for n, tr in trainers.items():
        held = exp_train_paths.held_bytes(cfg, tr, batch, exp_train_paths.variant_pass(cfg, n))
        step_fn = make_train_step(cfg, 2.0, 6.0, render_pass=exp_train_paths.variant_pass(cfg, n))
        run = _train_steps(tr, batch, 5, per_step[n], step_fn=step_fn)
        say("paths_train", variant=n, steps=5, held_mb=held / 2**20, **run, card=card)
        if not all(np.isfinite(x) for x in run["loss_curve"]):
            raise RuntimeError(f"path {n}: non-finite losses {run['loss_curve']}")
        runs.append(run["launches"])
    torch.cuda.empty_cache()
    return runs


def phase_pdf_frame(card: str, ckpt: str) -> dict:
    """A 200x200 frame from the phase-8 checkpoint with K7 in place of the
    chain (one launch per chunk), against the engine's render."""
    cfg = parity_config()
    trainer = Trainer(cfg, 2.0, 6.0, device="cuda").restore(ckpt)
    origins, dirs = trainer.pose_rays(pose_spherical(30.0, -30.0, 4.0), 200, 200, 240.0)
    chunk = 16384
    reset_counts()
    outs = [exp_train_paths.render_rays_union(cfg, trainer.eval_params, origins[i:i + chunk],
                                              dirs[i:i + chunk])
            for i in range(0, origins.shape[0], chunk)]
    launches = counts()
    n_chunks = len(outs)
    expected = dict(ZERO, k1_fwd=2 * n_chunks, k7=n_chunks)
    render = make_render_fn(cfg, 2.0, 6.0)
    errs = {"rgb": 0.0, "depth": 0.0}
    with torch.no_grad():
        for i, got in zip(range(0, origins.shape[0], chunk), outs):
            want = render(trainer.eval_params, origins[i:i + chunk], dirs[i:i + chunk])
            for k in errs:
                errs[k] = max(errs[k], float((got[f"{k}_fine"] - want[f"{k}_fine"]).abs().max()))
    rgb = torch.cat([o["rgb_fine"] for o in outs])
    say("pdf_frame", size=200, chunks=n_chunks, launches=launches, rgb_max_abs_err=errs["rgb"],
        depth_max_abs_err=errs["depth"], tol_rgb=FRAME_TOL_RGB, tol_depth=FRAME_TOL_DEPTH,
        card=card)
    if launches != expected:
        raise RuntimeError(f"the K7 frame launched {launches}, expected {expected}")
    if not bool(torch.isfinite(rgb).all()) or float(rgb.std()) == 0.0:
        raise RuntimeError("the K7 frame is non-finite or constant")
    if errs["rgb"] > FRAME_TOL_RGB or errs["depth"] > FRAME_TOL_DEPTH:
        raise RuntimeError(f"the K7 frame disagrees with the engine's render: {errs}")
    return launches


def _sum(runs: list[dict], key: str) -> int:
    return sum(r[key] for r in runs)


def main() -> None:
    card = phase_card()
    phase_build()
    k1r = phase_kernel(card)
    k2r = phase_k2(card)
    torch.cuda.empty_cache()
    k2c = phase_k2_chunks(card)
    torch.cuda.empty_cache()
    k5r = phase_k5(card)
    torch.cuda.empty_cache()
    k5c = phase_k5_chunks(card)
    torch.cuda.empty_cache()
    k4r = phase_k4(card)
    torch.cuda.empty_cache()
    k3r = phase_k3(card)
    k6r = phase_k6(card)
    k7r = phase_k7(card)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        runs.append(phase_serve(card, tmp))
        runs.append(phase_serve_int8(card, tmp))
        torch.cuda.empty_cache()
        train_runs, trainer = phase_train(card)
        runs += train_runs
        runs.append(phase_proposal_int8(card, trainer))
        del trainer
        torch.cuda.empty_cache()
        parity, ckpt = phase_parity(card, True, tmp)
        runs += parity
        torch.cuda.empty_cache()
        runs += phase_parity(card, False, tmp)[0]
        torch.cuda.empty_cache()
        runs.append(phase_full_render(card, ckpt))
        torch.cuda.empty_cache()
        runs += phase_paths(card)
        runs.append(phase_pdf_frame(card, ckpt))
    kernels = [
        kernel_entry("K1 fused_render_fwd", "K1", _sum(runs, "k1_fwd"), k1r["max_abs_err"],
                     k1r["ms_s192"], k1r["plain_ms_s192"], k1r["bound_s192"],
                     k1r["library_ms_s192"]),
        kernel_entry("K1-train fused_render_fwd (residuals)", "K1", _sum(runs, "k1_train"),
                     k2r["k1_train_err"], k2r["k1_train_ms"], k2r["k1_train_plain_ms"],
                     k2r["k1_train_bound"]),
        kernel_entry("K2 fused_render_bwd", "K2", _sum(runs, "k2"), k2r["max_abs_err"],
                     k2r["ms"], k2r["plain_ms"], k2r["bound"], k2c["library_ms"]),
        kernel_entry("K5-fwd fused_mlp_fwd", "K5f", _sum(runs, "k5_fwd"),
                     k5r["fwd_max_abs_err"], k5r["fwd_ms"], k5r["fwd_plain_ms"],
                     k5r["fwd_bound"]),
        kernel_entry("K5-bwd fused_render_bwd (k5_rows)", "K5b", _sum(runs, "k5_bwd"),
                     k5r["bwd_max_abs_err"], k5r["bwd_ms"], k5r["bwd_plain_ms"],
                     k5r["bwd_bound"], k5c["library_ms"]),
        kernel_entry("K4 quant_render_fwd", "K4", _sum(runs, "k4"), k4r["max_abs_err"],
                     k4r["ms_b16384_s192"], k4r["plain_ms_b16384_s192"],
                     k4r["bound_b16384_s192"], k4r["library_ms_b16384_s192"]),
        kernel_entry("K3 fused_render_bwd (recompute)", "K3", _sum(runs, "k3"),
                     k3r["max_abs_err"], k3r["ms"], k3r["plain_ms"], k3r["bound"]),
        kernel_entry("K6-fwd fused_render_fwd (encodings in)", "K6f", _sum(runs, "k6_fwd"),
                     k6r["fwd_max_abs_err"], k6r["fwd_ms"], k6r["fwd_plain_ms"],
                     k6r["fwd_bound"]),
        kernel_entry("K6-bwd fused_render_bwd (encodings in)", "K6b", _sum(runs, "k6_bwd"),
                     k6r["bwd_max_abs_err"], k6r["bwd_ms"], k6r["bwd_plain_ms"],
                     k6r["bwd_bound"]),
        kernel_entry("K7 pdf_union", "K7", _sum(runs, "k7"), k7r["max_abs_err"], k7r["ms"],
                     k7r["plain_ms"], k7r["bound"]),
    ]
    for entry in kernels:
        if entry["launches"] == 0:
            raise RuntimeError(f"{entry['name']} was never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
