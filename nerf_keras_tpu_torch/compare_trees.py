"""Time the same phases in several checkouts of this repository on one card.

    python -m nerf_keras_tpu_torch.compare_trees [--phases kernels,steps] TREE [TREE ...]

Each TREE is the root of a checkout, for example another commit unpacked
with ``git archive`` into a directory that ``.gitignore`` lists.  The
trees run in the order given, each in a process of its own with the tree
as its working directory, so each builds and runs its own kernels and its
own code; name a tree twice to interleave (parent, change, change,
parent).  Phases:

* ``kernels``: the tree's own ``chip_smoke.py`` phases for K1, K2 (with
  K1's training form), K3, K5 (forward, and backward with input gradients
  at N = 786,432) and K6, gates included; their CUDA-event times;
* ``k1k2``: K1 at B=4096, S=64 and 192 and in training form at S=160,
  and K2 at S=160 with the weights cotangent, with K2's device ms per
  kernel (``chip_smoke.device_ms_by_kernel``); CUDA events, median of 20;
* ``k4``: the tree's own ``chip_smoke.phase_k4`` (gates included): K4 at
  B=4096 and the server's chunk of 16,384 rays, S=64 and 192, CUDA events;
* ``k7``: the tree's ``sample_pdf_union`` at K7's three main shapes (the
  render chunk B=16384, S=64, NF=128 on the eval grid; B=4096, S=64 with
  sorted uniforms at NF=128 and 96), timed both ways: the call (CUDA
  events around it, median of 50) and ``pdf_union_kernel``'s device time
  (``chip_smoke.device_ms_by_kernel``, mean of 20 launches), with the
  chain's device time; a run of this phase alone builds only K7;
* ``serve``: float and int8 frames at 200x200 and 800x800 through a
  ``RenderService`` on random weights (``profile_render.time_requests``:
  the median of its warm ``render_png`` calls and of their
  ``render_image`` part, host clock);
* ``steps``: 14 steps of the proposal recipe, of the parity step and of
  the parity step with ``STOP_PDF_GRADIENT=false`` (K5's path)
  (``profile_train.bench_config``/``parity_config``, one fixed batch of
  4096 rays) through the tree's ``Trainer.train_step``: the median of
  the last 10 step times on the host clock (each step ends in a device
  synchronise) and the peak memory over a step (``max_memory_allocated``
  over what was allocated before it).

Prints one JSON line per tree and phase, prefixed ``TREE``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

_CHILD = r'''
import json, os, statistics, sys, time
sys.path.insert(0, os.getcwd())
import torch
from nerf_keras_tpu_torch.ops.kernels import _build

phases = sys.argv[1].split(",")
out = {"tree": os.getcwd()}
if phases == ["k7"]:
    _build._sources = lambda: [_build.CSRC / "pdf_union.cu"]
_build.build()
if "kernels" in phases:
    import chip_smoke as cs
    card = cs.phase_card()
    r = cs.phase_kernel(card)
    out.update(k1_s64=r["ms_s64"], k1_s192=r["ms_s192"])
    torch.cuda.empty_cache()
    r = cs.phase_k2(card)
    out.update(k2=r["ms"], k1_train=r["k1_train_ms"])
    torch.cuda.empty_cache()
    out["k3"] = cs.phase_k3(card)["ms"]
    torch.cuda.empty_cache()
    r = cs.phase_k6(card)
    out.update(k6_fwd=r["fwd_ms"], k6_bwd=r["bwd_ms"])
    torch.cuda.empty_cache()
    r = cs.phase_k5(card)
    out.update(k5_fwd=r["fwd_ms"], k5_bwd=r["bwd_ms"])
    torch.cuda.empty_cache()
if "k1k2" in phases:
    import chip_smoke as cs
    from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
    from nerf_keras_tpu_torch.ops.sampling import generate_t_vals
    from nerf_keras_tpu_torch.runtime import configure_numerics, cuda_ms
    configure_numerics()
    dev = torch.device("cuda")
    mlp, origins, dirs, t, g_rgb, g_w = cs._k2_inputs(dev)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for s in (64, 192):
            ts = generate_t_vals(2.0, 6.0, (4096,), s, "stratified",
                                 generator=gen).to(dev).contiguous()
            out[f"k1_s{s}"] = cuda_ms(
                lambda: k1.launch_k1(mlp, origins, dirs, ts, 10, 4, train=False), reps=20)
        out["k1_train_s160"] = cuda_ms(
            lambda: k1.launch_k1(mlp, origins, dirs, t, 10, 4, train=True), reps=20)
        _, _, x_enc, preds = k1.launch_k1(mlp, origins, dirs, t, 10, 4, train=True)
        run = lambda: k1.launch_k2(mlp, x_enc, dirs, t, preds, g_rgb, g_w, 10, 4)
        out["k2_s160"] = cuda_ms(run, reps=20)
        out["k2_device_ms"] = cs.device_ms_by_kernel(run, cs.K2_STAGES)
if "k4" in phases:
    import chip_smoke as cs
    r = cs.phase_k4(cs.phase_card())
    out.update({f"k4_{key}": r[f"ms_{key}"] for key in
                ("b4096_s64", "b4096_s192", "b16384_s64", "b16384_s192")})
    torch.cuda.empty_cache()
if "k7" in phases:
    import chip_smoke as cs
    from nerf_keras_tpu_torch import exp_train_paths as etp
    from nerf_keras_tpu_torch.ops.kernels import pdf_union as k7
    from nerf_keras_tpu_torch.runtime import configure_numerics, cuda_ms
    configure_numerics()
    # exp_train_paths.K7_SHAPES and k7_u, written out: older trees lack them.
    for b, s, nf, sorted_u in ((16384, 64, 128, False), (4096, 64, 128, True),
                               (4096, 64, 96, True)):
        t, w = etp.pdf_inputs(b, s, seed=b)
        u = None
        if sorted_u:
            gen = torch.Generator(device="cuda").manual_seed(8)
            u = torch.sort(torch.rand((b, nf), generator=gen, device="cuda"), dim=-1).values
        key = f"k7_b{b}_nf{nf}"
        for name, fn, names in (("", lambda: k7.sample_pdf_union(t, w, nf, u), "pdf_union_kernel"),
                                ("chain_", lambda: k7.sample_pdf_union_reference(t, w, nf, u),
                                 None)):
            dev = cs.device_ms_by_kernel(lambda: [fn() for _ in range(20)],
                                         {"k": (names,) if names else ()})
            out[f"{key}_{name}ms"] = cuda_ms(fn, reps=50)
            out[f"{key}_{name}device_ms"] = (dev["k"] if names else dev["all"]) / 20
if "serve" in phases:
    import tempfile
    from nerf_keras_tpu_torch import load_config, profile_render as pr
    from nerf_keras_tpu_torch.models.mlp import random_params
    from nerf_keras_tpu_torch.serving import RenderService
    from nerf_keras_tpu_torch.utils.checkpoint import save_params_npz
    cfg = load_config(pr.CONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "random.ckpt.npz")
        save_params_npz(ckpt, random_params(cfg, seed=0), cfg, scene={"near": 2.0, "far": 6.0})
        for quant in (False, True):
            svc = RenderService(cfg, ckpt, device="cuda", quant=quant)
            name = "int8" if quant else "float"
            if quant and not svc.use_quant:
                raise RuntimeError(f"the int8 gate failed: {svc.quant_gate_psnr} dB")
            for size, n in pr.FRAMES:
                r = pr.time_requests(svc, size, n)
                out[f"serve_{name}_{size}_s"] = r["median_request_s"]
                out[f"serve_{name}_{size}_render_s"] = r["median_render_image_s"]
            del svc
            torch.cuda.empty_cache()
if "steps" in phases:
    from nerf_keras_tpu_torch.engine.trainer import Trainer
    from nerf_keras_tpu_torch.profile_train import bench_batch, bench_config, parity_config
    for name, cfg in (("proposal", bench_config()), ("parity", parity_config()),
                      ("parity_pdf_grad", parity_config(stop_pdf_gradient=False))):
        tr = Trainer(cfg, 2.0, 6.0, device="cuda")
        batch = tr.put_batch(bench_batch(cfg.batch_size))
        ms, peak, losses = [], 0, []
        for _ in range(14):
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses.append(float(tr.train_step(batch)["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            peak = max(peak, torch.cuda.max_memory_allocated() - base)
        out[f"{name}_median_ms"] = statistics.median(ms[4:])
        out[f"{name}_peak_mib"] = peak / 2**20
        out[f"{name}_loss_first_last"] = [losses[0], losses[-1]]
        del tr
        torch.cuda.empty_cache()
print("TREE " + json.dumps(out), flush=True)
'''


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", help="checkout roots, in run order")
    parser.add_argument("--phases", default="kernels,steps",
                        help="comma-separated: kernels, k1k2, k4, k7, serve, steps")
    parser.add_argument("--timeout", type=float, default=900.0,
                        help="seconds allowed to each tree's process")
    args = parser.parse_args()
    unknown = set(args.phases.split(",")) - {"kernels", "k1k2", "k4", "k7", "serve", "steps"}
    if unknown:
        raise SystemExit(f"unknown phases: {sorted(unknown)}")
    failed = 0
    for tree in args.trees:
        proc = subprocess.run([sys.executable, "-c", _CHILD, args.phases],
                              cwd=os.path.abspath(tree), capture_output=True, text=True,
                              timeout=args.timeout)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TREE ")]
        print(*lines, sep="\n", flush=True)
        if proc.returncode != 0 or not lines:
            failed += 1
            print(f"[compare_trees] {tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
