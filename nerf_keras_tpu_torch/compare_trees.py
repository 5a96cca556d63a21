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
  over what was allocated before it);
* ``f32``: COMPUTE_DTYPE=float32 at 8x256 (``chip_smoke._suite_mlp``),
  B=4096, S=192: the f32 K1 in both forms, K6's and K5's forwards (N =
  786,432), K2 and K5's backward with input gradients, each alone (CUDA
  events, median of 5) with its device ms per kernel
  (``chip_smoke.device_ms_by_kernel``: the compositing VJP,
  ``f32_rows_kernel``, ``f32_dw_kernel``, the reduce, the forward and its
  compositing), the forwards' plain f32 versions beside them and their
  relative L2 to the float64 yardstick (``chip_smoke._f64_yardstick``);
  ``fused_render_f32.cu``'s ``-Xptxas -v`` report; then the f32 parity and
  proposal steps as in ``steps``; a run of this phase alone builds only
  the f32 source;
* ``wide``: hidden 512 (``chip_smoke._suite_mlp``/``_suite_inputs``, the
  same seeds in every tree): K1, K1's training form and K2 at B=4096,
  S=192, and K3, K5 (forward, backward without input gradients) and K6
  (forward, backward) at the ``widths`` phase's B=1,024, S=64, each alone
  (CUDA events, median of 10; K2 of 5), K2's device ms per kernel
  (``chip_smoke.device_ms_by_kernel``: the VJP, the rows kernel, dW, the
  reduce), the ``-Xptxas -v`` lines of the 512 instantiations, K2 at 8x256
  (B=4096, S=160) and K4 at 8x512 and 8x256 (the server's chunk, 16384
  rays at S=192; median of 5), then the 8x512 parity step
  (``chip_smoke.wide_config``) as in ``steps``; every
  output is saved, and the last line (``BITS``) says, kernel by kernel,
  whether each tree's outputs equal the first tree's bit for bit, or the
  largest difference; a run of this phase alone builds only the bf16 MLP
  sources and K4's;
* ``wide1024``: the same at hidden 1024 (the column passes of the
  hidden-1024 kernels): K1, K1's training form and K2 at B=4096, S=192,
  K3, K5 and K6 at B=1,024, S=64, K2's device ms per kernel with the dW
  product's library call (one ``torch.matmul`` of A^T D a layer), K4 at
  the server's chunk with its library call (``torch._int_mm`` a layer),
  the 1024 instantiations' ``-Xptxas -v`` lines, then the
  8x1024 parity step; the outputs' bits against the first tree's in a last
  line ``BITS1024``;
* ``decode``: the tree's image decoders on the card's host (no kernel;
  a run of this phase alone builds none): an 800x800 RGBA PNG whose every
  row is Paeth, at 8 and 16 bits (written once by this tree's
  ``chip_smoke._paeth_frame`` and ``_paeth_png``), and the views of the committed baseline and
  progressive JPEG captures; Mpx/s of the median of up to 5 passes (fewer
  where one pass takes over 2 s), or the error a tree's decoder raises.

Prints one JSON line per tree and phase, prefixed ``TREE``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

_CHILD = r'''
import json, os, statistics, sys, time
sys.path.insert(0, os.getcwd())
import torch
from nerf_keras_tpu_torch.ops.kernels import _build

phases = sys.argv[1].split(",")
out = {"tree": os.getcwd()}
if phases in (["k7"], ["f32"]):
    _build._sources = lambda: [_build.CSRC / ("pdf_union.cu" if phases == ["k7"] else
                                              "fused_render_f32.cu")]
if set(phases) <= {"wide", "wide1024"}:  # those of these sources the tree has
    _build._sources = lambda: [p for p in (_build.CSRC / f"{stem}.cu" for stem in (
        "fused_render_fwd", "fused_render_bwd", "fused_render_bwd_512", "fused_render_bwd_1024",
        "fused_mlp_fwd", "quant_render_fwd")) if p.exists()]
if phases != ["decode"]:
    _build.build()


def time_steps(prefix, configs):
    from nerf_keras_tpu_torch.engine.trainer import Trainer
    from nerf_keras_tpu_torch.profile_train import bench_batch
    for name, cfg in configs:
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
        out[f"{prefix}{name}_median_ms"] = statistics.median(ms[4:])
        out[f"{prefix}{name}_peak_mib"] = peak / 2**20
        out[f"{prefix}{name}_loss_first_last"] = [losses[0], losses[-1]]
        del tr
        torch.cuda.empty_cache()


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
    from nerf_keras_tpu_torch.profile_train import bench_config, parity_config
    time_steps("", (("proposal", bench_config()), ("parity", parity_config()),
                    ("parity_pdf_grad", parity_config(stop_pdf_gradient=False))))
if "f32" in phases:
    import dataclasses
    import chip_smoke as cs
    from nerf_keras_tpu_torch.profile_train import bench_config, parity_config
    from nerf_keras_tpu_torch.runtime import configure_numerics, cuda_ms
    configure_numerics()
    log = _build.build_log.split("== fused_render_f32.cu")[-1].split("\n== ")[0]
    out["f32_ptxas"] = [ln.strip() for ln in log.splitlines()
                        if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
    dev = torch.device("cuda")
    mlp = cs._suite_mlp(dev, 256, seed=27, dtype=torch.float32)
    x = cs._suite_inputs(mlp, 4096, 192, seed=27)
    calls = cs._suite_calls(mlp, x)
    families = {"vjp": ("composite_vjp_kernel",), "rows": ("f32_rows_kernel",),
                "dw": ("f32_dw_kernel",), "reduce": ("mlp_reduce_kernel",),
                "fwd": ("f32_fwd_kernel",), "composite": ("f32_composite_kernel",)}
    plain = cs._suite_plain(mlp, x)
    with torch.no_grad():
        for name in ("k1", "k1_train", "k6_fwd", "k5_fwd", "k2", "k5_bwd"):
            out[f"f32_{name}_ms"] = cuda_ms(calls[name], reps=5)
            out[f"f32_{name}_device_ms"] = cs.device_ms_by_kernel(calls[name], families)
            if name in ("k1", "k1_train", "k6_fwd", "k5_fwd"):
                out[f"f32_{name}_plain_ms"] = cuda_ms(plain[name], reps=5)
                with cs._f64_yardstick():
                    want = plain[name]()
                out[f"f32_{name}_rel_l2"] = cs._suite_errors(calls[name](), want)["rel_l2"]
                del want
    del mlp, x, calls, plain
    torch.cuda.empty_cache()
    time_steps("f32_", [(name, dataclasses.replace(cfg, compute_dtype="float32").validate())
                        for name, cfg in (("proposal", bench_config()),
                                          ("parity", parity_config()))])
if "wide" in phases:
    import re
    import chip_smoke as cs
    from nerf_keras_tpu_torch.runtime import configure_numerics, cuda_ms
    configure_numerics()
    name = None
    out["wide_ptxas"] = []
    for ln in _build.build_log.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if found:
            name = found.group(1)
        elif name and ("ILi512E" in name or "wide" in name or "pair" in name) and (
                "Used" in ln or "spill" in ln):
            out["wide_ptxas"].append(f"{name}: {ln.strip()}")
    dev = torch.device("cuda")
    saved = {}
    for b, s, names in ((4096, 192, ("k1", "k1_train", "k2")),
                        (1024, 64, ("k3", "k5_fwd", "k5_bwd", "k6_fwd", "k6_bwd"))):
        mlp = cs._suite_mlp(dev, 512, seed=525)
        x = cs._suite_inputs(mlp, b, s, seed=525)
        calls = cs._suite_calls(mlp, x)
        with torch.no_grad():
            for name in names:
                saved[name] = [t.detach().cpu() for t in calls[name]()]
                out[f"wide_{name}_ms"] = cuda_ms(calls[name], reps=5 if name == "k2" else 10)
            if "k2" in names:
                out["wide_k2_device_ms"] = cs.device_ms_by_kernel(calls["k2"], cs.K2_STAGES)
        del mlp, x, calls
        torch.cuda.empty_cache()
    # K2 at 8x256 and K4 at 8x512 and 8x256 (the server's chunk, 16384 rays
    # of a 128x128 pose at S=192), beside the 512 kernels: the 8x256 code
    # paths keep their bits and times.
    from nerf_keras_tpu_torch.ops.kernels import quant_render as k4
    from nerf_keras_tpu_torch.ops.rays import get_rays, pose_spherical
    from nerf_keras_tpu_torch.ops.sampling import generate_t_vals
    mlp = cs._suite_mlp(dev, 256, seed=525)
    x = cs._suite_inputs(mlp, 4096, 160, seed=525)
    calls = cs._suite_calls(mlp, x)
    with torch.no_grad():
        saved["k2_256"] = [t.detach().cpu() for t in calls["k2"]()]
        out["wide_k2_256_ms"] = cuda_ms(calls["k2"], reps=5)
    del mlp, x, calls
    o, d = get_rays(128, 128, 153.6, pose_spherical(30.0, -30.0, 4.0), device=dev)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    t = generate_t_vals(2.0, 6.0, (o.shape[0],), 192, "stratified",
                        generator=torch.Generator().manual_seed(4)).to(dev).contiguous()
    for hidden in (512, 256):
        qp = cs._calibrated_qparams(cs._suite_mlp(dev, hidden, seed=526), dev)
        run = lambda: k4.render_rays_fused_quant(qp, o, d, t)  # noqa: E731
        saved[f"k4_{hidden}"] = [a.cpu() for a in run()]
        out[f"wide_k4_{hidden}_ms"] = cuda_ms(run, reps=5)
        del qp
    torch.cuda.empty_cache()
    torch.save(saved, os.path.join(sys.argv[2], f"wide_{sys.argv[3]}.pt"))
    del saved
    time_steps("wide_", (("parity", cs.wide_config()),))
if "wide1024" in phases:
    import re
    import chip_smoke as cs
    from nerf_keras_tpu_torch.ops.kernels import quant_render as k4
    from nerf_keras_tpu_torch.ops.rays import get_rays, pose_spherical
    from nerf_keras_tpu_torch.ops.sampling import generate_t_vals
    from nerf_keras_tpu_torch.runtime import configure_numerics, cuda_ms
    configure_numerics()
    name = None
    out["wide1024_ptxas"] = []
    for ln in _build.build_log.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if found:
            name = found.group(1)
        elif name and ("ILi1024E" in name or "Li1024" in name) and ("Used" in ln or "spill" in ln):
            out["wide1024_ptxas"].append(f"{name}: {ln.strip()}")
    dev = torch.device("cuda")
    saved = {}
    for b, s, names in ((4096, 192, ("k1", "k1_train", "k2")),
                        (1024, 64, ("k3", "k5_fwd", "k5_bwd", "k6_fwd", "k6_bwd"))):
        mlp = cs._suite_mlp(dev, 1024, seed=1025)
        x = cs._suite_inputs(mlp, b, s, seed=1025)
        calls = cs._suite_calls(mlp, x)
        with torch.no_grad():
            for name in names:
                saved[name] = [t.detach().cpu() for t in calls[name]()]
                out[f"wide1024_{name}_ms"] = cuda_ms(calls[name], reps=5 if name == "k2" else 10)
            if "k2" in names:
                out["wide1024_k2_device_ms"] = cs.device_ms_by_kernel(calls["k2"], cs.K2_STAGES)
        if "k2" in names:
            out["wide1024_dw_library_ms"] = cs._dw_library_ms(mlp, dev, b * s)
        del mlp, x, calls
        torch.cuda.empty_cache()
    o, d = get_rays(128, 128, 153.6, pose_spherical(30.0, -30.0, 4.0), device=dev)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    t = generate_t_vals(2.0, 6.0, (o.shape[0],), 192, "stratified",
                        generator=torch.Generator().manual_seed(4)).to(dev).contiguous()
    qp = cs._calibrated_qparams(cs._suite_mlp(dev, 1024, seed=1026), dev)
    run = lambda: k4.render_rays_fused_quant(qp, o, d, t)  # noqa: E731
    saved["k4_1024"] = [a.cpu() for a in run()]
    out["wide1024_k4_ms"] = cuda_ms(run, reps=5)
    out["wide1024_k4_library_ms"] = cs.library_products_ms(
        k4.kernel_pack(qp, dev).desc, o.shape[0] * 192, torch.int8, dev)
    del qp
    torch.cuda.empty_cache()
    torch.save(saved, os.path.join(sys.argv[2], f"wide1024_{sys.argv[3]}.pt"))
    del saved
    time_steps("wide1024_", (("parity", cs.wide_config(1024)),))
if "decode" in phases:
    from nerf_keras_tpu_torch.utils import jpeg, png

    def rate(decode, blobs):
        """Mpx/s over ``blobs`` (the median pass), or the decoder's error."""
        try:
            img = [decode(b) for b in blobs][-1]  # the first pass builds the library
            runs = []
            while len(runs) < 5 and sum(runs) < 2.0:
                t0 = time.perf_counter()
                for b in blobs:
                    decode(b)
                runs.append(time.perf_counter() - t0)
        except ValueError as e:
            return {"error": str(e)[:200]}
        mpx = len(blobs) * img.shape[0] * img.shape[1] / 1e6
        return {"mpx_per_s": mpx / statistics.median(runs), "passes_s": runs}

    for depth in (8, 16):
        with open(os.path.join(sys.argv[2], f"paeth{depth}.png"), "rb") as f:
            out[f"decode_png_rgba{depth}_paeth"] = rate(png.decode_png, [f.read()])
    for capture in ("capture", "capture_progressive"):
        d = os.path.join("tests", "fixtures", "torch_jpeg", capture, "images")
        if os.path.isdir(d):
            blobs = [open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))]
            out[f"decode_jpeg_{capture}"] = rate(jpeg.decode_jpeg, blobs)
print("TREE " + json.dumps(out), flush=True)
'''


def _same_bits(tmp: str, trees: list[str], phase: str = "wide") -> dict:
    """Per tree after the first and per kernel of the ``wide`` (or
    ``wide1024``) phase: True where every output equals the first tree's
    bit for bit, else the largest absolute difference (a tree that saved
    nothing: None)."""
    import torch

    runs = [os.path.join(tmp, f"{phase}_{i}.pt") for i in range(len(trees))]
    if not os.path.exists(runs[0]):
        return {}
    first = torch.load(runs[0])
    report = {}
    for i, (tree, path) in enumerate(zip(trees[1:], runs[1:]), 1):
        if not os.path.exists(path):
            report[f"{i} {tree}"] = None
            continue
        other = torch.load(path)
        report[f"{i} {tree}"] = {
            name: all(torch.equal(a, b) for a, b in zip(outs, other[name])) or max(
                float((a.float() - b.float()).abs().max()) for a, b in zip(outs, other[name]))
            for name, outs in first.items()}
    return report


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", help="checkout roots, in run order")
    parser.add_argument("--phases", default="kernels,steps",
                        help="comma-separated: kernels, k1k2, k4, k7, serve, steps, f32, "
                             "wide, wide1024, decode")
    parser.add_argument("--timeout", type=float, default=900.0,
                        help="seconds allowed to each tree's process")
    args = parser.parse_args()
    unknown = set(args.phases.split(",")) - {"kernels", "k1k2", "k4", "k7", "serve", "steps",
                                             "f32", "wide", "wide1024", "decode"}
    if unknown:
        raise SystemExit(f"unknown phases: {sorted(unknown)}")
    pngs = tempfile.TemporaryDirectory()
    if "decode" in args.phases.split(","):
        from chip_smoke import _paeth_frame, _paeth_png

        rgba16 = _paeth_frame()
        for depth, img in ((8, rgba16 >> 8), (16, rgba16)):
            with open(os.path.join(pngs.name, f"paeth{depth}.png"), "wb") as f:
                f.write(_paeth_png(img, depth))
    failed = 0
    for i, tree in enumerate(args.trees):
        proc = subprocess.run([sys.executable, "-c", _CHILD, args.phases, pngs.name, str(i)],
                              cwd=os.path.abspath(tree), capture_output=True, text=True,
                              timeout=args.timeout)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TREE ")]
        print(*lines, sep="\n", flush=True)
        if proc.returncode != 0 or not lines:
            failed += 1
            print(f"[compare_trees] {tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
    if "wide" in args.phases.split(","):
        print("BITS " + json.dumps(_same_bits(pngs.name, args.trees)), flush=True)
    if "wide1024" in args.phases.split(","):
        print("BITS1024 " + json.dumps(_same_bits(pngs.name, args.trees, "wide1024")),
              flush=True)
    pngs.cleanup()
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
