"""K7's design measurements on one card: patched copies of the kernel, timed in turn.

    python -m nerf_keras_tpu_torch.exp_k7 prepare SRC OUT VARIANT [VARIANT ...]
    python -m nerf_keras_tpu_torch.exp_k7 time TREE [TREE ...]

``prepare`` copies the port of the checkout SRC (``nerf_keras_tpu_torch``,
``chip_smoke.py``, ``config``) into ``OUT/<variant>`` for each variant,
keeps only K7's source among the CUDA sources, applies the variant's text
patches to ``csrc/pdf_union.cu`` (and to its wrapper,
``ops/kernels/pdf_union.py``), and appends to the source an empty kernel
with a C entry point of its own (``nkt_k7_empty``).  Make OUT a directory
that ``.gitignore`` lists (``_archive/``).  The variants answer where the
first design's time went (``git archive 66f1db1`` gives it):

* ``as_is``: no patch (also for the redesigned kernel);
* ``float_cdf``: the pdf and cdf accumulated in float, not double;
* ``scan``: each binary search replaced by a linear scan that goes on from
  the lane's previous answer (a lane's values are ascending);
* ``cached``: the host work cached: the eval grid made once per
  ``(NF, device)``, the kernel's shared-memory attribute set once, and
  ``cudaSetDevice`` only when the device changes.

On the redesigned K7 (merge paths, this checkout):

* ``min4``, ``min5``: registers for 4 or 5 blocks of 256 threads a SM,
  not 6;
* ``lanes32``: a whole warp per ray, not half a warp;
* ``nodiv``: the draw's IEEE division replaced by a product with the
  reciprocal (wrong in the last bit; for its cost only);
* ``unroll``: the loop over a lane's draws unrolled by 4;
* ``fused``: the draw computed in the bin lookup's walk, at every step
  (stored to a spare slot when the step takes a cdf entry), in place of
  its own loop;
* ``warps4``: blocks of 4 warps (12 a SM) in place of 8 (6 a SM);
* ``u_cg``: u copied by ``cp.async.cg`` (L2 only) as t is, not through L1;
* ``prof``: clock64 counters: the share of a ray's cycles (its first
  lane's) in each phase (``PHASES``); ``lanes32_prof`` the same on a
  whole warp per ray.

``time`` runs each TREE in a process of its own, in the order given (name a
tree twice to interleave), and prints one JSON line per tree with, at each
of three shapes (the render chunk B=16384, S=64, NF=128 on the eval grid;
the parity step's B=4096, S=64, NF=128 and the bench recipe's NF=96, both
on sorted uniforms): the call time of ``sample_pdf_union`` (CUDA events
around the Python call, median of 50), the device time of
``pdf_union_kernel`` (``torch.profiler``, mean of 20 launches), the call
and device time of the empty kernel launched through ctypes on the first
design's grid (8 rays a block of 256 threads, its shared memory): the floor
of a launch, the ``sample_pdf`` + ``sorted_union`` chain's call time and
device time summed over its kernels, and K7's errors against the chain.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

KERNEL = "csrc/pdf_union.cu"
WRAPPER = "ops/kernels/pdf_union.py"

_FLOAT_CDF = {KERNEL: [("double", "float")]}
_SCAN = {KERNEL: [
    ("  for (int j = lane; j < NF; j += 32) {\n    const float u = ur[j];\n"
     "    const int below = max(0, min(upper_bound(cdf, K, u) - 1, K - 1));",
     "  int cur = 0;\n  for (int j = lane; j < NF; j += 32) {\n    const float u = ur[j];\n"
     "    while (cur < K && cdf[cur] <= u) ++cur;\n"
     "    const int below = max(0, min(cur - 1, K - 1));"),
    ("  for (int i = lane; i < S; i += 32) row[i + lower_bound(tf, NF, ts[i])] = ts[i];\n"
     "  for (int j = lane; j < NF; j += 32) row[j + upper_bound(ts, S, tf[j])] = tf[j];",
     "  for (int i = lane, c = 0; i < S; i += 32) {\n"
     "    while (c < NF && tf[c] < ts[i]) ++c;\n    row[i + c] = ts[i];\n  }\n"
     "  for (int j = lane, c = 0; j < NF; j += 32) {\n"
     "    while (c < S && ts[c] <= tf[j]) ++c;\n    row[j + c] = tf[j];\n  }"),
]}
_CACHED = {
    KERNEL: [
        ("  cudaError_t err = cudaSetDevice(device);\n  if (err != cudaSuccess) return (int)err;",
         "  int current = -1;\n  cudaError_t err = cudaGetDevice(&current);\n"
         "  if (err != cudaSuccess) return (int)err;\n"
         "  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) "
         "return (int)err;"),
        ("  err = cudaFuncSetAttribute(pdf_union_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
         "                             (int)smem);\n  if (err != cudaSuccess) return (int)err;",
         "  static bool opened = false;\n  if (!opened) {\n"
         "    err = cudaFuncSetAttribute(pdf_union_kernel, "
         "cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);\n"
         "    if (err != cudaSuccess) return (int)err;\n    opened = true;\n  }"),
    ],
    WRAPPER: [
        ("        u, u_stride = eval_grid(ns_fine, device), 0",
         "        u, u_stride = _grid(ns_fine, device), 0"),
        ("\ndef sample_pdf_union_eval(",
         "\nimport functools\n_grid = functools.lru_cache(maxsize=16)(eval_grid)\n\n\n"
         "def sample_pdf_union_eval("),
    ],
}
# The bin lookup's walk and the draws' loop, as the source has them, and the
# two fused into one walk.
_BINS_AND_DRAWS = """  // ---- Bin lookup: merge the cdf (a) with u (b).  Taking u[j] after i cdf
  // entries records #{cdf <= u[j]} = i in tf[j] (as the float's bits).  The
  // sentinels end each input and a step has no branch: both loads, one
  // compare, a store (to the spare slot tf[NF] when a cdf entry is taken).
  {
    const int n = K + NF, per = (n + kLanes - 1) / kLanes;
    const int d0 = min(hl * per, n), d1 = min(d0 + per, n);
    int i = merge_path<2>(&cm[0].x, K, us, NF, d0), j = d0 - i;
    for (int d = d0; d < d1; ++d) {
      const bool take_a = cm[i].x <= us[j];
      tf[take_a ? NF : j] = __int_as_float(i);
      i += take_a;
      j += !take_a;
    }
  }
  __syncwarp(mask);  // bins

  // ---- Inverse CDF per u, in place of its bin.
  for (int j = hl; j < NF; j += kLanes) {
    const int below = max(__float_as_int(tf[j]) - 1, 0);
    const int above = min(below + 1, K - 1);
    const float2 b = cm[below], a = cm[above];
    float denom = __fsub_rn(a.x, b.x);
    if (denom < 1e-5f) denom = 1.f;
    const float frac = __fdiv_rn(__fsub_rn(us[j], b.x), denom);
    tf[j] = __fadd_rn(b.y, __fmul_rn(frac, __fsub_rn(a.y, b.y)));
  }
  if (hl == 0) tf[NF] = inf();
  __syncwarp(mask);  // fine

"""
_FUSED = """  // ---- Bin lookup and draw in one walk (the draw of every step; kept
  // when the step takes a u, else stored to the spare slot tf[NF + 1]).
  {
    const int n = K + NF, per = (n + kLanes - 1) / kLanes;
    const int d0 = min(hl * per, n), d1 = min(d0 + per, n);
    int i = merge_path<2>(&cm[0].x, K, us, NF, d0), j = d0 - i;
    for (int d = d0; d < d1; ++d) {
      const float2 hi = cm[i], lo = cm[max(i - 1, 0)];
      const float u = us[j];
      const bool take_a = hi.x <= u;
      const float2 a = i < K ? hi : lo;
      float denom = __fsub_rn(a.x, lo.x);
      if (denom < 1e-5f) denom = 1.f;
      const float frac = __fdiv_rn(__fsub_rn(u, lo.x), denom);
      tf[take_a ? NF + 1 : j] = __fadd_rn(lo.y, __fmul_rn(frac, __fsub_rn(a.y, lo.y)));
      i += take_a;
      j += !take_a;
    }
  }
  if (hl == 0) tf[NF] = inf();
  __syncwarp(mask);  // bins
  __syncwarp(mask);  // fine

"""
# clock64 counters per ray, summed over the grid (PHASES order; "all" last).
PHASES = ["load", "cdf", "bins", "fine", "union", "store", "all"]
_PROF = {KERNEL: [
    ("namespace {\n", """__device__ unsigned long long g_prof[8];
extern "C" int nkt_k7_prof(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
extern "C" int nkt_k7_prof_reset() {
  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
#define PROF(i) do { const long long c_ = clock64(); \\
  if (hl == 0) atomicAdd(&g_prof[i], (unsigned long long)(c_ - pc)); pc = c_; } while (0)
namespace {
"""),
    ("  if (ray >= p.B) return;  // uniform over the ray's lanes\n",
     "  if (ray >= p.B) return;  // uniform over the ray's lanes\n"
     "  long long pc = clock64();\n  const long long p0 = pc;\n"),
    ("  __syncwarp(mask);  // loaded\n", "  __syncwarp(mask);  // loaded\n  PROF(0);\n"),
    ("  __syncwarp(mask);  // cdf\n", "  __syncwarp(mask);  // cdf\n  PROF(1);\n"),
    ("  __syncwarp(mask);  // bins\n", "  __syncwarp(mask);  // bins\n  PROF(2);\n"),
    ("  __syncwarp(mask);  // fine\n", "  __syncwarp(mask);  // fine\n  PROF(3);\n"),
    ("  __syncwarp(mask);  // union\n", "  __syncwarp(mask);  // union\n  PROF(4);\n"),
    ("    for (int k = hl; k < M; k += kLanes) out[k] = row[k];\n  }\n}\n",
     "    for (int k = hl; k < M; k += kLanes) out[k] = row[k];\n  }\n  PROF(5);\n"
     "  if (hl == 0) atomicAdd(&g_prof[6], (unsigned long long)(pc - p0));\n}\n"),
]}
VARIANTS = {
    "as_is": {}, "float_cdf": _FLOAT_CDF, "scan": _SCAN, "cached": _CACHED,
    "min4": {KERNEL: [("constexpr int kMinBlocks = 6;", "constexpr int kMinBlocks = 4;")]},
    "min5": {KERNEL: [("constexpr int kMinBlocks = 6;", "constexpr int kMinBlocks = 5;")]},
    "lanes32": {KERNEL: [("constexpr int kLanes = 16;", "constexpr int kLanes = 32;")]},
    "nodiv": {KERNEL: [("__fdiv_rn(__fsub_rn(us[j], b.x), denom)",
                        "__fmul_rn(__fsub_rn(us[j], b.x), __frcp_rn(denom))")]},
    "unroll": {KERNEL: [("  for (int j = hl; j < NF; j += kLanes) {\n    const int below",
                         "#pragma unroll 4\n  for (int j = hl; j < NF; j += kLanes) {\n"
                         "    const int below")]},
    "prof": _PROF,
    "fused": {KERNEL: [("  p.stride = p.off_tf + pad4(p.NF + 1);",
                        "  p.stride = p.off_tf + pad4(p.NF + 2);"),
                       (_BINS_AND_DRAWS, _FUSED)]},
    "u_cg": {KERNEL: [("cp_async16<true>(us", "cp_async16<false>(us")]},
    "warps4": {KERNEL: [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;"),
                        ("constexpr int kMinBlocks = 6;", "constexpr int kMinBlocks = 12;")]},
    "lanes32_prof": {KERNEL: [("constexpr int kLanes = 16;", "constexpr int kLanes = 32;"),
                              *_PROF[KERNEL]]},
}

# The floor of a launch: an empty kernel on the first design's grid.
_EMPTY = '''
namespace {
__global__ void k7_empty_kernel(int) {}
}  // namespace

extern "C" int nkt_k7_empty(int grid, int smem, void* stream) {
  k7_empty_kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(0);
  return (int)cudaGetLastError();
}
'''

# (B, S, NF, sorted uniforms): the render chunk, the parity step, the bench recipe.
SHAPES = [(16384, 64, 128, False), (4096, 64, 128, True), (4096, 64, 96, True)]


def patch_text(text: str, patches: list, what: str) -> str:
    """``text`` with each ``(old, new)`` replaced; raises if one does not apply."""
    for old, new in patches:
        if old not in text:
            raise ValueError(f"{what}: no {old[:60]!r}")
        text = text.replace(old, new)
    return text


def prepare(src_root: str, out: str, variants: list[str]) -> None:
    for variant in variants:
        dst = os.path.join(out, variant)
        shutil.rmtree(dst, ignore_errors=True)
        os.makedirs(dst)
        pkg = os.path.join(dst, "nerf_keras_tpu_torch")
        shutil.copytree(os.path.join(src_root, "nerf_keras_tpu_torch"), pkg,
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copytree(os.path.join(src_root, "config"), os.path.join(dst, "config"))
        shutil.copy(os.path.join(src_root, "chip_smoke.py"), dst)
        csrc = os.path.join(pkg, "csrc")
        for name in os.listdir(csrc):
            if name.endswith(".cu") and name != "pdf_union.cu":
                os.remove(os.path.join(csrc, name))
        for rel in (KERNEL, WRAPPER):
            path = os.path.join(pkg, rel)
            with open(path) as fh:
                text = patch_text(fh.read(), VARIANTS[variant].get(rel, []),
                                  f"{variant} {rel}")
            if rel == KERNEL:
                text += _EMPTY
            with open(path, "w") as fh:
                fh.write(text)


_CHILD = r'''
import ctypes, json, os, sys
sys.path.insert(0, os.getcwd())
import torch
from nerf_keras_tpu_torch import exp_train_paths as etp
from nerf_keras_tpu_torch.ops.kernels import _build, pdf_union as k7
from nerf_keras_tpu_torch.runtime import card_string, configure_numerics, cuda_ms
import chip_smoke as cs
REPS = 20
configure_numerics()
lib = _build.load("pdf_union")
empty = lib.nkt_k7_empty
empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
empty.restype = ctypes.c_int
out = {"tree": os.getcwd(), "card": card_string(),
       "ptxas": [ln.strip() for ln in _build.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]}

def device_ms(fn, names):
    r = cs.device_ms_by_kernel(lambda: [fn() for _ in range(REPS)], {"k": names})
    return r["k"] / REPS, r["all"] / REPS

for b, s, nf, sorted_u in json.loads(sys.argv[1]):
    t, w = etp.pdf_inputs(b, s, seed=b)
    u = None
    if sorted_u:
        gen = torch.Generator(device="cuda").manual_seed(8)
        u = torch.sort(torch.rand((b, nf), generator=gen, device="cuda"), dim=-1).values
    run = lambda: k7.sample_pdf_union(t, w, nf, u)
    chain = lambda: k7.sample_pdf_union_reference(t, w, nf, u)
    stream = torch.cuda.current_stream().cuda_stream
    floor = lambda: empty((b + 7) // 8, 4 * 8 * (3 * s + 1 + 2 * nf), stream)
    out[f"b{b}_s{s}_nf{nf}"] = {
        "u": "sorted" if sorted_u else "eval",
        "err": etp.union_errors(run(), chain()),
        "call_ms": cuda_ms(run, reps=50),
        "device_ms": device_ms(run, ("pdf_union_kernel",))[0],
        "empty_call_ms": cuda_ms(floor, reps=50),
        "empty_device_ms": device_ms(floor, ("k7_empty_kernel",))[0],
        "chain_call_ms": cuda_ms(chain, reps=50),
        "chain_device_ms": device_ms(chain, ())[1],
    }
    if hasattr(lib, "nkt_k7_prof"):
        torch.cuda.synchronize()
        lib.nkt_k7_prof_reset()
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 8)()
        lib.nkt_k7_prof(ctypes.cast(buf, ctypes.c_void_p))
        out[f"b{b}_s{s}_nf{nf}"]["shares"] = {
            p: buf[i] / buf[6] for i, p in enumerate(json.loads(sys.argv[2])[:6])}
        out[f"b{b}_s{s}_nf{nf}"]["cycles_per_ray"] = buf[6] / b
print("K7VAR " + json.dumps(out), flush=True)
'''


def time_trees(trees: list[str]) -> int:
    failed = 0
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(SHAPES),
                               json.dumps(PHASES)],
                              cwd=os.path.abspath(tree), capture_output=True, text=True,
                              timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("K7VAR ")]
        print(*lines, sep="\n", flush=True)
        if proc.returncode != 0 or not lines:
            failed += 1
            print(f"[exp_k7] {tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
    return failed


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("prepare")
    p.add_argument("src")
    p.add_argument("out")
    p.add_argument("variants", nargs="+", choices=sorted(VARIANTS))
    t = sub.add_parser("time")
    t.add_argument("trees", nargs="+")
    args = parser.parse_args()
    if args.cmd == "prepare":
        prepare(args.src, args.out, args.variants)
    else:
        sys.exit(1 if time_trees(args.trees) else 0)


if __name__ == "__main__":
    main()
