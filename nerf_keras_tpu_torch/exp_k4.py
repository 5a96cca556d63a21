"""K4's design measurements on one card: patched copies of the kernel, timed in turn.

    python -m nerf_keras_tpu_torch.exp_k4 prepare SRC OUT VARIANT [VARIANT ...]
    python -m nerf_keras_tpu_torch.exp_k4 time TREE [TREE ...]

``prepare`` copies the port of the checkout SRC (``nerf_keras_tpu_torch``,
``chip_smoke.py``, ``config``) into ``OUT/<variant>`` for each variant,
keeps only K4's source among the CUDA sources and applies the variant's
text patches to ``csrc/quant_render_fwd.cu``.  Make OUT a directory that
``.gitignore`` lists (``_archive/``), so git leaves it out of commits.  Each
variant answers one question about where K4's time goes; a patched kernel
computes wrong values on purpose (its errors against the plain version are
printed beside its time):

* on the mma.sync K4 (``git archive 85a3a73``, its first design):
  ``pr7_noconv`` (no int/float conversion in the epilogue: raw bits stored),
  ``pr7_smemw`` (B fragments from a shared-memory copy instead of each
  warp's ``__ldg`` stream from L2), ``pr7_both``;
* on the wgmma K4: ``noepi`` (the epilogue stores the accumulators' low
  bytes), ``noenc`` (the position encoding skipped), ``bare`` (no
  encoding, no epilogue, no compositing: the products and their
  synchronisation alone), ``nocopy`` (the producer issues no weight copy),
  ``pipe`` (a layer's next stage issued while the previous one's products
  run, ``wgmma.wait_group 1``), ``split`` (a relu layer's columns as two
  ``wgmma`` groups, the first half's epilogue while the second half's
  products run), ``prof`` (clock64 counters: the share of the consumer
  warps' cycles in each phase);
* ``as_is``: no patch.

``time`` runs each TREE in a process of its own, in the order given (name
a tree twice to interleave), and prints one JSON line per tree: K4 at the
server's chunk (B=16384, S=64 and 192) and at B=4096, S=192 on calibrated
int8 tables of random weights (``chip_smoke``'s), CUDA events, median of
20, with the errors against the plain version, and for ``prof`` the phase
shares.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

_NOCONV = [
    ("  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);\n"
     "  return static_cast<int8_t>(__float2int_rn(q));",
     "  return static_cast<int8_t>(__float_as_int(__fmul_rn(v, inv)));"),
    ("(float)acc[mt][s][half * 2 + 0]", "__int_as_float(acc[mt][s][half * 2 + 0])"),
    ("(float)acc[mt][s][half * 2 + 1]", "__int_as_float(acc[mt][s][half * 2 + 1])"),
]
_SMEMW = [
    ("namespace {\n", "namespace {\n__shared__ uint2 g_wsm[4096];\n"),
    ("bcur[s] = valid[s] ? __ldg(bptr[s]) : make_uint2(0u, 0u);",
     "bcur[s] = valid[s] ? g_wsm[(lane + 32 * (16 * s)) & 4095] : make_uint2(0u, 0u);"),
    ("? __ldg(bptr[s] + (ks + 1) * 4)", "? g_wsm[(lane + 32 * (ks + 1 + 16 * s)) & 4095]"),
    ("  __syncthreads();\n  // Direction features",
     "  for (int i = tid; i < 4096; i += kThreads) g_wsm[i] = "
     "reinterpret_cast<const uint2*>(p.w)[i];\n  __syncthreads();\n  // Direction features"),
]
_EPI = ('''    store2(act + g * ldx + c, requant<kRelu>(dequant<kMagic>(acc[4 * j], s.x, b.x), iv.x),
           requant<kRelu>(dequant<kMagic>(acc[4 * j + 1], s.y, b.y), iv.y));
    store2(act + (g + 8) * ldx + c,
           requant<kRelu>(dequant<kMagic>(acc[4 * j + 2], s.x, b.x), iv.x),
           requant<kRelu>(dequant<kMagic>(acc[4 * j + 3], s.y, b.y), iv.y));''')
_NOEPI = [(_EPI, '''    store2(act + g * ldx + c, acc[4 * j], acc[4 * j + 1]);
    store2(act + (g + 8) * ldx + c, acc[4 * j + 2], acc[4 * j + 3]);''')]
_NOENC = [("  if (ok) {\n    const float* o = ray", "  if (row < -1) {\n    const float* o = ray"),
          ("    const int8_t b = ok ? static_cast<int8_t>(requant<false>(v, inv_x[c])) : int8_t(0);",
           "    const int8_t b = 0;\n    (void)v;"),
          ("      sincosf(__fmul_rn(x[d], scale), &sn, &cs);", "      sn = cs = scale;")]
_BARE = _NOENC + [
    (_EPI, "    if (acc[4 * j] == 123456789) store2(act + g * ldx + c, acc[4 * j], acc[4 * j + 1]);"),
    ("  composite_rays(p.t_vals + s0,", "  if (S < 0) composite_rays(p.t_vals + s0,"),
]
_NOCOPY = [('''    mbar_expect_tx(&r.full[p.st], bytes);
    bulk_g2s(r.buf + static_cast<size_t>(p.st) * r.stage_bytes,
             w + L.w_off + static_cast<size_t>(k0) * L.n_pad, bytes, &r.full[p.st]);''',
            "    (void)bytes;\n    mbar_arrive(&r.full[p.st]);")]
_LOOP = '''  for (int k0 = 0; k0 < k_pad; k0 += kQKs) {
    const int steps = min(kQKs, k_pad - k0) >> 5;  // block-uniform
    uint32_t a[kSteps][4];
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps) load_a_s8(a[q], act, ldx, k0 + 32 * q);
    mbar_wait(&r.full[c.st], c.ph);
    const uint32_t sb = smem_u32(r.buf + static_cast<size_t>(c.st) * r.stage_bytes);
    acc_fence<N / 2>(acc);
    wg_fence();
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps) mma_rs_s8<N>(acc, a[q], smem_desc(sb + q * 2 * N * 16, N * 16, 128), 128, 1);
    wg_commit();
    wg_wait<0>();
    acc_fence<N / 2>(acc);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[c.st]);
    c.next(r.stages);
  }
'''
_PIPE = [(_LOOP, '''  uint32_t a[2][kSteps][4];
  int prev = -1;
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const int k0 = it * kQKs;
    if (k0 >= k_pad) break;
    const int steps = min(kQKs, k_pad - k0) >> 5;
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps) load_a_s8(a[it & 1][q], act, ldx, k0 + 32 * q);
    mbar_wait(&r.full[c.st], c.ph);
    const uint32_t sb = smem_u32(r.buf + static_cast<size_t>(c.st) * r.stage_bytes);
    acc_fence<N / 2>(acc);
    wg_fence();
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps)
        mma_rs_s8<N>(acc, a[it & 1][q], smem_desc(sb + q * 2 * N * 16, N * 16, 128), 128, 1);
    wg_commit();
    wg_wait<1>();
    acc_fence<N / 2>(acc);
    if (prev >= 0) {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[prev]);
    }
    prev = c.st;
    c.next(r.stages);
  }
  wg_wait<0>();
  acc_fence<N / 2>(acc);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[prev]);
''')]
# A relu layer's N columns as two wgmma groups (every A fragment and stage
# of the layer first): the first half's epilogue runs while the second
# half's products do.
_SPLIT_FN = '''template <int N>
__device__ __forceinline__ void q_layer_split(int* acc, int8_t* act, int ldx, const QDense& L,
                                              const float* f, const WRing& r, RingPos& c) {
  constexpr int NH = N / 2;
  constexpr int kSteps = kQKs / 32;
  uint32_t a[3][kSteps][4];
  uint32_t sb[3];
  int st[3];
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const int k0 = it * kQKs;
    if (k0 < L.k_pad) {
      const int steps = min(kQKs, L.k_pad - k0) >> 5;
#pragma unroll
      for (int q = 0; q < kSteps; ++q)
        if (q < steps) load_a_s8(a[it][q], act, ldx, k0 + 32 * q);
      mbar_wait(&r.full[c.st], c.ph);
      sb[it] = smem_u32(r.buf + static_cast<size_t>(c.st) * r.stage_bytes);
      st[it] = c.st;
      c.next(r.stages);
    }
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  acc_fence<N / 2>(acc);
  wg_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      const int k0 = it * kQKs;
      if (k0 < L.k_pad) {
        const int steps = min(kQKs, L.k_pad - k0) >> 5;
#pragma unroll
        for (int q = 0; q < kSteps; ++q)
          if (q < steps)
            mma_rs_s8<NH>(acc + h * NH / 2, a[it][q],
                          smem_desc(sb[it] + q * 2 * N * 16 + h * NH * 16, N * 16, 128), 128, 1);
      }
    }
    wg_commit();
  }
  wg_wait<1>();
  acc_fence<NH / 2>(acc);
  epi_relu_q<NH>(acc, f, L, act, ldx);
  wg_wait<0>();
  acc_fence<N / 2>(acc);
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int it = 0; it < 3; ++it)
      if (it * kQKs < L.k_pad) mbar_arrive(&r.empty[st[it]]);
  epi_relu_q<NH>(acc + NH / 2, f + NH, L, act + NH, ldx);
}

'''
_SPLIT = [
    ("// The merged head (N = hidden + 8)", _SPLIT_FN + "// The merged head (N = hidden + 8)"),
    ("    q_product<H>(acc, act, ldx, m.dense[i].k_pad, ring, rp);\n"
     "    epi_relu_q<H>(acc, f, m.dense[i], act, ldx);",
     "    q_layer_split<H>(acc, act, ldx, m.dense[i], f, ring, rp);"),
    ("  q_product<H / 2>(acc, act, ldx, m.dense[L + 1].k_pad, ring, rp);\n"
     "  epi_relu_q<H / 2>(acc, f, m.dense[L + 1], act, ldx);",
     "  q_layer_split<H / 2>(acc, act, ldx, m.dense[L + 1], f, ring, rp);"),
]
# clock64 counters per consumer warp, summed over the grid (PHASES order).
PHASES = ["wait_full", "mma", "epilogue_trunk", "encode", "all", "final_sync", "composite"]
_PROF = [
    ("namespace {\n", '''__device__ unsigned long long g_prof[8];
extern "C" int nkt_k4_prof(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
extern "C" int nkt_k4_prof_reset() {
  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
namespace {
__shared__ long long g_sprof[8][8];
#define PROF_ADD(i, v) \\
  do { if ((threadIdx.x & 31) == 0) g_sprof[threadIdx.x >> 5][i] += (v); } while (0)
'''),
    ("    mbar_wait(&r.full[c.st], c.ph);\n    const uint32_t sb",
     "    long long c0 = clock64();\n    mbar_wait(&r.full[c.st], c.ph);\n"
     "    PROF_ADD(0, clock64() - c0);\n    c0 = clock64();\n    const uint32_t sb"),
    ("    wg_wait<0>();\n    acc_fence<N / 2>(acc);\n    __syncwarp();",
     "    wg_wait<0>();\n    acc_fence<N / 2>(acc);\n    PROF_ADD(1, clock64() - c0);\n"
     "    __syncwarp();"),
    ("    epi_relu_q<H>(acc, f, m.dense[i], act, ldx);",
     "    long long e0 = clock64();\n    epi_relu_q<H>(acc, f, m.dense[i], act, ldx);\n"
     "    PROF_ADD(2, clock64() - e0);"),
    ("    encode_rows(m, ray, p.t_vals + s0, S, q0, valid, inv_x, wact, wxq);",
     "    long long n0 = clock64();\n"
     "    encode_rows(m, ray, p.t_vals + s0, S, q0, valid, inv_x, wact, wxq);\n"
     "    PROF_ADD(3, clock64() - n0);"),
    ("  reg_alloc<kConsumerRegs>();",
     "  reg_alloc<kConsumerRegs>();\n  if (lane < 8) g_sprof[warp][lane] = 0;\n  __syncwarp();\n"
     "  const long long a0 = clock64();"),
    ("  consumer_sync(kWgConsumers);\n\n  composite_rays(",
     "  const long long m0 = clock64();\n  consumer_sync(kWgConsumers);\n"
     "  PROF_ADD(5, clock64() - m0);\n  const long long k0c = clock64();\n  composite_rays("),
    ("                 p.rgb_out + (size_t)r0 * 3);\n}",
     "                 p.rgb_out + (size_t)r0 * 3);\n  PROF_ADD(6, clock64() - k0c);\n"
     "  PROF_ADD(4, clock64() - a0);\n  __syncwarp();\n"
     "  if (lane < 8) atomicAdd(&g_prof[lane], (unsigned long long)g_sprof[warp][lane]);\n}"),
]

VARIANTS = {
    "as_is": [], "pr7_noconv": _NOCONV, "pr7_smemw": _SMEMW, "pr7_both": _NOCONV + _SMEMW,
    "noepi": _NOEPI, "noenc": _NOENC, "bare": _BARE, "nocopy": _NOCOPY, "pipe": _PIPE,
    "split": _SPLIT,
    "prof": _PROF,
}


def patch_source(src: str, variant: str) -> str:
    """K4's source with the variant's patches; raises if one does not apply."""
    for old, new in VARIANTS[variant]:
        if old not in src:
            raise ValueError(f"{variant}: the source has no {old[:60]!r}")
        src = src.replace(old, new)
    return src


def prepare(src_root: str, out: str, variants: list[str]) -> None:
    for variant in variants:
        dst = os.path.join(out, variant)
        shutil.rmtree(dst, ignore_errors=True)
        os.makedirs(dst)
        shutil.copytree(os.path.join(src_root, "nerf_keras_tpu_torch"),
                        os.path.join(dst, "nerf_keras_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copytree(os.path.join(src_root, "config"), os.path.join(dst, "config"))
        shutil.copy(os.path.join(src_root, "chip_smoke.py"), dst)
        csrc = os.path.join(dst, "nerf_keras_tpu_torch", "csrc")
        for name in os.listdir(csrc):
            if name.endswith(".cu") and name != "quant_render_fwd.cu":
                os.remove(os.path.join(csrc, name))
        path = os.path.join(csrc, "quant_render_fwd.cu")
        with open(path) as fh:
            text = patch_source(fh.read(), variant)
        with open(path, "w") as fh:
            fh.write(text)


_CHILD = r'''
import ctypes, json, os, sys
sys.path.insert(0, os.getcwd())
import torch
from nerf_keras_tpu_torch.ops.kernels import _build, quant_render as k4
from nerf_keras_tpu_torch.ops.rays import get_rays, pose_spherical
from nerf_keras_tpu_torch.ops.sampling import generate_t_vals
from nerf_keras_tpu_torch.runtime import card_string, configure_numerics, cuda_ms
import chip_smoke as cs
phases = json.loads(sys.argv[1])
configure_numerics()
lib = _build.load("quant_render_fwd")
dev = torch.device("cuda")
qp = cs._calibrated_qparams(cs.full_mlp(dev, 4), dev)
o, d = get_rays(128, 128, 153.6, pose_spherical(30.0, -30.0, 4.0), device=dev)
o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
gen = torch.Generator().manual_seed(4)
out = {"tree": os.getcwd(), "card": card_string(),
       "ptxas": [ln.strip() for ln in _build.build_log.splitlines()
                 if ("registers" in ln or "spill" in ln) and "C7519" not in ln]}
for b, s in ((16384, 64), (16384, 192), (4096, 192)):
    t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
    ob, db = o[:b].contiguous(), d[:b].contiguous()
    run = lambda: k4.launch_k4(qp, ob, db, t, 10, 4, 4)
    got = run()
    out[f"err_b{b}_s{s}"] = cs._errs(got, k4.render_rays_reference_quant(qp, ob, db, t))
    out[f"ms_b{b}_s{s}"] = cuda_ms(run, reps=20)
    if hasattr(lib, "nkt_k4_prof"):
        torch.cuda.synchronize()
        lib.nkt_k4_prof_reset()
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 8)()
        lib.nkt_k4_prof(ctypes.cast(buf, ctypes.c_void_p))
        out[f"share_b{b}_s{s}"] = {p: buf[i] / buf[4] for i, p in enumerate(phases)}
print("K4VAR " + json.dumps(out), flush=True)
'''


def time_trees(trees: list[str]) -> int:
    failed = 0
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(PHASES)],
                              cwd=os.path.abspath(tree), capture_output=True, text=True,
                              timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("K4VAR ")]
        print(*lines, sep="\n", flush=True)
        if proc.returncode != 0 or not lines:
            failed += 1
            print(f"[exp_k4] {tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}",
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
