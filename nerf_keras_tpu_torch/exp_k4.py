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
* at hidden 512 and 1024, on the persistent K4 (``quant_render_wide_kernel``,
  clusters of two blocks that share each weight stage):
  ``nopipe`` (each stage's products waited on before the next stage's
  issue), ``enc1`` (the encode by warpgroup 0 alone, the other waiting),
  ``dequant_split`` (float(acc) above 2^22 as two magic-number halves,
  exact for |acc| < 2^24, in place of cvt.rn.f32.s32), ``ks32`` (32-deep
  weight stages: 7 in the ring instead of 3), ``fglobal`` (the f32 rows
  read from global memory through L1 instead of copied to shared memory:
  4 stages), ``fglobal_ks32`` (both: 8); ``nocopy`` and ``noepi`` apply
  there too, and ``pipe`` to the K4 before it;
* ``as_is``: no patch.

``time`` runs each TREE in a process of its own, in the order given (name
a tree twice to interleave), and prints one JSON line per tree: K4 at the
server's chunk (B=16384, S=64 and 192) and at B=4096, S=192 on calibrated
int8 tables of random weights (``chip_smoke``'s), CUDA events, median of
20, with the errors against the plain version (over chunks of 4,096
rays), and for ``prof`` the phase shares.  With ``--hidden 512`` or
``1024``: K4 on an 8x512 or 8x1024 model's tables at B=16384 and 4096,
S=192 and at B=100, S=100 (median of 5), with a digest of its outputs (the
same bits across trees), its weight bytes from L2 a launch (the int8 pack
once a 64-row tile, or once for the two tiles of a cluster where the tree
runs clusters) and the rate that gives.
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
_NOCOPY = [('''      mbar_expect_tx(&r.full[p.st], bytes);
      if (r.peer < 0) {
        bulk_g2s(dst, from, bytes, &r.full[p.st]);
      } else {  // bytes: a multiple of 256 (np a multiple of 8, 32 k at least)
        const uint32_t half = bytes / 2, off = r.peer ? 0u : half;
        bulk_g2s_multicast(dst + off, from + off, half, &r.full[p.st], 0x3);
      }''', "      (void)bytes;\n      (void)dst;\n      (void)from;\n      mbar_arrive(&r.full[p.st]);")]
_LOOP = '''  for (int k0 = 0; k0 < k_pad; k0 += KQ) {
    const int steps = min(KQ, k_pad - k0) >> 5;  // block-uniform
    uint32_t a[kSteps][4];
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps) load_a_s8(a[q], act, ldx, k0 + 32 * q);
    mbar_wait(&r.full[c.st], c.ph);
    const uint32_t sb = smem_u32(r.buf + static_cast<size_t>(c.st) * r.stage_bytes) + n0 * 16;
    acc_fence<N / 2>(acc);
    wg_fence();
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps)
        mma_rs_s8<N>(acc, a[q], smem_desc(sb + q * 2 * np * 16, np * 16, 128), 128, 1);
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
  for (int it = 0; it < 10; ++it) {  // a layer's stages: at most 3 of 128 k, or 9 of 64
    const int k0 = it * KQ;
    if (k0 >= k_pad) break;
    const int steps = min(KQ, k_pad - k0) >> 5;
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps) load_a_s8(a[it & 1][q], act, ldx, k0 + 32 * q);
    mbar_wait(&r.full[c.st], c.ph);
    const uint32_t sb = smem_u32(r.buf + static_cast<size_t>(c.st) * r.stage_bytes) + n0 * 16;
    acc_fence<N / 2>(acc);
    wg_fence();
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps)
        mma_rs_s8<N>(acc, a[it & 1][q], smem_desc(sb + q * 2 * np * 16, np * 16, 128), 128, 1);
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
  epi_relu_q<NH>(acc, f + L.f_off, L.n_pad, L.k_pad <= kMagicK, act, ldx);
  wg_wait<0>();
  acc_fence<N / 2>(acc);
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int it = 0; it < 3; ++it)
      if (it * kQKs < L.k_pad) mbar_arrive(&r.empty[st[it]]);
  epi_relu_q<NH>(acc + NH / 2, f + L.f_off + NH, L.n_pad, L.k_pad <= kMagicK, act + NH, ldx);
}

'''
# (On the 128-row tile only: hidden 512's split tile keeps its products.)
_SPLIT = [
    ("// The merged head (N = hidden + 8)", _SPLIT_FN + "// The merged head (N = hidden + 8)"),
    ("    q_layer_passes<H, H>(acc, act, ldx, Ly.k_pad, ring, rp, park,",
     "    if constexpr (!T::kSplit) {\n"
     "      q_layer_split<H>(acc, act, ldx, Ly, f, ring, rp);\n"
     "    } else q_layer_passes<H, H>(acc, act, ldx, Ly.k_pad, ring, rp, park,"),
    ("  q_layer_product<H, H / 2>(acc, act, ldx, m.dense[L + 1].k_pad, ring, rp);\n  {\n",
     "  if constexpr (!T::kSplit) {\n"
     "    q_layer_split<H / 2>(acc, act, ldx, m.dense[L + 1], f, ring, rp);\n"
     "  } else {\n"
     "  q_layer_product<H, H / 2>(acc, act, ldx, m.dense[L + 1].k_pad, ring, rp);\n"),
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
    ("                           layer_relu_q<H, decltype(w)::value>(a, fl, sd, Ly, dst, ld);",
     "                           long long e0 = clock64();\n"
     "                           layer_relu_q<H, decltype(w)::value>(a, fl, sd, Ly, dst, ld);\n"
     "                           PROF_ADD(2, clock64() - e0);"),
    ("    encode_rows(m, ray, p.t_vals + s0, S, q0, valid, inv_x, wact, wxq);\n    auto dir4",
     "    long long n0 = clock64();\n"
     "    encode_rows(m, ray, p.t_vals + s0, S, q0, valid, inv_x, wact, wxq);\n"
     "    PROF_ADD(3, clock64() - n0);\n    auto dir4"),
    ("  mbar_wait(fbar, 0);  // the f32 rows are in shared memory\n\n  // Direction",
     "  mbar_wait(fbar, 0);  // the f32 rows are in shared memory\n"
     "  if (lane < 8) g_sprof[warp][lane] = 0;\n  __syncwarp();\n"
     "  const long long a0 = clock64();\n\n  // Direction"),
    ("  consumer_sync(kWgConsumers);\n\n  composite_rays(",
     "  const long long m0 = clock64();\n  consumer_sync(kWgConsumers);\n"
     "  PROF_ADD(5, clock64() - m0);\n  const long long k0c = clock64();\n  composite_rays("),
    ("                 p.rgb_out + (size_t)r0 * 3);\n}",
     "                 p.rgb_out + (size_t)r0 * 3);\n  PROF_ADD(6, clock64() - k0c);\n"
     "  PROF_ADD(4, clock64() - a0);\n  __syncwarp();\n"
     "  if (lane < 8) atomicAdd(&g_prof[lane], (unsigned long long)g_sprof[warp][lane]);\n}"),
]

_NOPIPE = [("    q_product_pipe<P::width, KQ>(acc, act, ldx, k_pad, r, c, N, n0);",
            "    q_product<P::width, KQ>(acc, act, ldx, k_pad, r, c, N, n0);")]
_ENC1 = [("      encode_rows_split(m, ray, p.t_vals + s0, S, q0, valid, inv_x, wact, wxq);",
          "      if (col_part<H>() == 0)\n"
          "        encode_rows(m, ray, p.t_vals + s0, S, q0, valid, inv_x, wact, wxq);")]
_KS32 = [("constexpr int kQKsSplit = 64;", "constexpr int kQKsSplit = 32;")]
_FGLOBAL = [
    ("  constexpr bool kFGlobal = T::kParked;  // the f32 rows staged from global memory (FStage)",
     "  constexpr bool kFGlobal = true;  // the f32 rows read from global memory"),
    ("(parked ? (size_t)rows * kPassCols : (size_t)p.m.f_bytes)",
     "(parked ? (size_t)rows * kPassCols : hidden == 512 ? 0 : (size_t)p.m.f_bytes)")]
_DEQUANT_SPLIT = [(
    "  return kMagic ? __fsub_rn(__int_as_float(acc + kRoundBits), kRound) : __int2float_rn(acc);",
    "  if (kMagic) return __fsub_rn(__int_as_float(acc + kRoundBits), kRound);\n"
    "  const float hi = __fsub_rn(__int_as_float((acc >> 12) + kRoundBits), kRound);\n"
    "  const float lo = __fsub_rn(__int_as_float((acc & 0xfff) | 0x4B000000), 8388608.f);\n"
    "  return __fadd_rn(__fmul_rn(hi, 4096.f), lo);")]

VARIANTS = {
    "as_is": [], "pr7_noconv": _NOCONV, "pr7_smemw": _SMEMW, "pr7_both": _NOCONV + _SMEMW,
    "noepi": _NOEPI, "noenc": _NOENC, "bare": _BARE, "nocopy": _NOCOPY, "pipe": _PIPE,
    "split": _SPLIT,
    "prof": _PROF,
    "nopipe": _NOPIPE, "enc1": _ENC1, "dequant_split": _DEQUANT_SPLIT,
    "ks32": _KS32, "fglobal": _FGLOBAL, "fglobal_ks32": _FGLOBAL + _KS32,
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
import ctypes, hashlib, json, math, os, sys
sys.path.insert(0, os.getcwd())
import torch
from nerf_keras_tpu_torch.ops.kernels import _build, quant_render as k4
from nerf_keras_tpu_torch.ops.rays import get_rays, pose_spherical
from nerf_keras_tpu_torch.ops.sampling import generate_t_vals
from nerf_keras_tpu_torch.runtime import card_string, configure_numerics, cuda_ms
import chip_smoke as cs
phases, hidden = json.loads(sys.argv[1]), int(sys.argv[2])
configure_numerics()
lib = _build.load("quant_render_fwd")
dev = torch.device("cuda")
mlp = cs.full_mlp(dev, 4) if hidden == 256 else cs._suite_mlp(dev, hidden, seed=526)
qp = cs._calibrated_qparams(mlp, dev)
o, d = get_rays(128, 128, 153.6, pose_spherical(30.0, -30.0, 4.0), device=dev)
o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
gen = torch.Generator().manual_seed(4)
out = {"tree": os.getcwd(), "card": card_string(),
       "ptxas": [ln.strip() for ln in _build.build_log.splitlines()
                 if ("registers" in ln or "spill" in ln) and "C7519" not in ln]}
shapes = ((16384, 64), (16384, 192), (4096, 192)) if hidden == 256 else (
    (16384, 192), (4096, 192), (100, 100))
if hidden != 256:
    pack = k4.kernel_pack(qp, dev)
    out["pack_bytes"] = pack.w.numel()
for b, s in shapes:
    t = generate_t_vals(2.0, 6.0, (b,), s, "stratified", generator=gen).to(dev).contiguous()
    ob, db = o[:b].contiguous(), d[:b].contiguous()
    run = lambda: k4.launch_k4(qp, ob, db, t, 10, 4, 4)
    got = run()
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for x in got:
        h.update(x.cpu().numpy().tobytes())
    out[f"digest_b{b}_s{s}"] = h.hexdigest()[:16]
    out[f"err_b{b}_s{s}"] = cs._errs(got, cs._plain_k4(qp, ob, db, t, 4096))
    del got
    out[f"ms_b{b}_s{s}"] = cuda_ms(run, reps=20 if hidden == 256 else 5)
    if hidden != 256:
        r = 1 if s >= 640 else min(64 // math.gcd(s, 64), max(640 // s, 1))  # rays a group
        clustered = "bulk_g2s_multicast" in open(
            "nerf_keras_tpu_torch/csrc/quant_render_fwd.cu").read()
        gb = out["pack_bytes"] * -(-b // r) * -(-r * s // 64) / (2 if clustered else 1) / 1e9
        out[f"l2_weight_gb_b{b}_s{s}"] = gb
        out[f"l2_weight_tb_per_s_b{b}_s{s}"] = gb / out[f"ms_b{b}_s{s}"]
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


def time_trees(trees: list[str], hidden: int = 256) -> int:
    failed = 0
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(PHASES), str(hidden)],
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
    t.add_argument("--hidden", type=int, choices=(256, 512, 1024), default=256)
    t.add_argument("trees", nargs="+")
    args = parser.parse_args()
    if args.cmd == "prepare":
        prepare(args.src, args.out, args.variants)
    else:
        sys.exit(1 if time_trees(args.trees, args.hidden) else 0)


if __name__ == "__main__":
    main()
