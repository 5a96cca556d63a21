// K2 on Hopper: the backward of the NeRF ray megakernel (K1).
//
// Replaces the TPU kernel `_bwd_xres_kernel`
// (nerf_keras_tpu/ops/pallas/fused_render.py:453, with `_bwd_core` :362
// and `fused_mlp._mlp_bwd_tile` nerf_keras_tpu/ops/pallas/fused_mlp.py:163;
// pl.pallas_call at fused_render.py:909).
//
// What it computes: the parameter gradients dW/db of the 8x256 NeRF MLP
// for a loss on K1's outputs, given the per-ray rgb cotangent g_rgb and,
// optionally, the per-sample weights cotangent g_w (distortion loss), from
// K1's training residuals (bf16 position encodings, f32 raw predictions).
// Numerics follow the TPU kernel: the compositing is rebuilt as K1 has it
// (1e10 terminal delta, max(1-alpha,0)+1e-10, never reassociated);
//   dw_sum = g_w + sum_c g_rgb[c] * rgb_c
//   dalpha = trans * dw_sum - suffix_excl(w * dw_sum) / (max(1-alpha,0)+1e-10)
//   dsigma = dalpha * (delta * exp(-sigma*delta)) where sigma > 0
//            (the bracket first: with the 1e10 terminal delta, dalpha*delta
//            overflows before exp() cancels it)
//   dlogit_c = g_rgb[c] * alpha * trans * rgb_c * (1 - rgb_c)
// and the MLP's reverse walk takes bf16 operands with f32 accumulation;
// bias gradients sum the f32 dPre.  The weights cotangent is read only
// when the pointer is given.
//
// What bounds it: ~2.4 MFLOP of products per sample at full width (the
// forward recompute, the dX chain and dW), with dW summed over every
// sample of the batch (655,360 at the bench step) into 595,844 f32
// parameters.  The TPU grid runs in order and keeps dW resident in VMEM;
// Hopper's blocks run in parallel with 227 KB of shared memory each, and
// one f32 atomic per parameter per 64-row tile would be ~6e9 atomics.
//
// What the design does about that: three kernels on one stream, no
// atomics, the same sums in the same order on every run (deterministic).
//   1. k2_rows_kernel, one block per R rays (R = max(1, 64/S)), as K1.
//      The stored predictions let it run the per-ray compositing VJP
//      first (one warp per ray; the exclusive suffix sum is a chunk per
//      lane, a warp suffix scan, and a reverse walk of the chunk, not the
//      TPU's log-scan), giving dpreds (rgb logits, sigma) per sample.
//      Then per 64-sample tile it re-encodes the direction per ray,
//      recomputes the MLP from the x_enc residual (same products as K1,
//      so the same ReLU pattern), keeps each ReLU's sign as a bitmask in
//      shared memory, and walks the MLP backwards with the dX products
//      (merged feature+sigma head, skip split: only the hidden columns
//      of a layer input get dX).  Each layer's bf16 input (A) and bf16
//      dPre (D) are written to a global workspace, layer-major,
//      (B*S, width) each; bias sums stay in shared memory and go out as
//      one partial row per block.  Shared memory: a 64-row tile of every
//      layer input would be 2,592 bf16 columns, ~330 KB; spilling A and
//      D leaves two ping-pong tiles, the masks and the bias sums
//      (~112 KB at 8x256, S=160: two blocks per SM).
//   2. k2_dw_kernel: dW = A^T D per layer, contracting over samples, as a
//      tiled product (128x128 output tiles, 8 warps of 32x64, 64-row
//      stages double-buffered with cp.async, fragments by
//      ldmatrix.trans because both operands are sample-major), split over
//      row ranges; each block writes its partial tile to a slab.
//   3. k2_reduce_kernel: sums the dW slabs and the per-block bias rows in
//      a fixed order.
// Orientation: K1's pack is W^T interleaved (row = output column); the
// dX products read W in the other orientation, so K2 has its own pack
// (row = layer input column, k = layer output, same interleave).  Ragged
// edges: rows past a block's last sample get zero dpreds, so they add
// nothing, and the workspace holds only the B*S real samples.  No TF32
// anywhere (bf16 tensor-core products, f32 elsewhere), no fast math.
// wgmma, TMA and keeping A/D on chip are later work.

#include "nerf_tile.cuh"

using namespace nkt;

namespace {

// Per dense layer, where its backward lives.
struct Bwd {
  int a_col;    // A (layer input, bf16) at ws_a + N * a_col, row stride a_width
  int a_width;  // = forward k_pad
  int d_col;    // D (dPre, bf16) at ws_d + N * d_col, row stride d_width
  int d_width;  // = round16(n)
  int out_off;  // dW (a_width x d_width f32) at dw + out_off
};

struct RowParams {
  const __nv_bfloat16* x_res;  // (N, xyz_dim)
  const float* dirs;           // (B, 3)
  const float* t_vals;         // (B, S)
  const float* preds;          // (N, 4)
  const float* g_rgb;          // (B, 3)
  const float* g_w;            // (B, S) or null
  const __nv_bfloat16* w;      // K1 pack
  const float* b;
  const __nv_bfloat16* wb;     // K2 pack (dX products)
  __nv_bfloat16* ws_a;
  __nv_bfloat16* ws_d;
  float* db_part;  // (grid, total_b)
  int B, S, R, N, total_b;
  int num_layers, skip_layer, hidden, mask_words;
  int xyz_dim, xyz_pad, dir_dim, dir_pad, ldx;
  Dense dense[kMaxDense];   // forward (K1 pack)
  Dense bdense[kMaxDense];  // backward dX (K2 pack)
  Bwd bwd[kMaxDense];
};

// rows [0, nrows) x width columns of a bf16 tile (row stride ldx) to
// global rows starting at `row0` of a (N, width) matrix; 16-byte copies.
__device__ __forceinline__ void store_tile(const __nv_bfloat16* src, int ldx,
                                           __nv_bfloat16* dst, int width,
                                           size_t row0, int nrows) {
  const int vecs = width >> 3;
  for (int i = threadIdx.x; i < nrows * vecs; i += kThreads) {
    const int row = i / vecs, v = i - row * vecs;
    *reinterpret_cast<uint4*>(dst + (row0 + row) * width + v * 8) =
        *reinterpret_cast<const uint4*>(src + row * ldx + v * 8);
  }
}

// Two blocks per SM (<= 128 registers, <= 113 KB of shared memory) hide
// the latency of the weight-fragment loads, as in K1.
__global__ void __launch_bounds__(kThreads, 2)
    k2_rows_kernel(const __grid_constant__ RowParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ldx = p.ldx;
  const int R = p.R;
  const int S = p.S;
  const int H = p.hidden;
  const int L = p.num_layers;
  const int MW = p.mask_words;

  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf1 = buf0 + kTileRows * ldx;
  __nv_bfloat16* denc = buf1 + kTileRows * ldx;  // (R, dir_pad)
  uint32_t* masks = reinterpret_cast<uint32_t*>(denc + R * p.dir_pad);
  //                 (L + 1) x (64, MW): trunk layers, then the branch
  float* dpreds = reinterpret_cast<float*>(masks + (L + 1) * kTileRows * MW);
  //                 (R*S, 4): d rgb logits, d sigma
  float* db = dpreds + R * S * 4;  // (total_b), the K1 bias-pack layout
  float* ray_d = db + p.total_b;   // (R, 4)

  const int r0 = blockIdx.x * R;
  const int nrays = min(R, p.B - r0);
  const int P = nrays * S;
  const size_t s0 = (size_t)r0 * S;  // first sample of the block

  for (int i = tid; i < p.total_b; i += kThreads) db[i] = 0.f;
  for (int i = tid; i < R * 3; i += kThreads) {
    const int r = i / 3, c = i - r * 3;
    ray_d[r * 4 + c] = r < nrays ? p.dirs[(size_t)(r0 + r) * 3 + c] : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < R * p.dir_pad; i += kThreads) {
    const int r = i / p.dir_pad, c = i - r * p.dir_pad;
    denc[i] = __float2bfloat16_rn(encode_feature(ray_d + r * 4, c, p.dir_dim));
  }

  // ---- Compositing VJP: one warp per ray, a contiguous chunk per lane.
  const int chunk = (S + 31) / 32;
  for (int r = warp; r < R; r += kWarps) {
    float* dp = dpreds + (size_t)r * S * 4;
    if (r >= nrays) {  // padding ray: contributes nothing
      for (int j = lane; j < S * 4; j += 32) dp[j] = 0.f;
      continue;
    }
    const float* tr = p.t_vals + (size_t)(r0 + r) * S;
    const float* pr = p.preds + (s0 + (size_t)r * S) * 4;
    const float* gw = p.g_w != nullptr ? p.g_w + (size_t)(r0 + r) * S : nullptr;
    const float gr0 = p.g_rgb[(size_t)(r0 + r) * 3 + 0];
    const float gr1 = p.g_rgb[(size_t)(r0 + r) * 3 + 1];
    const float gr2 = p.g_rgb[(size_t)(r0 + r) * 3 + 2];
    const int j0 = min(lane * chunk, S);
    const int j1 = min(j0 + chunk, S);
    float prod = 1.f;
    for (int j = j0; j < j1; ++j) {
      const float delta = j + 1 < S ? tr[j + 1] - tr[j] : kTerminalDelta;
      const float alpha = 1.f - expf(-fmaxf(pr[j * 4 + 3], 0.f) * delta);
      prod *= fmaxf(1.f - alpha, 0.f) + kEps;
    }
    float incl = prod;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl *= v;
    }
    float trans = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) trans = 1.f;
    // Forward walk: p_j = w_j * dw_sum_j (stored), trans_j (stored).
    float psum = 0.f;
    for (int j = j0; j < j1; ++j) {
      const float delta = j + 1 < S ? tr[j + 1] - tr[j] : kTerminalDelta;
      const float alpha = 1.f - expf(-fmaxf(pr[j * 4 + 3], 0.f) * delta);
      float dws = gw != nullptr ? gw[j] : 0.f;
      dws = dws + gr0 * sigmoidf_(pr[j * 4 + 0]);
      dws = dws + gr1 * sigmoidf_(pr[j * 4 + 1]);
      dws = dws + gr2 * sigmoidf_(pr[j * 4 + 2]);
      const float pj = alpha * trans * dws;
      dp[j * 4 + 0] = pj;
      dp[j * 4 + 1] = trans;
      dp[j * 4 + 2] = dws;
      psum += pj;
      trans *= fmaxf(1.f - alpha, 0.f) + kEps;
    }
    // Exclusive suffix over lanes of the chunk sums.
    float sincl = psum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, sincl, off);
      if (lane + off < 32) sincl += v;
    }
    float suffix = __shfl_down_sync(0xffffffffu, sincl, 1);
    if (lane == 31) suffix = 0.f;
    // Reverse walk of the chunk: suffix = sum_{k > j} p_k.
    for (int j = j1 - 1; j >= j0; --j) {
      const float pj = dp[j * 4 + 0];
      const float tj = dp[j * 4 + 1];
      const float dws = dp[j * 4 + 2];
      const float delta = j + 1 < S ? tr[j + 1] - tr[j] : kTerminalDelta;
      const float sigma = fmaxf(pr[j * 4 + 3], 0.f);
      const float alpha = 1.f - expf(-sigma * delta);
      const float dalpha = tj * dws - suffix / (fmaxf(1.f - alpha, 0.f) + kEps);
      suffix += pj;
      const float dsigma = sigma > 0.f ? dalpha * (delta * expf(-sigma * delta)) : 0.f;
      const float gr[3] = {gr0, gr1, gr2};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float rc = sigmoidf_(pr[j * 4 + c]);
        dp[j * 4 + c] = gr[c] * alpha * tj * rc * (1.f - rc);
      }
      dp[j * 4 + 3] = dsigma;
    }
  }
  __syncthreads();

  const Dense& fs = p.dense[L];
  const Dense& br = p.dense[L + 1];
  const Dense& rgb = p.dense[L + 2];
  const int ntiles = (P + kTileRows - 1) / kTileRows;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int q0 = tile * kTileRows;
    const int nrows = min(kTileRows, P - q0);
    const size_t row0 = s0 + q0;  // workspace row of the tile's first sample
    // The x_enc tile (read again from the residual, in L2, for the skip).
    auto load_xenc = [&](__nv_bfloat16* dst) {
      for (int i = tid; i < kTileRows * p.xyz_pad; i += kThreads) {
        const int row = i / p.xyz_pad, c = i - row * p.xyz_pad;
        dst[row * ldx + c] = row < nrows && c < p.xyz_dim
                                 ? p.x_res[(row0 + row) * p.xyz_dim + c]
                                 : __float2bfloat16_rn(0.f);
      }
    };
    load_xenc(buf0);
    for (int i = tid; i < (L + 1) * kTileRows * MW; i += kThreads) masks[i] = 0u;
    __syncthreads();

    // ---- Forward recompute, storing each layer's input (A).
    __nv_bfloat16* in = buf0;
    __nv_bfloat16* out = buf1;
    Epi e{};
    e.mask_words = MW;
    e.rows_valid = nrows;
    for (int i = 0; i < L; ++i) {
      const Dense& d = p.dense[i];
      store_tile(in, ldx, p.ws_a + (size_t)p.N * p.bwd[i].a_col, d.k_pad, row0, nrows);
      e.out = out;
      e.bias = p.b + d.b_off;
      e.mask = masks + i * kTileRows * MW;
      tile_gemm<kReluBf16Mask>(p.w, d, in, ldx, e);
      if (is_skip(i, p.skip_layer)) load_xenc(out + H);
      __syncthreads();
      __nv_bfloat16* tmp = in;
      in = out;
      out = tmp;
    }
    store_tile(in, ldx, p.ws_a + (size_t)p.N * p.bwd[L].a_col, fs.k_pad, row0, nrows);
    e.out = out;
    e.bias = p.b + fs.b_off;
    e.sig = nullptr;  // sigma comes from the stored predictions
    tile_gemm<kFeatureSigma>(p.w, fs, in, ldx, e);
    for (int j = tid; j < kTileRows * p.dir_pad; j += kThreads) {
      const int row = j / p.dir_pad, c = j - row * p.dir_pad;
      const int q = q0 + row;
      out[row * ldx + H + c] =
          q < P ? denc[(q / S) * p.dir_pad + c] : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    store_tile(out, ldx, p.ws_a + (size_t)p.N * p.bwd[L + 1].a_col, br.k_pad, row0, nrows);
    e.out = in;
    e.bias = p.b + br.b_off;
    e.mask = masks + L * kTileRows * MW;
    tile_gemm<kReluBf16Mask>(p.w, br, out, ldx, e);
    __syncthreads();
    store_tile(in, ldx, p.ws_a + (size_t)p.N * p.bwd[L + 2].a_col, rgb.k_pad, row0, nrows);

    // ---- Backward walk.  `out` is free: d rgb logits, bf16, 16 columns.
    const int dw_rgb = p.bwd[L + 2].d_width;
    for (int i = tid; i < kTileRows * dw_rgb; i += kThreads) {
      const int row = i / dw_rgb, c = i - row * dw_rgb;
      const float v = c < 3 && row < nrows ? dpreds[(q0 + row) * 4 + c] : 0.f;
      out[row * ldx + c] = __float2bfloat16_rn(v);
    }
    if (warp == 0) {  // f32 bias sums of the rgb head and the sigma column
      for (int c = 0; c < 4; ++c) {
        float s = 0.f;
        for (int row = lane; row < nrows; row += 32) s += dpreds[(q0 + row) * 4 + c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) {
          if (c < 3) db[rgb.b_off + c] += s;
          else db[fs.b_off + H] += s;
        }
      }
    }
    __syncthreads();
    store_tile(out, ldx, p.ws_d + (size_t)p.N * p.bwd[L + 2].d_col, dw_rgb, row0, nrows);
    // dh2 = drgb W_rgb^T, masked by h2 > 0: dPre of the branch.
    e.out = in;
    e.mask = masks + L * kTileRows * MW;
    e.db = db + br.b_off;
    tile_gemm<kBwdMask>(p.wb, p.bdense[L + 2], out, ldx, e);
    __syncthreads();
    store_tile(in, ldx, p.ws_d + (size_t)p.N * p.bwd[L + 1].d_col,
               p.bwd[L + 1].d_width, row0, nrows);
    // dfeature = dh2 W_br^T (feature columns only): with d sigma, the
    // merged head's dPre [dfeature, dsigma].
    e.out = out;
    e.db = db + fs.b_off;
    tile_gemm<kBwdPlain>(p.wb, p.bdense[L + 1], in, ldx, e);
    const int dw_fs = p.bwd[L].d_width;
    for (int i = tid; i < kTileRows * (dw_fs - H); i += kThreads) {
      const int row = i / (dw_fs - H), c = i - row * (dw_fs - H);
      const float v = c == 0 && row < nrows ? dpreds[(q0 + row) * 4 + 3] : 0.f;
      out[row * ldx + H + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    store_tile(out, ldx, p.ws_d + (size_t)p.N * p.bwd[L].d_col, dw_fs, row0, nrows);
    // dx_last = dfs W_fs^T (hidden columns), masked by h_{L-1} > 0.
    e.out = in;
    e.mask = masks + (L - 1) * kTileRows * MW;
    e.db = db + p.dense[L - 1].b_off;
    tile_gemm<kBwdMask>(p.wb, p.bdense[L], out, ldx, e);
    __syncthreads();
    // Trunk: `in` holds dPre_i; dX_i's hidden columns give dPre_{i-1}.
    for (int i = L - 1; i >= 0; --i) {
      store_tile(in, ldx, p.ws_d + (size_t)p.N * p.bwd[i].d_col,
                 p.bwd[i].d_width, row0, nrows);
      if (i > 0) {
        e.out = out;
        e.mask = masks + (i - 1) * kTileRows * MW;
        e.db = db + p.dense[i - 1].b_off;
        tile_gemm<kBwdMask>(p.wb, p.bdense[i], in, ldx, e);
      }
      __syncthreads();
      __nv_bfloat16* tmp = in;
      in = out;
      out = tmp;
    }
  }

  __syncthreads();
  for (int i = tid; i < p.total_b; i += kThreads)
    p.db_part[(size_t)blockIdx.x * p.total_b + i] = db[i];
}

// ---------------------------------------------------------------------------
// dW = A^T D per layer: M = a_width (layer input), N = d_width (layer
// output), K = samples.  Both operands are stored sample-major, so the
// fragments come from shared memory by ldmatrix.trans.

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kLdS = kBN + 8;  // smem row stride (bf16): 272 B, conflict-free
constexpr int kStageElems = kBK * kLdS;

struct DwLayer {
  int a_col, a_width, d_col, d_width, out_off, tile_start, tiles_n;
};

struct DwParams {
  const __nv_bfloat16* ws_a;
  const __nv_bfloat16* ws_d;
  float* part;  // (nsplit, total_out)
  int N, rows_per_split, n_layers, total_out;
  DwLayer L[kMaxDense];
};

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_ptr);
  const int n = valid ? 16 : 0;  // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem_ptr) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_ptr);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__global__ void __launch_bounds__(kThreads)
    k2_dw_kernel(const __grid_constant__ DwParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kBK][kLdS]
  __nv_bfloat16* sD = sA + 2 * kStageElems;

  int li = 0;
  while (li + 1 < p.n_layers && p.L[li + 1].tile_start <= (int)blockIdx.x) ++li;
  const DwLayer& Ly = p.L[li];
  const int local = blockIdx.x - Ly.tile_start;
  const int m0 = (local / Ly.tiles_n) * kBM;
  const int n0 = (local % Ly.tiles_n) * kBN;
  const __nv_bfloat16* A = p.ws_a + (size_t)p.N * Ly.a_col;
  const __nv_bfloat16* D = p.ws_d + (size_t)p.N * Ly.d_col;
  const int r_begin = blockIdx.y * p.rows_per_split;
  const int r_end = min(p.N, r_begin + p.rows_per_split);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp & 3;   // 32-row slab of M
  const int wn = warp >> 2;  // 64-column slab of N

  float acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  auto load_stage = [&](int buf, int rs) {
    // kBK rows x 16 chunks of 8 bf16, for A and for D.
    for (int i = tid; i < kBK * 16; i += kThreads) {
      const int row = i >> 4, cc = (i & 15) * 8;
      const int gr = rs + row;
      const bool rv = gr < r_end;
      const bool va = rv && m0 + cc < Ly.a_width;
      const bool vd = rv && n0 + cc < Ly.d_width;
      cp_async16(sA + buf * kStageElems + row * kLdS + cc,
                 va ? A + (size_t)gr * Ly.a_width + m0 + cc : A, va);
      cp_async16(sD + buf * kStageElems + row * kLdS + cc,
                 vd ? D + (size_t)gr * Ly.d_width + n0 + cc : D, vd);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int nstages = r_end > r_begin ? (r_end - r_begin + kBK - 1) / kBK : 0;
  if (nstages > 0) load_stage(0, r_begin);
  const int mat = lane >> 3, mr = lane & 7;
  for (int st = 0; st < nstages; ++st) {
    if (st + 1 < nstages) {
      load_stage((st + 1) & 1, r_begin + (st + 1) * kBK);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* a_s = sA + (st & 1) * kStageElems;
    const __nv_bfloat16* d_s = sD + (st & 1) * kStageElems;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // Matrices: (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
        // (k 8-15, m 8-15); transposed they are a0..a3 of A = stored^T.
        const int row = kk * 16 + mr + (mat >> 1) * 8;
        const int col = wm * 32 + mi * 16 + (mat & 1) * 8;
        ldmatrix_x4_trans(af[mi], a_s + row * kLdS + col);
      }
      uint32_t bf[4][4];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15):
        // b0, b1 of n-tile 2nj, then of n-tile 2nj+1.
        const int row = kk * 16 + mr + (mat & 1) * 8;
        const int col = wn * 64 + nj * 16 + (mat >> 1) * 8;
        ldmatrix_x4_trans(bf[nj], d_s + row * kLdS + col);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          mma_bf16_16816(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                         bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  const int g = lane >> 2, tg = lane & 3;
  float* out = p.part + (size_t)blockIdx.y * p.total_out + Ly.out_off;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 32 + mi * 16 + g + half * 8;
        const int n = n0 + wn * 64 + ni * 8 + tg * 2;
        if (m < Ly.a_width && n < Ly.d_width)
          *reinterpret_cast<float2*>(out + (size_t)m * Ly.d_width + n) =
              make_float2(acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
      }
}

// dw[i] = sum_s part[s][i]; db[i] = sum_blk db_part[blk][i]; fixed order.
__global__ void k2_reduce_kernel(const float* part, int nsplit, int total_out,
                                 float* dw, const float* db_part, int nblk,
                                 int total_b, float* db) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total_out) {
    float s = 0.f;
    for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * total_out + i];
    dw[i] = s;
  } else if (i < total_out + total_b) {
    const int j = i - total_out;
    float s = 0.f;
    for (int k = 0; k < nblk; ++k) s += db_part[(size_t)k * total_b + j];
    db[j] = s;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Host arrays: `desc_fwd`
// (n_dense x 5: k_pad, n, n_pad, w_off, b_off of the K1 pack),
// `desc_bwd` (the same for the K2 pack: k_pad = round16(n), n = dX
// columns), `desc_ws` (n_dense x 5: a_col, a_width, d_col, d_width,
// out_off), in the order trunk[0..num_layers), merged head, branch, rgb.
// Workspaces (allocated by the caller): ws_a (N x sum a_width) and ws_d
// (N x sum d_width) bf16, db_part (grid x total_b) and dw_part (nsplit x
// total_out) f32, N = B*S; grid = ceil(B / R), R = max(1, 64 / S).
// Outputs dw (total_out) and db (total_b) f32.  Launches on `stream`,
// returns the first CUDA error (0 on success); does not synchronise.
extern "C" int nkt_fused_render_bwd(
    const void* x_res, const void* dirs, const void* t_vals, const void* preds,
    const void* g_rgb, const void* g_w, const void* w_pack, const void* b_pack,
    const void* desc_fwd, const void* wb_pack, const void* desc_bwd,
    const void* desc_ws, int n_dense, int num_layers, int skip_layer, int hidden,
    int l_xyz, int l_dir, int B, int S, int total_b, int total_out, void* ws_a,
    void* ws_d, void* db_part, void* dw_part, int nsplit, void* dw_out,
    void* db_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S < 2 || num_layers < 1 || skip_layer < 1 || hidden % 32 != 0 ||
      n_dense != num_layers + 3 || n_dense > kMaxDense || nsplit < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  RowParams p;
  p.x_res = static_cast<const __nv_bfloat16*>(x_res);
  p.dirs = static_cast<const float*>(dirs);
  p.t_vals = static_cast<const float*>(t_vals);
  p.preds = static_cast<const float*>(preds);
  p.g_rgb = static_cast<const float*>(g_rgb);
  p.g_w = static_cast<const float*>(g_w);
  p.w = static_cast<const __nv_bfloat16*>(w_pack);
  p.b = static_cast<const float*>(b_pack);
  p.wb = static_cast<const __nv_bfloat16*>(wb_pack);
  p.ws_a = static_cast<__nv_bfloat16*>(ws_a);
  p.ws_d = static_cast<__nv_bfloat16*>(ws_d);
  p.db_part = static_cast<float*>(db_part);
  p.B = B;
  p.S = S;
  p.R = S >= kTileRows ? 1 : kTileRows / S;
  p.N = B * S;
  p.total_b = total_b;
  p.num_layers = num_layers;
  p.skip_layer = skip_layer;
  p.hidden = hidden;
  p.mask_words = hidden / 32;
  p.xyz_dim = 3 + 6 * l_xyz;
  p.xyz_pad = round_up(p.xyz_dim, 16);
  p.dir_dim = 3 + 6 * l_dir;
  p.dir_pad = round_up(p.dir_dim, 16);
  const int kmax = hidden + (p.xyz_pad > p.dir_pad ? p.xyz_pad : p.dir_pad);
  p.ldx = kmax + 8;
  const int* df = static_cast<const int*>(desc_fwd);
  const int* dbw = static_cast<const int*>(desc_bwd);
  const int* dws = static_cast<const int*>(desc_ws);
  DwParams q;
  q.ws_a = p.ws_a;
  q.ws_d = p.ws_d;
  q.part = static_cast<float*>(dw_part);
  q.N = p.N;
  q.n_layers = n_dense;
  q.total_out = total_out;
  int tiles = 0;
  for (int i = 0; i < n_dense; ++i) {
    Dense& d = p.dense[i];
    d = Dense{df[i * 5], df[i * 5 + 1], df[i * 5 + 2], df[i * 5 + 3], df[i * 5 + 4]};
    Dense& bd = p.bdense[i];
    bd = Dense{dbw[i * 5], dbw[i * 5 + 1], dbw[i * 5 + 2], dbw[i * 5 + 3], dbw[i * 5 + 4]};
    Bwd& w = p.bwd[i];
    w = Bwd{dws[i * 5], dws[i * 5 + 1], dws[i * 5 + 2], dws[i * 5 + 3], dws[i * 5 + 4]};
    if (d.k_pad % 16 != 0 || d.k_pad > kmax || d.n_pad % 8 != 0 || d.n > d.n_pad ||
        d.w_off % 8 != 0 || bd.k_pad % 16 != 0 || bd.k_pad > kmax ||
        bd.n_pad % 8 != 0 || bd.n > bd.n_pad || bd.w_off % 8 != 0 ||
        w.a_width != d.k_pad || w.d_width != bd.k_pad || w.d_width % 16 != 0 ||
        (i > 0 && bd.n > kmax) || w.out_off % 2 != 0)
      return (int)cudaErrorInvalidValue;
    DwLayer& l = q.L[i];
    l.a_col = w.a_col;
    l.a_width = w.a_width;
    l.d_col = w.d_col;
    l.d_width = w.d_width;
    l.out_off = w.out_off;
    l.tile_start = tiles;
    l.tiles_n = (w.d_width + kBN - 1) / kBN;
    tiles += ((w.a_width + kBM - 1) / kBM) * l.tiles_n;
  }
  // The merged head's dPre carries [dfeature (hidden), dsigma] in d_width.
  if (p.bwd[num_layers].d_width <= hidden || p.bwd[num_layers + 2].d_width < 3)
    return (int)cudaErrorInvalidValue;

  const int grid = (B + p.R - 1) / p.R;
  const size_t smem =
      sizeof(__nv_bfloat16) * ((size_t)2 * kTileRows * p.ldx + (size_t)p.R * p.dir_pad) +
      sizeof(uint32_t) * (size_t)(num_layers + 1) * kTileRows * p.mask_words +
      sizeof(float) * ((size_t)p.R * S * 4 + (size_t)total_b + (size_t)p.R * 4);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(k2_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  k2_rows_kernel<<<grid, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  q.rows_per_split = ((p.N + nsplit - 1) / nsplit + kBK - 1) / kBK * kBK;
  const size_t smem_dw = sizeof(__nv_bfloat16) * 4 * kStageElems;
  err = cudaFuncSetAttribute(k2_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dw);
  if (err != cudaSuccess) return (int)err;
  k2_dw_kernel<<<dim3(tiles, nsplit), kThreads, smem_dw, st>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n = total_out + total_b;
  k2_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(dw_part), nsplit, total_out, static_cast<float*>(dw_out),
      p.db_part, grid, total_b, static_cast<float*>(db_out));
  return (int)cudaGetLastError();
}
