// The weight gradients of the MLP from the workspaces its backward writes
// (nerf_wgmlp.cuh: mlp_backward_wg for K2, K3, K5 and K6), for
// fused_render_bwd.cu.
//
// dW = A^T D per layer: M = a_width (layer input), N = d_width (layer
// output), K = samples.  The workspaces are stored in 64-sample stages of
// 8-column strips (element (r, c) of a layer of width W at (r / 64) * 64 *
// W + (c / 8) * 512 + (r % 64) * 8 + c % 8), which are the MN-major core
// matrices of wgmma: 8 samples x 16 bytes each, so both operands go to
// shared memory by plain bulk copies (cp.async.bulk, the TMA unit) and
// feed wgmma.mma_async without a transpose.
//
// A block computes a 128 x d_width tile of one layer's dW (two consumer
// warpgroups of 64 rows, the whole d_width, up to 272, in registers) over
// a range of sample stages; a producer warp keeps a ring of 4 stages (the
// block's 128 columns of A and all of D for 64 samples, <= 51,200 B each)
// in flight.  Each block writes (or, for a later chunk, adds) its
// partial tile to its own slab; mlp_reduce_kernel sums the slabs and the
// per-block bias rows in a fixed order.  No atomics: the same sums in the
// same order on every run (deterministic).
//
// What bounds it: the workspace bytes it reads (A once, D once for each
// 128-row tile of a layer: ~15 KB a sample at 8x256), far below the
// products' time; on an H100 it takes what one torch.matmul per layer
// takes for the same A^T D (PERF.md).

#pragma once

#include "nerf_hopper.cuh"
#include "nerf_tile.cuh"

namespace nkt {

constexpr int kDwRows = 64;     // samples per stage
constexpr int kDwM = 128;       // dW rows per block
constexpr int kDwStages = 4;
constexpr int kDwMaxN = 272;
constexpr int kDwThreads = 288;  // two consumer warpgroups and a producer warp
constexpr int kDwABytes = kDwM * kDwRows * 2;

struct DwLayer {
  int a_col, a_width, d_col, d_width, out_off, tile_start;
};

struct DwPlan {
  const __nv_bfloat16* ws_a;
  const __nv_bfloat16* ws_d;
  float* part;  // (nsplit, total_out)
  int rows_pad, total_out, n_layers, tiles, nsplit, stage_bytes;
  int nst, per_split, accumulate;  // set per launch
  DwLayer L[kMaxDense];
};

template <int N>
__device__ __forceinline__ void dw_consume(const DwPlan& p, const DwLayer& Ly, int m0, int s0,
                                           int s1, uint64_t* full, uint64_t* empty,
                                           unsigned char* buf) {
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const bool active = m0 + 64 * wg < Ly.a_width;  // warpgroup-uniform
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  int st = 0, prev = -1;
  uint32_t ph = 0;
  for (int s = s0; s < s1; ++s) {
    mbar_wait(&full[st], ph);
    const uint32_t sa = smem_u32(buf + (size_t)st * p.stage_bytes) + wg * 8 * 1024;
    const uint32_t sd = smem_u32(buf + (size_t)st * p.stage_bytes + kDwABytes);
    if (active) {
      acc_fence<N / 2>(acc);
      wg_fence();
#pragma unroll
      for (int q = 0; q < kDwRows / 16; ++q)
        mma_ss_t<N>(acc, smem_desc(sa + q * 256, 128, 1024), smem_desc(sd + q * 256, 128, 1024),
                    1024, 1);
      wg_commit();
      wg_wait<1>();  // the previous stage's products are done
      acc_fence<N / 2>(acc);
    }
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = st;
    if (++st == kDwStages) {
      st = 0;
      ph ^= 1u;
    }
  }
  if (!active) return;
  wg_wait<0>();
  acc_fence<N / 2>(acc);
  const int g = lane >> 2, t = lane & 3;
  float* out = p.part + (size_t)blockIdx.y * p.total_out + Ly.out_off;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + 64 * wg + 16 * (warp & 3) + g + 8 * half;
    if (m >= Ly.a_width) continue;
    float* row = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      float2* o = reinterpret_cast<float2*>(row + 8 * j + 2 * t);
      const float2 v = make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      if (p.accumulate) {
        const float2 w = *o;
        *o = make_float2(w.x + v.x, w.y + v.y);
      } else {
        *o = v;
      }
    }
  }
}

__global__ void __launch_bounds__(kDwThreads, 1)
    mlp_dw_kernel(const __grid_constant__ DwPlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kDwStages;
  unsigned char* buf = smem + 128;

  int li = 0;
  while (li + 1 < p.n_layers && p.L[li + 1].tile_start <= (int)blockIdx.x) ++li;
  const DwLayer& Ly = p.L[li];
  const int m0 = (blockIdx.x - Ly.tile_start) * kDwM;
  const int s0 = min(p.nst, (int)blockIdx.y * p.per_split);
  const int s1 = min(p.nst, s0 + p.per_split);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kDwStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp
    if (tid == 256) {
      const int a_rows = min(kDwM, Ly.a_width - m0);
      const uint32_t a_bytes = a_rows * kDwRows * 2, d_bytes = Ly.d_width * kDwRows * 2;
      const __nv_bfloat16* A = p.ws_a + (size_t)p.rows_pad * Ly.a_col + (m0 / 8) * 512;
      const __nv_bfloat16* D = p.ws_d + (size_t)p.rows_pad * Ly.d_col;
      int st = 0;
      uint32_t ph = 0;
      for (int s = s0; s < s1; ++s) {
        mbar_wait(&empty[st], ph ^ 1u);
        mbar_expect_tx(&full[st], a_bytes + d_bytes);
        unsigned char* dst = buf + (size_t)st * p.stage_bytes;
        bulk_g2s(dst, A + (size_t)s * kDwRows * Ly.a_width, a_bytes, &full[st]);
        bulk_g2s(dst + kDwABytes, D + (size_t)s * kDwRows * Ly.d_width, d_bytes, &full[st]);
        if (++st == kDwStages) {
          st = 0;
          ph ^= 1u;
        }
      }
    }
    return;
  }
  switch (Ly.d_width) {
    case 16: dw_consume<16>(p, Ly, m0, s0, s1, full, empty, buf); break;
    case 32: dw_consume<32>(p, Ly, m0, s0, s1, full, empty, buf); break;
    case 64: dw_consume<64>(p, Ly, m0, s0, s1, full, empty, buf); break;
    case 80: dw_consume<80>(p, Ly, m0, s0, s1, full, empty, buf); break;
    case 128: dw_consume<128>(p, Ly, m0, s0, s1, full, empty, buf); break;
    case 144: dw_consume<144>(p, Ly, m0, s0, s1, full, empty, buf); break;
    case 256: dw_consume<256>(p, Ly, m0, s0, s1, full, empty, buf); break;
    case 272: dw_consume<272>(p, Ly, m0, s0, s1, full, empty, buf); break;
    default: break;  // refused on the host (dw_plan)
  }
}

// dw[i] = sum_s part[s][i]; db[i] = sum_blk db_part[blk][i]; fixed order.
__global__ void mlp_reduce_kernel(const float* part, int nsplit, int total_out, float* dw,
                                  const float* db_part, int nblk, int total_b, float* db) {
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

inline bool dw_width_ok(int n) {
  return n == 16 || n == 32 || n == 64 || n == 80 || n == 128 || n == 144 || n == 256 ||
         n == 272;
}

// Host side: the dW product's plan for a backward's workspaces (rows_pad
// rows per layer) into dw_part (nsplit x total_out).  False when a layer's
// output width has no instantiation.
inline bool dw_plan(DwPlan& q, const MlpBwdParams& mb, int n_dense, int rows_pad,
                    int total_out, int nsplit, float* dw_part) {
  q.ws_a = mb.ws_a;
  q.ws_d = mb.ws_d;
  q.part = dw_part;
  q.rows_pad = rows_pad;
  q.total_out = total_out;
  q.n_layers = n_dense;
  q.nsplit = nsplit;
  int tiles = 0, dmax = 0;
  for (int i = 0; i < n_dense; ++i) {
    const Bwd& w = mb.bwd[i];
    if (!dw_width_ok(w.d_width) || w.a_width % 16 != 0) return false;
    q.L[i] = DwLayer{w.a_col, w.a_width, w.d_col, w.d_width, w.out_off, tiles};
    tiles += (w.a_width + kDwM - 1) / kDwM;
    dmax = w.d_width > dmax ? w.d_width : dmax;
  }
  q.tiles = tiles;
  q.stage_bytes = kDwABytes + dmax * kDwRows * 2;
  return 128 + (size_t)kDwStages * q.stage_bytes <= (size_t)kMaxSmem;
}

// One dW pass over the first `nst` 64-sample stages of the workspaces;
// `accumulate` adds into the slabs instead of writing them.
inline cudaError_t launch_dw(DwPlan& q, int nst, bool accumulate, cudaStream_t st) {
  q.nst = nst;
  q.per_split = (nst + q.nsplit - 1) / q.nsplit;
  q.accumulate = accumulate ? 1 : 0;
  const int smem = 128 + kDwStages * q.stage_bytes;
  cudaError_t err =
      cudaFuncSetAttribute(mlp_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mlp_dw_kernel<<<dim3(q.tiles, q.nsplit), kDwThreads, smem, st>>>(q);
  return cudaGetLastError();
}

// The fixed-order reduce into dw_out (total_out) and db_out (total_b).
inline cudaError_t launch_reduce(const float* dw_part, int nsplit, int total_out, float* dw_out,
                                 const float* db_part, int nblk, int total_b, float* db_out,
                                 cudaStream_t st) {
  const int n = total_out + total_b;
  mlp_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(dw_part, nsplit, total_out, dw_out,
                                                     db_part, nblk, total_b, db_out);
  return cudaGetLastError();
}

}  // namespace nkt
