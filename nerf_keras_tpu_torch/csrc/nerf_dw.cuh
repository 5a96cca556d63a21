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
// A block computes a 128 x n tile of one layer's dW (two consumer
// warpgroups of 64 rows, n columns in registers) over a range of sample
// stages: n is the whole d_width, up to 272 (kDwMaxN).  A producer warp
// keeps a ring of 4 stages (the block's 128 columns of A and its n columns
// of D for 64 samples, <= 51,200 B each) in flight.  Each block writes
// (or, for a later chunk, adds) its partial tile to its own slab;
// mlp_reduce_kernel sums the slabs and the per-block bias rows in a fixed
// order.  No atomics: the same sums in the same order on every run
// (deterministic).
//
// What bounds it: the workspace bytes it reads (A once, D once for each
// 128-row tile of a layer: ~15 KB a sample at 8x256), far below the
// products' time; on an H100 it takes what one torch.matmul per layer
// takes for the same A^T D (PERF.md).
//
// The split tile's widths (hidden 512: d_width 512 and 528; 1024: 1024
// and 1040) run mlp_dw_window_kernel: the same block, ring and sums as a
// persistent walk over units of up to 128 rows by 256 D columns, which the
// host cuts and spreads evenly over the SMs ("The split tile's walk"
// below).

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

// One layer: dW of its (a_width, d_width) = n.
struct DwLayer {
  int a_col, a_width, d_col, d_width, out_off, tile_start, n;
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
    float* row = out + (size_t)m * Ly.d_width;
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
      const uint32_t a_bytes = a_rows * kDwRows * 2, d_bytes = Ly.n * kDwRows * 2;
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
  switch (Ly.n) {
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

// ---------------------------------------------------------------------------
// The split tile's walk.
//
// Above 256 every layer's dW is cut into units of up to 128 rows (a row tile)
// by up to kDwUnitN D columns (n0 .. n0 + c_hi) and a sample range (y); the
// host (ops/kernels/fused_render.py: dw_units, dw_schedule) lists them and
// gives each block of a persistent grid of at most one block an SM its own
// list, the same number of kDwPartN-column parts for every block to within
// one (at 8x1024, 576 parts of 128 columns over 132 SMs where 286 tiles of
// 264 columns took three waves, the last of 22 blocks).  A unit is the
// window tile's block: two consumer warpgroups of 64 rows, its D columns in
// registers as parts of kDwPartN columns (one m64n128k16 each, ceil(c_hi /
// kDwPartN) of them), the producer's ring of 4 stages (the unit's 128
// columns of A and its parts' columns of D for 64 samples).  The ring runs
// on across units: the producer streams the next unit's stages while the
// consumers write the last one's tile to its slab, or (a later chunk) add
// it to what the slab holds, read from global memory a batch of registers
// at a time.  Each element's sums are the window tiles': the same stages of
// the same range, each a wgmma k16 step, started from zero and added to the
// slab after (a wgmma's sums of one element do not depend on the
// instruction's width: the n256 window as two n128 gave its bits).
// Measured on an H100 (PERF.md): parts of 64 (four A reads a k16 step)
// took 17% longer; units cut into 64-row halves, one warpgroup issuing,
// 30% longer.

constexpr int kDwUnitN = 256;  // D columns of a unit at most (128 f32 a thread)
constexpr int kDwPartN = 128;  // columns of one wgmma (fused_render.DW_PART_N)
constexpr int kDwWinStage = kDwABytes + kDwUnitN * kDwRows * 2;  // 49,152 B
constexpr int kDwWinSmem = 128 + kDwStages * kDwWinStage;
constexpr int kDwBatch = 8;  // float2 slab values a thread reads before it adds them

// A unit in four ints (ops/kernels/fused_render.py: dw_schedule_array):
// layer | m0 << 8, n0, c_hi (its columns n0 .. n0 + c_hi of the layer's dW),
// y (its sample range).
struct DwWinPlan {
  const __nv_bfloat16* ws_a;
  const __nv_bfloat16* ws_d;
  float* part;       // (nsplit, total_out)
  const int* sched;  // device: blocks + 1 unit offsets (padded to 4 ints), then the units
  int rows_pad, total_out, nsplit, blocks;
  int nst, per_split, accumulate;  // set per launch
  Bwd L[kMaxDense];
};

// Consumers: the unit's products over the stages [s0, s1) into acc (parts
// of kDwPartN columns), continuing the ring at (st, ph).
__device__ __forceinline__ void dw_unit_products(float* acc, int parts, int s0, int s1,
                                                 uint64_t* full, uint64_t* empty,
                                                 unsigned char* buf, int& st, uint32_t& ph) {
  constexpr int kParts = kDwUnitN / kDwPartN;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kDwUnitN / 2; ++i) acc[i] = 0.f;
  int prev = -1;
  for (int s = s0; s < s1; ++s) {
    mbar_wait(&full[st], ph);
    const uint32_t sa = smem_u32(buf + (size_t)st * kDwWinStage) + wg * 8 * 1024;
    const uint32_t sd = smem_u32(buf + (size_t)st * kDwWinStage + kDwABytes);
    acc_fence<kDwUnitN / 2>(acc);
    wg_fence();
#pragma unroll
    for (int q = 0; q < kDwRows / 16; ++q)
#pragma unroll
      for (int j = 0; j < kParts; ++j)
        if (j < parts)  // block-uniform
          mma_ss_t<kDwPartN>(acc + j * kDwPartN / 2, smem_desc(sa + q * 256, 128, 1024),
                             smem_desc(sd + j * (kDwPartN / 8) * 1024 + q * 256, 128, 1024),
                             1024, 1);
    wg_commit();
    wg_wait<1>();  // the previous stage's products are done
    acc_fence<kDwUnitN / 2>(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = st;
    if (++st == kDwStages) {
      st = 0;
      ph ^= 1u;
    }
  }
  wg_wait<0>();
  acc_fence<kDwUnitN / 2>(acc);
  if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
}

__global__ void __launch_bounds__(kDwThreads, 1)
    mlp_dw_window_kernel(const __grid_constant__ DwWinPlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kDwStages;
  unsigned char* buf = smem + 128;
  const int u0 = p.sched[blockIdx.x], u1 = p.sched[blockIdx.x + 1];
  const int4* units = reinterpret_cast<const int4*>(p.sched + round_up(p.blocks + 1, 4));
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kDwStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp: every unit's stages, in order
    if (tid == 256) {
      int st = 0;
      uint32_t ph = 0;
      for (int u = u0; u < u1; ++u) {
        const int4 w = units[u];
        const Bwd& Ly = p.L[w.x & 0xff];
        const int m0 = w.x >> 8, parts = (w.z + kDwPartN - 1) / kDwPartN;
        const uint32_t a_bytes = min(kDwM, Ly.a_width - m0) * kDwRows * 2,
                       d_bytes = parts * kDwPartN * kDwRows * 2;
        const __nv_bfloat16* A = p.ws_a + (size_t)p.rows_pad * Ly.a_col + (m0 / 8) * 512;
        const __nv_bfloat16* D = p.ws_d + (size_t)p.rows_pad * Ly.d_col + (w.y / 8) * 512;
        const int s0 = min(p.nst, w.w * p.per_split), s1 = min(p.nst, s0 + p.per_split);
        for (int s = s0; s < s1; ++s) {
          mbar_wait(&empty[st], ph ^ 1u);
          mbar_expect_tx(&full[st], a_bytes + d_bytes);
          unsigned char* dst = buf + (size_t)st * kDwWinStage;
          bulk_g2s(dst, A + (size_t)s * kDwRows * Ly.a_width, a_bytes, &full[st]);
          bulk_g2s(dst + kDwABytes, D + (size_t)s * kDwRows * Ly.d_width, d_bytes, &full[st]);
          if (++st == kDwStages) {
            st = 0;
            ph ^= 1u;
          }
        }
      }
    }
    return;
  }

  // Warpgroup wg computes rows 64 wg.. of each unit and every column of its
  // parts, whatever the stage holds there (rows past a_rows and columns past
  // c_hi are computed and not written): one wgmma path, no branch.
  const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[kDwUnitN / 2];
  int st = 0;
  uint32_t ph = 0;
  for (int u = u0; u < u1; ++u) {
    const int4 w = units[u];
    const Bwd& Ly = p.L[w.x & 0xff];
    const int m0 = w.x >> 8, c_hi = w.z;
    const int s0 = min(p.nst, w.w * p.per_split), s1 = min(p.nst, s0 + p.per_split);
    dw_unit_products(acc, (c_hi + kDwPartN - 1) / kDwPartN, s0, s1, full, empty, buf, st, ph);
    // The tile into its slab: written, or (a later chunk) slab + tile, as
    // nerf_dw.cuh's first design; the next unit's stages stream meanwhile.
    const int a_rows = min(kDwM, Ly.a_width - m0);
    float* out = p.part + (size_t)w.w * p.total_out + Ly.out_off + (size_t)m0 * Ly.d_width +
                 w.y + 2 * t;  // the unit's row 0, the thread's column pair
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 64 * wg + 16 * (warp & 3) + g + 8 * half;
      if (r >= a_rows) continue;
      float2* row = reinterpret_cast<float2*>(out + (size_t)r * Ly.d_width);
#pragma unroll
      for (int j0 = 0; j0 < kDwUnitN / 8; j0 += kDwBatch) {
        if (8 * j0 >= c_hi) break;
        float2 v[kDwBatch];
#pragma unroll
        for (int j = 0; j < kDwBatch; ++j) {
          const int c = 4 * (j0 + j) + 2 * half;  // acc of columns 8 (j0 + j) + 2t, +1 of row r
          v[j] = make_float2(acc[c], acc[c + 1]);
        }
        if (p.accumulate) {
          float2 old[kDwBatch];
#pragma unroll
          for (int j = 0; j < kDwBatch; ++j)
            if (8 * (j0 + j) < c_hi) old[j] = __ldcg(row + 4 * (j0 + j));
#pragma unroll
          for (int j = 0; j < kDwBatch; ++j)
            v[j] = make_float2(old[j].x + v[j].x, old[j].y + v[j].y);
        }
#pragma unroll
        for (int j = 0; j < kDwBatch; ++j)
          if (8 * (j0 + j) < c_hi) row[4 * (j0 + j)] = v[j];
      }
    }
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

// The widths dw_consume is instantiated for: d_width at hidden 64, 128
// and 256 (the heads' 80, 144 and 272).
inline bool dw_width_ok(int n) {
  return n == 16 || n == 32 || n == 64 || n == 80 || n == 128 || n == 144 || n == 256 ||
         n == 272;
}

// Host side: the dW product's plan for a backward's workspaces (rows_pad
// rows per layer) into dw_part (nsplit x total_out).  False when a layer's
// width has no instantiation.
inline bool dw_plan(DwPlan& q, const MlpBwdParams& mb, int n_dense, int rows_pad,
                    int total_out, int nsplit, float* dw_part) {
  q.ws_a = mb.ws_a;
  q.ws_d = mb.ws_d;
  q.part = dw_part;
  q.rows_pad = rows_pad;
  q.total_out = total_out;
  q.nsplit = nsplit;
  int tiles = 0, dmax = 0;
  for (int i = 0; i < n_dense; ++i) {
    const Bwd& w = mb.bwd[i];
    const int n = w.d_width;
    if (!dw_width_ok(n) || w.a_width % 16 != 0) return false;
    q.L[i] = DwLayer{w.a_col, w.a_width, w.d_col, w.d_width, w.out_off, tiles, n};
    tiles += (w.a_width + kDwM - 1) / kDwM;
    dmax = n > dmax ? n : dmax;
  }
  q.n_layers = n_dense;
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

// Host side: the split tile's plan from the workspace layout (mb.bwd) and
// the host's schedule (`sched`, in device memory: ops/kernels/fused_render.py:
// dw_schedule) for `blocks` blocks.  False when the layout is out of what
// the kernel takes.
inline bool dw_win_plan(DwWinPlan& q, const MlpBwdParams& mb, int n_dense, int rows_pad,
                        int total_out, int nsplit, float* dw_part, const int* sched,
                        int blocks) {
  if (sched == nullptr || blocks < 1 || nsplit < 1 || n_dense > kMaxDense) return false;
  q.ws_a = mb.ws_a;
  q.ws_d = mb.ws_d;
  q.part = dw_part;
  q.sched = sched;
  q.rows_pad = rows_pad;
  q.total_out = total_out;
  q.nsplit = nsplit;
  q.blocks = blocks;
  for (int i = 0; i < n_dense; ++i) {
    q.L[i] = mb.bwd[i];
    if (q.L[i].a_width % 16 != 0 || q.L[i].a_width <= 0 || q.L[i].d_width % 8 != 0) return false;
  }
  return true;
}

// One walk of the units over the first `nst` stages of the workspaces;
// `accumulate` adds into the slabs instead of writing them.
inline cudaError_t launch_dw_windows(DwWinPlan& q, int nst, bool accumulate, cudaStream_t st) {
  q.nst = nst;
  q.per_split = (nst + q.nsplit - 1) / q.nsplit;
  q.accumulate = accumulate ? 1 : 0;
  cudaError_t err = cudaFuncSetAttribute(mlp_dw_window_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDwWinSmem);
  if (err != cudaSuccess) return err;
  mlp_dw_window_kernel<<<q.blocks, kDwThreads, kDwWinSmem, st>>>(q);
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
