// The weight gradients of the MLP from the workspaces its backward tile
// code writes (nerf_tile.cuh: mlp_backward_tile), shared by K2
// (fused_render_bwd.cu) and K5 (fused_mlp_bwd.cu).
//
// dW = A^T D per layer: M = a_width (layer input), N = d_width (layer
// output), K = samples.  Both operands are stored sample-major, so the
// fragments come from shared memory by ldmatrix.trans.  A tiled product
// (128x128 output tiles, 8 warps of 32x64, 64-row stages double-buffered
// with cp.async), split over row ranges; each block writes its partial
// tile to a slab, and a second kernel sums the slabs and the per-block
// bias rows in a fixed order.  No atomics: the same sums in the same
// order on every run (deterministic).

#pragma once

#include "nerf_tile.cuh"

namespace nkt {

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
    mlp_dw_kernel(const __grid_constant__ DwParams p) {
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

// Host side: after the rows kernel has filled the workspaces and db_part
// (nblk rows of total_b), launch the dW product over nsplit row ranges
// into dw_part (nsplit x total_out) and the fixed-order reduce into dw_out
// (total_out) and db_out (total_b).  Returns the first CUDA error.
inline cudaError_t launch_dw_reduce(const MlpBwdParams& mb, int n_dense, int total_out,
                                    int total_b, float* dw_part, int nsplit, float* dw_out,
                                    const float* db_part, int nblk, float* db_out,
                                    cudaStream_t st) {
  DwParams q;
  q.ws_a = mb.ws_a;
  q.ws_d = mb.ws_d;
  q.part = dw_part;
  q.N = mb.N;
  q.n_layers = n_dense;
  q.total_out = total_out;
  int tiles = 0;
  for (int i = 0; i < n_dense; ++i) {
    const Bwd& w = mb.bwd[i];
    DwLayer& l = q.L[i];
    l = DwLayer{w.a_col, w.a_width, w.d_col, w.d_width, w.out_off, tiles,
                (w.d_width + kBN - 1) / kBN};
    tiles += ((w.a_width + kBM - 1) / kBM) * l.tiles_n;
  }
  q.rows_per_split = ((q.N + nsplit - 1) / nsplit + kBK - 1) / kBK * kBK;
  const size_t smem = sizeof(__nv_bfloat16) * 4 * kStageElems;
  cudaError_t err =
      cudaFuncSetAttribute(mlp_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mlp_dw_kernel<<<dim3(tiles, nsplit), kThreads, smem, st>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = total_out + total_b;
  mlp_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(dw_part, nsplit, total_out, dw_out,
                                                     db_part, nblk, total_b, db_out);
  return cudaGetLastError();
}

}  // namespace nkt
