// K5 forward on Hopper: the NeRF MLP over precomputed encodings.
//
// Replaces the TPU kernel `_fwd_kernel`
// (nerf_keras_tpu/ops/pallas/fused_mlp.py:148, launched by the
// pl.pallas_call at :330, entry `apply_nerf_mlp_pallas` at :430).
//
// What it computes: raw predictions (N, 4) f32 = [rgb logits, sigma] of
// the 8x256 skip MLP for N samples given their position encodings x_enc
// (N, 3+6*L_XYZ) and direction encodings d_enc (N, 3+6*L_DIR), both bf16
// (the compute dtype; the encodings are stored in it): the trunk with the
// skip concat [h, x_enc] after layer SKIP_LAYER, the merged
// feature(256)+sigma(1) head, the 128-wide branch over [feature, d_enc]
// and the rgb head, bf16 products with f32 accumulation.  bf16 rounding
// sits where the reference's apply_nerf_mlp puts it (each post-ReLU
// hidden, the feature before the concat); sigma and the rgb logits stay
// f32.  This is K1's MLP body without expand, encode or compositing: the
// two share nerf_tile.cuh's mlp_forward_tile.
//
// What bounds it on this card: 593,408 multiply-adds per sample at 8x256
// (L_XYZ 10, L_DIR 4), 1.19 MFLOP, against 196 bytes of input and output
// per sample (126 + 54 in, 16 out): ~6,000 operations per byte, twenty
// times the ~295 where the H100's bf16 tensor cores stop waiting on
// memory.  So the tensor cores bound it; at N = 786,432 the least time is
// 0.934 TFLOP / 989 TFLOP/s = 0.94 ms, the bytes 0.05 ms.
//
// What the design does about that: each block of 8 warps streams 64-row
// tiles of (x_enc, d_enc) (a grid-stride loop over tiles) through the
// whole MLP with every activation in shared memory as bf16, products by
// mma.sync m16n8k16 with the weights read from L2 (K1's interleaved W^T
// pack, cached per set of weights), and writes only the (N, 4) output.
// Ragged N is masked in the kernel: rows past N load zeros and are not
// written.  wgmma, TMA and warp specialisation are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.

#include "nerf_tile.cuh"

using namespace nkt;

namespace {

struct Params {
  const __nv_bfloat16* x_enc;  // (N, xyz_dim)
  const __nv_bfloat16* d_enc;  // (N, dir_dim)
  const __nv_bfloat16* w;
  const float* b;
  float* preds;  // (N, 4)
  int N, ntiles;
  MlpDims m;
};

__global__ void __launch_bounds__(kThreads)
    fused_mlp_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MlpDims& m = p.m;
  const int tid = threadIdx.x;
  const int ldx = m.ldx;

  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf1 = buf0 + kTileRows * ldx;
  __nv_bfloat16* xenc = buf1 + kTileRows * ldx;        // (64, xyz_pad)
  __nv_bfloat16* denc = xenc + kTileRows * m.xyz_pad;  // (64, dir_pad)
  float* sig = reinterpret_cast<float*>(denc + kTileRows * m.dir_pad);  // (64)
  float* rgbl = sig + kTileRows;                                        // (64, 3)

  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * kTileRows;
    const int nrows = min(kTileRows, p.N - tile * kTileRows);
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int i = tid; i < kTileRows * m.xyz_pad; i += kThreads) {
      const int row = i / m.xyz_pad, c = i - row * m.xyz_pad;
      const __nv_bfloat16 v =
          row < nrows && c < m.xyz_dim ? p.x_enc[(row0 + row) * m.xyz_dim + c] : zero;
      buf0[row * ldx + c] = v;
      xenc[i] = v;
    }
    for (int i = tid; i < kTileRows * m.dir_pad; i += kThreads) {
      const int row = i / m.dir_pad, c = i - row * m.dir_pad;
      denc[i] = row < nrows && c < m.dir_dim ? p.d_enc[(row0 + row) * m.dir_dim + c] : zero;
    }
    __syncthreads();
    auto dir = [&](int row, int c) { return denc[row * m.dir_pad + c]; };
    mlp_forward_tile(m, p.w, p.b, buf0, buf1, xenc, dir, sig, rgbl, nrows);
    for (int i = tid; i < nrows * 4; i += kThreads) {
      const int row = i >> 2, c = i & 3;
      p.preds[row0 * 4 + i] = c < 3 ? rgbl[row * 3 + c] : sig[row];
    }
    // The next tile writes sig/rgbl only after mlp_forward_tile's first
    // synchronisation, so no barrier is needed here.
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `dense_desc` is a HOST array of
// n_dense * 5 ints (k_pad, n, n_pad, w_off, b_off) of K1's pack, in the
// order trunk[0..num_layers), merged feature+sigma head, branch, rgb.
// `grid` blocks stride over the ceil(N / 64) tiles.  Launches on `stream`
// and returns cudaGetLastError() (0 on success); does not synchronise
// and allocates nothing.
extern "C" int nkt_fused_mlp_fwd(
    const void* x_enc, const void* d_enc, const void* w_pack, const void* b_pack,
    const void* dense_desc, int n_dense, int num_layers, int skip_layer, int hidden,
    int l_xyz, int l_dir, int N, int grid, void* preds_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  if (N <= 0 || grid <= 0 ||
      !mlp_dims_init(p.m, static_cast<const int*>(dense_desc), n_dense, num_layers,
                     skip_layer, hidden, l_xyz, l_dir))
    return (int)cudaErrorInvalidValue;
  p.x_enc = static_cast<const __nv_bfloat16*>(x_enc);
  p.d_enc = static_cast<const __nv_bfloat16*>(d_enc);
  p.w = static_cast<const __nv_bfloat16*>(w_pack);
  p.b = static_cast<const float*>(b_pack);
  p.preds = static_cast<float*>(preds_out);
  p.N = N;
  p.ntiles = (N + kTileRows - 1) / kTileRows;
  const size_t smem =
      sizeof(__nv_bfloat16) * ((size_t)2 * kTileRows * p.m.ldx +
                               (size_t)kTileRows * (p.m.xyz_pad + p.m.dir_pad)) +
      sizeof(float) * (size_t)kTileRows * 4;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_mlp_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_fwd_kernel<<<grid < p.ntiles ? grid : p.ntiles, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
