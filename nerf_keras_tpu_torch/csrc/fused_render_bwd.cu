// K2 on Hopper: the backward of the NeRF ray megakernel (K1); with K3,
// its recompute variant, and K6's backward (see the modes below).
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
//   1. the rows kernel, one block per R rays (R = max(1, 64/S)), as K1.
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
//      The recompute and the walk are nerf_tile.cuh's mlp_backward_tile,
//      which K5's backward (fused_mlp_bwd.cu) runs too.
//   2. mlp_dw_kernel (nerf_dw.cuh): dW = A^T D per layer, contracting over
//      samples, as a tiled product (128x128 output tiles, 8 warps of
//      32x64, 64-row stages double-buffered with cp.async, fragments by
//      ldmatrix.trans because both operands are sample-major), split over
//      row ranges; each block writes its partial tile to a slab.
//   3. mlp_reduce_kernel (nerf_dw.cuh): sums the dW slabs and the
//      per-block bias rows in a fixed order.
// Orientation: K1's pack is W^T interleaved (row = output column); the
// dX products read W in the other orientation, so K2 has its own pack
// (row = layer input column, k = layer output, same interleave).  Ragged
// edges: rows past a block's last sample get zero dpreds, so they add
// nothing, and the workspace holds only the B*S real samples.  No TF32
// anywhere (bf16 tensor-core products, f32 elsewhere), no fast math.
// wgmma, TMA and keeping A/D on chip are later work.
//
// The rows kernel has three modes, one __global__ each (one body):
//   * k2_rows_kernel (K2): position features from K1's x_enc residual.
//   * k3_rows_kernel (K3): replaces `_bwd_encode_kernel`
//     (fused_render.py:425, pl.pallas_call at :969), the
//     bwd_mode="recompute" backward.  The position features of each
//     64-sample tile are encoded again from (origins, dirs, t) with K1's
//     arithmetic (o + d*t as two roundings, encode_feature, bf16), so it
//     reads no x_enc: what a step holds between K1 and K3 is K1's f32
//     predictions (16 B per sample) against K2's 142 B.  Given the same
//     predictions its dW/db are K2's bit for bit.  The cost is the encode
//     twice per tile (layer 0 and the skip concat): ~120 sin/cos per
//     sample against ~2.4 MFLOP of products.
//   * k6_rows_kernel (K6's backward): replaces `_bwd_kernel`
//     (fused_render.py:350, pl.pallas_call at :592), the backward of
//     `apply_nerf_render_pallas`: position and direction encodings both
//     read per sample from the caller's (B*S, .) bf16 inputs, no weights
//     cotangent (the JAX entry's weights carry no gradient).

#include "nerf_dw.cuh"

using namespace nkt;

namespace {

// Where the rows kernel takes the MLP's inputs from.
enum RowsMode {
  kResidual = 0,     // K2: x_enc residual, directions encoded per ray
  kRecompute = 1,    // K3: x_enc encoded from (origins, dirs, t), directions per ray
  kEncodingsIn = 2,  // K6: x_enc and d_enc per sample, as given
};

struct RowParams {
  MlpBwdParams mb;             // packs, workspaces, layer descriptors
  const __nv_bfloat16* x_res;  // (B*S, xyz_dim): K2's residual, K6's x_enc
  const float* origins;        // (B, 3): K3
  const float* dirs;           // (B, 3): K2, K3
  const __nv_bfloat16* d_enc;  // (B*S, dir_dim): K6
  const float* t_vals;         // (B, S)
  const float* preds;          // (N, 4)
  const float* g_rgb;          // (B, 3)
  const float* g_w;            // (B, S) or null
  float* db_part;              // (grid, total_b)
  int B, S, R, total_b;
};

template <int MODE>
__device__ __forceinline__ void rows_body(const RowParams& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MlpDims& m = p.mb.m;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ldx = m.ldx;
  const int R = p.R;
  const int S = p.S;
  const int L = m.num_layers;
  const int MW = p.mb.mask_words;

  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf1 = buf0 + kTileRows * ldx;
  __nv_bfloat16* denc = buf1 + kTileRows * ldx;  // (R, dir_pad)
  uint32_t* masks = reinterpret_cast<uint32_t*>(denc + R * m.dir_pad);
  //                 (L + 1) x (64, MW): trunk layers, then the branch
  float* dpreds = reinterpret_cast<float*>(masks + (L + 1) * kTileRows * MW);
  //                 (R*S, 4): d rgb logits, d sigma
  float* db = dpreds + R * S * 4;  // (total_b), the K1 bias-pack layout
  float* ray_d = db + p.total_b;   // (R, 4)
  float* ray_o = ray_d + R * 4;    // (R, 4), K3 only

  const int r0 = blockIdx.x * R;
  const int nrays = min(R, p.B - r0);
  const int P = nrays * S;
  const size_t s0 = (size_t)r0 * S;  // first sample of the block

  for (int i = tid; i < p.total_b; i += kThreads) db[i] = 0.f;
  if (MODE != kEncodingsIn) {
    for (int i = tid; i < R * 3; i += kThreads) {
      const int r = i / 3, c = i - r * 3;
      const bool ok = r < nrays;
      ray_d[r * 4 + c] = ok ? p.dirs[(size_t)(r0 + r) * 3 + c] : 0.f;
      if (MODE == kRecompute) ray_o[r * 4 + c] = ok ? p.origins[(size_t)(r0 + r) * 3 + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < R * m.dir_pad; i += kThreads) {
      const int r = i / m.dir_pad, c = i - r * m.dir_pad;
      denc[i] = __float2bfloat16_rn(encode_feature(ray_d + r * 4, c, m.dir_dim));
    }
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

  const int ntiles = (P + kTileRows - 1) / kTileRows;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int q0 = tile * kTileRows;
    const int nrows = min(kTileRows, P - q0);
    const size_t row0 = s0 + q0;
    if constexpr (MODE == kEncodingsIn) {
      auto dir = [&](int row, int c) {
        return row < nrows && c < m.dir_dim ? p.d_enc[(row0 + row) * m.dir_dim + c]
                                            : __float2bfloat16_rn(0.f);
      };
      mlp_backward_tile(p.mb, buf0, buf1, masks, db, row0, nrows,
                        StoredXenc{p.x_res, row0, m.xyz_dim}, dir, dpreds + q0 * 4, nullptr,
                        nullptr, nullptr);
    } else {
      auto dir = [&](int row, int c) {
        const int q = q0 + row;
        return q < P ? denc[(q / S) * m.dir_pad + c] : __float2bfloat16_rn(0.f);
      };
      if constexpr (MODE == kRecompute) {
        // K1's encode of sample q0 + row (called for row < nrows only).
        auto xenc = [&](int row, int c) {
          const int q = q0 + row;
          const float* o = ray_o + (q / S) * 4;
          const float* d = ray_d + (q / S) * 4;
          const float t = p.t_vals[s0 + q];
          const float x[3] = {__fadd_rn(o[0], __fmul_rn(d[0], t)),
                              __fadd_rn(o[1], __fmul_rn(d[1], t)),
                              __fadd_rn(o[2], __fmul_rn(d[2], t))};
          return __float2bfloat16_rn(encode_feature(x, c, m.xyz_dim));
        };
        mlp_backward_tile(p.mb, buf0, buf1, masks, db, row0, nrows, xenc, dir,
                          dpreds + q0 * 4, nullptr, nullptr, nullptr);
      } else {
        mlp_backward_tile(p.mb, buf0, buf1, masks, db, row0, nrows,
                          StoredXenc{p.x_res, row0, m.xyz_dim}, dir, dpreds + q0 * 4,
                          nullptr, nullptr, nullptr);
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < p.total_b; i += kThreads)
    p.db_part[(size_t)blockIdx.x * p.total_b + i] = db[i];
}

// Two blocks per SM (<= 128 registers, <= 113 KB of shared memory) hide
// the latency of the weight-fragment loads, as in K1.
__global__ void __launch_bounds__(kThreads, 2)
    k2_rows_kernel(const __grid_constant__ RowParams p) {
  rows_body<kResidual>(p);
}

__global__ void __launch_bounds__(kThreads, 2)
    k3_rows_kernel(const __grid_constant__ RowParams p) {
  rows_body<kRecompute>(p);
}

__global__ void __launch_bounds__(kThreads, 2)
    k6_rows_kernel(const __grid_constant__ RowParams p) {
  rows_body<kEncodingsIn>(p);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `mode` picks the rows kernel:
// 0 = K2 (x_res and dirs given), 1 = K3 (origins and dirs given, x_res
// null), 2 = K6 (x_res = x_enc and d_enc given, dirs null).  Host arrays:
// `desc_fwd` (n_dense x 5: k_pad, n, n_pad, w_off, b_off of the K1 pack),
// `desc_bwd` (the same for the K2 pack: k_pad = round16(n), n = dX
// columns), `desc_ws` (n_dense x 5: a_col, a_width, d_col, d_width,
// out_off), in the order trunk[0..num_layers), merged head, branch, rgb.
// Workspaces (allocated by the caller): ws_a (N x sum a_width) and ws_d
// (N x sum d_width) bf16, db_part (grid x total_b) and dw_part (nsplit x
// total_out) f32, N = B*S; grid = ceil(B / R), R = max(1, 64 / S).
// Outputs dw (total_out) and db (total_b) f32.  Launches on `stream`,
// returns the first CUDA error (0 on success); does not synchronise.
extern "C" int nkt_fused_render_bwd(
    int mode, const void* x_res, const void* origins, const void* dirs, const void* d_enc,
    const void* t_vals, const void* preds, const void* g_rgb, const void* g_w,
    const void* w_pack, const void* b_pack, const void* desc_fwd, const void* wb_pack,
    const void* desc_bwd, const void* desc_ws, int n_dense, int num_layers, int skip_layer,
    int hidden, int l_xyz, int l_dir, int B, int S, int total_b, int total_out, void* ws_a,
    void* ws_d, void* db_part, void* dw_part, int nsplit, void* dw_out, void* db_out,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool inputs_ok =
      (mode == kResidual && x_res != nullptr && dirs != nullptr) ||
      (mode == kRecompute && x_res == nullptr && origins != nullptr && dirs != nullptr) ||
      (mode == kEncodingsIn && x_res != nullptr && d_enc != nullptr && dirs == nullptr);
  RowParams p;
  MlpBwdParams& mb = p.mb;
  if (!inputs_ok || B <= 0 || S < 2 || nsplit < 1 ||
      !mlp_dims_init(mb.m, static_cast<const int*>(desc_fwd), n_dense, num_layers,
                     skip_layer, hidden, l_xyz, l_dir) ||
      !mlp_bwd_init(mb, static_cast<const int*>(desc_bwd), static_cast<const int*>(desc_ws),
                    n_dense))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  mb.w = static_cast<const __nv_bfloat16*>(w_pack);
  mb.b = static_cast<const float*>(b_pack);
  mb.wb = static_cast<const __nv_bfloat16*>(wb_pack);
  mb.ws_a = static_cast<__nv_bfloat16*>(ws_a);
  mb.ws_d = static_cast<__nv_bfloat16*>(ws_d);
  mb.N = B * S;
  p.x_res = static_cast<const __nv_bfloat16*>(x_res);
  p.origins = static_cast<const float*>(origins);
  p.dirs = static_cast<const float*>(dirs);
  p.d_enc = static_cast<const __nv_bfloat16*>(d_enc);
  p.t_vals = static_cast<const float*>(t_vals);
  p.preds = static_cast<const float*>(preds);
  p.g_rgb = static_cast<const float*>(g_rgb);
  p.g_w = static_cast<const float*>(g_w);
  p.db_part = static_cast<float*>(db_part);
  p.B = B;
  p.S = S;
  p.R = S >= kTileRows ? 1 : kTileRows / S;
  p.total_b = total_b;

  const int grid = (B + p.R - 1) / p.R;
  const size_t smem =
      sizeof(__nv_bfloat16) * ((size_t)2 * kTileRows * mb.m.ldx + (size_t)p.R * mb.m.dir_pad) +
      sizeof(uint32_t) * (size_t)(num_layers + 1) * kTileRows * mb.mask_words +
      sizeof(float) * ((size_t)p.R * S * 4 + (size_t)total_b + (size_t)p.R * 8);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  void (*kernel)(const RowParams) =
      mode == kResidual ? k2_rows_kernel : mode == kRecompute ? k3_rows_kernel : k6_rows_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dw_reduce(mb, n_dense, total_out, total_b, static_cast<float*>(dw_part),
                               nsplit, static_cast<float*>(dw_out), p.db_part, grid,
                               static_cast<float*>(db_out), st);
}
