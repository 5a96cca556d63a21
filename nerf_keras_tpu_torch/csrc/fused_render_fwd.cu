// K1 forward on Hopper: the NeRF ray megakernel.
//
// Replaces the TPU kernel `_fwd_encode_kernel`
// (nerf_keras_tpu/ops/pallas/fused_render.py:709, launched by the
// pl.pallas_call at :810, entry `render_rays_fused` at :1004), in its
// forward form and in its training form (`emit_enc=True`, :724-735).
//
// What it computes, per ray, without leaving on-chip memory between steps:
//   points o + t*d (f32) -> Fourier encode of points (63 wide) and of the
//   ray direction (27 wide), f32 -> the trunk MLP (8x256, skip concat
//   [h, x_enc] after layer 4), the merged feature(256)+sigma(1) head, the
//   128-wide branch over [feature, d_enc] and the rgb head, as bf16
//   products with f32 accumulation -> relu(sigma), sigmoid(rgb), delta with
//   a 1e10 terminal, alpha, exclusive transmittance prod(max(1-alpha,0)
//   + 1e-10), weights, composited rgb.
// bf16 rounding sits where the reference puts it: the encodings, each
// post-ReLU hidden, and the feature before the concat.  sigma and rgb
// logits stay f32.
//
// Training mode (two optional outputs, null = not written):
//   * x_enc_out (B*S, 3+6L) bf16: the position encodings, the TPU kernel's
//     residual.  They are the values the first product already rounds, so
//     they change no numerics;
//   * preds_out (B*S, 4) f32: rgb logits and sigma per sample (16 B per
//     sample).  The TPU kernel holds whole rays in VMEM and its backward
//     recomputes the MLP once and composites in place; this kernel streams
//     64-sample tiles of a ray and composites at the end, so a backward
//     without the stored predictions would have to run the forward twice
//     (once for the ray's alpha/transmittance, once for the activations).
//     With them K2 runs the per-ray compositing VJP first and then one
//     recompute per tile.
//
// What bounds it on this card: about 1.19 MFLOP of matmul per sample at
// full width (8x256 trunk with the skip, heads and branch), against a few
// bytes of input per sample (o, d per ray; one t per sample) and two
// small outputs (plus 142 B per sample in training mode).  So the tensor
// cores bound it, not device memory.
//
// What the design does about that:
//   * A block of 8 warps owns R whole rays (R = max(1, 64 / S)) and
//     streams 64-sample tiles through the whole MLP.  Activations stay in
//     shared memory as bf16 (two ping-pong buffers of 64 x (hidden+72)),
//     so no per-layer activation ever touches device memory.
//   * Products use mma.sync m16n8k16 (bf16 in, f32 accumulate), as the
//     tile product of nerf_tile.cuh: each warp owns a set of 8-column
//     output tiles and all 64 rows of the tile.
//   * Weights (~1.2 MB bf16 per MLP) are read from global memory and stay
//     in L2, packed once per set of weights as interleaved W^T (one-step
//     prefetch of the B fragments).
//   * Per-sample (sigma, rgb) go to shared memory; at the end one warp
//     per ray runs the transmittance scan in sample order (a chunk per
//     lane plus a multiplicative warp scan) and writes weights and rgb
//     (composite_rays, nerf_tile.cuh, shared with K4).
// Not carried over from the TPU kernel: its one-hot selector matmuls,
// three-limb exact dots, the sin(z + pi/2) cos trick, the log-space
// cumsum and the padded-t ragged batch (the ragged edge is masked here).
// wgmma, TMA and warp specialisation are later work.
//
// K6's forward is the same body over encodings: fused_render_enc_kernel
// replaces `_fwd_kernel` (nerf_keras_tpu/ops/pallas/fused_render.py:336,
// pl.pallas_call at :530; entry `apply_nerf_render_pallas` at :1083).  It
// reads x_enc (B*S, 3+6 L_XYZ) and d_enc (B*S, 3+6 L_DIR) bf16 per sample
// from the caller instead of encoding rays (d_enc per sample, as the JAX
// entry takes it), then runs the same MLP tile and compositing; in
// training mode it writes the f32 predictions for K6's backward
// (fused_render_bwd.cu, k6_rows_kernel).  It reads 180 B per sample more
// than K1 (its encodings), still far below the products' time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (never -use_fast_math: the top
//        octave's argument is 2^9*|p|, thousands of radians, where the
//        fast sin is wrong).

#include "nerf_tile.cuh"

using namespace nkt;

namespace {

struct Params {
  const float* origins;  // (B, 3), K1
  const float* dirs;     // (B, 3), K1
  const float* t_vals;   // (B, S)
  const __nv_bfloat16* x_in;  // (B*S, xyz_dim), K6
  const __nv_bfloat16* d_in;  // (B*S, dir_dim), K6
  const __nv_bfloat16* w;
  const float* b;
  float* rgb_out;           // (B, 3)
  float* w_out;             // (B, S)
  __nv_bfloat16* xenc_out;  // (B*S, xyz_dim) or null
  float* preds_out;         // (B*S, 4) or null
  int B, S, R;
  MlpDims m;
};

// kEncIn: K6 (encodings given per sample), else K1 (rays encoded here).
template <bool kEncIn>
__device__ __forceinline__ void render_body(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MlpDims& m = p.m;
  const int tid = threadIdx.x;
  const int ldx = m.ldx;
  const int R = p.R;
  const int S = p.S;

  // Shared-memory carve-up (all section sizes are multiples of 16 bytes).
  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf1 = buf0 + kTileRows * ldx;
  __nv_bfloat16* xenc = buf1 + kTileRows * ldx;     // (64, xyz_pad)
  __nv_bfloat16* denc = xenc + kTileRows * m.xyz_pad;  // (R, dir_pad)
  float* pts = reinterpret_cast<float*>(denc + R * m.dir_pad);  // (64, 4)
  float* ray_o = pts + kTileRows * 4;  // (R, 4)
  float* ray_d = ray_o + R * 4;        // (R, 4)
  float* sig = ray_d + R * 4;          // (R*S)
  float* rgbl = sig + R * S;           // (R*S, 3)

  const int r0 = blockIdx.x * R;
  const int nrays = min(R, p.B - r0);
  const int P = nrays * S;

  const size_t s0 = (size_t)r0 * S;  // first sample of the block

  if (!kEncIn) {
    for (int i = tid; i < R * 3; i += kThreads) {
      const int r = i / 3, c = i - r * 3;
      const bool ok = r < nrays;
      ray_o[r * 4 + c] = ok ? p.origins[(size_t)(r0 + r) * 3 + c] : 0.f;
      ray_d[r * 4 + c] = ok ? p.dirs[(size_t)(r0 + r) * 3 + c] : 0.f;
    }
    __syncthreads();
    // Direction features once per ray (every sample of a ray shares them).
    for (int i = tid; i < R * m.dir_pad; i += kThreads) {
      const int r = i / m.dir_pad, c = i - r * m.dir_pad;
      denc[i] = __float2bfloat16_rn(encode_feature(ray_d + r * 4, c, m.dir_dim));
    }
  }

  const int ntiles = (P + kTileRows - 1) / kTileRows;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int q0 = tile * kTileRows;
    const int rows_valid = P - q0;
    if (kEncIn) {
      for (int i = tid; i < kTileRows * m.xyz_pad; i += kThreads) {
        const int row = i / m.xyz_pad, c = i - row * m.xyz_pad;
        const __nv_bfloat16 v = row < rows_valid && c < m.xyz_dim
                                    ? p.x_in[(s0 + q0 + row) * m.xyz_dim + c]
                                    : __float2bfloat16_rn(0.f);
        buf0[row * ldx + c] = v;
        xenc[i] = v;
      }
      __syncthreads();
      auto dir = [&](int row, int c) {
        return row < rows_valid && c < m.dir_dim ? p.d_in[(s0 + q0 + row) * m.dir_dim + c]
                                                 : __float2bfloat16_rn(0.f);
      };
      mlp_forward_tile(m, p.w, p.b, buf0, buf1, xenc, dir, sig + q0, rgbl + q0 * 3,
                       rows_valid);
      continue;
    }
    if (tid < kTileRows) {
      const int q = q0 + tid;
      float x = 0.f, y = 0.f, z = 0.f;
      if (q < P) {
        const int r = q / S;
        const float t = p.t_vals[s0 + q];
        // o + d*t rounded as two operations (no fma), as the plain path.
        x = __fadd_rn(ray_o[r * 4 + 0], __fmul_rn(ray_d[r * 4 + 0], t));
        y = __fadd_rn(ray_o[r * 4 + 1], __fmul_rn(ray_d[r * 4 + 1], t));
        z = __fadd_rn(ray_o[r * 4 + 2], __fmul_rn(ray_d[r * 4 + 2], t));
      }
      pts[tid * 4 + 0] = x;
      pts[tid * 4 + 1] = y;
      pts[tid * 4 + 2] = z;
    }
    __syncthreads();
    for (int i = tid; i < kTileRows * m.xyz_pad; i += kThreads) {
      const int row = i / m.xyz_pad, c = i - row * m.xyz_pad;
      const __nv_bfloat16 v =
          __float2bfloat16_rn(encode_feature(pts + row * 4, c, m.xyz_dim));
      buf0[row * ldx + c] = v;
      xenc[i] = v;
      if (p.xenc_out != nullptr && row < rows_valid && c < m.xyz_dim)
        p.xenc_out[(s0 + q0 + row) * m.xyz_dim + c] = v;
    }
    __syncthreads();
    auto dir = [&](int row, int c) {
      const int q = q0 + row;
      return q < P ? denc[(q / S) * m.dir_pad + c] : __float2bfloat16_rn(0.f);
    };
    mlp_forward_tile(m, p.w, p.b, buf0, buf1, xenc, dir, sig + q0, rgbl + q0 * 3,
                     rows_valid);
  }

  if (p.preds_out != nullptr) {
    for (int i = tid; i < P * 4; i += kThreads) {
      const int q = i >> 2, c = i & 3;
      p.preds_out[s0 * 4 + i] = c < 3 ? rgbl[q * 3 + c] : sig[q];
    }
  }

  composite_rays(p.t_vals + s0, sig, rgbl, nrays, S, p.w_out + s0,
                 p.rgb_out + (size_t)r0 * 3);
}

__global__ void __launch_bounds__(kThreads)
    fused_render_fwd_kernel(const __grid_constant__ Params p) {
  render_body<false>(p);
}

__global__ void __launch_bounds__(kThreads)
    fused_render_enc_kernel(const __grid_constant__ Params p) {
  render_body<true>(p);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  K1 takes origins and dirs
// (x_in, d_in null); K6 takes x_in and d_in (origins, dirs and xenc_out
// null).  `dense_desc` is a HOST array of n_dense * 5 ints (k_pad, n,
// n_pad, w_off, b_off) in the order trunk[0..num_layers), merged
// feature+sigma head, branch, rgb.  `xenc_out` and `preds_out` may be null
// (forward only).  Launches on `stream` and returns cudaGetLastError() (0
// on success); does not synchronise and allocates nothing.
extern "C" int nkt_fused_render_fwd(
    const void* origins, const void* dirs, const void* t_vals, const void* x_in,
    const void* d_in, const void* w_pack, const void* b_pack, const void* dense_desc,
    int n_dense, int num_layers, int skip_layer, int hidden, int l_xyz,
    int l_dir, int B, int S, void* rgb_out, void* w_out, void* xenc_out,
    void* preds_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool enc_in = x_in != nullptr;
  const bool inputs_ok =
      enc_in ? d_in != nullptr && origins == nullptr && dirs == nullptr && xenc_out == nullptr
             : origins != nullptr && dirs != nullptr && d_in == nullptr;
  Params p;
  if (!inputs_ok || B <= 0 || S < 2 ||
      !mlp_dims_init(p.m, static_cast<const int*>(dense_desc), n_dense, num_layers,
                     skip_layer, hidden, l_xyz, l_dir))
    return (int)cudaErrorInvalidValue;
  p.origins = static_cast<const float*>(origins);
  p.dirs = static_cast<const float*>(dirs);
  p.t_vals = static_cast<const float*>(t_vals);
  p.x_in = static_cast<const __nv_bfloat16*>(x_in);
  p.d_in = static_cast<const __nv_bfloat16*>(d_in);
  p.w = static_cast<const __nv_bfloat16*>(w_pack);
  p.b = static_cast<const float*>(b_pack);
  p.rgb_out = static_cast<float*>(rgb_out);
  p.w_out = static_cast<float*>(w_out);
  p.xenc_out = static_cast<__nv_bfloat16*>(xenc_out);
  p.preds_out = static_cast<float*>(preds_out);
  p.B = B;
  p.S = S;
  p.R = S >= kTileRows ? 1 : kTileRows / S;

  const size_t smem =
      sizeof(__nv_bfloat16) *
          ((size_t)2 * kTileRows * p.m.ldx + (size_t)kTileRows * p.m.xyz_pad +
           (size_t)p.R * p.m.dir_pad) +
      sizeof(float) * ((size_t)kTileRows * 4 + (size_t)p.R * 8 +
                       (size_t)p.R * S * 4);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  void (*kernel)(const Params) = enc_in ? fused_render_enc_kernel : fused_render_fwd_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + p.R - 1) / p.R;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
