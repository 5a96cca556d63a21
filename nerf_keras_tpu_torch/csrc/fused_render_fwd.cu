// K1 forward on Hopper: the NeRF ray megakernel.
//
// Replaces the TPU kernel `_fwd_encode_kernel`
// (nerf_keras_tpu/ops/pallas/fused_render.py:709, launched by the
// pl.pallas_call at :810, entry `render_rays_fused` at :1004), in its
// forward form (no encoding residual).
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
// What bounds it on this card: about 1.19 MFLOP of matmul per sample at
// full width (8x256 trunk with the skip, heads and branch), against a few
// bytes of input per sample (o, d per ray; one t per sample) and two
// small outputs.  So the tensor cores bound it, not device memory.
//
// What the design does about that:
//   * A block of 8 warps owns R whole rays (R = max(1, 64 / S)) and
//     streams 64-sample tiles through the whole MLP.  Activations stay in
//     shared memory as bf16 (two ping-pong buffers of 64 x (hidden+72)),
//     so no per-layer activation ever touches device memory.
//   * Products use mma.sync m16n8k16 (bf16 in, f32 accumulate).  Each
//     warp owns a set of 8-column output tiles and all 64 rows of the
//     tile.  Row stride of the activation buffers is padded by 8 bf16 so
//     the A-fragment loads hit 32 distinct banks.
//   * Weights (~1.2 MB bf16 per MLP) are read from global memory and stay
//     in L2.  They are packed once per checkpoint as W^T with each
//     16-wide k-group interleaved [0,1,8,9,2,3,10,11,...], so a thread's
//     B fragment is one 8-byte load; the next k-step's fragments are
//     loaded before the current step's products (one-step prefetch).
//   * Per-sample (sigma, rgb) go to shared memory; at the end one warp
//     per ray runs the transmittance scan in sample order (a chunk per
//     lane plus a multiplicative warp scan) and writes weights and rgb.
// Not carried over from the TPU kernel: its one-hot selector matmuls,
// three-limb exact dots, the sin(z + pi/2) cos trick, the log-space
// cumsum and the padded-t ragged batch (the ragged edge is masked here).
// wgmma, TMA and warp specialisation are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (never -use_fast_math: the top
//        octave's argument is 2^9*|p|, thousands of radians, where the
//        fast sin is wrong).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNB = 4;  // 8-column output tiles per warp per pass
constexpr int kMaxDense = 16;
constexpr int kMaxSmem = 232448;
constexpr float kEps = 1e-10f;
constexpr float kTerminalDelta = 1e10f;

struct Dense {
  int k_pad;  // input width, padded to 16 (rows of W, zero-filled)
  int n;      // true output width
  int n_pad;  // output width padded to 8
  int w_off;  // offset of W^T (n_pad, k_pad) in the bf16 pack
  int b_off;  // offset of the bias (n_pad) in the f32 pack
};

struct Params {
  const float* origins;  // (B, 3)
  const float* dirs;     // (B, 3)
  const float* t_vals;   // (B, S)
  const __nv_bfloat16* w;
  const float* b;
  float* rgb_out;  // (B, 3)
  float* w_out;    // (B, S)
  int B, S, R;
  int num_layers, skip_layer, hidden;
  int l_xyz, l_dir, xyz_dim, xyz_pad, dir_dim, dir_pad, ldx;
  Dense dense[kMaxDense];
};

enum Epilogue { kReluBf16 = 0, kFeatureSigma = 1, kRgbLogits = 2 };

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Column c of the encoding of a D=3 coordinate x with `dim` = 3 + 6L
// columns: [x | sin 2^0 x, cos 2^0 x | ... ]; 0 beyond `dim` (padding).
__device__ __forceinline__ float encode_feature(const float* x, int c, int dim) {
  if (c < 3) return x[c];
  if (c >= dim) return 0.f;
  const int k = c - 3;
  const int octave = k / 6;
  const int w = k - octave * 6;
  const int d = w < 3 ? w : w - 3;
  const float arg = x[d] * (float)(1 << octave);  // exact: power of two
  return w < 3 ? sinf(arg) : cosf(arg);
}

// out = epilogue(in[64, k_pad] @ W + b).  `in` and `out` are bf16 tiles in
// shared memory with row stride ldx.  Warp w computes 8-column tiles
// w, w+8, w+16, ... in passes of kNB tiles.  No block-level sync inside.
template <int MODE>
__device__ __forceinline__ void dense_layer(const Params& p, const Dense& L,
                                            const __nv_bfloat16* in,
                                            __nv_bfloat16* out, float* sig,
                                            float* rgbl, int rows_valid) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int ldx = p.ldx;
  const int nt_total = L.n_pad >> 3;
  const int ksteps = L.k_pad >> 4;
  const __nv_bfloat16* W = p.w + L.w_off;
  const float* bias = p.b + L.b_off;

  for (int pass = 0; pass * kWarps * kNB < nt_total; ++pass) {
    int tile[kNB];
    bool valid[kNB];
#pragma unroll
    for (int s = 0; s < kNB; ++s) {
      tile[s] = warp + kWarps * (pass * kNB + s);
      valid[s] = tile[s] < nt_total;
    }
    if (!valid[0]) continue;  // warp-uniform

    const uint2* bptr[kNB];
#pragma unroll
    for (int s = 0; s < kNB; ++s) {
      const int n = (valid[s] ? tile[s] : 0) * 8 + g;
      bptr[s] = reinterpret_cast<const uint2*>(W + (size_t)n * L.k_pad + tg * 4);
    }

    float acc[4][kNB][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int s = 0; s < kNB; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][s][e] = 0.f;

    uint2 bcur[kNB], bnxt[kNB];
#pragma unroll
    for (int s = 0; s < kNB; ++s)
      bcur[s] = valid[s] ? __ldg(bptr[s]) : make_uint2(0u, 0u);

    for (int ks = 0; ks < ksteps; ++ks) {
      // One k-step = 16 bf16 = 32 bytes = 4 uint2 along the packed row.
#pragma unroll
      for (int s = 0; s < kNB; ++s)
        bnxt[s] = (valid[s] && ks + 1 < ksteps) ? __ldg(bptr[s] + (ks + 1) * 4)
                                                 : make_uint2(0u, 0u);
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const __nv_bfloat16* r0 = in + (mt * 16 + g) * ldx + ks * 16 + tg * 2;
        const __nv_bfloat16* r1 = r0 + 8 * ldx;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(r1);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
      }
#pragma unroll
      for (int s = 0; s < kNB; ++s) {
        if (!valid[s]) continue;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          mma_bf16_16816(acc[mt][s], a[mt], bcur[s].x, bcur[s].y);
      }
#pragma unroll
      for (int s = 0; s < kNB; ++s) bcur[s] = bnxt[s];
    }

    // Epilogue: thread holds rows (mt*16+g, +8), columns (c0, c0+1).
#pragma unroll
    for (int s = 0; s < kNB; ++s) {
      if (!valid[s]) continue;
      const int c0 = tile[s] * 8 + tg * 2;
      const float b0 = bias[c0];
      const float b1 = bias[c0 + 1];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = mt * 16 + g + half * 8;
          const float v0 = acc[mt][s][half * 2 + 0] + b0;
          const float v1 = acc[mt][s][half * 2 + 1] + b1;
          if (MODE == kReluBf16) {
            *reinterpret_cast<__nv_bfloat162*>(out + row * ldx + c0) =
                __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          } else if (MODE == kFeatureSigma) {
            // Columns [0, hidden) are the feature, column hidden is sigma.
            const int hid = L.n - 1;
            if (c0 + 1 < hid) {
              *reinterpret_cast<__nv_bfloat162*>(out + row * ldx + c0) =
                  __floats2bfloat162_rn(v0, v1);
            } else if (c0 == hid) {
              if (row < rows_valid) sig[row] = v0;
            }
          } else {  // kRgbLogits
            if (row < rows_valid) {
              if (c0 < 3) rgbl[row * 3 + c0] = v0;
              if (c0 + 1 < 3) rgbl[row * 3 + c0 + 1] = v1;
            }
          }
        }
      }
    }
  }
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(kThreads)
    fused_render_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int ldx = p.ldx;
  const int R = p.R;
  const int S = p.S;
  const int H = p.hidden;

  // Shared-memory carve-up (all section sizes are multiples of 16 bytes).
  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf1 = buf0 + kTileRows * ldx;
  __nv_bfloat16* xenc = buf1 + kTileRows * ldx;     // (64, xyz_pad)
  __nv_bfloat16* denc = xenc + kTileRows * p.xyz_pad;  // (R, dir_pad)
  float* pts = reinterpret_cast<float*>(denc + R * p.dir_pad);  // (64, 4)
  float* ray_o = pts + kTileRows * 4;  // (R, 4)
  float* ray_d = ray_o + R * 4;        // (R, 4)
  float* sig = ray_d + R * 4;          // (R*S)
  float* rgbl = sig + R * S;           // (R*S, 3)

  const int r0 = blockIdx.x * R;
  const int nrays = min(R, p.B - r0);
  const int P = nrays * S;

  for (int i = tid; i < R * 3; i += kThreads) {
    const int r = i / 3, c = i - r * 3;
    const bool ok = r < nrays;
    ray_o[r * 4 + c] = ok ? p.origins[(size_t)(r0 + r) * 3 + c] : 0.f;
    ray_d[r * 4 + c] = ok ? p.dirs[(size_t)(r0 + r) * 3 + c] : 0.f;
  }
  __syncthreads();
  // Direction features once per ray (every sample of a ray shares them).
  for (int i = tid; i < R * p.dir_pad; i += kThreads) {
    const int r = i / p.dir_pad, c = i - r * p.dir_pad;
    denc[i] = __float2bfloat16_rn(encode_feature(ray_d + r * 4, c, p.dir_dim));
  }

  const int ntiles = (P + kTileRows - 1) / kTileRows;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int q0 = tile * kTileRows;
    const int rows_valid = P - q0;
    if (tid < kTileRows) {
      const int q = q0 + tid;
      float x = 0.f, y = 0.f, z = 0.f;
      if (q < P) {
        const int r = q / S;
        const float t = p.t_vals[(size_t)r0 * S + q];
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
    for (int i = tid; i < kTileRows * p.xyz_pad; i += kThreads) {
      const int row = i / p.xyz_pad, c = i - row * p.xyz_pad;
      const __nv_bfloat16 v =
          __float2bfloat16_rn(encode_feature(pts + row * 4, c, p.xyz_dim));
      buf0[row * ldx + c] = v;
      xenc[i] = v;
    }
    __syncthreads();

    __nv_bfloat16* in = buf0;
    __nv_bfloat16* out = buf1;
    for (int i = 0; i < p.num_layers; ++i) {
      dense_layer<kReluBf16>(p, p.dense[i], in, out, nullptr, nullptr, 0);
      if (i % p.skip_layer == 0 && i > 0) {
        for (int j = tid; j < kTileRows * p.xyz_pad; j += kThreads) {
          const int row = j / p.xyz_pad, c = j - row * p.xyz_pad;
          out[row * ldx + H + c] = xenc[j];
        }
      }
      __syncthreads();
      __nv_bfloat16* tmp = in;
      in = out;
      out = tmp;
    }
    // Merged feature+sigma head; the direction features fill the columns
    // after the feature, so `out` becomes the branch input [feature, d_enc].
    dense_layer<kFeatureSigma>(p, p.dense[p.num_layers], in, out, sig + q0,
                               nullptr, rows_valid);
    for (int j = tid; j < kTileRows * p.dir_pad; j += kThreads) {
      const int row = j / p.dir_pad, c = j - row * p.dir_pad;
      const int q = q0 + row;
      out[row * ldx + H + c] =
          q < P ? denc[(q / S) * p.dir_pad + c] : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    dense_layer<kReluBf16>(p, p.dense[p.num_layers + 1], out, in, nullptr,
                           nullptr, 0);
    __syncthreads();
    dense_layer<kRgbLogits>(p, p.dense[p.num_layers + 2], in, out, nullptr,
                            rgbl + q0 * 3, rows_valid);
    __syncthreads();
  }

  // Transmittance scan: one warp per ray, a contiguous chunk per lane.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int chunk = (S + 31) / 32;
  for (int r = warp; r < nrays; r += kWarps) {
    const float* tr = p.t_vals + (size_t)(r0 + r) * S;
    const float* sg = sig + r * S;
    const int j0 = min(lane * chunk, S);
    const int j1 = min(j0 + chunk, S);
    float prod = 1.f;
    for (int j = j0; j < j1; ++j) {
      const float delta = j + 1 < S ? tr[j + 1] - tr[j] : kTerminalDelta;
      const float alpha = 1.f - expf(-fmaxf(sg[j], 0.f) * delta);
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
    float cr = 0.f, cg = 0.f, cb = 0.f;
    float* wr = p.w_out + (size_t)(r0 + r) * S;
    const float* lg = rgbl + (size_t)r * S * 3;
    for (int j = j0; j < j1; ++j) {
      const float delta = j + 1 < S ? tr[j + 1] - tr[j] : kTerminalDelta;
      const float alpha = 1.f - expf(-fmaxf(sg[j], 0.f) * delta);
      const float w = alpha * trans;
      trans *= fmaxf(1.f - alpha, 0.f) + kEps;
      wr[j] = w;
      cr += w * sigmoidf_(lg[j * 3 + 0]);
      cg += w * sigmoidf_(lg[j * 3 + 1]);
      cb += w * sigmoidf_(lg[j * 3 + 2]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      cr += __shfl_xor_sync(0xffffffffu, cr, off);
      cg += __shfl_xor_sync(0xffffffffu, cg, off);
      cb += __shfl_xor_sync(0xffffffffu, cb, off);
    }
    if (lane == 0) {
      p.rgb_out[(size_t)(r0 + r) * 3 + 0] = cr;
      p.rgb_out[(size_t)(r0 + r) * 3 + 1] = cg;
      p.rgb_out[(size_t)(r0 + r) * 3 + 2] = cb;
    }
  }
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

}  // namespace

// Plain C entry point, loaded with ctypes.  `dense_desc` is a HOST array of
// n_dense * 5 ints (k_pad, n, n_pad, w_off, b_off) in the order
// trunk[0..num_layers), merged feature+sigma head, branch, rgb.  Launches
// on `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise and allocates nothing.
extern "C" int nkt_fused_render_fwd(
    const void* origins, const void* dirs, const void* t_vals,
    const void* w_pack, const void* b_pack, const void* dense_desc,
    int n_dense, int num_layers, int skip_layer, int hidden, int l_xyz,
    int l_dir, int B, int S, void* rgb_out, void* w_out, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S < 2 || num_layers < 1 || skip_layer < 1 ||
      hidden % 16 != 0 || hidden < 16 || n_dense != num_layers + 3 ||
      n_dense > kMaxDense)
    return (int)cudaErrorInvalidValue;

  Params p;
  p.origins = static_cast<const float*>(origins);
  p.dirs = static_cast<const float*>(dirs);
  p.t_vals = static_cast<const float*>(t_vals);
  p.w = static_cast<const __nv_bfloat16*>(w_pack);
  p.b = static_cast<const float*>(b_pack);
  p.rgb_out = static_cast<float*>(rgb_out);
  p.w_out = static_cast<float*>(w_out);
  p.B = B;
  p.S = S;
  p.R = S >= kTileRows ? 1 : kTileRows / S;
  p.num_layers = num_layers;
  p.skip_layer = skip_layer;
  p.hidden = hidden;
  p.l_xyz = l_xyz;
  p.l_dir = l_dir;
  p.xyz_dim = 3 + 6 * l_xyz;
  p.xyz_pad = round_up(p.xyz_dim, 16);
  p.dir_dim = 3 + 6 * l_dir;
  p.dir_pad = round_up(p.dir_dim, 16);
  const int kmax = hidden + (p.xyz_pad > p.dir_pad ? p.xyz_pad : p.dir_pad);
  // +8 bf16: row stride of 4 (mod 8) words keeps A-fragment loads
  // conflict-free.
  p.ldx = kmax + 8;
  const int* desc = static_cast<const int*>(dense_desc);
  for (int i = 0; i < n_dense; ++i) {
    Dense& d = p.dense[i];
    d.k_pad = desc[i * 5 + 0];
    d.n = desc[i * 5 + 1];
    d.n_pad = desc[i * 5 + 2];
    d.w_off = desc[i * 5 + 3];
    d.b_off = desc[i * 5 + 4];
    if (d.k_pad % 16 != 0 || d.k_pad > kmax || d.n_pad % 8 != 0 ||
        d.n > d.n_pad || d.w_off % 8 != 0)
      return (int)cudaErrorInvalidValue;
  }

  const size_t smem =
      sizeof(__nv_bfloat16) *
          ((size_t)2 * kTileRows * p.ldx + (size_t)kTileRows * p.xyz_pad +
           (size_t)p.R * p.dir_pad) +
      sizeof(float) * ((size_t)kTileRows * 4 + (size_t)p.R * 8 +
                       (size_t)p.R * S * 4);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_render_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + p.R - 1) / p.R;
  fused_render_fwd_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
