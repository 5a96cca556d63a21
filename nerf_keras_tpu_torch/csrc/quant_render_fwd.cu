// K4 on Hopper: the int8 NeRF ray megakernel (forward only).
//
// Replaces the TPU kernel `_fwd_kernel_q`
// (nerf_keras_tpu/ops/pallas/quant_render.py:66, launched by the
// pl.pallas_call at :141, entry `render_rays_fused_quant` at :100; its MLP
// body is `quant_forward_tile`, nerf_keras_tpu/ops/quant.py:212).
//
// What it computes, per ray, without leaving on-chip memory between steps:
//   points o + t*d (f32) -> Fourier encode of the points (63 wide, f32),
//   quantized per column with inv_x -> the int8 trunk (8x256, skip concat
//   [hq | qx] after layer 4), the merged feature(256)+sigma(1) head, the
//   128-wide branch over [qfeat | qd] and the rgb head: int8 x int8 ->
//   int32 products, dequantized per output column as
//   y = float(acc) * scale[j] + b[j] (two roundings), then relu (trunk,
//   branch) and requantized with q = rint(y * inv[j]) (half to even),
//   clamped to [-127, 127].  The feature is signed and linear (no relu)
//   and requantized with inv_feat; sigma and the rgb logits stay f32.
//   The direction is encoded and quantized with inv_d once per ray.  Then
//   K1's compositing (composite_rays, nerf_tile.cuh).
// The encodings stay f32 up to their int8 rounding: a bf16 round first (as
// K1 takes them) would move values across quantization boundaries.
//
// What bounds it on this card: 593,408 int8 multiply-adds per sample at
// full width (1.187 MOP), against a few bytes per sample (o, d per ray; one
// t in and one weight out per sample).  At the int8 dense peak of 1,979
// TOPS and 3.35 TB/s the operations bound it: at B=16384 rays, S=64 ->
// 0.63 ms, S=192 -> 1.89 ms.
//
// What the design does about that: K1's structure with int8 operands.
//   * A block of 8 warps owns R whole rays (R = max(1, 64 / S)) and streams
//     64-sample tiles through the MLP; activations stay in shared memory as
//     int8 (two ping-pong buffers of 64 x (hidden + 80) bytes, half of K1's
//     bytes per row).
//   * Products use mma.sync m16n8k32 (s8 operands, s32 accumulation).  K is
//     padded to 32 per layer (63 -> 64, 319 -> 320, 283 -> 288), N to 8
//     (257 -> 264, 3 -> 8); padded columns are zero in the pack.  The pack
//     (W^T, one row per output column, every 32-wide k-group interleaved
//     [0..3, 16..19, 4..7, 20..23, ...]) gives a thread its B fragment
//     (k = 4t..4t+3, 16+4t..16+4t+3) as one 8-byte load; it is built once
//     per set of qparams and read from global memory (L2), with a one-step
//     prefetch.
//   * The skip and branch concats are one int8 operand each, their
//     per-column scales folded into the pack rows: no rescale pass.
// wgmma, TMA and warp specialisation are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (never -use_fast_math: the top octave's
//        argument is 2^9*|p|, where the fast sin is wrong).

#include "nerf_tile.cuh"

using namespace nkt;

namespace {

struct QDense {
  int k_pad;  // input width, padded to 32 (rows of W, zero-filled)
  int n;      // true output width
  int n_pad;  // output width padded to 8
  int w_off;  // offset of the packed (n_pad, k_pad) int8 matrix
  int f_off;  // offset of its f32 rows: scale, bias, inv (n_pad each)
};

struct QDims {
  int num_layers, skip_layer, hidden;
  int xyz_dim, xyz_pad, dir_dim, dir_pad;  // pads: multiples of 32
  int ldx;                                 // row stride (bytes) of the activation tiles
  int x_off, d_off;                        // inv_x, inv_d rows in the f32 pack
  QDense dense[kMaxDense];                 // trunk, merged head, branch, rgb
};

struct Params {
  const float* origins;  // (B, 3)
  const float* dirs;     // (B, 3)
  const float* t_vals;   // (B, S)
  const int8_t* w;
  const float* f;
  float* rgb_out;  // (B, 3)
  float* w_out;    // (B, S)
  int B, S, R;
  QDims m;
};

__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// round(v * inv), half to even, clamped to [-127, 127] (never -128).
__device__ __forceinline__ int8_t quantize(float v, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

enum QEpilogue {
  kQRelu = 0,       // out = q(relu(y) * inv)
  kQFeatSigma = 1,  // columns [0, n-1): out = q(y * inv); column n-1 -> sig (f32)
  kQRgb = 2,        // columns 0..2 -> rgbl (f32)
};

// out[64, n] = epilogue(in[64, k_pad] @ Pack^T) for one layer.  Warp w owns
// 8-column output tiles w, w+8, ... in passes of kNB tiles and all 64 rows.
// No block-level sync inside.
template <int MODE>
__device__ __forceinline__ void qtile_gemm(const int8_t* W, const float* F, const QDense& L,
                                           const int8_t* in, int ldx, int8_t* out,
                                           float* sig, float* rgbl, int rows_valid) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int nt_total = L.n_pad >> 3;
  const int ksteps = L.k_pad >> 5;
  W += L.w_off;
  const float* scale = F + L.f_off;
  const float* bias = scale + L.n_pad;
  const float* inv = bias + L.n_pad;

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
      bptr[s] = reinterpret_cast<const uint2*>(W + (size_t)n * L.k_pad + tg * 8);
    }

    int acc[4][kNB][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int s = 0; s < kNB; ++s)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][s][k] = 0;

    uint2 bcur[kNB], bnxt[kNB];
#pragma unroll
    for (int s = 0; s < kNB; ++s)
      bcur[s] = valid[s] ? __ldg(bptr[s]) : make_uint2(0u, 0u);

    for (int ks = 0; ks < ksteps; ++ks) {
      // One k-step = 32 int8 = 32 bytes = 4 uint2 along the packed row.
#pragma unroll
      for (int s = 0; s < kNB; ++s)
        bnxt[s] = (valid[s] && ks + 1 < ksteps) ? __ldg(bptr[s] + (ks + 1) * 4)
                                                 : make_uint2(0u, 0u);
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int8_t* r0 = in + (mt * 16 + g) * ldx + ks * 32 + tg * 4;
        const int8_t* r1 = r0 + 8 * ldx;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(r1);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(r1 + 16);
      }
#pragma unroll
      for (int s = 0; s < kNB; ++s) {
        if (!valid[s]) continue;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_s8_16832(acc[mt][s], a[mt], bcur[s].x, bcur[s].y);
      }
#pragma unroll
      for (int s = 0; s < kNB; ++s) bcur[s] = bnxt[s];
    }

    // Epilogue: thread holds rows (mt*16+g, +8), columns (c0, c0+1).
#pragma unroll
    for (int s = 0; s < kNB; ++s) {
      if (!valid[s]) continue;  // warp-uniform
      const int c0 = tile[s] * 8 + tg * 2;
      const float s0 = scale[c0], s1 = scale[c0 + 1];
      const float b0 = bias[c0], b1 = bias[c0 + 1];
      float i0 = 0.f, i1 = 0.f;
      if (MODE != kQRgb) {
        i0 = inv[c0];
        i1 = inv[c0 + 1];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = mt * 16 + g + half * 8;
          const float v0 = __fadd_rn(__fmul_rn((float)acc[mt][s][half * 2 + 0], s0), b0);
          const float v1 = __fadd_rn(__fmul_rn((float)acc[mt][s][half * 2 + 1], s1), b1);
          char2* o = reinterpret_cast<char2*>(out + row * ldx + c0);
          if (MODE == kQRelu) {
            *o = make_char2(quantize(fmaxf(v0, 0.f), i0), quantize(fmaxf(v1, 0.f), i1));
          } else if (MODE == kQFeatSigma) {
            // Columns [0, hidden) are the feature, column hidden is sigma
            // (hidden is even, so c0 and c0 + 1 fall on one side).
            const int hid = L.n - 1;
            if (c0 + 1 < hid) {
              *o = make_char2(quantize(v0, i0), quantize(v1, i1));
            } else if (c0 == hid && row < rows_valid) {
              sig[row] = v0;
            }
          } else if (row < rows_valid) {  // kQRgb
            if (c0 < 3) rgbl[row * 3 + c0] = v0;
            if (c0 + 1 < 3) rgbl[row * 3 + c0 + 1] = v1;
          }
        }
      }
    }
  }
}

// One 64-row tile through the int8 MLP.  On entry buf0 holds the quantized
// position encodings (columns [0, xyz_pad), zero beyond xyz_dim) and xq a
// copy of them (row stride xyz_pad) for the skip concats; dir4(row, w) gives
// word w (4 int8) of the quantized direction features of tile row `row`.
// Writes sigma (per row) and the rgb logits (rows x 3) for rows <
// rows_valid.  Ends synchronised.
template <class DirFn>
__device__ void qmlp_forward_tile(const QDims& m, const int8_t* w, const float* f,
                                  int8_t* buf0, int8_t* buf1, const int8_t* xq, DirFn dir4,
                                  float* sig, float* rgbl, int rows_valid) {
  const int tid = threadIdx.x;
  const int ldx = m.ldx;
  const int H = m.hidden;
  const int L = m.num_layers;
  const int xw = m.xyz_pad >> 2, dw = m.dir_pad >> 2;
  int8_t* in = buf0;
  int8_t* out = buf1;
  for (int i = 0; i < L; ++i) {
    qtile_gemm<kQRelu>(w, f, m.dense[i], in, ldx, out, nullptr, nullptr, rows_valid);
    if (is_skip(i, m.skip_layer)) {  // [hq | qx]
      for (int j = tid; j < kTileRows * xw; j += kThreads) {
        const int row = j / xw, c = j - row * xw;
        reinterpret_cast<uint32_t*>(out + row * ldx + H)[c] =
            reinterpret_cast<const uint32_t*>(xq)[j];
      }
    }
    __syncthreads();
    int8_t* tmp = in;
    in = out;
    out = tmp;
  }
  // Merged feature+sigma head; the direction features fill the columns
  // after the feature, so `out` becomes the branch input [qfeat | qd].
  qtile_gemm<kQFeatSigma>(w, f, m.dense[L], in, ldx, out, sig, nullptr, rows_valid);
  for (int j = tid; j < kTileRows * dw; j += kThreads) {
    const int row = j / dw, c = j - row * dw;
    reinterpret_cast<uint32_t*>(out + row * ldx + H)[c] = dir4(row, c);
  }
  __syncthreads();
  qtile_gemm<kQRelu>(w, f, m.dense[L + 1], out, ldx, in, nullptr, nullptr, rows_valid);
  __syncthreads();
  qtile_gemm<kQRgb>(w, f, m.dense[L + 2], in, ldx, out, nullptr, rgbl, rows_valid);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    quant_render_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const QDims& m = p.m;
  const int tid = threadIdx.x;
  const int ldx = m.ldx;
  const int R = p.R;
  const int S = p.S;

  // Shared-memory carve-up (all section sizes are multiples of 16 bytes).
  int8_t* buf0 = reinterpret_cast<int8_t*>(smem);
  int8_t* buf1 = buf0 + kTileRows * ldx;
  int8_t* xq = buf1 + kTileRows * ldx;    // (64, xyz_pad)
  int8_t* dq = xq + kTileRows * m.xyz_pad;  // (R, dir_pad)
  float* pts = reinterpret_cast<float*>(dq + R * m.dir_pad);  // (64, 4)
  float* ray_o = pts + kTileRows * 4;  // (R, 4)
  float* ray_d = ray_o + R * 4;        // (R, 4)
  float* sig = ray_d + R * 4;          // (R*S)
  float* rgbl = sig + R * S;           // (R*S, 3)
  const float* inv_x = p.f + m.x_off;
  const float* inv_d = p.f + m.d_off;

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
  // Direction features, quantized once per ray (every sample of a ray
  // shares them); inv_d is zero beyond dir_dim.
  for (int i = tid; i < R * m.dir_pad; i += kThreads) {
    const int r = i / m.dir_pad, c = i - r * m.dir_pad;
    dq[i] = quantize(encode_feature(ray_d + r * 4, c, m.dir_dim), inv_d[c]);
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
    // f32 encode, quantized per column with inv_x (zero beyond xyz_dim).
    for (int i = tid; i < kTileRows * m.xyz_pad; i += kThreads) {
      const int row = i / m.xyz_pad, c = i - row * m.xyz_pad;
      const int8_t q = quantize(encode_feature(pts + row * 4, c, m.xyz_dim), inv_x[c]);
      buf0[row * ldx + c] = q;
      xq[i] = q;
    }
    __syncthreads();
    const int dw = m.dir_pad >> 2;
    auto dir4 = [&](int row, int c) -> uint32_t {
      const int q = q0 + row;
      return q < P ? reinterpret_cast<const uint32_t*>(dq)[(q / S) * dw + c] : 0u;
    };
    qmlp_forward_tile(m, p.w, p.f, buf0, buf1, xq, dir4, sig + q0, rgbl + q0 * 3,
                      rows_valid);
  }

  composite_rays(p.t_vals + (size_t)r0 * S, sig, rgbl, nrays, S,
                 p.w_out + (size_t)r0 * S, p.rgb_out + (size_t)r0 * 3);
}

// Host side: fill `m` from the launch arguments and the pack's descriptors;
// false when a shape is out of what the kernel takes.
bool qdims_init(QDims& m, const int* desc, int n_dense, int num_layers, int skip_layer,
                int hidden, int l_xyz, int l_dir, int x_off, int d_off) {
  if (num_layers < 1 || skip_layer < 1 || hidden < 32 || hidden % 32 != 0 || l_xyz < 0 ||
      l_dir < 0 || n_dense != num_layers + 3 || n_dense > kMaxDense || x_off < 0 ||
      d_off < 0)
    return false;
  m.num_layers = num_layers;
  m.skip_layer = skip_layer;
  m.hidden = hidden;
  m.xyz_dim = 3 + 6 * l_xyz;
  m.xyz_pad = round_up(m.xyz_dim, 32);
  m.dir_dim = 3 + 6 * l_dir;
  m.dir_pad = round_up(m.dir_dim, 32);
  const int kmax = hidden + (m.xyz_pad > m.dir_pad ? m.xyz_pad : m.dir_pad);
  // +16 bytes: a row stride of 4 (mod 8) words keeps A-fragment loads
  // conflict-free.
  m.ldx = kmax + 16;
  m.x_off = x_off;
  m.d_off = d_off;
  for (int i = 0; i < n_dense; ++i) {
    QDense& d = m.dense[i];
    d = QDense{desc[i * 5], desc[i * 5 + 1], desc[i * 5 + 2], desc[i * 5 + 3],
               desc[i * 5 + 4]};
    if (d.k_pad % 32 != 0 || d.k_pad > kmax || d.n_pad % 8 != 0 || d.n > d.n_pad ||
        d.n_pad > kmax || d.w_off % 8 != 0 || d.f_off < 0)
      return false;
  }
  const QDense& fs = m.dense[num_layers];
  return fs.n == hidden + 1 && m.dense[num_layers + 1].n == hidden / 2 &&
         m.dense[num_layers + 1].k_pad == hidden + m.dir_pad &&
         m.dense[num_layers + 2].n == 3;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `dense_desc` is a HOST array of
// n_dense * 5 ints (k_pad, n, n_pad, w_off, f_off) in the order
// trunk[0..num_layers), merged feature+sigma head, branch, rgb; `x_off` and
// `d_off` locate the inv_x and inv_d rows (padded to 32 with zeros) in the
// f32 pack.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronise and allocates nothing.
extern "C" int nkt_quant_render_fwd(const void* origins, const void* dirs, const void* t_vals,
                                    const void* w_pack, const void* f_pack,
                                    const void* dense_desc, int n_dense, int num_layers,
                                    int skip_layer, int hidden, int l_xyz, int l_dir, int x_off,
                                    int d_off, int B, int S, void* rgb_out, void* w_out,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  if (B <= 0 || S < 2 ||
      !qdims_init(p.m, static_cast<const int*>(dense_desc), n_dense, num_layers, skip_layer,
                  hidden, l_xyz, l_dir, x_off, d_off))
    return (int)cudaErrorInvalidValue;
  p.origins = static_cast<const float*>(origins);
  p.dirs = static_cast<const float*>(dirs);
  p.t_vals = static_cast<const float*>(t_vals);
  p.w = static_cast<const int8_t*>(w_pack);
  p.f = static_cast<const float*>(f_pack);
  p.rgb_out = static_cast<float*>(rgb_out);
  p.w_out = static_cast<float*>(w_out);
  p.B = B;
  p.S = S;
  p.R = S >= kTileRows ? 1 : kTileRows / S;

  const size_t smem = (size_t)2 * kTileRows * p.m.ldx + (size_t)kTileRows * p.m.xyz_pad +
                      (size_t)p.R * p.m.dir_pad +
                      sizeof(float) * ((size_t)kTileRows * 4 + (size_t)p.R * 8 +
                                       (size_t)p.R * S * 4);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(quant_render_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + p.R - 1) / p.R;
  quant_render_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
