// Device code shared by the ray megakernel's forward (K1, and K6 over
// encodings: fused_render_fwd.cu), the MLP over encodings (K5's forward:
// fused_mlp_fwd.cu), the rows kernel of the backwards (K2, K3, K5 and K6:
// fused_render_bwd.cu) and the int8 ray megakernel (K4,
// quant_render_fwd.cu): the Fourier encoding of one coordinate column, the
// compositing of whole rays (K1, K4, K6), and the network's shape as the
// kernels see it (the layer descriptors of the forward pack, the
// transposed pack and the backward's workspace).
//
// Every kernel's MLP runs on wgmma: nerf_wgmlp.cuh's bf16 MLP, and K4's
// int8 one in quant_render_fwd.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nkt {

constexpr int kWarps = 8;  // warps that composite: the two consumer warpgroups
constexpr int kMaxDense = 16;
constexpr int kMaxSmem = 232448;
constexpr float kEps = 1e-10f;
constexpr float kTerminalDelta = 1e10f;

struct Dense {
  int k_pad;  // input width, padded to 16 (rows of W, zero-filled)
  int n;      // true output width
  int n_pad;  // output width padded to 8
  int w_off;  // offset of the packed matrix (n_pad, k_pad) in the bf16 pack
  int b_off;  // offset of the bias (n_pad) in the f32 pack
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ __forceinline__ bool is_skip(int i, int skip_layer) {
  return i % skip_layer == 0 && i > 0;
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

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// Alpha compositing of `nrays` rays of S samples (K1 and K4): relu sigma,
// sigmoid rgb, a 1e10 terminal delta, weights alpha * T with the exclusive
// transmittance T = prod(max(1 - alpha, 0) + 1e-10).  One warp per ray, a
// contiguous chunk of samples per lane plus a multiplicative warp scan.
// t: (nrays, S) global; sig (nrays*S) and rgbl (nrays*S, 3): per-sample
// sigma and rgb logits (shared memory).  Writes w_out (nrays, S) and
// rgb_out (nrays, 3).  No block-level sync inside.
__device__ __forceinline__ void composite_rays(const float* t, const float* sig,
                                               const float* rgbl, int nrays, int S,
                                               float* w_out, float* rgb_out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk = (S + 31) / 32;
  for (int r = warp; r < nrays; r += kWarps) {
    const float* tr = t + (size_t)r * S;
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
    float* wr = w_out + (size_t)r * S;
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
      rgb_out[(size_t)r * 3 + 0] = cr;
      rgb_out[(size_t)r * 3 + 1] = cg;
      rgb_out[(size_t)r * 3 + 2] = cb;
    }
  }
}

// ---------------------------------------------------------------------------
// The network as the kernels see it.

struct MlpDims {
  int num_layers, skip_layer, hidden;
  int xyz_dim, xyz_pad, dir_dim, dir_pad;
  int ldx;                  // row stride (bf16) of the activation tiles
  Dense dense[kMaxDense];   // the forward pack (W^T): trunk, merged head, branch, rgb
};

// Host side: fill `m` from the launch arguments and the forward pack's
// descriptors (a host array of n_dense * 5 ints: k_pad, n, n_pad, w_off,
// b_off); false when a shape is out of what the tile code takes.
inline bool mlp_dims_init(MlpDims& m, const int* desc, int n_dense, int num_layers,
                          int skip_layer, int hidden, int l_xyz, int l_dir) {
  if (num_layers < 1 || skip_layer < 1 || hidden < 32 || hidden % 32 != 0 ||
      l_xyz < 0 || l_dir < 0 || n_dense != num_layers + 3 || n_dense > kMaxDense)
    return false;
  m.num_layers = num_layers;
  m.skip_layer = skip_layer;
  m.hidden = hidden;
  m.xyz_dim = 3 + 6 * l_xyz;
  m.xyz_pad = round_up(m.xyz_dim, 16);
  m.dir_dim = 3 + 6 * l_dir;
  m.dir_pad = round_up(m.dir_dim, 16);
  const int kmax = hidden + (m.xyz_pad > m.dir_pad ? m.xyz_pad : m.dir_pad);
  // +8 bf16: row stride of 4 (mod 8) words keeps A-fragment loads
  // conflict-free.
  m.ldx = kmax + 8;
  for (int i = 0; i < n_dense; ++i) {
    Dense& d = m.dense[i];
    d = Dense{desc[i * 5], desc[i * 5 + 1], desc[i * 5 + 2], desc[i * 5 + 3],
              desc[i * 5 + 4]};
    if (d.k_pad % 16 != 0 || d.k_pad > kmax || d.n_pad % 8 != 0 || d.n > d.n_pad ||
        d.n_pad > kmax || d.w_off % 8 != 0)
      return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// The backward (K2, K3, K5 and K6).

// Per dense layer, where its backward lives in the workspaces.
struct Bwd {
  int a_col;    // A (layer input, bf16) at ws_a + N * a_col, row stride a_width
  int a_width;  // = forward k_pad
  int d_col;    // D (dPre, bf16) at ws_d + N * d_col, row stride d_width
  int d_width;  // = round16(n)
  int out_off;  // dW (a_width x d_width f32) at dw + out_off
};

struct MlpBwdParams {
  const __nv_bfloat16* w;      // forward pack
  const float* b;
  const __nv_bfloat16* wb;     // transposed pack (dX products)
  __nv_bfloat16* ws_a;
  __nv_bfloat16* ws_d;
  int N;           // workspace rows per layer (samples, padded)
  int mask_words;  // hidden / 32
  MlpDims m;
  Dense bdense[kMaxDense];
  Bwd bwd[kMaxDense];
};

// Host side: the transposed pack's and the workspace's descriptors
// (desc_bwd: k_pad = round16(layer outputs), n = dX columns; desc_ws:
// a_col, a_width, d_col, d_width, out_off), checked against the forward.
inline bool mlp_bwd_init(MlpBwdParams& p, const int* desc_bwd, const int* desc_ws,
                         int n_dense) {
  const MlpDims& m = p.m;
  const int kmax = m.ldx - 8;
  p.mask_words = m.hidden / 32;
  for (int i = 0; i < n_dense; ++i) {
    const Dense& d = m.dense[i];
    Dense& bd = p.bdense[i];
    bd = Dense{desc_bwd[i * 5], desc_bwd[i * 5 + 1], desc_bwd[i * 5 + 2],
               desc_bwd[i * 5 + 3], desc_bwd[i * 5 + 4]};
    Bwd& w = p.bwd[i];
    w = Bwd{desc_ws[i * 5], desc_ws[i * 5 + 1], desc_ws[i * 5 + 2], desc_ws[i * 5 + 3],
            desc_ws[i * 5 + 4]};
    if (bd.k_pad % 16 != 0 || bd.k_pad > kmax || bd.n_pad % 8 != 0 || bd.n > bd.n_pad ||
        bd.n_pad > kmax || bd.w_off % 8 != 0 || w.a_width != d.k_pad ||
        w.d_width != bd.k_pad || w.d_width % 16 != 0 || w.out_off % 2 != 0)
      return false;
  }
  // The merged head's dPre carries [dfeature (hidden), dsigma] in d_width.
  return p.bwd[m.num_layers].d_width > m.hidden && p.bwd[m.num_layers + 2].d_width >= 3;
}

}  // namespace nkt
