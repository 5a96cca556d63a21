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

// Alpha compositing of `nrays` rays of S samples (K1, K4 and the float32
// kernels): relu sigma, sigmoid rgb, a 1e10 terminal delta, weights alpha *
// T with the exclusive transmittance T = prod(max(1 - alpha, 0) + 1e-10).
// One warp per ray, a contiguous chunk of samples per lane plus a
// multiplicative warp scan.  t: (nrays, S) global; sigma of sample q at
// sig[q * kSigStride], its rgb logits at rgbl[q * kRgbStride + c] (shared
// memory for the bf16 and int8 kernels; the float32 kernels read their
// (N, 4) predictions in global memory with strides 4 and 4).  Writes w_out
// (nrays, S) and rgb_out (nrays, 3).  No block-level sync inside.
template <int kSigStride = 1, int kRgbStride = 3>
__device__ __forceinline__ void composite_rays(const float* t, const float* sig,
                                               const float* rgbl, int nrays, int S,
                                               float* w_out, float* rgb_out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk = (S + 31) / 32;
  for (int r = warp; r < nrays; r += kWarps) {
    const float* tr = t + (size_t)r * S;
    const float* sg = sig + (size_t)r * S * kSigStride;
    const int j0 = min(lane * chunk, S);
    const int j1 = min(j0 + chunk, S);
    float prod = 1.f;
    for (int j = j0; j < j1; ++j) {
      const float delta = j + 1 < S ? tr[j + 1] - tr[j] : kTerminalDelta;
      const float alpha = 1.f - expf(-fmaxf(sg[j * kSigStride], 0.f) * delta);
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
    const float* lg = rgbl + (size_t)r * S * kRgbStride;
    for (int j = j0; j < j1; ++j) {
      const float delta = j + 1 < S ? tr[j + 1] - tr[j] : kTerminalDelta;
      const float alpha = 1.f - expf(-fmaxf(sg[j * kSigStride], 0.f) * delta);
      const float w = alpha * trans;
      trans *= fmaxf(1.f - alpha, 0.f) + kEps;
      wr[j] = w;
      cr += w * sigmoidf_(lg[j * kRgbStride + 0]);
      cg += w * sigmoidf_(lg[j * kRgbStride + 1]);
      cb += w * sigmoidf_(lg[j * kRgbStride + 2]);
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

// The compositing VJP (K2, K3, K6 and the float32 backward): dpreds (B*S,
// 4) from K1's predictions.
// T: the arithmetic of the VJP, float for the bf16 backwards and double for
// the float32 one (fused_render_f32.cu), whose rays' cancelling terms
// (dalpha = T dw - suffix / (1 - alpha)) would otherwise carry the f32
// rounding of this formula into the sigma head's gradient.  dpreds holds
// each sample's p_j and trans_j (two T) between the walks.
__device__ __forceinline__ float t_exp(float x) { return expf(x); }
__device__ __forceinline__ double t_exp(double x) { return exp(x); }
__device__ __forceinline__ float t_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double t_max(double a, double b) { return fmax(a, b); }
template <class T>
__device__ __forceinline__ T t_sigmoid(T x) { return T(1) / (T(1) + t_exp(-x)); }

template <class T = float>
__global__ void __launch_bounds__(256)
    composite_vjp_kernel(const float* t_vals, const float* preds, const float* g_rgb,
                         const float* g_w, float* dpreds, int B, int S) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * 8 + warp;
  if (ray >= B) return;
  float* dp = dpreds + (size_t)ray * S * 4;
  const float* tr = t_vals + (size_t)ray * S;
  const float* pr = preds + (size_t)ray * S * 4;
  const float* gw = g_w != nullptr ? g_w + (size_t)ray * S : nullptr;
  const T gr0 = g_rgb[(size_t)ray * 3 + 0];
  const T gr1 = g_rgb[(size_t)ray * 3 + 1];
  const T gr2 = g_rgb[(size_t)ray * 3 + 2];
  const T eps = T(1e-10), terminal = T(1e10), zero = T(0), one = T(1);
  const int chunk = (S + 31) / 32;
  const int j0 = min(lane * chunk, S);
  const int j1 = min(j0 + chunk, S);
  auto delta_at = [&](int j) { return j + 1 < S ? T(tr[j + 1]) - T(tr[j]) : terminal; };
  auto dws_at = [&](int j) {
    T dws = gw != nullptr ? T(gw[j]) : zero;
    dws = dws + gr0 * t_sigmoid(T(pr[j * 4 + 0]));
    dws = dws + gr1 * t_sigmoid(T(pr[j * 4 + 1]));
    dws = dws + gr2 * t_sigmoid(T(pr[j * 4 + 2]));
    return dws;
  };
  T prod = one;
  for (int j = j0; j < j1; ++j) {
    const T alpha = one - t_exp(-t_max(T(pr[j * 4 + 3]), zero) * delta_at(j));
    prod *= t_max(one - alpha, zero) + eps;
  }
  T incl = prod;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl *= v;
  }
  T trans = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) trans = one;
  // Forward walk: p_j = w_j * dw_sum_j and trans_j (stored).
  T psum = zero;
  for (int j = j0; j < j1; ++j) {
    const T alpha = one - t_exp(-t_max(T(pr[j * 4 + 3]), zero) * delta_at(j));
    const T pj = alpha * trans * dws_at(j);
    T* held = reinterpret_cast<T*>(dp + j * 4);
    held[0] = pj;
    held[1] = trans;
    psum += pj;
    trans *= t_max(one - alpha, zero) + eps;
  }
  // Exclusive suffix over lanes of the chunk sums.
  T sincl = psum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T v = __shfl_down_sync(0xffffffffu, sincl, off);
    if (lane + off < 32) sincl += v;
  }
  T suffix = __shfl_down_sync(0xffffffffu, sincl, 1);
  if (lane == 31) suffix = zero;
  // Reverse walk of the chunk: suffix = sum_{k > j} p_k.
  for (int j = j1 - 1; j >= j0; --j) {
    const T* held = reinterpret_cast<const T*>(dp + j * 4);
    const T pj = held[0];
    const T tj = held[1];
    const T dws = dws_at(j);
    const T delta = delta_at(j);
    const T sigma = t_max(T(pr[j * 4 + 3]), zero);
    const T alpha = one - t_exp(-sigma * delta);
    const T dalpha = tj * dws - suffix / (t_max(one - alpha, zero) + eps);
    suffix += pj;
    const T dsigma = sigma > zero ? dalpha * (delta * t_exp(-sigma * delta)) : zero;
    const T gr[3] = {gr0, gr1, gr2};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T rc = t_sigmoid(T(pr[j * 4 + c]));
      dp[j * 4 + c] = float(gr[c] * alpha * tj * rc * (one - rc));
    }
    dp[j * 4 + 3] = float(dsigma);
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

// The x_enc and d_enc gradient columns of K5's input-gradient products
// (nerf_wgmlp.cuh: mlp_backward_wg): 64 or 128 (xyz_dim <= 128: L_XYZ <=
// 20) and 32 or 64 (dir_dim <= 64: L_DIR <= 10).
__host__ __device__ constexpr int ig_xcols(int xyz_dim) { return xyz_dim <= 64 ? 64 : 128; }
__host__ __device__ constexpr int ig_dcols(int dir_dim) { return dir_dim <= 32 ? 32 : 64; }

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
  // The activation tile holds hidden + the widest encoding part of a
  // layer's input or of K5's input-gradient products (which pad x_enc to
  // ig_xcols and d_enc to ig_dcols columns, at least xyz_pad and dir_pad).
  const int ix = ig_xcols(m.xyz_dim), id = ig_dcols(m.dir_dim);
  const int kmax = hidden + (ix > id ? ix : id);
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
