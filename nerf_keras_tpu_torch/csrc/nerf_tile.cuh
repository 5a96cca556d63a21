// Device code shared by the ray megakernel's forward (K1, and K6 over
// encodings: fused_render_fwd.cu) and backward (K2, K3 and K6:
// fused_render_bwd.cu), by the MLP kernel over encodings (K5,
// fused_mlp_fwd.cu and fused_mlp_bwd.cu) and by the int8 ray megakernel
// (K4, quant_render_fwd.cu): the Fourier encoding of one coordinate
// column, the compositing of whole rays (K1, K4, K6), the 64-row bf16
// tile product with its epilogues, and the MLP's forward and backward over
// one tile.
//
// A tile product computes out[64, n] = epilogue(in[64, k_pad] @ Pack^T)
// with mma.sync m16n8k16 (bf16 operands, f32 accumulation).  `in` is a
// bf16 tile in shared memory with row stride ldx (padded so the A-fragment
// loads hit 32 distinct banks).  Pack holds one row per output column,
// each 16-wide k-group interleaved [0,1,8,9,2,3,10,11,...] so a thread's
// B fragment (k = 2t, 2t+1, 2t+8, 2t+9) is one 8-byte load; it is read
// from global memory (it stays in L2) with a one-step prefetch.  Warp w
// owns 8-column output tiles w, w+8, ... in passes of kNB tiles and all
// 64 rows.  No block-level sync inside.
//
// The forward products use the weight pack W^T (output column = layer
// output); the backward's dX products use the transposed pack (output
// column = layer input, k = layer output).  K2's transposed pack holds
// only the input columns whose gradient feeds the walk (the hidden part of
// each layer input); K5's, with input gradients, holds every input column
// of every layer, so the products also give the encodings' gradients.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nkt {

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
  int w_off;  // offset of the packed matrix (n_pad, k_pad) in the bf16 pack
  int b_off;  // offset of the bias (n_pad) in the f32 pack
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ __forceinline__ bool is_skip(int i, int skip_layer) {
  return i % skip_layer == 0 && i > 0;
}

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

enum Epilogue {
  kReluBf16 = 0,      // out = bf16(relu(v + b))
  kFeatureSigma = 1,  // columns [0, n-1) -> bf16 out, column n-1 -> sig (f32)
  kRgbLogits = 2,     // columns 0..2 -> rgbl (f32)
  kReluBf16Mask = 3,  // kReluBf16, and set bit (row, col) of `mask` where out > 0
  // Backward (dX) products.  Columns [0, split) are the hidden part of the
  // layer input: their column sums of v go to db, and
  kBwdMask = 4,       //   out = bf16(v * bit(row, col)); columns >= split add
                      //   v into acc (f32) when acc is given, else are dropped
  kBwdPlain = 5,      //   out = bf16(v); columns >= split: out = bf16(v) too
};

// What an epilogue writes besides (or instead of) the bf16 `out` tile.
struct Epi {
  __nv_bfloat16* out;  // bf16 tile, row stride ldx
  const float* bias;   // forward modes: (n_pad) f32
  float* sig;          // kFeatureSigma: per-row sigma, or null
  float* rgbl;         // kRgbLogits: (rows, 3)
  uint32_t* mask;      // relu bits, `mask_words` 32-bit words per row
  int mask_words;
  float* db;           // backward modes: (split) f32 column sums, accumulated
  int split;           // backward modes: width of the hidden part (even)
  float* acc;          // kBwdMask: (64, acc_ld) f32 for columns >= split, or null
  int acc_ld;
  int rows_valid;
};

template <int MODE>
__device__ __forceinline__ void tile_gemm(const __nv_bfloat16* W, const Dense& L,
                                          const __nv_bfloat16* in, int ldx,
                                          const Epi& e) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int nt_total = L.n_pad >> 3;
  const int ksteps = L.k_pad >> 4;
  W += L.w_off;

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
        for (int k = 0; k < 4; ++k) acc[mt][s][k] = 0.f;

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
      if (!valid[s]) continue;  // warp-uniform
      const int c0 = tile[s] * 8 + tg * 2;
      float b0 = 0.f, b1 = 0.f;
      if (MODE <= kReluBf16Mask) {
        b0 = e.bias[c0];
        b1 = e.bias[c0 + 1];
      }
      // Backward modes: the split is even, so c0 and c0 + 1 fall on one side.
      const bool hidden_col = c0 < e.split;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = mt * 16 + g + half * 8;
          float v0 = acc[mt][s][half * 2 + 0] + b0;
          float v1 = acc[mt][s][half * 2 + 1] + b1;
          __nv_bfloat162* o =
              reinterpret_cast<__nv_bfloat162*>(e.out + row * ldx + c0);
          if (MODE == kReluBf16 || MODE == kReluBf16Mask) {
            const __nv_bfloat162 h =
                __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
            *o = h;
            if (MODE == kReluBf16Mask) {
              // The mask of the rounded value, as the reference takes it.
              const uint32_t bits =
                  (__bfloat162float(h.x) > 0.f ? 1u : 0u) |
                  (__bfloat162float(h.y) > 0.f ? 2u : 0u);
              if (bits)
                atomicOr(e.mask + row * e.mask_words + (c0 >> 5), bits << (c0 & 31));
            }
          } else if (MODE == kFeatureSigma) {
            // Columns [0, hidden) are the feature, column hidden is sigma.
            const int hid = L.n - 1;
            if (c0 + 1 < hid) {
              *o = __floats2bfloat162_rn(v0, v1);
            } else if (c0 == hid) {
              if (e.sig != nullptr && row < e.rows_valid) e.sig[row] = v0;
            }
          } else if (MODE == kRgbLogits) {
            if (row < e.rows_valid) {
              if (c0 < 3) e.rgbl[row * 3 + c0] = v0;
              if (c0 + 1 < 3) e.rgbl[row * 3 + c0 + 1] = v1;
            }
          } else if (hidden_col) {  // kBwdMask, kBwdPlain: the hidden part
            if (MODE == kBwdMask) {
              const uint32_t word = e.mask[row * e.mask_words + (c0 >> 5)];
              if (!((word >> (c0 & 31)) & 1u)) v0 = 0.f;
              if (!((word >> ((c0 + 1) & 31)) & 1u)) v1 = 0.f;
            }
            *o = __floats2bfloat162_rn(v0, v1);
            sum0 += v0;
            sum1 += v1;
          } else if (MODE == kBwdPlain) {
            *o = __floats2bfloat162_rn(v0, v1);
          } else if (e.acc != nullptr) {  // kBwdMask beyond the split
            float* a = e.acc + row * e.acc_ld + (c0 - e.split);
            a[0] += v0;
            a[1] += v1;
          }
        }
      }
      if ((MODE == kBwdMask || MODE == kBwdPlain) && hidden_col) {
        // Column sums over the tile's 64 rows: reduce over g (lane bits 2-4).
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
          sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
        }
        if (g == 0) {
          e.db[c0] += sum0;
          e.db[c0 + 1] += sum1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The network as the tile code sees it.

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

// One 64-row tile through the whole MLP.  On entry buf0 holds the
// position encodings (bf16, columns [0, xyz_pad), zero beyond xyz_dim);
// `xenc` is a copy of them (row stride xyz_pad) for the skip concats, and
// dir(row, c) gives direction feature c of tile row `row` (bf16, zero for
// c >= dir_dim).  Writes sigma (f32, per row) to sig and the rgb logits
// (f32, rows x 3) to rgbl for rows < rows_valid.  bf16 rounding sits where
// the reference puts it: the encodings, each post-ReLU hidden, the feature
// before the concat; sigma and the rgb logits stay f32.  Ends synchronised.
template <class DirFn>
__device__ void mlp_forward_tile(const MlpDims& m, const __nv_bfloat16* w, const float* b,
                                 __nv_bfloat16* buf0, __nv_bfloat16* buf1,
                                 const __nv_bfloat16* xenc, DirFn dir, float* sig,
                                 float* rgbl, int rows_valid) {
  const int tid = threadIdx.x;
  const int ldx = m.ldx;
  const int H = m.hidden;
  const int L = m.num_layers;
  __nv_bfloat16* in = buf0;
  __nv_bfloat16* out = buf1;
  Epi e{};
  e.rows_valid = rows_valid;
  for (int i = 0; i < L; ++i) {
    e.out = out;
    e.bias = b + m.dense[i].b_off;
    tile_gemm<kReluBf16>(w, m.dense[i], in, ldx, e);
    if (is_skip(i, m.skip_layer)) {
      for (int j = tid; j < kTileRows * m.xyz_pad; j += kThreads) {
        const int row = j / m.xyz_pad, c = j - row * m.xyz_pad;
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
  const Dense& fs = m.dense[L];
  e.out = out;
  e.bias = b + fs.b_off;
  e.sig = sig;
  tile_gemm<kFeatureSigma>(w, fs, in, ldx, e);
  for (int j = tid; j < kTileRows * m.dir_pad; j += kThreads) {
    const int row = j / m.dir_pad, c = j - row * m.dir_pad;
    out[row * ldx + H + c] = dir(row, c);
  }
  __syncthreads();
  e.out = in;
  e.bias = b + m.dense[L + 1].b_off;
  tile_gemm<kReluBf16>(w, m.dense[L + 1], out, ldx, e);
  __syncthreads();
  e.out = out;
  e.bias = b + m.dense[L + 2].b_off;
  e.rgbl = rgbl;
  tile_gemm<kRgbLogits>(w, m.dense[L + 2], in, ldx, e);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The backward over one tile (K2, K3, K5 and K6).

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

// The 64 rows of a bf16 tile (row stride ldx, columns [0, width)) to the
// workspace of one layer at the 64-row stage starting at row0 (a multiple
// of 64), in nerf_dw.cuh's layout: element (r, c) at (r / 64) * 64 * width
// + (c / 8) * 512 + (r % 64) * 8 + c % 8.  Rows past the last sample are
// stored too: their inputs are zero and their dPre zero, so they add
// nothing to dW.
__device__ __forceinline__ void store_tile(const __nv_bfloat16* src, int ldx,
                                           __nv_bfloat16* dst, int width, size_t row0) {
  const int vecs = width >> 3;
  __nv_bfloat16* stage = dst + (row0 >> 6) * 64 * width;
  for (int i = threadIdx.x; i < kTileRows * vecs; i += kThreads) {
    const int row = i & (kTileRows - 1), cc = i >> 6;
    *reinterpret_cast<uint4*>(stage + cc * 512 + row * 8) =
        *reinterpret_cast<const uint4*>(src + row * ldx + cc * 8);
  }
}

// Position features of a tile read from stored (N, xyz_dim) bf16
// encodings (K2's residual, K5's and K6's input): tile row `row` is sample
// row0 + row.
struct StoredXenc {
  const __nv_bfloat16* x;
  size_t row0;
  int dim;
  __device__ __forceinline__ __nv_bfloat16 operator()(int row, int c) const {
    return x[(row0 + row) * dim + c];
  }
};

// The MLP's backward for the 64-row tile at workspace rows [row0, row0 +
// nrows), given the cotangent g of its raw predictions (f32, row stride 4:
// d rgb logits, d sigma; rows < nrows are read).
//   * Recompute: from the position encodings, xenc(row, c) for row <
//     nrows and c < xyz_dim as bf16 (read from a stored residual, or
//     encoded from the points by K3), with the same products as the
//     forward, so the same ReLU pattern; each ReLU's sign is kept as a
//     bitmask (masks: (L + 1) x (64, mask_words) words, trunk then branch)
//     and each layer's input (A) is written to the workspace.
//   * Reverse walk with the dX products, writing each layer's dPre (D) to
//     the workspace and adding the bias gradients (f32 column sums of
//     dPre) into db (the forward bias-pack layout).
//   * With dx_out (K5's input gradients; the transposed pack then has every
//     input column): the gradient of the position encodings, the skip
//     concats' columns plus the layer-0 product, summed in f32 in dx_acc
//     ((64, xyz_pad) shared memory) and written to dx_out rows as bf16.
//     With dd_out: the branch product's direction columns, written per
//     sample as bf16.
// dir(row, c) gives the direction features as in mlp_forward_tile.
// Starts and ends synchronised.
template <class XencFn, class DirFn>
__device__ void mlp_backward_tile(const MlpBwdParams& p, __nv_bfloat16* buf0,
                                  __nv_bfloat16* buf1, uint32_t* masks, float* db,
                                  size_t row0, int nrows, XencFn xenc, DirFn dir,
                                  const float* g,
                                  float* dx_acc, __nv_bfloat16* dx_out,
                                  __nv_bfloat16* dd_out) {
  const MlpDims& m = p.m;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ldx = m.ldx;
  const int H = m.hidden;
  const int L = m.num_layers;
  const int MW = p.mask_words;
  const size_t N = p.N;
  const Dense& fs = m.dense[L];
  const Dense& br = m.dense[L + 1];
  const Dense& rgb = m.dense[L + 2];
  if (dx_out == nullptr) dx_acc = nullptr;

  // The x_enc tile (fetched again for the skip concat).
  auto load_xenc = [&](__nv_bfloat16* dst) {
    for (int i = tid; i < kTileRows * m.xyz_pad; i += kThreads) {
      const int row = i / m.xyz_pad, c = i - row * m.xyz_pad;
      dst[row * ldx + c] =
          row < nrows && c < m.xyz_dim ? xenc(row, c) : __float2bfloat16_rn(0.f);
    }
  };
  load_xenc(buf0);
  for (int i = tid; i < (L + 1) * kTileRows * MW; i += kThreads) masks[i] = 0u;
  if (dx_acc != nullptr)
    for (int i = tid; i < kTileRows * m.xyz_pad; i += kThreads) dx_acc[i] = 0.f;
  __syncthreads();

  // ---- Forward recompute, storing each layer's input (A).
  __nv_bfloat16* in = buf0;
  __nv_bfloat16* out = buf1;
  Epi e{};
  e.mask_words = MW;
  e.rows_valid = nrows;
  for (int i = 0; i < L; ++i) {
    const Dense& d = m.dense[i];
    store_tile(in, ldx, p.ws_a + N * p.bwd[i].a_col, d.k_pad, row0);
    e.out = out;
    e.bias = p.b + d.b_off;
    e.mask = masks + i * kTileRows * MW;
    tile_gemm<kReluBf16Mask>(p.w, d, in, ldx, e);
    if (is_skip(i, m.skip_layer)) load_xenc(out + H);
    __syncthreads();
    __nv_bfloat16* tmp = in;
    in = out;
    out = tmp;
  }
  store_tile(in, ldx, p.ws_a + N * p.bwd[L].a_col, fs.k_pad, row0);
  e.out = out;
  e.bias = p.b + fs.b_off;
  e.sig = nullptr;  // sigma's cotangent is given; its value is not needed
  tile_gemm<kFeatureSigma>(p.w, fs, in, ldx, e);
  for (int j = tid; j < kTileRows * m.dir_pad; j += kThreads) {
    const int row = j / m.dir_pad, c = j - row * m.dir_pad;
    out[row * ldx + H + c] = dir(row, c);
  }
  __syncthreads();
  store_tile(out, ldx, p.ws_a + N * p.bwd[L + 1].a_col, br.k_pad, row0);
  e.out = in;
  e.bias = p.b + br.b_off;
  e.mask = masks + L * kTileRows * MW;
  tile_gemm<kReluBf16Mask>(p.w, br, out, ldx, e);
  __syncthreads();
  store_tile(in, ldx, p.ws_a + N * p.bwd[L + 2].a_col, rgb.k_pad, row0);

  // ---- Backward walk.  `out` is free: d rgb logits, bf16, 16 columns.
  const int dw_rgb = p.bwd[L + 2].d_width;
  for (int i = tid; i < kTileRows * dw_rgb; i += kThreads) {
    const int row = i / dw_rgb, c = i - row * dw_rgb;
    const float v = c < 3 && row < nrows ? g[row * 4 + c] : 0.f;
    out[row * ldx + c] = __float2bfloat16_rn(v);
  }
  if (warp == 0) {  // f32 bias sums of the rgb head and the sigma column
    for (int c = 0; c < 4; ++c) {
      float s = 0.f;
      for (int row = lane; row < nrows; row += 32) s += g[row * 4 + c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        if (c < 3) db[rgb.b_off + c] += s;
        else db[fs.b_off + H] += s;
      }
    }
  }
  __syncthreads();
  store_tile(out, ldx, p.ws_d + N * p.bwd[L + 2].d_col, dw_rgb, row0);
  // dh2 = drgb W_rgb^T, masked by h2 > 0: dPre of the branch.
  e.out = in;
  e.mask = masks + L * kTileRows * MW;
  e.db = db + br.b_off;
  e.split = p.bdense[L + 2].n;
  tile_gemm<kBwdMask>(p.wb, p.bdense[L + 2], out, ldx, e);
  __syncthreads();
  store_tile(in, ldx, p.ws_d + N * p.bwd[L + 1].d_col, p.bwd[L + 1].d_width, row0);
  // dfd = dh2 W_br^T: the feature columns [0, H), with d sigma the merged
  // head's dPre [dfeature, dsigma]; with K5's full pack also the direction
  // columns [H, H + dir_dim).
  e.out = out;
  e.db = db + fs.b_off;
  e.split = H;
  tile_gemm<kBwdPlain>(p.wb, p.bdense[L + 1], in, ldx, e);
  __syncthreads();
  if (dd_out != nullptr) {
    for (int i = tid; i < nrows * m.dir_dim; i += kThreads) {
      const int row = i / m.dir_dim, c = i - row * m.dir_dim;
      dd_out[(row0 + row) * m.dir_dim + c] = out[row * ldx + H + c];
    }
    __syncthreads();
  }
  const int dw_fs = p.bwd[L].d_width;
  for (int i = tid; i < kTileRows * (dw_fs - H); i += kThreads) {
    const int row = i / (dw_fs - H), c = i - row * (dw_fs - H);
    const float v = c == 0 && row < nrows ? g[row * 4 + 3] : 0.f;
    out[row * ldx + H + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  store_tile(out, ldx, p.ws_d + N * p.bwd[L].d_col, dw_fs, row0);
  // dx_last = dfs W_fs^T: its hidden columns, masked by h_{L-1} > 0, are
  // dPre_{L-1}; a skip part (the last trunk layer is a skip) goes to dx_acc.
  e.out = in;
  e.mask = masks + (L - 1) * kTileRows * MW;
  e.db = db + m.dense[L - 1].b_off;
  e.acc = dx_acc;
  e.acc_ld = m.xyz_pad;
  tile_gemm<kBwdMask>(p.wb, p.bdense[L], out, ldx, e);
  __syncthreads();
  // Trunk: `in` holds dPre_i; dX_i's hidden columns give dPre_{i-1}, its
  // skip columns (layer i's input is [h, x_enc]) go to dx_acc.  Layer 0's
  // dX is all encoding gradient.
  for (int i = L - 1; i >= 0; --i) {
    store_tile(in, ldx, p.ws_d + N * p.bwd[i].d_col, p.bwd[i].d_width, row0);
    if (i > 0 || dx_acc != nullptr) {
      e.out = out;
      e.split = i > 0 ? H : 0;
      e.mask = masks + (i > 0 ? i - 1 : 0) * kTileRows * MW;
      e.db = db + m.dense[i > 0 ? i - 1 : 0].b_off;
      tile_gemm<kBwdMask>(p.wb, p.bdense[i], in, ldx, e);
    }
    __syncthreads();
    __nv_bfloat16* tmp = in;
    in = out;
    out = tmp;
  }
  if (dx_acc != nullptr) {
    for (int i = tid; i < nrows * m.xyz_dim; i += kThreads) {
      const int row = i / m.xyz_dim, c = i - row * m.xyz_dim;
      dx_out[(row0 + row) * m.xyz_dim + c] = __float2bfloat16_rn(dx_acc[row * m.xyz_pad + c]);
    }
    __syncthreads();
  }
}

}  // namespace nkt
