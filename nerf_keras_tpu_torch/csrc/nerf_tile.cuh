// Device code shared by the ray megakernel's forward (K1,
// fused_render_fwd.cu) and backward (K2, fused_render_bwd.cu): the
// Fourier encoding of one coordinate column and the 64-row tile product
// with its epilogues.
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
// column = layer input, k = layer output).

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

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

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

enum Epilogue {
  kReluBf16 = 0,      // out = bf16(relu(v + b))
  kFeatureSigma = 1,  // columns [0, n-1) -> bf16 out, column n-1 -> sig (f32)
  kRgbLogits = 2,     // columns 0..2 -> rgbl (f32)
  kReluBf16Mask = 3,  // kReluBf16, and set bit (row, col) of `mask` where out > 0
  kBwdMask = 4,       // out = bf16(v * bit(row, col)); column sums of v -> db
  kBwdPlain = 5,      // out = bf16(v); column sums of v -> db
};

// What an epilogue writes besides (or instead of) the bf16 `out` tile.
struct Epi {
  __nv_bfloat16* out;  // bf16 tile, row stride ldx
  const float* bias;   // forward modes: (n_pad) f32
  float* sig;          // kFeatureSigma: per-row sigma, or null
  float* rgbl;         // kRgbLogits: (rows, 3)
  uint32_t* mask;      // relu bits, `mask_words` 32-bit words per row
  int mask_words;
  float* db;           // backward modes: (n) f32 column sums, accumulated
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
          } else {  // kBwdMask, kBwdPlain
            if (MODE == kBwdMask) {
              const uint32_t word = e.mask[row * e.mask_words + (c0 >> 5)];
              if (!((word >> (c0 & 31)) & 1u)) v0 = 0.f;
              if (!((word >> ((c0 + 1) & 31)) & 1u)) v1 = 0.f;
            }
            *o = __floats2bfloat162_rn(v0, v1);
            sum0 += v0;
            sum1 += v1;
          }
        }
      }
      if (MODE == kBwdMask || MODE == kBwdPlain) {
        // Column sums over the tile's 64 rows: reduce over g (lane bits 2-4).
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
          sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
        }
        if (g == 0) {
          if (c0 < L.n) e.db[c0] += sum0;
          if (c0 + 1 < L.n) e.db[c0 + 1] += sum1;
        }
      }
    }
  }
}

}  // namespace nkt
