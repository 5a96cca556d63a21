// The NeRF MLP on Hopper's warpgroup products, shared by the ray
// megakernel's forward (K1, and K6's forward over encodings:
// fused_render_fwd.cu), the MLP over encodings (K5's forward:
// fused_mlp_fwd.cu) and the rows kernel of the backwards (K2, K3, K5, K6:
// fused_render_bwd.cu).  K4 (quant_render_fwd.cu) runs the same block,
// ring and producer with int8 operands and an epilogue of its own.
//
// A block is two consumer warpgroups and one producer warpgroup (384
// threads; one thread of it issues the copies, and setmaxnreg moves its
// registers to the consumers, 232 a thread) over a 128-row sample tile.
// Warpgroup w owns rows 64w..64w+63, and warp v of the block (v = 0..7)
// owns rows 16v..16v+15 of every activation tile: it loads their A
// fragments, and wgmma returns their accumulators to it.  So a warp reads
// and writes only its own rows, and a layer's output overwrites its input
// in place: one activation tile, no ping-pong, no block barrier between
// layers.
//
// Weights: the producer thread streams every layer's weights, in the order
// the consumers use them, through a ring of shared-memory stages with bulk
// copies (cp.async.bulk, the TMA unit) and a full/empty mbarrier pair per
// stage.  A stage holds one k-slice of one layer: all of its n_pad output
// columns and kKs (for a layer's last slice, a multiple of 16 up to kKs)
// k.  Both consumer warpgroups read each stage, so a weight byte brought
// from L2 feeds 128 rows.  The slice is stored in the K-major core-matrix
// layout wgmma's descriptor names (ops/kernels/fused_render.py:
// pack_weights_wg): element (n, k) of the slice at ((k / 8) * n_pad + n)
// * 8 + k % 8, so a k16 step starts 2 * n_pad * 16 bytes after the one
// before, core matrices along K lie n_pad * 16 bytes apart (LBO) and
// along N 128 bytes apart (SBO); columns [n0, n0 + N) of a stage are one
// more product at n0 * 16 bytes.
//
// Products: wgmma.mma_async m64nNk16 (bf16, f32 accumulation), A from
// registers (the mma.sync A fragment loaded from the row-major activation
// tile), B from the stage; a layer's N is one accumulator array in
// registers (N/2 floats a thread, 132 for the merged 264-wide head).  The
// epilogues are nerf_tile.cuh's, per warp: the bias, the ReLU with bf16
// rounding, the ReLU sign bits (built with quad shuffles, no atomics), and
// for the backward the masked dPre and its f32 column sums.  Column sums
// (the bias gradients) go through a per-warp scratch row and are added in
// warp order after a barrier of the consumers, so they are deterministic.
//
// Precision is nerf_tile.cuh's: bf16 rounding at the encodings, at each
// post-ReLU hidden and at the feature before the concat; sigma and the rgb
// logits in f32; the mask taken on the rounded value.

#pragma once

#include "nerf_hopper.cuh"
#include "nerf_tile.cuh"

namespace nkt {

constexpr int kWgRows = 128;                   // sample rows per tile
constexpr int kWgConsumers = 256;              // two warpgroups
constexpr int kWgThreads = kWgConsumers + 128;  // and the producer warpgroup
constexpr int kConsumerWarps = kWgConsumers / 32;
constexpr int kProducerRegs = 40;   // setmaxnreg: the producer's warpgroup gives
constexpr int kConsumerRegs = 232;  // registers to the consumers' (2 x 232 + 40 <= 512)
constexpr int kKs = 64;        // k per weight stage
constexpr int kMaxStages = 8;  // ring stages at most
constexpr int kBarBytes = 2 * kMaxStages * 8;

// The hidden widths the wgmma kernels are instantiated for.
inline bool wg_hidden_ok(int h) { return h == 64 || h == 128 || h == 256; }

// Rays per block of K1/K6's forward: whole rays, as many as make R*S fill
// whole 128-row tiles, at most 640 samples a block (the per-sample
// predictions stay in shared memory until the rays are composited).
inline int wg_rays_per_block(int S) {
  if (S >= 640) return 1;
  int a = S, b = kWgRows;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  const int r = kWgRows / a, cap = 640 / S;
  return r < cap ? r : (cap > 0 ? cap : 1);
}

// Host: the layer widths the instantiations take (trunk H, merged head
// H + 8, branch H / 2, rgb 8 columns).
inline bool wg_dims_ok(const MlpDims& m) {
  const int H = m.hidden, L = m.num_layers;
  for (int i = 0; i < L; ++i)
    if (m.dense[i].n_pad != H) return false;
  return m.dense[L].n == H + 1 && m.dense[L].n_pad == H + 8 && m.dense[L + 1].n_pad == H / 2 &&
         m.dense[L + 2].n_pad == 8;
}

// Bytes of one weight stage: the widest layer's k-slice.
inline int wg_stage_bytes(const Dense* d, int n) {
  int w = 0;
  for (int i = 0; i < n; ++i) w = d[i].n_pad > w ? d[i].n_pad : w;
  return w * kKs * 2;
}

struct WRing {
  uint64_t* full;   // [stages] count 1 + transaction bytes
  uint64_t* empty;  // [stages] count kConsumerWarps
  unsigned char* buf;
  int stages;
  int stage_bytes;
};

struct RingPos {
  int st = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++st == stages) {
      st = 0;
      ph ^= 1u;
    }
  }
};

// Barriers of the ring at the start of dynamic shared memory.  Thread 0;
// the caller synchronises the block afterwards.
__device__ __forceinline__ void ring_init(const WRing& r) {
  for (int i = 0; i < r.stages; ++i) {
    mbar_init(&r.full[i], 1);
    mbar_init(&r.empty[i], kConsumerWarps);
  }
  fence_mbar_init();
}

// Producer: every k-slice of one layer of the pack `w`, in order.
__device__ __forceinline__ void produce_layer(const WRing& r, RingPos& p,
                                              const __nv_bfloat16* w, const Dense& L) {
  for (int k0 = 0; k0 < L.k_pad; k0 += kKs) {
    const int kw = min(kKs, L.k_pad - k0);
    const uint32_t bytes = static_cast<uint32_t>(L.n_pad * kw * 2);
    mbar_wait(&r.empty[p.st], p.ph ^ 1u);
    mbar_expect_tx(&r.full[p.st], bytes);
    bulk_g2s(r.buf + static_cast<size_t>(p.st) * r.stage_bytes,
             w + L.w_off + static_cast<size_t>(k0) * L.n_pad, bytes, &r.full[p.st]);
    p.next(r.stages);
  }
}

// The warp's A fragment of the k16 step at column k (act: the warp's row 0).
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* act, int ldx, int k) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* r0 = act + (lane >> 2) * ldx + k + (lane & 3) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(r0);
  a[1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * ldx);
  a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * ldx + 8);
}

// acc[0, N/2) = act[64 rows of the warpgroup, 0:k_pad) @ columns [0, N)
// of the layer's stages and, with NX > 0, accx[0, NX/2) += the same rows @
// columns [N, N + NX) (the caller zeroes accx where a sum starts); `np`:
// the stages' width (the layer's n_pad).  Consumes ceil(k_pad / kKs)
// stages of the ring.
template <int N, int NX = 0>
__device__ __forceinline__ void wg_product(float* acc, const __nv_bfloat16* act, int ldx,
                                           int k_pad, const WRing& r, RingPos& c,
                                           float* accx = nullptr, int np = N + NX) {
  static_assert(N % 8 == 0 && NX % 8 == 0 && N <= 264 && NX <= 64, "wgmma widths");
  constexpr int kSteps = kKs / 16;
  if constexpr (N > 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  }
  for (int k0 = 0; k0 < k_pad; k0 += kKs) {
    const int steps = min(kKs, k_pad - k0) >> 4;  // block-uniform
    uint32_t a[kSteps][4];
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps) load_a(a[q], act, ldx, k0 + 16 * q);
    mbar_wait(&r.full[c.st], c.ph);
    const uint32_t sb = smem_u32(r.buf + static_cast<size_t>(c.st) * r.stage_bytes);
    if constexpr (N > 0) acc_fence<N / 2>(acc);
    if constexpr (NX > 0) acc_fence<NX / 2>(accx);
    wg_fence();
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps) {
        const uint32_t step = sb + q * 2 * np * 16;
        if constexpr (N > 0) mma_rs<N>(acc, a[q], smem_desc(step, np * 16, 128), 128, 1);
        if constexpr (NX > 0)
          mma_rs<NX>(accx, a[q], smem_desc(step + N * 16, np * 16, 128), 128, 1);
      }
    wg_commit();
    wg_wait<0>();
    if constexpr (N > 0) acc_fence<N / 2>(acc);
    if constexpr (NX > 0) acc_fence<NX / 2>(accx);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[c.st]);
    c.next(r.stages);
  }
}

// ---------------------------------------------------------------------------
// Epilogues.  A thread holds rows g and g+8 of its warp's 16 and, for each
// 8-column block j, columns 8j+2t and 8j+2t+1 (g = lane/4, t = lane%4).

// act = bf16(relu(acc + bias)); with mask, the sign bits of the rounded
// values, one 32-bit word per 32 columns of a row (row stride mw words).
template <int N, bool kMask>
__device__ __forceinline__ void epi_relu(const float* acc, const float* bias,
                                         __nv_bfloat16* act, int ldx, uint32_t* mask, int mw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int W = N / 32 > 0 ? N / 32 : 1;
  uint32_t m0[W], m1[W];
#pragma unroll
  for (int w = 0; w < W; ++w) m0[w] = m1[w] = 0u;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float b0 = bias[c], b1 = bias[c + 1];
    const __nv_bfloat162 h0 =
        __floats2bfloat162_rn(fmaxf(acc[4 * j] + b0, 0.f), fmaxf(acc[4 * j + 1] + b1, 0.f));
    const __nv_bfloat162 h1 =
        __floats2bfloat162_rn(fmaxf(acc[4 * j + 2] + b0, 0.f), fmaxf(acc[4 * j + 3] + b1, 0.f));
    *reinterpret_cast<__nv_bfloat162*>(act + g * ldx + c) = h0;
    *reinterpret_cast<__nv_bfloat162*>(act + (g + 8) * ldx + c) = h1;
    if (kMask) {
      const int sh = (j & 3) * 8 + 2 * t;
      m0[j >> 2] |= ((__bfloat162float(h0.x) > 0.f ? 1u : 0u) |
                     (__bfloat162float(h0.y) > 0.f ? 2u : 0u)) << sh;
      m1[j >> 2] |= ((__bfloat162float(h1.x) > 0.f ? 1u : 0u) |
                     (__bfloat162float(h1.y) > 0.f ? 2u : 0u)) << sh;
    }
  }
  if (kMask) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      m0[w] |= __shfl_xor_sync(0xffffffffu, m0[w], 1);
      m0[w] |= __shfl_xor_sync(0xffffffffu, m0[w], 2);
      m1[w] |= __shfl_xor_sync(0xffffffffu, m1[w], 1);
      m1[w] |= __shfl_xor_sync(0xffffffffu, m1[w], 2);
    }
    if (t == 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        mask[g * mw + w] = m0[w];
        mask[(g + 8) * mw + w] = m1[w];
      }
    }
  }
}

// The merged feature+sigma head (N = hidden + 8): columns [0, hidden) ->
// bf16(acc + bias) (no ReLU), column hidden -> sig (f32, rows < valid)
// when sig is given.
template <int N>
__device__ __forceinline__ void epi_feature_sigma(const float* acc, const float* bias,
                                                  __nv_bfloat16* act, int ldx, float* sig,
                                                  int valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8 - 1; ++j) {
    const int c = 8 * j + 2 * t;
    const float b0 = bias[c], b1 = bias[c + 1];
    *reinterpret_cast<__nv_bfloat162*>(act + g * ldx + c) =
        __floats2bfloat162_rn(acc[4 * j] + b0, acc[4 * j + 1] + b1);
    *reinterpret_cast<__nv_bfloat162*>(act + (g + 8) * ldx + c) =
        __floats2bfloat162_rn(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
  constexpr int js = N / 8 - 1;
  if (sig != nullptr && t == 0) {
    const float b = bias[8 * js];
    if (g < valid) sig[g] = acc[4 * js] + b;
    if (g + 8 < valid) sig[g + 8] = acc[4 * js + 2] + b;
  }
}

// The rgb head (N = 8): columns 0..2 -> rgbl (rows x 3, f32) for rows < valid.
__device__ __forceinline__ void epi_rgb(const float* acc, const float* bias, float* rgbl,
                                        int valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (t > 1) return;
  const int c = 2 * t;
  const float b0 = bias[c], b1 = bias[c + 1];
  if (g < valid) {
    rgbl[g * 3 + c] = acc[0] + b0;
    if (c + 1 < 3) rgbl[g * 3 + c + 1] = acc[1] + b1;
  }
  if (g + 8 < valid) {
    rgbl[(g + 8) * 3 + c] = acc[2] + b0;
    if (c + 1 < 3) rgbl[(g + 8) * 3 + c + 1] = acc[3] + b1;
  }
}

// Backward (dX) products: every output column is a hidden column of the
// layer input.  act = bf16(v), v masked by the ReLU bit of the forward
// (kMask); the f32 column sums of v over the warp's 16 rows go to
// srow[c] (the warp's scratch row).  The sums over the 8 lanes that share
// a column pair are a butterfly reduce-scatter (each of three shuffle
// rounds halves the values a lane carries), so every lane ends with N/32
// of the warp's column sums.
template <int N, bool kMask>
__device__ __forceinline__ void epi_bwd(const float* acc, __nv_bfloat16* act, int ldx,
                                        const uint32_t* mask, int mw, float* srow) {
  static_assert(N >= 32, "the reduce-scatter needs N/4 >= 8 values a lane");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int M = N / 4;  // values a lane carries: two columns per 8-column block
  float v[M];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * t;
    float v00 = acc[4 * j], v01 = acc[4 * j + 1], v10 = acc[4 * j + 2], v11 = acc[4 * j + 3];
    if (kMask) {
      const uint32_t w0 = mask[g * mw + (c >> 5)] >> (c & 31);
      const uint32_t w1 = mask[(g + 8) * mw + (c >> 5)] >> (c & 31);
      if (!(w0 & 1u)) v00 = 0.f;
      if (!(w0 & 2u)) v01 = 0.f;
      if (!(w1 & 1u)) v10 = 0.f;
      if (!(w1 & 2u)) v11 = 0.f;
    }
    *reinterpret_cast<__nv_bfloat162*>(act + g * ldx + c) = __floats2bfloat162_rn(v00, v01);
    *reinterpret_cast<__nv_bfloat162*>(act + (g + 8) * ldx + c) =
        __floats2bfloat162_rn(v10, v11);
    v[2 * j] = v00 + v10;
    v[2 * j + 1] = v01 + v11;
  }
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const float send = b4 ? v[i] : v[i + M / 2];
    const float keep = b4 ? v[i + M / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < M / 4; ++i) {
    const float send = b3 ? v[i] : v[i + M / 4];
    const float keep = b3 ? v[i + M / 4] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int i = 0; i < M / 8; ++i) {
    const float send = b2 ? v[i] : v[i + M / 8];
    const float keep = b2 ? v[i + M / 8] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  const int base = (b4 ? M / 2 : 0) + (b3 ? M / 4 : 0) + (b2 ? M / 8 : 0);
#pragma unroll
  for (int i = 0; i < M / 8; ++i) {
    const int idx = base + i;
    srow[8 * (idx >> 1) + 2 * t + (idx & 1)] = v[i];
  }
}

// After every consumer warp has written its scratch row: for c < n,
// add(c, sum of the rows in warp order).  Starts with a barrier of the
// consumers; the scratch is double-buffered by the caller, so the next
// layer's rows may be written before every thread has read these.
template <class AddFn>
__device__ __forceinline__ void colsum_add(const float* scratch, int sld, int n, AddFn add) {
  consumer_sync(kWgConsumers);
  for (int c = threadIdx.x; c < n; c += kWgConsumers) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) s += scratch[w * sld + c];
    add(c, s);
  }
}

// The warp's 16 rows of a bf16 tile (columns [0, W)) to the workspace of
// one layer in the dW product's layout: 64-row stages, in each stage
// 8-column strips of 64 rows x 16 bytes, so that element (r, c) lies at
// (r / 64) * 64 * W + (c / 8) * 512 + (r % 64) * 8 + c % 8 and a stage's
// strips are the MN-major core matrices of nerf_dw.cuh's products.  `rbase`:
// the workspace row of the warp's row 0 (a multiple of 16).
__device__ __forceinline__ void store_ws(const __nv_bfloat16* act, int ldx, __nv_bfloat16* dst,
                                         int W, int rbase) {
  const int lane = threadIdx.x & 31;
  const int vecs = W >> 3;
  __nv_bfloat16* stage = dst + static_cast<size_t>(rbase >> 6) * 64 * W + (rbase & 63) * 8;
  for (int i = lane; i < 16 * vecs; i += 32) {
    const int row = i & 15, cc = i >> 4;
    *reinterpret_cast<uint4*>(stage + cc * 512 + row * 8) =
        *reinterpret_cast<const uint4*>(act + row * ldx + cc * 8);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// The forward of the warp's 16 rows.  On entry act (the warp's row 0) holds
// the position features in [0, xyz_pad); xenc(row, c) gives them again for
// the skip concats, dir(row, c) the direction features (bf16, zero beyond
// their width).  sig and rgbl (the warp's rows) receive sigma and the rgb
// logits for rows < valid.  The producer streams dense[0..L+2] in order.
template <int H, class XencFn, class DirFn>
__device__ __forceinline__ void mlp_forward_wg(const MlpDims& m, const float* b,
                                               __nv_bfloat16* act, XencFn xenc, DirFn dir,
                                               float* sig, float* rgbl, int valid,
                                               const WRing& ring, RingPos& rp) {
  const int lane = threadIdx.x & 31;
  const int ldx = m.ldx;
  const int L = m.num_layers;
  float acc[(H + 8) / 2];
  for (int i = 0; i < L; ++i) {
    wg_product<H>(acc, act, ldx, m.dense[i].k_pad, ring, rp);
    epi_relu<H, false>(acc, b + m.dense[i].b_off, act, ldx, nullptr, 0);
    if (is_skip(i, m.skip_layer))
      for (int j = lane; j < 16 * m.xyz_pad; j += 32) {
        const int row = j / m.xyz_pad, c = j - row * m.xyz_pad;
        act[row * ldx + H + c] = xenc(row, c);
      }
    __syncwarp();
  }
  wg_product<H + 8>(acc, act, ldx, m.dense[L].k_pad, ring, rp);
  epi_feature_sigma<H + 8>(acc, b + m.dense[L].b_off, act, ldx, sig, valid);
  for (int j = lane; j < 16 * m.dir_pad; j += 32) {
    const int row = j / m.dir_pad, c = j - row * m.dir_pad;
    act[row * ldx + H + c] = dir(row, c);
  }
  __syncwarp();
  wg_product<H / 2>(acc, act, ldx, m.dense[L + 1].k_pad, ring, rp);
  epi_relu<H / 2, false>(acc, b + m.dense[L + 1].b_off, act, ldx, nullptr, 0);
  __syncwarp();
  wg_product<8>(acc, act, ldx, m.dense[L + 2].k_pad, ring, rp);
  epi_rgb(acc, b + m.dense[L + 2].b_off, rgbl, valid);
  __syncwarp();
}

// The producer's side of mlp_forward_wg.
__device__ __forceinline__ void produce_forward(const MlpDims& m, const __nv_bfloat16* w,
                                                const WRing& ring, RingPos& rp) {
  for (int i = 0; i < m.num_layers + 3; ++i) produce_layer(ring, rp, w, m.dense[i]);
}

// act[rows, 0:N) = bf16(acc): an accumulator's 16 x N columns of the warp.
template <int N>
__device__ __forceinline__ void epi_store(const float* acc, __nv_bfloat16* act, int ldx) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(act + g * ldx + c) =
        __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(act + (g + 8) * ldx + c) =
        __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// out rows [0, valid) x columns [0, w) (row stride w) = the warp's tile
// `act` (row stride ldx): per-sample rows out of shared memory, in order.
__device__ __forceinline__ void rows_out(const __nv_bfloat16* act, int ldx, __nv_bfloat16* out,
                                         int w, int valid) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int j = lane; j < valid * w; j += 32) {
    const int row = j / w, c = j - row * w;
    out[j] = act[row * ldx + c];
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// The backward of the warp's 16 rows (K2, K3, K5, K6's rows kernel), given
// the cotangent g of their raw predictions (f32, row stride 4: d rgb
// logits, d sigma; rows < valid are read):
//   * recompute: from the position features xf(row, c) (called for rows <
//     valid, c < xyz_dim), with the forward's products, so the same ReLU
//     pattern; each ReLU's sign bits go to `masks` ((L + 1) slots of 128
//     rows x mask_words: trunk layers, then the branch) and each layer's
//     input (A) to the workspace;
//   * reverse walk with the transposed pack: each layer's dPre (D) to the
//     workspace; the bias gradients (f32 column sums of dPre) added into db
//     (the forward bias-pack layout), through `scratch` (2 x 8 rows of sld
//     floats).
// With kIG (K5's input gradients; the pack then holds every input column,
// the x_enc part of a layer padded to kXCols, the direction part of the
// branch to kDCols) the walk also runs the products K2's skips: the
// branch's direction columns, rounded once to bf16, go to dd (the warp's
// rows, row stride dir_dim); the x_enc columns of each layer whose input
// has the skip concat, from the top down, then layer 0's product, are
// summed in f32 in kXCols/2 registers a thread (wgmma accumulates each
// product into them) and rounded once to bf16 into dx (row stride
// xyz_dim).  dx or dd may be null (not written).
// The workspace rows are rbase + [0, 16) of p.N rows per layer.  The
// producer streams produce_backward<kIG>'s order.
constexpr int kXCols = 64;  // x_enc gradient columns of K5's product (xyz_dim <= 64)
constexpr int kDCols = 32;  // d_enc gradient columns (dir_dim <= 32)

template <int H, bool kIG = false, class XFn, class DirFn>
__device__ __forceinline__ void mlp_backward_wg(const MlpBwdParams& p, __nv_bfloat16* act,
                                                uint32_t* masks, float* scratch, int sld,
                                                float* db, XFn xf, DirFn dir, const float* g,
                                                int valid, int rbase, const WRing& ring,
                                                RingPos& rp, __nv_bfloat16* dx = nullptr,
                                                __nv_bfloat16* dd = nullptr) {
  const MlpDims& m = p.m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ldx = m.ldx, L = m.num_layers, MW = p.mask_words;
  const size_t N = p.N;
  const int mslot = kWgRows * MW;
  const Dense& fs = m.dense[L];
  const Dense& br = m.dense[L + 1];
  const Dense& rgb = m.dense[L + 2];
  int sb = 0;
  auto srow = [&]() { return scratch + (sb * kConsumerWarps + warp) * sld; };
  auto finish = [&](float* dst, int n) {
    colsum_add(scratch + sb * kConsumerWarps * sld, sld, n,
               [&](int c, float s) { dst[c] += s; });
    sb ^= 1;
  };
  auto load_x = [&](int col0) {
    for (int j = lane; j < 16 * m.xyz_pad; j += 32) {
      const int row = j / m.xyz_pad, c = j - row * m.xyz_pad;
      act[row * ldx + col0 + c] =
          row < valid && c < m.xyz_dim ? xf(row, c) : __float2bfloat16_rn(0.f);
    }
    __syncwarp();
  };
  float acc[(H + 8) / 2];
  float xs[kIG ? kXCols / 2 : 1];  // kIG: the encodings' gradient columns, f32
  // The dX product of dense layer i (i >= 1) into acc: the hidden columns
  // of its input and, with kIG where that input has the skip concat, its
  // x_enc columns added into xs.
  auto dx_product = [&](int i) {
    if constexpr (kIG) {
      if (is_skip(i - 1, m.skip_layer)) {
        wg_product<H, kXCols>(acc, act, ldx, p.bdense[i].k_pad, ring, rp, xs,
                              p.bdense[i].n_pad);
        return;
      }
    }
    wg_product<H>(acc, act, ldx, p.bdense[i].k_pad, ring, rp);
  };

  // ---- Forward recompute, storing each layer's input (A).
  load_x(0);
  for (int i = 0; i < L; ++i) {
    store_ws(act, ldx, p.ws_a + N * p.bwd[i].a_col, m.dense[i].k_pad, rbase);
    wg_product<H>(acc, act, ldx, m.dense[i].k_pad, ring, rp);
    epi_relu<H, true>(acc, p.b + m.dense[i].b_off, act, ldx, masks + i * mslot, MW);
    __syncwarp();
    if (is_skip(i, m.skip_layer)) load_x(H);
  }
  store_ws(act, ldx, p.ws_a + N * p.bwd[L].a_col, fs.k_pad, rbase);
  wg_product<H + 8>(acc, act, ldx, fs.k_pad, ring, rp);
  epi_feature_sigma<H + 8>(acc, p.b + fs.b_off, act, ldx, nullptr, 0);
  for (int j = lane; j < 16 * m.dir_pad; j += 32) {
    const int row = j / m.dir_pad, c = j - row * m.dir_pad;
    act[row * ldx + H + c] = dir(row, c);
  }
  __syncwarp();
  store_ws(act, ldx, p.ws_a + N * p.bwd[L + 1].a_col, br.k_pad, rbase);
  wg_product<H / 2>(acc, act, ldx, br.k_pad, ring, rp);
  epi_relu<H / 2, true>(acc, p.b + br.b_off, act, ldx, masks + L * mslot, MW);
  __syncwarp();
  store_ws(act, ldx, p.ws_a + N * p.bwd[L + 2].a_col, rgb.k_pad, rbase);

  // ---- Backward walk.  d rgb logits, bf16, d_width columns.
  const int dw_rgb = p.bwd[L + 2].d_width;
  for (int j = lane; j < 16 * dw_rgb; j += 32) {
    const int row = j / dw_rgb, c = j - row * dw_rgb;
    act[row * ldx + c] = __float2bfloat16_rn(c < 3 && row < valid ? g[row * 4 + c] : 0.f);
  }
  {  // f32 sums of the rgb head's and the sigma column's cotangent
    const int row = lane & 15, c0 = (lane >> 4) * 2;
    float s0 = row < valid ? g[row * 4 + c0] : 0.f;
    float s1 = row < valid ? g[row * 4 + c0 + 1] : 0.f;
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (row == 0) {
      srow()[c0] = s0;
      srow()[c0 + 1] = s1;
    }
  }
  __syncwarp();
  colsum_add(scratch + sb * kConsumerWarps * sld, sld, 4, [&](int c, float s) {
    db[c < 3 ? rgb.b_off + c : fs.b_off + H] += s;
  });
  sb ^= 1;
  store_ws(act, ldx, p.ws_d + N * p.bwd[L + 2].d_col, dw_rgb, rbase);
  // dh2 = drgb W_rgb^T, masked by h2 > 0: the branch's dPre.
  wg_product<H / 2>(acc, act, ldx, p.bdense[L + 2].k_pad, ring, rp);
  __syncwarp();
  epi_bwd<H / 2, true>(acc, act, ldx, masks + L * mslot, MW, srow());
  __syncwarp();
  finish(db + br.b_off, H / 2);
  store_ws(act, ldx, p.ws_d + N * p.bwd[L + 1].d_col, p.bwd[L + 1].d_width, rbase);
  // dfeature = dh2 W_br^T; with d sigma the merged head's dPre.  With kIG
  // the direction columns too: dd_enc.
  if constexpr (kIG) {
#pragma unroll
    for (int i = 0; i < kDCols / 2; ++i) xs[i] = 0.f;
    wg_product<H, kDCols>(acc, act, ldx, p.bdense[L + 1].k_pad, ring, rp, xs,
                          p.bdense[L + 1].n_pad);
  } else {
    wg_product<H>(acc, act, ldx, p.bdense[L + 1].k_pad, ring, rp);
  }
  __syncwarp();
  epi_bwd<H, false>(acc, act, ldx, nullptr, 0, srow());
  if constexpr (kIG) {
    if (dd != nullptr) {
      epi_store<kDCols>(xs, act + H, ldx);
      rows_out(act + H, ldx, dd, m.dir_dim, valid);
    }
#pragma unroll
    for (int i = 0; i < kXCols / 2; ++i) xs[i] = 0.f;
  }
  const int dw_fs = p.bwd[L].d_width;
  for (int j = lane; j < 16 * (dw_fs - H); j += 32) {
    const int row = j / (dw_fs - H), c = j - row * (dw_fs - H);
    act[row * ldx + H + c] = __float2bfloat16_rn(c == 0 && row < valid ? g[row * 4 + 3] : 0.f);
  }
  __syncwarp();
  finish(db + fs.b_off, H);
  store_ws(act, ldx, p.ws_d + N * p.bwd[L].d_col, dw_fs, rbase);
  // dh_{L-1} = dfs W_fs^T (hidden columns), masked: dPre_{L-1}.
  dx_product(L);
  __syncwarp();
  epi_bwd<H, true>(acc, act, ldx, masks + (L - 1) * mslot, MW, srow());
  __syncwarp();
  finish(db + m.dense[L - 1].b_off, H);
  // Trunk: act holds dPre_i; dX_i's hidden columns, masked, are dPre_{i-1}.
  for (int i = L - 1; i >= 0; --i) {
    store_ws(act, ldx, p.ws_d + N * p.bwd[i].d_col, p.bwd[i].d_width, rbase);
    if (i > 0) {
      dx_product(i);
      __syncwarp();
      epi_bwd<H, true>(acc, act, ldx, masks + (i - 1) * mslot, MW, srow());
      __syncwarp();
      finish(db + m.dense[i - 1].b_off, H);
    }
  }
  if constexpr (kIG) {
    // Layer 0's input is the encoding alone: its product adds into xs.
    wg_product<0, kXCols>(nullptr, act, ldx, p.bdense[0].k_pad, ring, rp, xs,
                          p.bdense[0].n_pad);
    if (dx != nullptr) {
      epi_store<kXCols>(xs, act, ldx);
      rows_out(act, ldx, dx, m.xyz_dim, valid);
    }
  }
}

// The producer's side of mlp_backward_wg: the recompute's layers of the
// forward pack, then the walk's of the transposed pack (with kIG layer 0's
// too).
template <bool kIG = false>
__device__ __forceinline__ void produce_backward(const MlpBwdParams& p, const WRing& ring,
                                                 RingPos& rp) {
  const int L = p.m.num_layers;
  for (int i = 0; i < L + 2; ++i) produce_layer(ring, rp, p.w, p.m.dense[i]);
  produce_layer(ring, rp, p.wb, p.bdense[L + 2]);
  produce_layer(ring, rp, p.wb, p.bdense[L + 1]);
  produce_layer(ring, rp, p.wb, p.bdense[L]);
  for (int i = L - 1; i > 0; --i) produce_layer(ring, rp, p.wb, p.bdense[i]);
  if (kIG) produce_layer(ring, rp, p.wb, p.bdense[0]);
}

// Host: with K5's input gradients, the transposed pack's widths must be
// the product's: layer 0 kXCols, a layer whose input has the skip concat
// hidden + kXCols, the branch hidden + kDCols, every other hidden.
inline bool wg_input_grads_ok(const MlpBwdParams& p) {
  const MlpDims& m = p.m;
  const int H = m.hidden, L = m.num_layers;
  if (m.xyz_dim > kXCols || m.dir_dim > kDCols || p.bdense[0].n_pad != kXCols ||
      p.bdense[L + 1].n_pad != H + kDCols || p.bdense[L + 2].n_pad != H / 2)
    return false;
  for (int i = 1; i <= L; ++i)
    if (p.bdense[i].n_pad != (is_skip(i - 1, m.skip_layer) ? H + kXCols : H)) return false;
  return true;
}

}  // namespace nkt
