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
// 0.63 ms, S=192 -> 1.89 ms.  Beside the products, each sample has 2,448
// output columns to dequantize and 2,432 of them to requantize.
//
// What the design does about that: K1's block (nerf_wgmlp.cuh) with int8
// operands, and an epilogue that stays off the conversion pipe.
//   * A block is two consumer warpgroups over a 128-row sample tile and a
//     producer warpgroup (setmaxnreg gives its registers to the consumers)
//     whose one thread streams every layer's weights through the mbarrier
//     ring with bulk copies, one 128-wide k-slice of a layer per stage, so
//     that each staged byte feeds 128 rows (the first design, on 64-row
//     tiles, read the whole pack from L2 in every warp for every 64 rows).
//     The block owns whole rays (wg_rays_per_block).
//   * Warp v owns rows 16v..16v+15 of one int8 activation tile of 128 x
//     (hidden + 80) bytes, updated in place layer by layer: no block
//     barrier between layers.
//   * Products are wgmma.mma_async m64nNk32 .s32.s8.s8: A from registers
//     (the m16n8k32 A-fragment layout of the warp's rows), B from a K-major
//     descriptor over the stage.  An int8 core matrix is 8 columns x 16 k;
//     the pack (ops/kernels/quant_render.py: pack_qparams) stores element
//     (n, k) of a stage at ((k / 16) * n_pad + n) * 16 + k % 16, so a k32
//     step starts 2 * n_pad * 16 bytes after the one before, LBO = n_pad *
//     16 and SBO = 128 bytes: the bf16 pack's byte arithmetic with 16 k per
//     core-matrix row.  The 264-wide merged head is 256 + 8.
//   * The f32 scale, bias and requantization rows of every layer (~29 KB at
//     8x256) are brought into shared memory by one bulk copy per block.
//   * The position encoding is per row, not per element: a lane computes
//     its row's point once and one sincosf per octave and coordinate (the
//     sin and cos columns of one argument), not a t load, a point and a
//     sin/cos for every element.
//   * The epilogue does almost no type conversion (the conversion pipe runs
//     at 16 a clock per SM against 128 for f32 arithmetic):
//       - dequantize: float(acc) = __int_as_float(acc + 0x4B400000) -
//         1.5 * 2^23 exactly when |acc| <= 2^22.  A layer's |acc| is at most
//         k * 127^2 (padded k is zero in the pack; int8 values never reach
//         -128, which pack_qparams checks for the weights), within 2^22 for
//         k <= 260: every layer whose padded k is at most 256 takes it; the
//         layer after the skip (k 319) and the branch (k 283) keep
//         cvt.rn.f32.s32.
//       - requantize: c = min(max(y * inv, -127), 127), then c + 1.5 * 2^23
//         rounds c half to even into the float's low byte (exact: |c| <=
//         127), which is the int8 two's complement of rint(c); equal to
//         rint-then-clamp because +-127 are integers, and a NaN clamps to
//         -127 as fmaxf(rintf(NaN), -127) does.  Two neighbouring columns' bytes are paired with
//         __byte_perm.  After a relu (inv >= 0 in every pack) the relu and
//         the lower clamp are one max(y * inv, 0).
//   * Shared memory at 8x256 (S = 192, two rays a block): barriers 144 B,
//     the f32 rows 29,760, the activation tile 128 x 336 = 43,008, the
//     x_enc copy for the skip 128 x 64 = 8,192, the rays' direction
//     features, origins and directions 128, per-sample sigma and rgb 6,144
//     (<= 10,240 at S = 160), and 4 stages of 264 x 128 = 33,792 B: 222,544
//     of 232,448 B (one block per SM).
// What holds it back now (PERF.md section 6): the epilogue, ~8 f32/int
// operations for each output column, which the two warpgroups run in
// lockstep with their products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (never -use_fast_math: the top octave's
//        argument is 2^9*|p|, where the fast sin is wrong).

#include "nerf_wgmlp.cuh"

using namespace nkt;

namespace {

constexpr int kQKs = 128;             // k per weight stage (128 int8 = 128 bytes a row)
constexpr int kMagicK = 256;          // padded k up to which |acc| <= k * 127^2 < 2^22
constexpr float kRound = 12582912.f;  // 1.5 * 2^23
constexpr int kRoundBits = 0x4B400000;
constexpr int kQBarBytes = kBarBytes + 16;  // the ring's barriers and the f32 rows' one

struct QDense {
  int k_pad;  // input width, padded to 32 (rows of W, zero-filled)
  int n;      // true output width
  int n_pad;  // output width padded to 8
  int w_off;  // byte offset of the layer's k-slices in the int8 pack
  int f_off;  // offset of its f32 rows: scale, bias, inv (n_pad each)
};

struct QDims {
  int num_layers, skip_layer, hidden;
  int xyz_dim, xyz_pad, dir_dim, dir_pad;  // pads: multiples of 32
  int ldx;                                 // row stride (bytes) of the activation tile
  int x_off, d_off;                        // inv_x, inv_d rows in the f32 pack
  int f_bytes;                             // the f32 pack's bytes
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
  int B, S, R, stages, stage_bytes;
  QDims m;
};

// ---------------------------------------------------------------------------
// Arithmetic of the epilogue: bit for bit the plain path's, without
// conversions (see the note at the top).

// float(acc), exact: by the magic number for |acc| <= 2^22, else converted.
template <bool kMagic>
__device__ __forceinline__ float acc_to_float(int acc) {
  return kMagic ? __fsub_rn(__int_as_float(acc + kRoundBits), kRound) : __int2float_rn(acc);
}

// y = float(acc) * scale + b, two roundings.
template <bool kMagic>
__device__ __forceinline__ float dequant(int acc, float scale, float b) {
  return __fadd_rn(__fmul_rn(acc_to_float<kMagic>(acc), scale), b);
}

// rint(v * inv) clamped to [-127, 127] (with kRelu: rint(relu(v) * inv),
// inv >= 0) as the low byte of the result.
template <bool kRelu>
__device__ __forceinline__ uint32_t requant(float v, float inv) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv), kRelu ? 0.f : -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, kRound));
}

// Two columns' bytes (the low bytes of lo, hi) stored at p.
__device__ __forceinline__ void store2(int8_t* p, uint32_t lo, uint32_t hi) {
  *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(__byte_perm(lo, hi, 0x0040));
}

// ---------------------------------------------------------------------------
// The warp's side of one layer: products over the ring, then an epilogue.

__device__ __forceinline__ void load_a_s8(uint32_t a[4], const int8_t* act, int ldx, int k) {
  const int lane = threadIdx.x & 31;
  const int8_t* r0 = act + (lane >> 2) * ldx + k + (lane & 3) * 4;
  a[0] = *reinterpret_cast<const uint32_t*>(r0);
  a[1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * ldx);
  a[2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * ldx + 16);
}

// acc[0, N/2) = act[64 rows of the warpgroup, 0:k_pad) @ the layer's N
// columns (N = its n_pad); consumes ceil(k_pad / kQKs) stages of the ring.
template <int N>
__device__ __forceinline__ void q_product(int* acc, const int8_t* act, int ldx, int k_pad,
                                          const WRing& r, RingPos& c) {
  static_assert(N % 8 == 0 && N <= 264, "wgmma widths");
  constexpr int kSteps = kQKs / 32;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  for (int k0 = 0; k0 < k_pad; k0 += kQKs) {
    const int steps = min(kQKs, k_pad - k0) >> 5;  // block-uniform
    uint32_t a[kSteps][4];
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps) load_a_s8(a[q], act, ldx, k0 + 32 * q);
    mbar_wait(&r.full[c.st], c.ph);
    const uint32_t sb = smem_u32(r.buf + static_cast<size_t>(c.st) * r.stage_bytes);
    acc_fence<N / 2>(acc);
    wg_fence();
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps) mma_rs_s8<N>(acc, a[q], smem_desc(sb + q * 2 * N * 16, N * 16, 128), 128, 1);
    wg_commit();
    wg_wait<0>();
    acc_fence<N / 2>(acc);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[c.st]);
    c.next(r.stages);
  }
}

// act[rows, 0:N) = requant(dequant(acc)) with the layer's f32 rows at f
// (scale, bias, inv; n_pad each).  A thread holds rows g and g+8 of its
// warp's 16 and, per 8-column block j, columns 8j+2t and 8j+2t+1.
template <int N, bool kRelu, bool kMagic>
__device__ __forceinline__ void epi_requant(const int* acc, const float* f, int n_pad,
                                            int8_t* act, int ldx) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 s = *reinterpret_cast<const float2*>(f + c);
    const float2 b = *reinterpret_cast<const float2*>(f + n_pad + c);
    const float2 iv = *reinterpret_cast<const float2*>(f + 2 * n_pad + c);
    store2(act + g * ldx + c, requant<kRelu>(dequant<kMagic>(acc[4 * j], s.x, b.x), iv.x),
           requant<kRelu>(dequant<kMagic>(acc[4 * j + 1], s.y, b.y), iv.y));
    store2(act + (g + 8) * ldx + c,
           requant<kRelu>(dequant<kMagic>(acc[4 * j + 2], s.x, b.x), iv.x),
           requant<kRelu>(dequant<kMagic>(acc[4 * j + 3], s.y, b.y), iv.y));
  }
}

// A trunk layer or the branch: relu, then requantized in place.
template <int N>
__device__ __forceinline__ void epi_relu_q(const int* acc, const float* f, const QDense& L,
                                           int8_t* act, int ldx) {
  if (L.k_pad <= kMagicK)
    epi_requant<N, true, true>(acc, f + L.f_off, L.n_pad, act, ldx);
  else
    epi_requant<N, true, false>(acc, f + L.f_off, L.n_pad, act, ldx);
}

// The merged head (N = hidden + 8): the feature requantized (no relu) into
// columns [0, hidden), column hidden -> sig (f32, rows < valid).
template <int N, bool kMagic>
__device__ __forceinline__ void epi_fs(const int* acc, const float* f, int n_pad, int8_t* act,
                                       int ldx, float* sig, int valid) {
  epi_requant<N - 8, false, kMagic>(acc, f, n_pad, act, ldx);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int js = N / 8 - 1;
  if (t == 0) {
    const float s = f[8 * js], b = f[n_pad + 8 * js];
    if (g < valid) sig[g] = dequant<kMagic>(acc[4 * js], s, b);
    if (g + 8 < valid) sig[g + 8] = dequant<kMagic>(acc[4 * js + 2], s, b);
  }
}

// The rgb head (N = 8): columns 0..2 -> rgbl (rows x 3, f32) for rows < valid.
template <bool kMagic>
__device__ __forceinline__ void epi_rgb(const int* acc, const float* f, int n_pad, float* rgbl,
                                        int valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (t > 1) return;
  const int c = 2 * t;
  const float s0 = f[c], s1 = f[c + 1], b0 = f[n_pad + c], b1 = f[n_pad + c + 1];
  if (g < valid) {
    rgbl[g * 3 + c] = dequant<kMagic>(acc[0], s0, b0);
    if (c + 1 < 3) rgbl[g * 3 + c + 1] = dequant<kMagic>(acc[1], s1, b1);
  }
  if (g + 8 < valid) {
    rgbl[(g + 8) * 3 + c] = dequant<kMagic>(acc[2], s0, b0);
    if (c + 1 < 3) rgbl[(g + 8) * 3 + c + 1] = dequant<kMagic>(acc[3], s1, b1);
  }
}

// The warp's 16 rows through the int8 MLP.  On entry act (the warp's row 0)
// holds the quantized position features in [0, xyz_pad) and xq (row stride
// xyz_pad) a copy of them for the skip concat; dir4(row, w) gives word w (4
// int8) of the row's quantized direction features.  sig and rgbl (the
// warp's rows) receive sigma and the rgb logits for rows < valid.  The
// producer streams dense[0..L+2] in order.
template <int H, class DirFn>
__device__ __forceinline__ void qmlp_forward_wg(const QDims& m, const float* f, int8_t* act,
                                                const int8_t* xq, DirFn dir4, float* sig,
                                                float* rgbl, int valid, const WRing& ring,
                                                RingPos& rp) {
  const int lane = threadIdx.x & 31;
  const int ldx = m.ldx;
  const int L = m.num_layers;
  const int xw = m.xyz_pad >> 2, dw = m.dir_pad >> 2;
  int acc[(H + 8) / 2];
  for (int i = 0; i < L; ++i) {
    q_product<H>(acc, act, ldx, m.dense[i].k_pad, ring, rp);
    epi_relu_q<H>(acc, f, m.dense[i], act, ldx);
    if (is_skip(i, m.skip_layer))  // [hq | qx]
      for (int j = lane; j < 16 * xw; j += 32) {
        const int row = j / xw, c = j - row * xw;
        reinterpret_cast<uint32_t*>(act + row * ldx + H)[c] =
            reinterpret_cast<const uint32_t*>(xq)[j];
      }
    __syncwarp();
  }
  // The merged feature+sigma head; the direction features fill the columns
  // after the feature, so act becomes the branch input [qfeat | qd].
  const QDense& fs = m.dense[L];
  q_product<H + 8>(acc, act, ldx, fs.k_pad, ring, rp);
  if (fs.k_pad <= kMagicK)
    epi_fs<H + 8, true>(acc, f + fs.f_off, fs.n_pad, act, ldx, sig, valid);
  else
    epi_fs<H + 8, false>(acc, f + fs.f_off, fs.n_pad, act, ldx, sig, valid);
  for (int j = lane; j < 16 * dw; j += 32) {
    const int row = j / dw, c = j - row * dw;
    reinterpret_cast<uint32_t*>(act + row * ldx + H)[c] = row < valid ? dir4(row, c) : 0u;
  }
  __syncwarp();
  q_product<H / 2>(acc, act, ldx, m.dense[L + 1].k_pad, ring, rp);
  epi_relu_q<H / 2>(acc, f, m.dense[L + 1], act, ldx);
  __syncwarp();
  const QDense& rgb = m.dense[L + 2];
  q_product<8>(acc, act, ldx, rgb.k_pad, ring, rp);
  if (rgb.k_pad <= kMagicK)
    epi_rgb<true>(acc, f + rgb.f_off, rgb.n_pad, rgbl, valid);
  else
    epi_rgb<false>(acc, f + rgb.f_off, rgb.n_pad, rgbl, valid);
  __syncwarp();
}

// The producer's side: every k-slice of one layer, in order.
__device__ __forceinline__ void produce_q_layer(const WRing& r, RingPos& p, const int8_t* w,
                                                const QDense& L) {
  for (int k0 = 0; k0 < L.k_pad; k0 += kQKs) {
    const uint32_t bytes = static_cast<uint32_t>(L.n_pad * min(kQKs, L.k_pad - k0));
    mbar_wait(&r.empty[p.st], p.ph ^ 1u);
    mbar_expect_tx(&r.full[p.st], bytes);
    bulk_g2s(r.buf + static_cast<size_t>(p.st) * r.stage_bytes,
             w + L.w_off + static_cast<size_t>(k0) * L.n_pad, bytes, &r.full[p.st]);
    p.next(r.stages);
  }
}

// The warp's 16 rows of quantized position features (zero beyond xyz_dim,
// and in rows >= valid) into act (row stride ldx) and xq (row stride
// xyz_pad).  Lane (row = lane / 2, part = lane % 2) computes its row's
// point once and one half of its octaves with one sincosf per octave and
// coordinate (part 0 also the raw coordinates): sin and cos of one argument
// fill columns 3 + 6o + d and 3 + 6o + 3 + d.
__device__ __forceinline__ void encode_rows(const QDims& m, const float* ray, const float* t,
                                            int S, int q0, int valid, const float* inv_x,
                                            int8_t* act, int8_t* xq) {
  const int lane = threadIdx.x & 31;
  const int row = lane >> 1, part = lane & 1;
  const bool ok = row < valid;
  float x[3] = {0.f, 0.f, 0.f};
  if (ok) {
    const float* o = ray + ((q0 + row) / S) * 8;
    const float tq = t[q0 + row];
    // o + d*t rounded as two operations (no fma), as the plain path.
#pragma unroll
    for (int d = 0; d < 3; ++d) x[d] = __fadd_rn(o[d], __fmul_rn(o[4 + d], tq));
  }
  int8_t* arow = act + row * m.ldx;
  int8_t* xrow = xq + row * m.xyz_pad;
  auto put = [&](int c, float v) {
    const int8_t b = ok ? static_cast<int8_t>(requant<false>(v, inv_x[c])) : int8_t(0);
    arow[c] = b;
    xrow[c] = b;
  };
  if (part == 0)
#pragma unroll
    for (int d = 0; d < 3; ++d) put(d, x[d]);
  const int octaves = (m.xyz_dim - 3) / 6;
  const int half = (octaves + 1) / 2;
  const int o_end = min(octaves, (part + 1) * half);
  for (int o = part * half; o < o_end; ++o) {
    const float scale = __int_as_float((127 + o) << 23);  // 2^o, exact
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float sn, cs;
      sincosf(__fmul_rn(x[d], scale), &sn, &cs);
      put(3 + 6 * o + d, sn);
      put(6 + 6 * o + d, cs);
    }
  }
  for (int c = m.xyz_dim + part; c < m.xyz_pad; c += 2) {
    arow[c] = 0;
    xrow[c] = 0;
  }
  __syncwarp();
}

template <int H>
__global__ void __launch_bounds__(kWgThreads, 1)
    quant_render_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const QDims& m = p.m;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ldx = m.ldx;
  const int R = p.R;
  const int S = p.S;

  // Shared-memory carve-up (every section a multiple of 16 bytes).
  WRing ring;
  ring.full = reinterpret_cast<uint64_t*>(smem);
  ring.empty = ring.full + kMaxStages;
  uint64_t* fbar = ring.empty + kMaxStages;
  ring.buf = smem + kQBarBytes;
  ring.stages = p.stages;
  ring.stage_bytes = p.stage_bytes;
  float* f = reinterpret_cast<float*>(ring.buf + p.stages * p.stage_bytes);
  int8_t* act = reinterpret_cast<int8_t*>(f) + m.f_bytes;  // (128, ldx)
  int8_t* xq = act + kWgRows * ldx;                         // (128, xyz_pad)
  int8_t* dq = xq + kWgRows * m.xyz_pad;                    // (R, dir_pad)
  float* ray = reinterpret_cast<float*>(dq + round_up(R * m.dir_pad, 16));  // (R, 8): o, d
  float* sig = ray + R * 8;   // (R*S)
  float* rgbl = sig + R * S;  // (R*S, 3)
  const float* inv_x = f + m.x_off;
  const float* inv_d = f + m.d_off;

  const int r0 = blockIdx.x * R;
  const int nrays = min(R, p.B - r0);
  const int P = nrays * S;
  const size_t s0 = (size_t)r0 * S;  // first sample of the block
  const int ntiles = (P + kWgRows - 1) / kWgRows;

  if (tid == 0) {
    ring_init(ring);
    mbar_init(fbar, 1);
    fence_mbar_init();
  }
  for (int i = tid; i < R * 3; i += kWgThreads) {
    const int r = i / 3, c = i - r * 3;
    const bool ok = r < nrays;
    ray[r * 8 + c] = ok ? p.origins[(size_t)(r0 + r) * 3 + c] : 0.f;
    ray[r * 8 + 4 + c] = ok ? p.dirs[(size_t)(r0 + r) * 3 + c] : 0.f;
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one thread issues
    reg_dealloc<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(fbar, static_cast<uint32_t>(m.f_bytes));
      bulk_g2s(f, p.f, static_cast<uint32_t>(m.f_bytes), fbar);
      RingPos rp;
      for (int tile = 0; tile < ntiles; ++tile)
        for (int i = 0; i < m.num_layers + 3; ++i) produce_q_layer(ring, rp, p.w, m.dense[i]);
    }
    return;
  }
  reg_alloc<kConsumerRegs>();
  mbar_wait(fbar, 0);  // the f32 rows are in shared memory

  // Direction features, quantized once per ray (every sample of a ray
  // shares them); inv_d is zero beyond dir_dim.
  for (int i = tid; i < R * m.dir_pad; i += kWgConsumers) {
    const int r = i / m.dir_pad, c = i - r * m.dir_pad;
    dq[i] = static_cast<int8_t>(
        requant<false>(encode_feature(ray + r * 8 + 4, c, m.dir_dim), inv_d[c]));
  }
  consumer_sync(kWgConsumers);

  const int wrow = warp * 16;  // this warp's rows of every tile
  int8_t* wact = act + wrow * ldx;
  int8_t* wxq = xq + wrow * m.xyz_pad;
  const int dw = m.dir_pad >> 2;
  RingPos rp;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int q0 = tile * kWgRows + wrow;  // block sample of the warp's row 0
    const int valid = min(16, P - q0);     // may be <= 0 on the last tile
    encode_rows(m, ray, p.t_vals + s0, S, q0, valid, inv_x, wact, wxq);
    auto dir4 = [&](int row, int c) -> uint32_t {
      return reinterpret_cast<const uint32_t*>(dq)[((q0 + row) / S) * dw + c];
    };
    qmlp_forward_wg<H>(m, f, wact, wxq, dir4, sig + q0, rgbl + q0 * 3, valid, ring, rp);
  }
  consumer_sync(kWgConsumers);

  composite_rays(p.t_vals + s0, sig, rgbl, nrays, S, p.w_out + s0,
                 p.rgb_out + (size_t)r0 * 3);
}

// The hidden widths K4 is instantiated for.
inline bool q_hidden_ok(int h) { return h == 32 || h == 64 || h == 128 || h == 256; }

// Host side: fill `m` from the launch arguments and the pack's descriptors;
// false when a shape is out of what the kernel takes.
bool qdims_init(QDims& m, const int* desc, int n_dense, int num_layers, int skip_layer,
                int hidden, int l_xyz, int l_dir, int x_off, int d_off) {
  if (num_layers < 1 || skip_layer < 1 || !q_hidden_ok(hidden) || l_xyz < 0 || l_dir < 0 ||
      n_dense != num_layers + 3 || n_dense > kMaxDense || x_off < 0 || d_off < 0)
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
  // The f32 pack ends with inv_x and inv_d, each padded to 32 floats.
  if (d_off != x_off + m.xyz_pad) return false;
  m.f_bytes = (d_off + m.dir_pad) * 4;
  int w_end = 0, f_end = 0;
  for (int i = 0; i < n_dense; ++i) {
    QDense& d = m.dense[i];
    d = QDense{desc[i * 5], desc[i * 5 + 1], desc[i * 5 + 2], desc[i * 5 + 3],
               desc[i * 5 + 4]};
    if (d.k_pad % 32 != 0 || d.k_pad <= 0 || d.k_pad > kmax || d.n_pad % 8 != 0 ||
        d.n > d.n_pad || d.w_off != w_end || d.f_off != f_end)
      return false;
    w_end += d.n_pad * d.k_pad;
    f_end += 3 * d.n_pad;
  }
  if (x_off != f_end) return false;
  // The widths the instantiations take: trunk H, merged head H + 8 (sigma
  // last), branch H / 2 over [feature | direction], rgb 8 columns.
  for (int i = 0; i < num_layers; ++i)
    if (m.dense[i].n_pad != hidden) return false;
  const QDense& fs = m.dense[num_layers];
  const QDense& br = m.dense[num_layers + 1];
  const QDense& rgb = m.dense[num_layers + 2];
  return m.dense[0].k_pad == m.xyz_pad && fs.n == hidden + 1 && fs.n_pad == hidden + 8 &&
         br.n_pad == hidden / 2 && br.k_pad == hidden + m.dir_pad && rgb.n == 3 &&
         rgb.n_pad == 8 && rgb.k_pad == hidden / 2;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `w_pack` is the int8 pack
// (pack_qparams: every layer's 128-wide k-slices in wgmma's K-major layout);
// `dense_desc` is a HOST array of n_dense * 5 ints (k_pad, n, n_pad, w_off,
// f_off) in the order trunk[0..num_layers), merged feature+sigma head,
// branch, rgb; `x_off` and `d_off` locate the inv_x and inv_d rows (padded
// to 32 with zeros) at the end of the f32 pack.  hidden is 32, 64, 128 or
// 256.  Launches on `stream` and returns cudaGetLastError() (0 on success);
// does not synchronise and allocates nothing.
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
  p.R = wg_rays_per_block(S);
  p.stage_bytes = (hidden + 8) * kQKs;  // the widest layer's k-slice: the merged head

  const size_t rest = kQBarBytes + (size_t)p.m.f_bytes + (size_t)kWgRows * p.m.ldx +
                      (size_t)kWgRows * p.m.xyz_pad + (size_t)round_up(p.R * p.m.dir_pad, 16) +
                      sizeof(float) * ((size_t)p.R * 8 + (size_t)p.R * S * 4);
  if (rest + 2 * (size_t)p.stage_bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const size_t fit = ((size_t)kMaxSmem - rest) / p.stage_bytes;
  p.stages = fit < (size_t)kMaxStages ? (int)fit : kMaxStages;
  const size_t smem = rest + (size_t)p.stages * p.stage_bytes;
  void (*kernel)(const Params) = hidden == 32    ? quant_render_fwd_kernel<32>
                                 : hidden == 64  ? quant_render_fwd_kernel<64>
                                 : hidden == 128 ? quant_render_fwd_kernel<128>
                                                 : quant_render_fwd_kernel<256>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + p.R - 1) / p.R;
  kernel<<<grid, kWgThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
