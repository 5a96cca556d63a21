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
// Hidden 512 (any width 257-512 on tables padded by pad_qparams): 2,300,928
// int8 multiply-adds a sample.  The 128-row tile does not fit (the f32 rows
// alone are 58,944 B), so K4 takes nerf_wgmlp.cuh's split tile: 64 rows,
// the two warpgroups each computing a part of every layer's columns
// (SplitProduct), stages of 64 k.  Every layer whose padded k passes 256 --
// each trunk layer after the first, the head and the branch -- dequantizes
// with cvt.rn.f32.s32 (exact at any |acc|), the first layer and the rgb
// head by the magic number.  Shared memory at 8x512, S = 192: the f32 rows
// 58,944 B, the activation tile 64 x 592 = 37,888, the x_enc copy 4,096,
// the ray and its predictions 3,136, and 3 stages of 520 x 64 = 33,280 B:
// 204,048 B.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (never -use_fast_math: the top octave's
//        argument is 2^9*|p|, where the fast sin is wrong).

#include "nerf_wgmlp.cuh"

using namespace nkt;

namespace {

constexpr int kQKs = 128;             // k per weight stage (128 int8 = 128 bytes a row)
constexpr int kQKsSplit = 64;         // the same on a split tile (hidden 512)
constexpr int kMagicK = 256;          // padded k up to which |acc| <= k * 127^2 < 2^22
constexpr float kRound = 12582912.f;  // 1.5 * 2^23
constexpr int kRoundBits = 0x4B400000;
constexpr int kQBarBytes = kBarBytes + 48;  // the ring's barriers, the f32 rows' one, FStage's
// Hidden 1024: each column pass's f32 rows (scale, bias, inv) staged in two
// slots of shared memory, kFStageCols floats a row (the widest pass).
constexpr int kFStageCols = 520;

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

// k per weight stage of hidden H's tile.
__host__ __device__ constexpr int q_ks(int hidden) {
  return hidden > kSplitAbove ? kQKsSplit : kQKs;
}

// acc[0, N/2) = act[64 rows of the warpgroup, 0:k_pad) @ columns [n0, n0
// + N) of the layer's stages (`np` wide: its n_pad); consumes ceil(k_pad /
// KQ) stages of the ring.  The int8 pack is one K-major layout over all k
// (element (n, k) at ((k / 16) * n_pad + n) * 16 + k % 16), so stages of 64
// or 128 k are contiguous runs of the same pack.
template <int N, int KQ>
__device__ __forceinline__ void q_product(int* acc, const int8_t* act, int ldx, int k_pad,
                                          const WRing& r, RingPos& c, int np = N, int n0 = 0) {
  static_assert(N % 8 == 0 && N <= 264, "wgmma widths");
  constexpr int kSteps = KQ / 32;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  for (int k0 = 0; k0 < k_pad; k0 += KQ) {
    const int steps = min(KQ, k_pad - k0) >> 5;  // block-uniform
    uint32_t a[kSteps][4];
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps) load_a_s8(a[q], act, ldx, k0 + 32 * q);
    mbar_wait(&r.full[c.st], c.ph);
    const uint32_t sb = smem_u32(r.buf + static_cast<size_t>(c.st) * r.stage_bytes) + n0 * 16;
    acc_fence<N / 2>(acc);
    wg_fence();
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps)
        mma_rs_s8<N>(acc, a[q], smem_desc(sb + q * 2 * np * 16, np * 16, 128), 128, 1);
    wg_commit();
    wg_wait<0>();
    acc_fence<N / 2>(acc);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[c.st]);
    c.next(r.stages);
  }
}

// The A fragments of the stage of k [k0, k0 + KQ) (fewer k32 steps where
// k_pad ends first).
template <int KQ>
__device__ __forceinline__ void q_load_stage(uint32_t (&a)[KQ / 32][4], const int8_t* act,
                                             int ldx, int k_pad, int k0) {
  const int steps = min(KQ, k_pad - k0) >> 5;  // block-uniform
#pragma unroll
  for (int q = 0; q < KQ / 32; ++q)
    if (q < steps) load_a_s8(a[q], act, ldx, k0 + 32 * q);
}

// One stage of q_product_pipe: wait for
// it, issue its k32 steps from `cur` as one wgmma group, then wait until
// only this group is in flight, release the previous stage (`held`) and
// load the next stage's A into `nxt`.
template <int N, int KQ>
__device__ __forceinline__ void q_pipe_stage(int* acc, uint32_t (&cur)[KQ / 32][4],
                                             uint32_t (&nxt)[KQ / 32][4], const int8_t* act,
                                             int ldx, int k_pad, int k0, const WRing& r,
                                             RingPos& c, int& held, int np, int n0) {
  const int steps = min(KQ, k_pad - k0) >> 5;
  mbar_wait(&r.full[c.st], c.ph);
  const uint32_t sb = smem_u32(r.buf + static_cast<size_t>(c.st) * r.stage_bytes) + n0 * 16;
  acc_fence<N / 2>(acc);
  wg_fence();
#pragma unroll
  for (int q = 0; q < KQ / 32; ++q)
    if (q < steps)
      mma_rs_s8<N>(acc, cur[q], smem_desc(sb + q * 2 * np * 16, np * 16, 128), 128, 1);
  wg_commit();
  if (held >= 0) {
    wg_wait<1>();
    reg_fence<KQ / 8>(&nxt[0][0]);
    ring_release(r, held);
  }
  held = c.st;
  c.next(r.stages);
  if (k0 + KQ < k_pad) q_load_stage<KQ>(nxt, act, ldx, k_pad, k0 + KQ);
}

// q_product's sums with wgmma groups kept in flight across stages: stage s
// + 1's A fragments load and its group issues before stage s's group is
// waited on and its stage released; two register buffers of A fragments.
// Integer sums: the same bits in any order.
template <int N, int KQ>
__device__ __forceinline__ void q_product_pipe(int* acc, const int8_t* act, int ldx, int k_pad,
                                               const WRing& r, RingPos& c, int np, int n0) {
  static_assert(N % 8 == 0 && N <= 264, "wgmma widths");
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  uint32_t a0[KQ / 32][4], a1[KQ / 32][4];
  int held = -1;
  q_load_stage<KQ>(a0, act, ldx, k_pad, 0);
  for (int k0 = 0; k0 < k_pad; k0 += 2 * KQ) {
    q_pipe_stage<N, KQ>(acc, a0, a1, act, ldx, k_pad, k0, r, c, held, np, n0);
    if (k0 + KQ < k_pad)
      q_pipe_stage<N, KQ>(acc, a1, a0, act, ldx, k_pad, k0 + KQ, r, c, held, np, n0);
  }
  wg_wait<0>();
  acc_fence<N / 2>(acc);
  reg_fence<KQ / 8>(&a0[0][0]);
  reg_fence<KQ / 8>(&a1[0][0]);
  ring_release(r, held);
}

// The warp's share of an N-wide layer's product on H's tile (as the bf16
// layer_product, nerf_wgmlp.cuh): all N columns, or its warpgroup's
// SplitProduct with its groups in flight across stages (q_product_pipe),
// then split_sync.
template <int H, int N>
__device__ __forceinline__ void q_layer_product(int* acc, const int8_t* act, int ldx, int k_pad,
                                                const WRing& r, RingPos& c) {
  constexpr int KQ = q_ks(H);
  if constexpr (!WgTile<H>::kSplit) {
    q_product<N, KQ>(acc, act, ldx, k_pad, r, c);
  } else {
    using P = SplitProduct<N>;
    const int n0 = col_part<H>() ? P::n0_hi : 0;
    q_product_pipe<P::width, KQ>(acc, act, ldx, k_pad, r, c, N, n0);
    split_sync<H>();
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

// A trunk layer or the branch: relu, then requantized (columns [n0, n0 +
// N) of the layer's f32 rows `fl`, n_pad apart, to act + n0).
template <int N>
__device__ __forceinline__ void epi_relu_q(const int* acc, const float* fl, int n_pad, bool magic,
                                           int8_t* act, int ldx, int n0 = 0) {
  if (magic)
    epi_requant<N, true, true>(acc, fl + n0, n_pad, act + n0, ldx);
  else
    epi_requant<N, true, false>(acc, fl + n0, n_pad, act + n0, ldx);
}

// epi_relu_q over the warp's columns of an N-wide layer (or column pass,
// whose f32 rows start at fl) on H's tile.
template <int H, int N>
__device__ __forceinline__ void layer_relu_q(const int* acc, const float* fl, int stride,
                                             const QDense& L, int8_t* act, int ldx) {
  const bool magic = L.k_pad <= kMagicK;
  if constexpr (!WgTile<H>::kSplit) {
    epi_relu_q<N>(acc, fl, stride, magic, act, ldx);
  } else if (col_part<H>() == 0) {
    epi_relu_q<Split<N>::lo>(acc, fl, stride, magic, act, ldx);
  } else {
    epi_relu_q<Split<N>::hi>(acc, fl, stride, magic, act, ldx, Split<N>::lo);
  }
}

// Hidden 1024's staged f32 rows (FStage): slot n % 2 holds the rows of the
// n-th column pass, which the producer copies once the consumers released
// what the slot held.  Elsewhere `buf` is null and the rows are read where
// they are.
struct FStage {
  float* buf = nullptr;  // 2 slots x 3 rows x kFStageCols
  uint64_t* full;        // [2] count 1 + bytes
  uint64_t* empty;       // [2] count kConsumerWarps
  int n = 0;             // passes produced (producer) or consumed (consumers)
};

// Consumers: the f32 rows of columns c0.. of layer L and their row stride.
__device__ __forceinline__ const float* f_rows(FStage& fs, const float* f, const QDense& L,
                                               int c0, int& stride) {
  if (fs.buf == nullptr) {
    stride = L.n_pad;
    return f + L.f_off + c0;
  }
  mbar_wait(&fs.full[fs.n & 1], (fs.n >> 1) & 1);
  stride = kFStageCols;
  return fs.buf + (fs.n & 1) * 3 * kFStageCols;
}

// Consumers (every warp, after its epilogue of the pass): the slot released.
__device__ __forceinline__ void f_done(FStage& fs) {
  if (fs.buf == nullptr) return;
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&fs.empty[fs.n & 1]);
  ++fs.n;
}

// Producer: pass q of layer L's f32 rows into the next slot.
__device__ __forceinline__ void produce_f_pass(FStage& fs, const float* f, const QDense& L, int q) {
  const int slot = fs.n & 1, c0 = q * kPassCols, w = pass_width(L.n_pad, q);
  float* dst = fs.buf + slot * 3 * kFStageCols;
  mbar_wait(&fs.empty[slot], ((fs.n >> 1) & 1) ^ 1u);
  mbar_expect_tx(&fs.full[slot], static_cast<uint32_t>(3 * w * 4));
  for (int r = 0; r < 3; ++r)  // w * 4 bytes: a multiple of 32; n_pad a multiple of 8
    bulk_g2s(dst + r * kFStageCols, f + L.f_off + r * L.n_pad + c0, static_cast<uint32_t>(w * 4),
             &fs.full[slot]);
  ++fs.n;
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

// The merged head over the warp's columns on H's tile (all N of it, or a
// column pass; with kSigma the part that ends with sigma): warpgroup 0's
// part of a split head is feature columns alone, warpgroup 1's ends with
// sigma.
template <int H, int N, bool kSigma, bool kMagic>
__device__ __forceinline__ void layer_fs_q(const int* acc, const float* f, int n_pad,
                                           int8_t* act, int ldx, float* sig, int valid) {
  if constexpr (!WgTile<H>::kSplit) {
    epi_fs<N, kMagic>(acc, f, n_pad, act, ldx, sig, valid);
  } else {
    using S = Split<N>;
    if (col_part<H>() == 0)
      epi_requant<S::lo, false, kMagic>(acc, f, n_pad, act, ldx);
    else if constexpr (kSigma)
      epi_fs<S::hi, kMagic>(acc, f + S::lo, n_pad, act + S::lo, ldx, sig, valid);
    else
      epi_requant<S::hi, false, kMagic>(acc, f + S::lo, n_pad, act + S::lo, ldx);
  }
}

// The warp's columns of a parked N-wide pass (Split<N>: the bytes its
// epilogue wrote, rows g and g + 8, columns 8j + 2t and + 1) from the park
// (row stride kPassCols) back into the activation tile (as nerf_wgmlp.cuh's
// park_back).
template <int H, int N>
__device__ __forceinline__ void q_park_back(const int8_t* park, int8_t* act, int ldx) {
  using S = Split<N>;
  static_assert(S::lo == S::hi, "equal parts");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c0 = col_part<H>() ? S::lo : 0;
#pragma unroll
  for (int j = 0; j < S::lo / 8; ++j) {
    const int c = c0 + 8 * j + 2 * t;
    *reinterpret_cast<uint16_t*>(act + g * ldx + c) =
        *reinterpret_cast<const uint16_t*>(park + g * kPassCols + c);
    *reinterpret_cast<uint16_t*>(act + (g + 8) * ldx + c) =
        *reinterpret_cast<const uint16_t*>(park + (g + 8) * kPassCols + c);
  }
}

// An N-wide layer's products and epilogues on H's tile, pass by pass (as
// nerf_wgmlp.cuh's layer_passes): epi(acc, width, last, c0, dst, ld)
// writes pass columns [c0, c0 + width) to dst, the tile for the last pass
// and the park (the warp's rows, in shared memory) for the other.
template <int H, int N, class Epi>
__device__ __forceinline__ void q_layer_passes(int* acc, int8_t* act, int ldx, int k_pad,
                                               const WRing& r, RingPos& c, int8_t* park,
                                               Epi epi) {
  constexpr int NP = n_passes(N);
  if constexpr (NP == 1) {
    q_layer_product<H, N>(acc, act, ldx, k_pad, r, c);
    epi(acc, std::integral_constant<int, N>{}, std::true_type{}, 0, act, ldx);
  } else {
    static_assert(NP == 2 && WgTile<H>::kParked, "two passes (hidden 1024)");
    constexpr int W1 = N - kPassCols;
    q_layer_product<H, kPassCols>(acc, act, ldx, k_pad, r, c);
    epi(acc, std::integral_constant<int, kPassCols>{}, std::false_type{}, 0, park, kPassCols);
    q_layer_product<H, W1>(acc, act, ldx, k_pad, r, c);
    epi(acc, std::integral_constant<int, W1>{}, std::true_type{}, kPassCols, act + kPassCols,
        ldx);
    q_park_back<H, kPassCols>(park, act, ldx);
  }
}

// The warp's 16 rows (with its peer's on a split tile) through the int8
// MLP.  On entry act (the warp's row 0) holds the quantized position
// features in [0, xyz_pad) and xq (row stride xyz_pad) a copy of them for
// the skip concat; dir4(row, w) gives word w (4 int8) of the row's
// quantized direction features.  sig and rgbl (the warp's rows) receive
// sigma and the rgb logits for rows < valid.  The producer streams
// dense[0..L+2] in order.
template <int H, class DirFn>
__device__ __forceinline__ void qmlp_forward_wg(const QDims& m, const float* f, int8_t* act,
                                                const int8_t* xq, DirFn dir4, float* sig,
                                                float* rgbl, int valid, const WRing& ring,
                                                RingPos& rp, FStage& fst,
                                                int8_t* park = nullptr) {
  using T = WgTile<H>;
  const int pl = peer_lane<H>();
  const int ldx = m.ldx;
  const int L = m.num_layers;
  const int xw = m.xyz_pad >> 2, dw = m.dir_pad >> 2;
  int acc[T::kAcc];
  for (int i = 0; i < L; ++i) {
    const QDense& Ly = m.dense[i];
    q_layer_passes<H, H>(acc, act, ldx, Ly.k_pad, ring, rp, park,
                         [&](int* a, auto w, auto, int c0, int8_t* dst, int ld) {
                           int sd;
                           const float* fl = f_rows(fst, f, Ly, c0, sd);
                           layer_relu_q<H, decltype(w)::value>(a, fl, sd, Ly, dst, ld);
                           f_done(fst);
                         });
    if (is_skip(i, m.skip_layer))  // [hq | qx]
      for (int j = pl; j < 16 * xw; j += T::kLanes) {
        const int row = j / xw, c = j - row * xw;
        reinterpret_cast<uint32_t*>(act + row * ldx + H)[c] =
            reinterpret_cast<const uint32_t*>(xq)[j];
      }
    rows_sync<H>();
  }
  // The merged feature+sigma head; the direction features fill the columns
  // after the feature, so act becomes the branch input [qfeat | qd].
  const QDense& fs = m.dense[L];
  q_layer_passes<H, H + 8>(
      acc, act, ldx, fs.k_pad, ring, rp, park,
      [&](int* a, auto w, auto last, int c0, int8_t* dst, int ld) {
        constexpr int W = decltype(w)::value;
        constexpr bool kLast = decltype(last)::value;
        int sd;
        const float* fl = f_rows(fst, f, fs, c0, sd);
        if (fs.k_pad <= kMagicK)
          layer_fs_q<H, W, kLast, true>(a, fl, sd, dst, ld, sig, valid);
        else
          layer_fs_q<H, W, kLast, false>(a, fl, sd, dst, ld, sig, valid);
        f_done(fst);
      });
  for (int j = pl; j < 16 * dw; j += T::kLanes) {
    const int row = j / dw, c = j - row * dw;
    reinterpret_cast<uint32_t*>(act + row * ldx + H)[c] = row < valid ? dir4(row, c) : 0u;
  }
  rows_sync<H>();
  q_layer_product<H, H / 2>(acc, act, ldx, m.dense[L + 1].k_pad, ring, rp);
  {
    int sd;
    const float* fl = f_rows(fst, f, m.dense[L + 1], 0, sd);
    layer_relu_q<H, H / 2>(acc, fl, sd, m.dense[L + 1], act, ldx);
    f_done(fst);
  }
  rows_sync<H>();
  const QDense& rgb = m.dense[L + 2];
  q_layer_product<H, 8>(acc, act, ldx, rgb.k_pad, ring, rp);
  int sd;
  const float* fl = f_rows(fst, f, rgb, 0, sd);
  if (col_part<H>() == 0) {
    if (rgb.k_pad <= kMagicK)
      epi_rgb<true>(acc, fl, sd, rgbl, valid);
    else
      epi_rgb<false>(acc, fl, sd, rgbl, valid);
  }
  f_done(fst);
  rows_sync<H>();
}

// The producer's side: every k-slice of one layer, column pass by pass
// (each pass's block of the pack at w_off + k_pad * c0), in order, `kq`
// deep; on a cluster's ring half of each slice into both blocks (as
// nerf_wgmlp.cuh's produce_pass).
__device__ __forceinline__ void produce_q_layer(const WRing& r, RingPos& p, const int8_t* w,
                                                const QDense& L, int kq, FStage& fst,
                                                const float* f) {
  for (int q = 0; q < n_passes(L.n_pad); ++q) {
    if (fst.buf != nullptr) produce_f_pass(fst, f, L, q);
    const int np = pass_width(L.n_pad, q);
    const int8_t* src = w + L.w_off + static_cast<size_t>(L.k_pad) * q * kPassCols;
    for (int k0 = 0; k0 < L.k_pad; k0 += kq) {
      const uint32_t bytes = static_cast<uint32_t>(np * min(kq, L.k_pad - k0));
      unsigned char* dst = r.buf + static_cast<size_t>(p.st) * r.stage_bytes;
      const int8_t* from = src + static_cast<size_t>(k0) * np;
      mbar_wait(&r.empty[p.st], p.ph ^ 1u);  // on a cluster: both blocks' consumers released it
      mbar_expect_tx(&r.full[p.st], bytes);
      if (r.peer < 0) {
        bulk_g2s(dst, from, bytes, &r.full[p.st]);
      } else {  // bytes: a multiple of 256 (np a multiple of 8, 32 k at least)
        const uint32_t half = bytes / 2, off = r.peer ? 0u : half;
        bulk_g2s_multicast(dst + off, from + off, half, &r.full[p.st], 0x3);
      }
      p.next(r.stages);
    }
  }
}

// A phantom tile's share of a cluster's ring: every stage of every layer
// waited for and released, so both producers go on filling both blocks.
__device__ __forceinline__ void drain_q_tile(const QDims& m, const WRing& r, RingPos& c, int kq,
                                             FStage& fst) {
  for (int i = 0; i < m.num_layers + 3; ++i)
    for (int q = 0; q < n_passes(m.dense[i].n_pad); ++q) {
      for (int k0 = 0; k0 < m.dense[i].k_pad; k0 += kq) {
        mbar_wait(&r.full[c.st], c.ph);
        ring_release(r, c.st);
        c.next(r.stages);
      }
      if (fst.buf != nullptr) {  // the pass's staged rows, unread
        int sd;
        f_rows(fst, nullptr, m.dense[i], 0, sd);
        f_done(fst);
      }
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
  using T = WgTile<H>;
  static_assert(!T::kSplit, "the split tile runs quant_render_wide_kernel");
  constexpr int kRows = T::kRows;
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
  int8_t* act = reinterpret_cast<int8_t*>(f) + m.f_bytes;  // (rows, ldx)
  int8_t* xq = act + kRows * ldx;                           // (rows, xyz_pad)
  int8_t* dq = xq + kRows * m.xyz_pad;                      // (R, dir_pad)
  float* ray = reinterpret_cast<float*>(dq + round_up(R * m.dir_pad, 16));  // (R, 8): o, d
  float* sig = ray + R * 8;   // (R*S)
  float* rgbl = sig + R * S;  // (R*S, 3)
  const float* inv_x = f + m.x_off;
  const float* inv_d = f + m.d_off;

  const int r0 = blockIdx.x * R;
  const int nrays = min(R, p.B - r0);
  const int P = nrays * S;
  const size_t s0 = (size_t)r0 * S;  // first sample of the block
  const int ntiles = (P + kRows - 1) / kRows;

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
      FStage fst;
      for (int tile = 0; tile < ntiles; ++tile)
        for (int i = 0; i < m.num_layers + 3; ++i)
          produce_q_layer(ring, rp, p.w, m.dense[i], q_ks(H), fst, p.f);
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

  const int wrow = row_warp<H>() * 16;  // this warp's rows of every tile
  int8_t* wact = act + wrow * ldx;
  int8_t* wxq = xq + wrow * m.xyz_pad;
  const int dw = m.dir_pad >> 2;
  RingPos rp;
  FStage fst;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int q0 = tile * kRows + wrow;  // block sample of the warp's row 0
    const int valid = min(16, P - q0);   // may be <= 0 on the last tile
    encode_rows(m, ray, p.t_vals + s0, S, q0, valid, inv_x, wact, wxq);
    auto dir4 = [&](int row, int c) -> uint32_t {
      return reinterpret_cast<const uint32_t*>(dq)[((q0 + row) / S) * dw + c];
    };
    qmlp_forward_wg<H>(m, f, wact, wxq, dir4, sig + q0, rgbl + q0 * 3, valid, ring, rp, fst);
  }
  consumer_sync(kWgConsumers);

  composite_rays(p.t_vals + s0, sig, rgbl, nrays, S, p.w_out + s0,
                 p.rgb_out + (size_t)r0 * 3);
}

// encode_rows on the split tile, by both warps of the rows: warp v of
// warpgroup w takes 8 of the rows (8w..8w+7 of the 16), four lanes a row,
// each a quarter of the octaves (lane 0 of the four also the raw
// coordinates).  The same values as encode_rows.
__device__ __forceinline__ void encode_rows_split(const QDims& m, const float* ray, const float* t,
                                                  int S, int q0, int valid, const float* inv_x,
                                                  int8_t* act, int8_t* xq) {
  const int lane = threadIdx.x & 31;
  const int row = 8 * (threadIdx.x >> 7) + (lane >> 2), part = lane & 3;
  const bool ok = row < valid;
  float x[3] = {0.f, 0.f, 0.f};
  if (ok) {
    const float* o = ray + ((q0 + row) / S) * 8;
    const float tq = t[q0 + row];
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
  const int quarter = (octaves + 3) / 4;
  const int o_end = min(octaves, (part + 1) * quarter);
  for (int o = part * quarter; o < o_end; ++o) {
    const float scale = __int_as_float((127 + o) << 23);  // 2^o, exact
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float sn, cs;
      sincosf(__fmul_rn(x[d], scale), &sn, &cs);
      put(3 + 6 * o + d, sn);
      put(6 + 6 * o + d, cs);
    }
  }
  for (int c = m.xyz_dim + part; c < m.xyz_pad; c += 4) {
    arow[c] = 0;
    xrow[c] = 0;
  }
}

// K4 at hidden 512 and 1024 on a persistent grid of clusters of two blocks
// (nerf_wgmlp.cuh, "Clusters"): block b takes the groups of R rays b, b +
// gridDim.x, ... (wg_rays_per_block), so it brings the f32 rows (58,944 B
// at 8x512) and initialises its barriers once, and its producer streams the
// next group's weights while the consumers composite the last.  Each block
// keeps its own 64-row tile, ring and memory plan; each producer brings half
// of every weight stage into both blocks' rings (TMA multicast), so a staged
// byte read from L2 feeds 128 rows (the whole int8 pack, 9.07 MB at 8x1024,
// was read from L2 for every 64-row tile).  So both blocks consume the same
// stages: each walks as many groups as its cluster's first block, and each
// step as many tiles as the first block's group (the other's group is
// shorter only at the batch's last group, or past it: a phantom group); the
// tiles it lacks it drains (drain_q_tile).  Per group: the rays and their
// direction features, a barrier of the consumers, the tiles, another
// barrier, the compositing.  The encode is shared by both warpgroups
// (encode_rows_split).  At 1024 the layers run in column passes of 512
// (nerf_wgmlp.cuh: n_passes), the first pass's bytes parked in shared memory
// (64 x 512 B) until the second pass's products are done, and the f32 rows
// (116,928 B at 8x1024: they and an activation tile of 64 x 1,104 B leave no
// room for stages) stay in global memory: the producer copies each pass's
// rows into one of two slots of shared memory (FStage) before its stages.
// Read through L1 from global memory instead, K4 took 103 ms at 16,384 x
// 192 on an H100 against 91 staged (PERF.md).
template <int H>
__global__ void __launch_bounds__(kWgThreads, 1)
    quant_render_wide_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using T = WgTile<H>;
  static_assert(T::kSplit, "clusters of the split tile");
  constexpr bool kFGlobal = T::kParked;  // the f32 rows staged from global memory (FStage)
  constexpr int kRows = T::kRows;
  const QDims& m = p.m;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ldx = m.ldx;
  const int R = p.R;
  const int S = p.S;
  const int groups = (p.B + R - 1) / R;
  const int steps = walk_steps<H>(groups);
  const int first = blockIdx.x & ~(kCluster - 1);  // the cluster's first block
  // Tiles of group g (none past the last group).
  auto group_tiles = [&](int g) {
    return g < groups ? (min(R, p.B - g * R) * S + kRows - 1) / kRows : 0;
  };

  WRing ring;
  ring.full = reinterpret_cast<uint64_t*>(smem);
  ring.empty = ring.full + kMaxStages;
  uint64_t* fbar = ring.empty + kMaxStages;
  ring.buf = smem + kQBarBytes;
  ring.stages = p.stages;
  ring.stage_bytes = p.stage_bytes;
  float* fs = reinterpret_cast<float*>(ring.buf + p.stages * p.stage_bytes);  // the f32 rows
  int8_t* act = reinterpret_cast<int8_t*>(fs) + (kFGlobal ? 0 : m.f_bytes);   // (rows, ldx)
  int8_t* park = act + kRows * ldx;                          // (rows, kPassCols): 1024
  int8_t* xq = park + (T::kParked ? kRows * kPassCols : 0);  // (rows, xyz_pad)
  int8_t* dq = xq + kRows * m.xyz_pad;                      // (R, dir_pad)
  float* ray = reinterpret_cast<float*>(dq + round_up(R * m.dir_pad, 16));  // (R, 8): o, d
  float* sig = ray + R * 8;   // (R*S)
  float* rgbl = sig + R * S;  // (R*S, 3)
  FStage fst;  // hidden 1024: after the predictions, 16-byte aligned
  if (T::kParked) {
    const int used = static_cast<int>(reinterpret_cast<unsigned char*>(rgbl + R * S * 3) - smem);
    fst.buf = reinterpret_cast<float*>(smem + round_up(used, 16));
    fst.full = fbar + 1;
    fst.empty = fbar + 3;
  }
  const float* f = kFGlobal ? p.f : fs;
  const float* inv_x = f + m.x_off;
  const float* inv_d = f + m.d_off;

  ring_peer<H>(ring);
  if (tid == 0) {
    ring_init(ring);
    mbar_init(fbar, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(fbar + 1 + i, 1);
      mbar_init(fbar + 3 + i, kConsumerWarps);
    }
    fence_mbar_init();
  }
  block_sync<H>();  // the peer's barriers are set before its copies land here

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one thread issues
    reg_dealloc<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      if (!kFGlobal) {
        mbar_expect_tx(fbar, static_cast<uint32_t>(m.f_bytes));
        bulk_g2s(fs, p.f, static_cast<uint32_t>(m.f_bytes), fbar);
      }
      RingPos rp;
      for (int k = 0; k < steps; ++k) {
        const int ntiles = group_tiles(first + k * gridDim.x);
        for (int tile = 0; tile < ntiles; ++tile)
          for (int i = 0; i < m.num_layers + 3; ++i)
            produce_q_layer(ring, rp, p.w, m.dense[i], q_ks(H), fst, p.f);
      }
    }
    block_exit<H>();
    return;
  }
  reg_alloc<kConsumerRegs>();
  if (!kFGlobal) mbar_wait(fbar, 0);  // the f32 rows are in shared memory

  const int wrow = row_warp<H>() * 16;  // this warp's rows of every tile
  int8_t* wact = act + wrow * ldx;
  int8_t* wxq = xq + wrow * m.xyz_pad;
  int8_t* wpark = T::kParked ? park + wrow * kPassCols : nullptr;
  const int dw = m.dir_pad >> 2;
  RingPos rp;
  for (int k = 0; k < steps; ++k) {
    const int g = blockIdx.x + k * gridDim.x;
    const int ntiles = group_tiles(g), cluster_tiles = group_tiles(first + k * gridDim.x);
    if (ntiles > 0) {
      const int r0 = g * R;
      const int nrays = min(R, p.B - r0);
      const int P = nrays * S;
      const size_t s0 = (size_t)r0 * S;  // first sample of the group
      // The group's rays and their direction features, quantized once per
      // ray (inv_d is zero beyond dir_dim); the last group's compositing
      // reads neither.
      for (int i = tid; i < R * 3; i += kWgConsumers) {
        const int r = i / 3, c = i - r * 3;
        const bool ok = r < nrays;
        ray[r * 8 + c] = ok ? p.origins[(size_t)(r0 + r) * 3 + c] : 0.f;
        ray[r * 8 + 4 + c] = ok ? p.dirs[(size_t)(r0 + r) * 3 + c] : 0.f;
      }
      for (int i = tid; i < R * m.dir_pad; i += kWgConsumers) {
        const int r = i / m.dir_pad, c = i - r * m.dir_pad;
        float d3[3] = {0.f, 0.f, 0.f};
        if (r < nrays)
#pragma unroll
          for (int j = 0; j < 3; ++j) d3[j] = p.dirs[(size_t)(r0 + r) * 3 + j];
        dq[i] = static_cast<int8_t>(requant<false>(encode_feature(d3, c, m.dir_dim), inv_d[c]));
      }
      consumer_sync(kWgConsumers);  // the last group's compositing is done too
      for (int tile = 0; tile < ntiles; ++tile) {
        const int q0 = tile * kRows + wrow;  // group sample of the warp's row 0
        const int valid = min(16, P - q0);   // may be <= 0 on the last tile
        encode_rows_split(m, ray, p.t_vals + s0, S, q0, valid, inv_x, wact, wxq);
        split_sync<H>();
        auto dir4 = [&](int row, int c) -> uint32_t {
          return reinterpret_cast<const uint32_t*>(dq)[((q0 + row) / S) * dw + c];
        };
        qmlp_forward_wg<H>(m, f, wact, wxq, dir4, sig + q0, rgbl + q0 * 3, valid, ring, rp,
                           fst, wpark);
      }
    }
    for (int tile = ntiles; tile < cluster_tiles; ++tile)
      drain_q_tile(m, ring, rp, q_ks(H), fst);
    if (ntiles > 0) {
      consumer_sync(kWgConsumers);
      const size_t s0 = (size_t)g * R * S;
      composite_rays(p.t_vals + s0, sig, rgbl, min(R, p.B - g * R), S, p.w_out + s0,
                     p.rgb_out + (size_t)g * R * 3);
    }
  }
  block_exit<H>();
}

// The hidden widths K4 is instantiated for.
inline bool q_hidden_ok(int h) {
  return h == 32 || h == 64 || h == 128 || h == 256 || h == 512 || h == 1024;
}

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
// to 32 with zeros) at the end of the f32 pack.  hidden is 32, 64, 128,
// 256, 512 or 1024.  A block per group of rays (wg_rays_per_block); above
// 256 clusters of two blocks, at most one block an SM, each striding over
// the groups (cudaErrorInvalidClusterSize when not one cluster fits).  Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise and allocates nothing.
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
  const int rows = wg_rows(hidden);
  p.R = wg_rays_per_block(S, rows);
  // The widest layer's (or column pass's) k-slice: the merged head's (its
  // last pass at 1024: 520 columns).
  p.stage_bytes = pass_width(hidden + 8, n_passes(hidden + 8) - 1) * q_ks(hidden);
  const bool parked = hidden > kPassCols;  // the f32 rows in global memory, a park
  const size_t rest = kQBarBytes + (parked ? (size_t)rows * kPassCols : (size_t)p.m.f_bytes) +
                      (size_t)rows * p.m.ldx + (size_t)rows * p.m.xyz_pad +
                      (size_t)round_up(p.R * p.m.dir_pad, 16) +
                      sizeof(float) * ((size_t)p.R * 8 + (size_t)p.R * S * 4) +
                      (parked ? 16 + sizeof(float) * 2 * 3 * kFStageCols : 0);
  if (rest + 2 * (size_t)p.stage_bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const size_t fit = ((size_t)kMaxSmem - rest) / p.stage_bytes;
  p.stages = fit < (size_t)kMaxStages ? (int)fit : kMaxStages;
  const size_t smem = rest + (size_t)p.stages * p.stage_bytes;
  void (*kernel)(const Params) = hidden == 32    ? quant_render_fwd_kernel<32>
                                 : hidden == 64  ? quant_render_fwd_kernel<64>
                                 : hidden == 128 ? quant_render_fwd_kernel<128>
                                 : hidden == 256 ? quant_render_fwd_kernel<256>
                                 : hidden == 512 ? quant_render_wide_kernel<512>
                                                 : quant_render_wide_kernel<1024>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // A block per group of R rays; above 256 clusters of two blocks, no more
  // blocks than SMs nor than the clusters the card holds at once (none:
  // cudaErrorInvalidClusterSize).
  const int groups = (B + p.R - 1) / p.R;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hidden > kSplitAbove) {
    int sms = 0, max_clusters = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = cluster_config(cfg, attr, kernel, sms, smem, st, &max_clusters);
    if (err != cudaSuccess) return (int)err;
    const int grid = split_grid(sms, groups, max_clusters);
    if (grid < kCluster) return (int)cudaErrorInvalidClusterSize;
    err = launch_clusters(kernel, grid, smem, st, p);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }
  kernel<<<groups, kWgThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}
