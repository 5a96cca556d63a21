// The NeRF MLP on Hopper's warpgroup products, shared by the ray
// megakernel's forward (K1, and K6's forward over encodings:
// fused_render_fwd.cu), the MLP over encodings (K5's forward:
// fused_mlp_fwd.cu) and the rows kernel of the backwards (K2, K3, K5, K6:
// fused_render_bwd.cu).  K4 (quant_render_fwd.cu) runs the same block,
// ring and producer with int8 operands and an epilogue of its own.
//
// A block is two consumer warpgroups and one producer warpgroup (384
// threads; one thread of it issues the copies, and setmaxnreg moves its
// registers to the consumers, 232 a thread: ptxas compiles a 384-thread
// block at 168 registers a thread, and only code after setmaxnreg.inc may
// use more) over a sample tile, in one of two layouts (WgTile):
//   * hidden <= 256: a 128-row tile.  Warpgroup w owns rows 64w..64w+63,
//     and warp v of the block (v = 0..7) owns rows 16v..16v+15 of every
//     activation tile and every column of a layer: it loads their A
//     fragments, and wgmma returns their accumulators to it.  So a warp
//     reads and writes only its own rows, and a layer's output overwrites
//     its input in place: one activation tile, no ping-pong, no block
//     barrier between layers.
//   * hidden 512: a 64-row tile whose two warpgroups split each layer's
//     output columns (warpgroup 0 the first Split<N>::lo of an N-wide
//     layer, warpgroup 1 the rest: 256 + 256 for the trunk, 256 + 264 for
//     the merged head, 128 + 128 for the branch; the 8-wide rgb head is
//     warpgroup 0's alone, though both compute its product: SplitProduct).  Warp v and warp v + 4 (its peer) own rows
//     16(v % 4)..+15: both load the rows' A fragments over the whole k, each
//     keeps its m64n256 (or n264) accumulator in registers (132 f32 a
//     thread at most, as the 8x256 head's), and a named barrier of the two
//     warps (rows_sync) follows the layer's last wgmma wait before either
//     writes its columns back in place, and another follows the writes.
//     Still one activation tile and no block barrier between layers: at
//     8x512 the 128-row tile (149.5 KB) and two 64-deep stages of the
//     520-wide head (133 KB) pass the 227 KB a block has, and one
//     warpgroup's m64n512 accumulator would be 256 f32 a thread.  Stages
//     are 32 k deep there (kKsNarrow): 33,280 B at the head's 520 columns.
//     A 64-row tile does half the 128-row tile's work with each staged
//     weight byte, so the split tile's kernels run in clusters of two
//     blocks (kCluster, "Clusters" below) whose producers each bring half
//     of every stage into both blocks (TMA multicast): an SM reads half the
//     weight bytes from L2.  In the forward kernels a layer's stages are
//     not waited on one by one: each stage's wgmma group stays in flight
//     while the next stage's A fragments load and its group issues
//     (wg_product_pipe, kPipeForward).  The rows kernel holds its bias sums
//     in global memory instead, for a third stage, and waits stage by
//     stage (kPipeRows): a group in flight would hold a second of its three
//     stages.
//   * hidden 1024: the same split tile, every layer wider than 520 columns
//     in column passes of 512 (kPassCols, layer_passes): 2 stages of the
//     widest pass fit beside the 64 x 1,096 tile (140 KB), and a pass's
//     part of each warpgroup is a hidden-512 product (132 f32 a thread at
//     most); the first pass's outputs wait in global memory (the park)
//     until the second pass has read the tile.  Each stage's products are
//     a sum of their own, added into the layer's f32 sums
//     (wg_product_staged): wgmma's sums round toward zero, and over a
//     1,024-deep layer in one sum that bias misses the kernels' gates.
// Weights: the producer thread streams every layer's weights, in the order
// the consumers use them, through a ring of shared-memory stages with bulk
// copies (cp.async.bulk, the TMA unit) and a full/empty mbarrier pair per
// stage.  A stage holds one k-slice of one layer: all of its n_pad output
// columns and kKs (for a layer's last slice, a multiple of 16 up to kKs)
// k.  Both consumer warpgroups read each stage, so a weight byte brought
// from L2 feeds the whole tile.  The slice is stored in the K-major
// core-matrix layout wgmma's descriptor names (ops/kernels/fused_render.py:
// pack_weights_wg): element (n, k) of the slice at ((k / 8) * n_pad + n)
// * 8 + k % 8, so a k16 step starts 2 * n_pad * 16 bytes after the one
// before, core matrices along K lie n_pad * 16 bytes apart (LBO) and
// along N 128 bytes apart (SBO); columns [n0, n0 + N) of a stage are one
// more product at n0 * 16 bytes.  The whole pack is that layout over all
// k (element (n, k) of a layer at ((k / 8) * n_pad + n) * 8 + k % 8), so a
// stage of any depth that is a multiple of 16 is one contiguous run of it:
// the 32-deep stages of hidden 512 read the same pack as the 64-deep ones.
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

#include <type_traits>

namespace nkt {

constexpr int kWgConsumers = 256;              // two warpgroups
constexpr int kWgThreads = kWgConsumers + 128;  // and the producer warpgroup
constexpr int kConsumerWarps = kWgConsumers / 32;
constexpr int kProducerRegs = 40;   // setmaxnreg: the producer's warpgroup gives
constexpr int kConsumerRegs = 232;  // registers to the consumers' (2 x 232 + 40 <= 512)
constexpr int kKs = 64;        // k per weight stage
constexpr int kKsNarrow = 32;  // k per stage of the wide input-gradient packs and of hidden 512
constexpr int kMaxStages = 8;  // ring stages at most
constexpr int kBarBytes = 2 * kMaxStages * 8;
constexpr int kSplitAbove = 256;  // wider hidden layers split their columns over the warpgroups
// Whether the split tile keeps wgmma groups in flight across stages
// (wg_product_pipe; at hidden 1024 two parts of the staged sums,
// wg_product_staged): in the forward kernels (K1, K5's and K6's forward:
// 4 stages at 512), not in the rows kernel (3 stages: a group in flight
// holds a second stage and leaves the producer one stage ahead; at 1024
// two parts spill; PERF.md).
constexpr bool kPipeForward = true, kPipeRows = false;

// The hidden widths the wgmma kernels are instantiated for.
inline bool wg_hidden_ok(int h) {
  return h == 64 || h == 128 || h == 256 || h == 512 || h == 1024;
}

// Column passes (hidden 1024).  A layer wider than kPassCols + 8 columns
// is computed in passes of kPassCols output columns (the last takes the
// rest: the merged head's 1,032 are 512 + 520), each pass one split-tile
// product of the width of a hidden-512 layer: its stages hold only the
// pass's columns, whose own block of the pack (pass p's columns of a layer
// at w_off + k_pad * 512 p, in the K-major layout of a pass-wide matrix:
// ops/kernels/fused_render.py, _pack_wg) the producer streams over every k
// before the next pass's.  A layer's output overwrites its input in place,
// and every pass reads the whole input, so the outputs of every pass but
// the last wait in the park (64 rows x kPassCols bf16 a block, in global
// memory: no room is left in shared memory beside a 64 x 1,096 tile) until
// the last pass's products are done; each thread reads back only what it
// wrote (park_back).
constexpr int kPassCols = 512;
__host__ __device__ constexpr int n_passes(int n_pad) {
  return n_pad <= kPassCols + 8 ? 1 : n_pad / kPassCols;
}
__host__ __device__ constexpr int pass_width(int n_pad, int p) {
  return p + 1 < n_passes(n_pad) ? kPassCols : n_pad - p * kPassCols;
}
// Pass p of a layer as a layer of its own: its columns, weights and bias.
__host__ __device__ inline Dense pass_dense(const Dense& d, int p) {
  const int c0 = p * kPassCols, w = pass_width(d.n_pad, p);
  return Dense{d.k_pad, d.n - c0 < w ? d.n - c0 : w, w, d.w_off + d.k_pad * c0, d.b_off + c0};
}

// Sample rows per tile, and k per weight stage, of a hidden width.
__host__ __device__ constexpr int wg_rows(int hidden) { return hidden > kSplitAbove ? 64 : 128; }
__host__ __device__ constexpr int wg_ks(int hidden) {
  return hidden > kSplitAbove ? kKsNarrow : kKs;
}

// The columns warpgroup 0 computes of an N-wide layer on a split tile (a
// multiple of 32, or all of an 8-wide layer); warpgroup 1 the other hi.
template <int N>
struct Split {
  static constexpr int lo = N <= 8 ? N : N / 64 * 32;
  static constexpr int hi = N - lo;
};

// The tile of the hidden width H (see the note at the top).
template <int H>
struct WgTile {
  static constexpr bool kSplit = H > kSplitAbove;
  static constexpr bool kParked = H > kPassCols;  // column passes and a park (hidden 1024)
  static constexpr int kRows = wg_rows(H);
  static constexpr int kRowWarps = kRows / 16;      // warps with rows of their own: 8 or 4
  static constexpr int kLanes = kSplit ? 64 : 32;   // threads that share a warp's rows
  static constexpr int kKsTile = wg_ks(H);  // k per weight stage
  // f32 accumulators a thread holds: the widest layer's, or its widest part
  // of a pass.
  static constexpr int kAcc = kSplit ? Split<(kParked ? kPassCols : H) + 8>::hi / 2 : (H + 8) / 2;
};

// Device: the rows a warp owns (rows 16 * row_warp ..), the columns part it
// computes (0 unless split), and the lane among the kLanes threads of its rows.
template <int H>
__device__ __forceinline__ int row_warp() {
  return WgTile<H>::kSplit ? (threadIdx.x >> 5) & 3 : threadIdx.x >> 5;
}
template <int H>
__device__ __forceinline__ int col_part() {
  return WgTile<H>::kSplit ? threadIdx.x >> 7 : 0;
}
template <int H>
__device__ __forceinline__ int peer_lane() {
  return (threadIdx.x & 31) + 32 * col_part<H>();
}

// Barrier of the threads that share the warp's rows: the warp itself, or
// the warp and its peer in the other warpgroup (named barriers 2..5; 0 is
// __syncthreads', 1 the consumers').
template <int H>
__device__ __forceinline__ void rows_sync() {
  if constexpr (WgTile<H>::kSplit)
    asm volatile("bar.sync %0, 64;\n" ::"r"(2 + row_warp<H>()) : "memory");
  else
    __syncwarp();
}

// On a split tile, rows_sync; else nothing (a warp's own reads of its rows
// are done when its products are).
template <int H>
__device__ __forceinline__ void split_sync() {
  if constexpr (WgTile<H>::kSplit) rows_sync<H>();
}

// Rays per block of K1/K6's (and K4's) forward: whole rays, as many as
// make R*S fill whole tiles of `rows` rows, at most 640 samples a block
// (the per-sample predictions stay in shared memory until the rays are
// composited).
inline int wg_rays_per_block(int S, int rows) {
  if (S >= 640) return 1;
  int a = S, b = rows;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  const int r = rows / a, cap = 640 / S;
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

// Bytes of one weight stage: the widest layer's (or pass's) k-slice of `ks` k.
inline int wg_stage_bytes(const Dense* d, int n, int ks = kKs) {
  int w = 0;
  for (int i = 0; i < n; ++i)
    for (int p = 0; p < n_passes(d[i].n_pad); ++p)
      w = pass_width(d[i].n_pad, p) > w ? pass_width(d[i].n_pad, p) : w;
  return w * ks * 2;
}

// The bytes of global scratch a block of H's tile needs (the park;
// for the rows kernel with `masks`, its ReLU bits of L + 1 layers and the
// column-sum scratch too, which pass shared memory at hidden 1024).
__host__ __device__ inline size_t wg_glob_bytes(int hidden, int num_layers, bool rows) {
  if (hidden <= kPassCols) return 0;
  const size_t park = (size_t)64 * kPassCols * 2;
  return rows ? park + (size_t)4 * (num_layers + 1) * 64 * (hidden / 32) + (size_t)4 * 2 * 4 * hidden
              : park;
}

struct WRing {
  uint64_t* full;   // [stages] count 1 + transaction bytes
  uint64_t* empty;  // [stages] count kConsumerWarps (2 x on a cluster's ring)
  unsigned char* buf;
  int stages;
  int stage_bytes;
  int peer = -1;  // the other block's rank on a cluster's ring (split tile), else -1
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
    mbar_init(&r.empty[i], r.peer < 0 ? kConsumerWarps : 2 * kConsumerWarps);
  }
  fence_mbar_init();
}

// A consumer warp releases stage `st`: to its own producer and, on a
// cluster's ring, to the peer's (whose copies write into this block's
// stage too).  Every lane calls it.
__device__ __forceinline__ void ring_release(const WRing& r, int st) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    mbar_arrive(&r.empty[st]);
    if (r.peer >= 0) mbar_arrive_cluster(&r.empty[st], static_cast<uint32_t>(r.peer));
  }
}

// Producer: every k-slice of one layer of the pack `w` (pass by pass), in
// order; `ks`: the pack's k per slice (kKs, or kKsNarrow for the
// input-gradient packs whose stages would not fit two in shared memory at
// kKs).
__device__ __forceinline__ void produce_pass(const WRing& r, RingPos& p,
                                             const __nv_bfloat16* w, const Dense& L, int ks) {
  for (int k0 = 0; k0 < L.k_pad; k0 += ks) {
    const int kw = min(ks, L.k_pad - k0);
    const uint32_t bytes = static_cast<uint32_t>(L.n_pad * kw * 2);
    unsigned char* dst = r.buf + static_cast<size_t>(p.st) * r.stage_bytes;
    const __nv_bfloat16* src = w + L.w_off + static_cast<size_t>(k0) * L.n_pad;
    mbar_wait(&r.empty[p.st], p.ph ^ 1u);  // on a cluster: both blocks' consumers released it
    mbar_expect_tx(&r.full[p.st], bytes);  // the whole stage lands here, half from the peer
    if (r.peer < 0) {
      bulk_g2s(dst, src, bytes, &r.full[p.st]);
    } else {  // rank 0 brings the first half into both blocks, rank 1 the second
      const uint32_t half = bytes / 2, off = r.peer ? 0u : half;  // bytes: a multiple of 256
      bulk_g2s_multicast(dst + off, reinterpret_cast<const unsigned char*>(src) + off, half,
                         &r.full[p.st], 0x3);
    }
    p.next(r.stages);
  }
}

__device__ __forceinline__ void produce_layer(const WRing& r, RingPos& p,
                                              const __nv_bfloat16* w, const Dense& L,
                                              int ks = kKs) {
  for (int q = 0; q < n_passes(L.n_pad); ++q) produce_pass(r, p, w, pass_dense(L, q), ks);
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

// acc[0, N/2) = act[64 rows of the warpgroup, 0:k_pad) @ columns [n0, n0
// + N) of the layer's stages and, with NX > 0, accx[0, NX/2) += the same
// rows @ columns [n0 + N, n0 + N + NX) (the caller zeroes accx where a sum
// starts); `np`: the stages' width (the layer's n_pad); KS: k per stage.
// Consumes ceil(k_pad / KS) stages of the ring.
template <int N, int NX = 0, int KS = kKs>
__device__ __forceinline__ void wg_product(float* acc, const __nv_bfloat16* act, int ldx,
                                           int k_pad, const WRing& r, RingPos& c,
                                           float* accx = nullptr, int np = N + NX, int n0 = 0) {
  static_assert(N % 8 == 0 && NX % 8 == 0 && N <= 264 && NX <= 128, "wgmma widths");
  static_assert(KS % 16 == 0 && KS <= kKs, "k per stage");
  constexpr int kSteps = KS / 16;
  if constexpr (N > 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  }
  for (int k0 = 0; k0 < k_pad; k0 += KS) {
    const int steps = min(KS, k_pad - k0) >> 4;  // block-uniform
    uint32_t a[kSteps][4];
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps) load_a(a[q], act, ldx, k0 + 16 * q);
    mbar_wait(&r.full[c.st], c.ph);
    const uint32_t sb = smem_u32(r.buf + static_cast<size_t>(c.st) * r.stage_bytes) + n0 * 16;
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
    ring_release(r, c.st);
    c.next(r.stages);
  }
}

// Keeps the compiler from reusing A-fragment registers that an
// asynchronous product may still read.
template <int NR>
__device__ __forceinline__ void reg_fence(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The A fragments of the stage of k [k0, k0 + KS) (fewer k16 steps where
// k_pad ends first).
template <int KS>
__device__ __forceinline__ void load_stage_a(uint32_t (&a)[KS / 16][4], const __nv_bfloat16* act,
                                             int ldx, int k_pad, int k0) {
  const int steps = min(KS, k_pad - k0) >> 4;  // block-uniform
#pragma unroll
  for (int q = 0; q < KS / 16; ++q)
    if (q < steps) load_a(a[q], act, ldx, k0 + 16 * q);
}

// One stage of wg_product_pipe: wait for it, issue its k16 steps from
// `cur` as one wgmma group, then wait until only this group is in flight
// (the previous stage's, which read `nxt`, is done), release the previous
// stage and load the next stage's A into `nxt`.  `held`: the ring slot of
// the group in flight (-1: none).
template <int N, int KS>
__device__ __forceinline__ void pipe_stage(float* acc, uint32_t (&cur)[KS / 16][4],
                                           uint32_t (&nxt)[KS / 16][4], const __nv_bfloat16* act,
                                           int ldx, int k_pad, int k0, const WRing& r,
                                           RingPos& c, int& held, int np, int n0) {
  const int steps = min(KS, k_pad - k0) >> 4;
  mbar_wait(&r.full[c.st], c.ph);
  const uint32_t sb = smem_u32(r.buf + static_cast<size_t>(c.st) * r.stage_bytes) + n0 * 16;
  acc_fence<N / 2>(acc);
  wg_fence();
#pragma unroll
  for (int q = 0; q < KS / 16; ++q)
    if (q < steps) mma_rs<N>(acc, cur[q], smem_desc(sb + q * 2 * np * 16, np * 16, 128), 128, 1);
  wg_commit();
  if (held >= 0) {
    wg_wait<1>();
    reg_fence<KS / 4>(&nxt[0][0]);
    ring_release(r, held);
  }
  held = c.st;
  c.next(r.stages);
  if (k0 + KS < k_pad) load_stage_a<KS>(nxt, act, ldx, k_pad, k0 + KS);
}

// wg_product's sums for the split tile (N columns from column n0 of
// stages np wide; no accx), with wgmma groups kept in flight across
// stages as CUTLASS's main loop keeps them: stage s + 1's A fragments load
// and its group issues before stage s's group is waited on (wg_wait<1>)
// and its stage released, so the tensor cores never drain between stages
// of a layer; two register buffers of A fragments.  The k16 steps
// accumulate in the same order as wg_product's, so the sums are its bits.
template <int N, int KS>
__device__ __forceinline__ void wg_product_pipe(float* acc, const __nv_bfloat16* act, int ldx,
                                                int k_pad, const WRing& r, RingPos& c, int np,
                                                int n0) {
  static_assert(N % 8 == 0 && N <= 264, "wgmma widths");
  static_assert(KS % 16 == 0 && KS <= kKs, "k per stage");
  constexpr int kSteps = KS / 16;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  uint32_t a0[kSteps][4], a1[kSteps][4];
  int held = -1;
  load_stage_a<KS>(a0, act, ldx, k_pad, 0);
  for (int k0 = 0; k0 < k_pad; k0 += 2 * KS) {
    pipe_stage<N, KS>(acc, a0, a1, act, ldx, k_pad, k0, r, c, held, np, n0);
    if (k0 + KS < k_pad)
      pipe_stage<N, KS>(acc, a1, a0, act, ldx, k_pad, k0 + KS, r, c, held, np, n0);
  }
  wg_wait<0>();
  acc_fence<N / 2>(acc);
  reg_fence<KS / 4>(&a0[0][0]);
  reg_fence<KS / 4>(&a1[0][0]);
  ring_release(r, held);
}

// The sums of hidden 1024's column passes: every stage's k16 steps go to
// a fresh wgmma sum (scale-d 0 at the stage's first step), which one f32
// add per element then takes into acc (rounded to nearest), a part of the
// columns at a time.  wgmma's f32 sum of bf16 products rounds toward zero
// at each k16 step (exp_wide_numerics' "sums", PERF.md): over the whole
// 1,024- to 1,088-deep layer in one wgmma sum those roundings add up, one
// way, past K1's and K2's gates against their plain versions; over the
// two k16 steps of a 32-deep stage they stay within the f32 rounding of
// the adds.  (At hidden 512 a layer's whole depth in one sum passes them,
// and the staged sums cost K1 +53% and K2 +29% there: PERF.md.)  Two
// schedules of the same sums
// (the same bits): with kPipe (the forward kernels) parts of 64 columns,
// two in flight, so a part's adds run while the next part's products do;
// without (the rows kernel, whose other live values leave less room)
// parts of at most 88 columns, each waited on before its adds.  A stage's
// last part is waited on before its ring slot is released.
template <int N, bool kPipe>
struct StageParts {
  static constexpr int kMax = kPipe ? 64 : 88;  // 32 f32 a thread twice, or 44 once
  static constexpr int count = (N + kMax - 1) / kMax;
  static constexpr int step = kPipe ? kMax : ((N + count - 1) / count + 7) / 8 * 8;
  template <int C>
  static constexpr int width = C + 1 < count ? step : N - step * C;
};

// Issue part C's products (its fresh sum into buf) as one wgmma group.
template <int N, bool kPipe, int KS, int C>
__device__ __forceinline__ void part_issue(float* buf, uint32_t (&a)[KS / 16][4], int steps,
                                           uint32_t sb, int np) {
  using P = StageParts<N, kPipe>;
  constexpr int kW = P::template width<C>;
  acc_fence<kW / 2>(buf);
  wg_fence();
#pragma unroll
  for (int q = 0; q < KS / 16; ++q)
    if (q < steps)
      mma_rs<kW>(buf, a[q], smem_desc(sb + C * P::step * 16 + q * 2 * np * 16, np * 16, 128),
                 128, q);
  wg_commit();
}

// Part C's sums (done) into acc.
template <int N, bool kPipe, int C>
__device__ __forceinline__ void part_add(float* acc, float* buf) {
  using P = StageParts<N, kPipe>;
  constexpr int kW = P::template width<C>;
  acc_fence<kW / 2>(buf);
#pragma unroll
  for (int i = 0; i < kW / 2; ++i) acc[C * P::step / 2 + i] += buf[i];
}

// Parts C.. of a stage: with kPipe part C issued into its buffer (parts
// alternate between p0 and p1) while part C - 1's is in flight, and once
// only C's is, C - 1's adds; without, part C issued, waited on and added.
template <int N, bool kPipe, int KS, int C>
__device__ __forceinline__ void stage_parts(float* acc, float* p0, float* p1,
                                            uint32_t (&a)[KS / 16][4], int steps, uint32_t sb,
                                            int np) {
  if constexpr (kPipe) {
    part_issue<N, kPipe, KS, C>(C & 1 ? p1 : p0, a, steps, sb, np);
    wg_wait<1>();
    part_add<N, kPipe, C - 1>(acc, C & 1 ? p0 : p1);
  } else {
    part_issue<N, kPipe, KS, C>(p0, a, steps, sb, np);
    wg_wait<0>();
    part_add<N, kPipe, C>(acc, p0);
  }
  if constexpr (C + 1 < StageParts<N, kPipe>::count)
    stage_parts<N, kPipe, KS, C + 1>(acc, p0, p1, a, steps, sb, np);
}

template <int N, int KS, bool kPipe>
__device__ __forceinline__ void wg_product_staged(float* acc, const __nv_bfloat16* act, int ldx,
                                                  int k_pad, const WRing& r, RingPos& c, int np,
                                                  int n0) {
  static_assert(N % 8 == 0 && N <= 264, "wgmma widths");
  static_assert(KS % 16 == 0 && KS <= kKs, "k per stage");
  using P = StageParts<N, kPipe>;
  constexpr int kSteps = KS / 16, kLast = P::count - 1;
  float p0[P::step / 2], p1[kPipe ? P::step / 2 : 1];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < k_pad; k0 += KS) {
    const int steps = min(KS, k_pad - k0) >> 4;  // block-uniform
    uint32_t a[kSteps][4];
#pragma unroll
    for (int q = 0; q < kSteps; ++q)
      if (q < steps) load_a(a[q], act, ldx, k0 + 16 * q);
    mbar_wait(&r.full[c.st], c.ph);
    const uint32_t sb = smem_u32(r.buf + static_cast<size_t>(c.st) * r.stage_bytes) + n0 * 16;
    if constexpr (kPipe) {
      part_issue<N, kPipe, KS, 0>(p0, a, steps, sb, np);
      if constexpr (kLast > 0) stage_parts<N, kPipe, KS, 1>(acc, p0, p1, a, steps, sb, np);
      wg_wait<0>();
      part_add<N, kPipe, kLast>(acc, kLast & 1 ? p1 : p0);
    } else {
      stage_parts<N, kPipe, KS, 0>(acc, p0, p1, a, steps, sb, np);
    }
    ring_release(r, c.st);
    c.next(r.stages);
  }
}

// A phantom tile's share of the ring (a cluster's block with fewer tiles
// than its peer): every stage of the layer waited for and released, so
// both blocks' producers go on filling both blocks.
__device__ __forceinline__ void drain_layer(const WRing& r, RingPos& c, const Dense& L, int ks) {
  for (int q = 0; q < n_passes(L.n_pad); ++q)
    for (int k0 = 0; k0 < L.k_pad; k0 += ks) {
      mbar_wait(&r.full[c.st], c.ph);
      ring_release(r, c.st);
      c.next(r.stages);
    }
}

// The columns each warpgroup's product takes on a split tile: the wider
// part's width, warpgroup 0 from column 0 and warpgroup 1 ending at N.
// Both run one instantiation (no divergent path around wgmma, which ptxas
// would serialize); where the parts differ, warpgroup 0 computes a few
// columns more than its part (8 of the merged head's), and both compute
// the 8-wide rgb head, whose epilogue is warpgroup 0's.
template <int N>
struct SplitProduct {
  static constexpr int width = Split<N>::lo > Split<N>::hi ? Split<N>::lo : Split<N>::hi;
  static constexpr int n0_hi = N - width;  // warpgroup 1's first column
};

// The warp's share of an N-wide layer's product on H's tile: all N columns,
// or its warpgroup's SplitProduct of a split tile (at hidden 1024 the
// staged sums, wg_product_staged, kPipe their schedule; else with kPipe
// its groups in flight across stages, wg_product_pipe), after which
// split_sync: the
// peers' reads of the activation tile are done and either may write its
// part (Split<N>) back in place.  `np`: the stages' width.
template <int H, int N, int KS, bool kPipe>
__device__ __forceinline__ void layer_product(float* acc, const __nv_bfloat16* act, int ldx,
                                              int k_pad, const WRing& r, RingPos& c,
                                              int np = N) {
  if constexpr (!WgTile<H>::kSplit) {
    wg_product<N, 0, KS>(acc, act, ldx, k_pad, r, c, nullptr, np);
  } else {
    using P = SplitProduct<N>;
    const int n0 = col_part<H>() ? P::n0_hi : 0;
    if constexpr (WgTile<H>::kParked)
      wg_product_staged<P::width, KS, kPipe>(acc, act, ldx, k_pad, r, c, np, n0);
    else if constexpr (kPipe)
      wg_product_pipe<P::width, KS>(acc, act, ldx, k_pad, r, c, np, n0);
    else
      wg_product<P::width, 0, KS>(acc, act, ldx, k_pad, r, c, nullptr, np, n0);
    split_sync<H>();
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
// when sig is given.  Without kSigma, N feature columns (warpgroup 0's part
// of a split head).
template <int N, bool kSigma = true>
__device__ __forceinline__ void epi_feature_sigma(const float* acc, const float* bias,
                                                  __nv_bfloat16* act, int ldx, float* sig,
                                                  int valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8 - (kSigma ? 1 : 0); ++j) {
    const int c = 8 * j + 2 * t;
    const float b0 = bias[c], b1 = bias[c + 1];
    *reinterpret_cast<__nv_bfloat162*>(act + g * ldx + c) =
        __floats2bfloat162_rn(acc[4 * j] + b0, acc[4 * j + 1] + b1);
    *reinterpret_cast<__nv_bfloat162*>(act + (g + 8) * ldx + c) =
        __floats2bfloat162_rn(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
  constexpr int js = N / 8 - 1;
  if (kSigma && sig != nullptr && t == 0) {
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

// The epilogues over the warp's columns of an N-wide layer on H's tile:
// all N, or its warpgroup's part (Split<N>, each part starting at a
// multiple of 32 columns, so its mask words are whole).
template <int H, int N, bool kMask>
__device__ __forceinline__ void layer_relu(const float* acc, const float* bias,
                                           __nv_bfloat16* act, int ldx, uint32_t* mask, int mw) {
  if constexpr (!WgTile<H>::kSplit) {
    epi_relu<N, kMask>(acc, bias, act, ldx, mask, mw);
  } else {
    using S = Split<N>;
    static_assert(S::lo % 32 == 0 && S::hi % 32 == 0, "whole mask words per part");
    static_assert(SplitProduct<N>::n0_hi == S::lo, "warpgroup 1's product starts its part");
    if (col_part<H>() == 0)
      epi_relu<S::lo, kMask>(acc, bias, act, ldx, mask, mw);
    else
      epi_relu<S::hi, kMask>(acc, bias + S::lo, act + S::lo, ldx,
                             kMask ? mask + S::lo / 32 : nullptr, mw);
  }
}

// The merged head's N columns (all of it, or one column pass of it; with
// kSigma the part that ends with sigma).
template <int H, int N = H + 8, bool kSigma = true>
__device__ __forceinline__ void layer_head(const float* acc, const float* bias,
                                           __nv_bfloat16* act, int ldx, float* sig, int valid) {
  if constexpr (!WgTile<H>::kSplit) {
    epi_feature_sigma<N>(acc, bias, act, ldx, sig, valid);
  } else {
    using S = Split<N>;
    static_assert(SplitProduct<N>::n0_hi == S::lo, "warpgroup 1's product starts its part");
    if (col_part<H>() == 0)
      epi_feature_sigma<S::lo, false>(acc, bias, act, ldx, nullptr, 0);
    else
      epi_feature_sigma<S::hi, kSigma>(acc, bias + S::lo, act + S::lo, ldx, sig, valid);
  }
}

template <int H>
__device__ __forceinline__ void layer_rgb(const float* acc, const float* bias, float* rgbl,
                                          int valid) {
  if (col_part<H>() == 0) epi_rgb(acc, bias, rgbl, valid);
}

template <int H, int N, bool kMask>
__device__ __forceinline__ void layer_bwd(const float* acc, __nv_bfloat16* act, int ldx,
                                          const uint32_t* mask, int mw, float* srow) {
  if constexpr (!WgTile<H>::kSplit) {
    epi_bwd<N, kMask>(acc, act, ldx, mask, mw, srow);
  } else {
    using S = Split<N>;
    static_assert(SplitProduct<N>::n0_hi == S::lo, "warpgroup 1's product starts its part");
    if (col_part<H>() == 0)
      epi_bwd<S::lo, kMask>(acc, act, ldx, mask, mw, srow);
    else
      epi_bwd<S::hi, kMask>(acc, act + S::lo, ldx, kMask ? mask + S::lo / 32 : nullptr, mw,
                            srow + S::lo);
  }
}

// The warp's columns of a parked N-wide pass (Split<N>: the positions its
// epilogue wrote, rows g and g + 8, columns 8j + 2t and + 1) from the park
// (row stride kPassCols) back into the activation tile.
template <int H, int N>
__device__ __forceinline__ void park_back(const __nv_bfloat16* park, __nv_bfloat16* act,
                                          int ldx) {
  using S = Split<N>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c0 = col_part<H>() ? S::lo : 0;
#pragma unroll
  for (int j = 0; j < S::lo / 8; ++j) {
    const int c = c0 + 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(act + g * ldx + c) =
        *reinterpret_cast<const uint32_t*>(park + g * kPassCols + c);
    *reinterpret_cast<uint32_t*>(act + (g + 8) * ldx + c) =
        *reinterpret_cast<const uint32_t*>(park + (g + 8) * kPassCols + c);
  }
}

// An N-wide layer's products and epilogues on H's tile, pass by pass (one
// pass unless N > kPassCols + 8): each pass's product into acc, then
// epi(acc, width, last, c0, dst, ld) writes the pass's columns [c0, c0 +
// width) to dst (row stride ld): the activation tile at column c0 for the
// last pass, the park (`park`: the warp's rows) for the others, which go
// back into the tile after the last pass's products (park_back).  `width`
// and `last` are std::integral_constant.
template <int H, int N, int KS, bool kPipe, class Epi>
__device__ __forceinline__ void layer_passes(float* acc, __nv_bfloat16* act, int ldx, int k_pad,
                                             const WRing& r, RingPos& c, __nv_bfloat16* park,
                                             Epi epi) {
  constexpr int NP = n_passes(N);
  if constexpr (NP == 1) {
    layer_product<H, N, KS, kPipe>(acc, act, ldx, k_pad, r, c);
    epi(acc, std::integral_constant<int, N>{}, std::true_type{}, 0, act, ldx);
  } else {
    static_assert(NP == 2 && WgTile<H>::kParked, "two passes (hidden 1024)");
    constexpr int W1 = N - kPassCols;
    layer_product<H, kPassCols, KS, kPipe>(acc, act, ldx, k_pad, r, c);
    epi(acc, std::integral_constant<int, kPassCols>{}, std::false_type{}, 0, park, kPassCols);
    layer_product<H, W1, KS, kPipe>(acc, act, ldx, k_pad, r, c);
    epi(acc, std::integral_constant<int, W1>{}, std::true_type{}, kPassCols, act + kPassCols, ldx);
    park_back<H, kPassCols>(park, act, ldx);
  }
}

// After every consumer warp has written its part of its scratch row: for c
// < n, add(c, sum of the kRowW rows in order).  Starts with a barrier of
// the consumers; the scratch is double-buffered by the caller, so the next
// layer's rows may be written before every thread has read these.
template <int kRowW, class AddFn>
__device__ __forceinline__ void colsum_add(const float* scratch, int sld, int n, AddFn add) {
  consumer_sync(kWgConsumers);
  for (int c = threadIdx.x; c < n; c += kWgConsumers) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kRowW; ++w) s += scratch[w * sld + c];
    add(c, s);
  }
}

// The warp's 16 rows of a bf16 tile (columns [0, W)) to the workspace of
// one layer in the dW product's layout: 64-row stages, in each stage
// 8-column strips of 64 rows x 16 bytes, so that element (r, c) lies at
// (r / 64) * 64 * W + (c / 8) * 512 + (r % 64) * 8 + c % 8 and a stage's
// strips are the MN-major core matrices of nerf_dw.cuh's products.  `rbase`:
// the workspace row of the warp's row 0 (a multiple of 16).  The kLanes
// threads of the rows share the copy.
template <int H>
__device__ __forceinline__ void store_ws(const __nv_bfloat16* act, int ldx, __nv_bfloat16* dst,
                                         int W, int rbase) {
  const int vecs = W >> 3;
  __nv_bfloat16* stage = dst + static_cast<size_t>(rbase >> 6) * 64 * W + (rbase & 63) * 8;
  for (int i = peer_lane<H>(); i < 16 * vecs; i += WgTile<H>::kLanes) {
    const int row = i & 15, cc = i >> 4;
    *reinterpret_cast<uint4*>(stage + cc * 512 + row * 8) =
        *reinterpret_cast<const uint4*>(act + row * ldx + cc * 8);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// The forward of the warp's 16 rows (with its peer's on a split tile).  On
// entry act (the warp's row 0) holds the position features in [0,
// xyz_pad); xenc(row, c) gives them again for the skip concats, dir(row, c)
// the direction features (bf16, zero beyond their width).  sig and rgbl
// (the warp's rows) receive sigma and the rgb logits for rows < valid.
// `park`: the warp's rows of the block's park (hidden 1024), else null.
// The producer streams dense[0..L+2] in order (produce_forward).
template <int H, class XencFn, class DirFn>
__device__ __forceinline__ void mlp_forward_wg(const MlpDims& m, const float* b,
                                               __nv_bfloat16* act, XencFn xenc, DirFn dir,
                                               float* sig, float* rgbl, int valid,
                                               const WRing& ring, RingPos& rp,
                                               __nv_bfloat16* park = nullptr) {
  using T = WgTile<H>;
  constexpr int KS = T::kKsTile;
  const int pl = peer_lane<H>();
  const int ldx = m.ldx;
  const int L = m.num_layers;
  float acc[T::kAcc];
  for (int i = 0; i < L; ++i) {
    const float* bias = b + m.dense[i].b_off;
    layer_passes<H, H, KS, kPipeForward>(acc, act, ldx, m.dense[i].k_pad, ring, rp, park,
                           [&](float* a, auto w, auto, int c0, __nv_bfloat16* dst, int ld) {
                             layer_relu<H, decltype(w)::value, false>(a, bias + c0, dst, ld,
                                                                      nullptr, 0);
                           });
    if (is_skip(i, m.skip_layer))
      for (int j = pl; j < 16 * m.xyz_pad; j += T::kLanes) {
        const int row = j / m.xyz_pad, c = j - row * m.xyz_pad;
        act[row * ldx + H + c] = xenc(row, c);
      }
    rows_sync<H>();
  }
  const float* bias = b + m.dense[L].b_off;
  layer_passes<H, H + 8, KS, kPipeForward>(acc, act, ldx, m.dense[L].k_pad, ring, rp, park,
                             [&](float* a, auto w, auto last, int c0, __nv_bfloat16* dst, int ld) {
                               layer_head<H, decltype(w)::value, decltype(last)::value>(
                                   a, bias + c0, dst, ld, sig, valid);
                             });
  for (int j = pl; j < 16 * m.dir_pad; j += T::kLanes) {
    const int row = j / m.dir_pad, c = j - row * m.dir_pad;
    act[row * ldx + H + c] = dir(row, c);
  }
  rows_sync<H>();
  layer_product<H, H / 2, KS, kPipeForward>(acc, act, ldx, m.dense[L + 1].k_pad, ring, rp);
  layer_relu<H, H / 2, false>(acc, b + m.dense[L + 1].b_off, act, ldx, nullptr, 0);
  rows_sync<H>();
  layer_product<H, 8, KS, kPipeForward>(acc, act, ldx, m.dense[L + 2].k_pad, ring, rp);
  layer_rgb<H>(acc, b + m.dense[L + 2].b_off, rgbl, valid);
  rows_sync<H>();
}

// The producer's side of mlp_forward_wg, `ks` deep (the tile's kKsTile).
__device__ __forceinline__ void produce_forward(const MlpDims& m, const __nv_bfloat16* w,
                                                const WRing& ring, RingPos& rp, int ks) {
  for (int i = 0; i < m.num_layers + 3; ++i) produce_layer(ring, rp, w, m.dense[i], ks);
}

// The consumers' side of produce_forward for a phantom tile.
__device__ __forceinline__ void drain_forward(const MlpDims& m, const WRing& ring, RingPos& rp,
                                              int ks) {
  for (int i = 0; i < m.num_layers + 3; ++i) drain_layer(ring, rp, m.dense[i], ks);
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
// the x_enc part of a layer padded to kXC, the direction part of the
// branch to kDC) the walk also runs the products K2's skips: the
// branch's direction columns, rounded once to bf16, go to dd (the warp's
// rows, row stride dir_dim); the x_enc columns of each layer whose input
// has the skip concat, from the top down, then layer 0's product, are
// summed in f32 in kXC/2 registers a thread (wgmma accumulates each
// product into them) and rounded once to bf16 into dx (row stride
// xyz_dim).  dx or dd may be null (not written).
// The workspace rows are rbase + [0, 16) of p.N rows per layer.  The
// producer streams produce_backward<kIG>'s order.
// kXC, kDC: the x_enc and d_enc gradient columns of K5's products
// (nerf_tile.cuh: ig_xcols, ig_dcols).  Beyond (64, 32) the transposed
// pack's stages are kKsNarrow deep (ig_ks), so that two of them still fit
// beside the activation tile.
__host__ __device__ constexpr int ig_ks(int kxc, int kdc) {
  return kxc == 64 && kdc == 32 ? kKs : kKsNarrow;
}

template <int H, bool kIG = false, int kXC = 64, int kDC = 32, class XFn, class DirFn>
__device__ __forceinline__ void mlp_backward_wg(const MlpBwdParams& p, __nv_bfloat16* act,
                                                uint32_t* masks, float* scratch, int sld,
                                                float* db, XFn xf, DirFn dir, const float* g,
                                                int valid, int rbase, const WRing& ring,
                                                RingPos& rp, __nv_bfloat16* dx = nullptr,
                                                __nv_bfloat16* dd = nullptr,
                                                __nv_bfloat16* park = nullptr) {
  using T = WgTile<H>;
  static_assert(!(kIG && T::kSplit), "K5's input gradients run on 128-row tiles");
  constexpr int KSF = T::kKsTile;                          // the forward pack's k per stage
  constexpr int KSB = kIG ? ig_ks(kXC, kDC) : T::kKsTile;  // the transposed pack's
  const MlpDims& m = p.m;
  const int lane = threadIdx.x & 31, pl = peer_lane<H>(), rw = row_warp<H>();
  const int ldx = m.ldx, L = m.num_layers, MW = p.mask_words;
  const size_t N = p.N;
  const int mslot = T::kRows * MW;
  const Dense& fs = m.dense[L];
  const Dense& br = m.dense[L + 1];
  const Dense& rgb = m.dense[L + 2];
  int sb = 0;
  auto srow = [&]() { return scratch + (sb * T::kRowWarps + rw) * sld; };
  auto finish = [&](float* dst, int n) {
    colsum_add<T::kRowWarps>(scratch + sb * T::kRowWarps * sld, sld, n,
                             [&](int c, float s) { dst[c] += s; });
    sb ^= 1;
  };
  auto load_x = [&](int col0) {  // the caller syncs the rows
    for (int j = pl; j < 16 * m.xyz_pad; j += T::kLanes) {
      const int row = j / m.xyz_pad, c = j - row * m.xyz_pad;
      act[row * ldx + col0 + c] =
          row < valid && c < m.xyz_dim ? xf(row, c) : __float2bfloat16_rn(0.f);
    }
  };
  float acc[T::kAcc];
  float xs[kIG ? kXC / 2 : 1];  // kIG: the encodings' gradient columns, f32
  // The dX product of dense layer i (i >= 1): the hidden columns of its
  // input, masked by layer i - 1's ReLU, into act (dPre_{i-1}) and their
  // column sums into the scratch; with kIG where that input has the skip
  // concat, its x_enc columns added into xs.
  auto dx_layer = [&](int i) {
    const uint32_t* mk = masks + (i - 1) * mslot;
    if constexpr (kIG) {
      if (is_skip(i - 1, m.skip_layer)) {
        wg_product<H, kXC, KSB>(acc, act, ldx, p.bdense[i].k_pad, ring, rp, xs,
                                p.bdense[i].n_pad);
        __syncwarp();
        layer_bwd<H, H, true>(acc, act, ldx, mk, MW, srow());
        return;
      }
    }
    layer_passes<H, H, KSB, kPipeRows>(acc, act, ldx, p.bdense[i].k_pad, ring, rp, park,
                            [&](float* a, auto w, auto, int c0, __nv_bfloat16* dst, int ld) {
                              __syncwarp();
                              layer_bwd<H, decltype(w)::value, true>(a, dst, ld, mk + c0 / 32,
                                                                     MW, srow() + c0);
                            });
  };

  // ---- Forward recompute, storing each layer's input (A).
  load_x(0);
  rows_sync<H>();
  for (int i = 0; i < L; ++i) {
    store_ws<H>(act, ldx, p.ws_a + N * p.bwd[i].a_col, m.dense[i].k_pad, rbase);
    const float* bias = p.b + m.dense[i].b_off;
    uint32_t* mk = masks + i * mslot;
    layer_passes<H, H, KSF, kPipeRows>(acc, act, ldx, m.dense[i].k_pad, ring, rp, park,
                            [&](float* a, auto w, auto, int c0, __nv_bfloat16* dst, int ld) {
                              layer_relu<H, decltype(w)::value, true>(a, bias + c0, dst, ld,
                                                                      mk + c0 / 32, MW);
                            });
    if (is_skip(i, m.skip_layer)) load_x(H);
    rows_sync<H>();
  }
  store_ws<H>(act, ldx, p.ws_a + N * p.bwd[L].a_col, fs.k_pad, rbase);
  layer_passes<H, H + 8, KSF, kPipeRows>(
      acc, act, ldx, fs.k_pad, ring, rp, park,
      [&](float* a, auto w, auto last, int c0, __nv_bfloat16* dst, int ld) {
        layer_head<H, decltype(w)::value, decltype(last)::value>(a, p.b + fs.b_off + c0, dst,
                                                                 ld, nullptr, 0);
      });
  for (int j = pl; j < 16 * m.dir_pad; j += T::kLanes) {
    const int row = j / m.dir_pad, c = j - row * m.dir_pad;
    act[row * ldx + H + c] = dir(row, c);
  }
  rows_sync<H>();
  store_ws<H>(act, ldx, p.ws_a + N * p.bwd[L + 1].a_col, br.k_pad, rbase);
  layer_product<H, H / 2, KSF, kPipeRows>(acc, act, ldx, br.k_pad, ring, rp);
  layer_relu<H, H / 2, true>(acc, p.b + br.b_off, act, ldx, masks + L * mslot, MW);
  rows_sync<H>();
  store_ws<H>(act, ldx, p.ws_a + N * p.bwd[L + 2].a_col, rgb.k_pad, rbase);
  split_sync<H>();  // the peers' copies of the branch output are done

  // ---- Backward walk.  d rgb logits, bf16, d_width columns.
  const int dw_rgb = p.bwd[L + 2].d_width;
  for (int j = pl; j < 16 * dw_rgb; j += T::kLanes) {
    const int row = j / dw_rgb, c = j - row * dw_rgb;
    act[row * ldx + c] = __float2bfloat16_rn(c < 3 && row < valid ? g[row * 4 + c] : 0.f);
  }
  if (col_part<H>() == 0) {  // f32 sums of the rgb head's and the sigma column's cotangent
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
  rows_sync<H>();
  colsum_add<T::kRowWarps>(scratch + sb * T::kRowWarps * sld, sld, 4, [&](int c, float s) {
    db[c < 3 ? rgb.b_off + c : fs.b_off + H] += s;
  });
  sb ^= 1;
  store_ws<H>(act, ldx, p.ws_d + N * p.bwd[L + 2].d_col, dw_rgb, rbase);
  // dh2 = drgb W_rgb^T, masked by h2 > 0: the branch's dPre.
  layer_product<H, H / 2, KSB, kPipeRows>(acc, act, ldx, p.bdense[L + 2].k_pad, ring, rp);
  __syncwarp();
  layer_bwd<H, H / 2, true>(acc, act, ldx, masks + L * mslot, MW, srow());
  rows_sync<H>();
  finish(db + br.b_off, H / 2);
  store_ws<H>(act, ldx, p.ws_d + N * p.bwd[L + 1].d_col, p.bwd[L + 1].d_width, rbase);
  // dfeature = dh2 W_br^T; with d sigma the merged head's dPre.  With kIG
  // the direction columns too: dd_enc.
  if constexpr (kIG) {
#pragma unroll
    for (int i = 0; i < kDC / 2; ++i) xs[i] = 0.f;
    wg_product<H, kDC, KSB>(acc, act, ldx, p.bdense[L + 1].k_pad, ring, rp, xs,
                            p.bdense[L + 1].n_pad);
    __syncwarp();
    layer_bwd<H, H, false>(acc, act, ldx, nullptr, 0, srow());
  } else {
    layer_passes<H, H, KSB, kPipeRows>(acc, act, ldx, p.bdense[L + 1].k_pad, ring, rp, park,
                            [&](float* a, auto w, auto, int c0, __nv_bfloat16* dst, int ld) {
                              __syncwarp();
                              layer_bwd<H, decltype(w)::value, false>(a, dst, ld, nullptr, 0,
                                                                      srow() + c0);
                            });
  }
  if constexpr (kIG) {
    if (dd != nullptr) {
      epi_store<kDC>(xs, act + H, ldx);
      rows_out(act + H, ldx, dd, m.dir_dim, valid);
    }
#pragma unroll
    for (int i = 0; i < kXC / 2; ++i) xs[i] = 0.f;
  }
  const int dw_fs = p.bwd[L].d_width;
  for (int j = pl; j < 16 * (dw_fs - H); j += T::kLanes) {
    const int row = j / (dw_fs - H), c = j - row * (dw_fs - H);
    act[row * ldx + H + c] = __float2bfloat16_rn(c == 0 && row < valid ? g[row * 4 + 3] : 0.f);
  }
  rows_sync<H>();
  finish(db + fs.b_off, H);
  store_ws<H>(act, ldx, p.ws_d + N * p.bwd[L].d_col, dw_fs, rbase);
  // dh_{L-1} = dfs W_fs^T (hidden columns), masked: dPre_{L-1}.
  dx_layer(L);
  rows_sync<H>();
  finish(db + m.dense[L - 1].b_off, H);
  // Trunk: act holds dPre_i; dX_i's hidden columns, masked, are dPre_{i-1}.
  for (int i = L - 1; i >= 0; --i) {
    store_ws<H>(act, ldx, p.ws_d + N * p.bwd[i].d_col, p.bwd[i].d_width, rbase);
    if (i > 0) {
      dx_layer(i);
      rows_sync<H>();
      finish(db + m.dense[i - 1].b_off, H);
    }
  }
  if constexpr (kIG) {
    // Layer 0's input is the encoding alone: its product adds into xs.
    wg_product<0, kXC, KSB>(nullptr, act, ldx, p.bdense[0].k_pad, ring, rp, xs,
                            p.bdense[0].n_pad);
    if (dx != nullptr) {
      epi_store<kXC>(xs, act, ldx);
      rows_out(act, ldx, dx, m.xyz_dim, valid);
    }
  }
  split_sync<H>();  // the peers' copies of dPre_0 are done before the next tile
}

// The producer's side of mlp_backward_wg: the recompute's layers of the
// forward pack, `ksf` deep, then the walk's of the transposed pack (with
// kIG layer 0's too), `ksb` deep (the consumers' KSF and KSB).
template <bool kIG = false>
__device__ __forceinline__ void produce_backward(const MlpBwdParams& p, const WRing& ring,
                                                 RingPos& rp, int ksf, int ksb) {
  const int L = p.m.num_layers;
  for (int i = 0; i < L + 2; ++i) produce_layer(ring, rp, p.w, p.m.dense[i], ksf);
  produce_layer(ring, rp, p.wb, p.bdense[L + 2], ksb);
  produce_layer(ring, rp, p.wb, p.bdense[L + 1], ksb);
  produce_layer(ring, rp, p.wb, p.bdense[L], ksb);
  for (int i = L - 1; i > 0; --i) produce_layer(ring, rp, p.wb, p.bdense[i], ksb);
  if (kIG) produce_layer(ring, rp, p.wb, p.bdense[0], ksb);
}

// The consumers' side of produce_backward (no input gradients) for a
// phantom tile.
__device__ __forceinline__ void drain_backward(const MlpBwdParams& p, const WRing& ring,
                                               RingPos& rp, int ksf, int ksb) {
  const int L = p.m.num_layers;
  for (int i = 0; i < L + 2; ++i) drain_layer(ring, rp, p.m.dense[i], ksf);
  for (int i = L + 2; i > 0; --i) drain_layer(ring, rp, p.bdense[i], ksb);
}

// ---------------------------------------------------------------------------
// Clusters.  On the split tile the blocks run in clusters of kCluster; each
// block keeps its own tiles and its full ring, and each producer brings
// half of every stage into both blocks' rings (produce_layer), so an SM
// reads half the weight bytes from L2.  So both blocks consume the same
// stages in the same order: a block walks as many tiles as the first block
// of its cluster, and a step past its own tiles is a phantom tile whose
// stages its consumers only wait for and release (drain_forward,
// drain_backward).  A barrier of the cluster follows ring_init (the peer's
// copies and arrivals land on these barriers) and precedes exit (no block
// leaves while its peer may still write into it or arrive on its
// barriers).
constexpr int kCluster = 2;

// The steps of this block's walk over `ntiles` tiles with a stride of the
// grid (tile = blockIdx.x + step * gridDim.x, a phantom past ntiles): on
// the split tile the first block of its cluster's count, else its own
// (tests/test_torch_wide.py models it: _cluster_walk).
template <int H>
__device__ __forceinline__ int walk_steps(int ntiles) {
  const int first = WgTile<H>::kSplit ? blockIdx.x & ~(kCluster - 1) : blockIdx.x;
  return ntiles > first ? (ntiles - first + gridDim.x - 1) / gridDim.x : 0;
}

// The ring's peer (split tile), before ring_init.
template <int H>
__device__ __forceinline__ void ring_peer(WRing& r) {
  if constexpr (WgTile<H>::kSplit) r.peer = static_cast<int>(cluster_rank() ^ 1u);
}

// After ring_init: the block's barrier, or the cluster's on the split tile.
template <int H>
__device__ __forceinline__ void block_sync() {
  if constexpr (WgTile<H>::kSplit)
    cluster_sync();
  else
    __syncthreads();
}

// Every thread of the block, before it exits: the cluster's barrier on the
// split tile, else nothing.
template <int H>
__device__ __forceinline__ void block_exit() {
  if constexpr (WgTile<H>::kSplit) {
    __syncwarp();
    cluster_sync();
  }
}

// Host: the blocks of a grid-strided split-tile kernel: at most `grid`
// rounded up to the cluster, at most the tiles rounded up to it, and no
// more than the clusters the card holds at once; 0 when not one cluster
// fits (the caller refuses the launch).
inline int split_grid(int grid, int ntiles, int max_clusters) {
  const int g = round_up(grid < ntiles ? grid : ntiles, kCluster);
  return g < kCluster * max_clusters ? g : kCluster * max_clusters;
}

// Host: the clusters of `kernel` that fit on the card at once (0: none),
// and its launch as clusters of kCluster blocks of kWgThreads threads.
template <class P>
inline cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                                  void (*kernel)(const P), int grid, size_t smem,
                                  cudaStream_t st, int* max_clusters) {
  cfg = {};
  cfg.gridDim = dim3(round_up(grid > 0 ? grid : 1, kCluster));  // whole clusters, or the query finds none
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
}

// Host: launch `kernel` on `grid` blocks (a multiple of kCluster) as
// clusters; cudaErrorInvalidClusterSize when not one cluster fits.
template <class P>
inline cudaError_t launch_clusters(void (*kernel)(const P), int grid, size_t smem,
                                   cudaStream_t st, const P& p) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int max_clusters = 0;
  cudaError_t err = cluster_config(cfg, attr, kernel, grid, smem, st, &max_clusters);
  if (err != cudaSuccess) return err;
  if (max_clusters < 1 || grid % kCluster != 0) return cudaErrorInvalidClusterSize;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// Host: with K5's input gradients, the transposed pack's widths must be
// the product's: layer 0 kXC, a layer whose input has the skip concat
// hidden + kXC, the branch hidden + kDC, every other hidden, with kXC and
// kDC the encodings' ig_xcols and ig_dcols.
inline bool wg_input_grads_ok(const MlpBwdParams& p) {
  const MlpDims& m = p.m;
  const int H = m.hidden, L = m.num_layers;
  if (m.xyz_dim > 128 || m.dir_dim > 64) return false;
  const int kxc = ig_xcols(m.xyz_dim), kdc = ig_dcols(m.dir_dim);
  if (p.bdense[0].n_pad != kxc || p.bdense[L + 1].n_pad != H + kdc ||
      p.bdense[L + 2].n_pad != H / 2)
    return false;
  for (int i = 1; i <= L; ++i)
    if (p.bdense[i].n_pad != (is_skip(i - 1, m.skip_layer) ? H + kxc : H)) return false;
  return true;
}

}  // namespace nkt
