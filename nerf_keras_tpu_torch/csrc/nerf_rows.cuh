// K2 on Hopper: the backward of the NeRF ray megakernel (K1); with K3,
// its recompute variant, K6's backward and K5's (see the modes below).
//
// Replaces the TPU kernel `_bwd_xres_kernel`
// (nerf_keras_tpu/ops/pallas/fused_render.py:453, with `_bwd_core` :362
// and `fused_mlp._mlp_bwd_tile` nerf_keras_tpu/ops/pallas/fused_mlp.py:163;
// pl.pallas_call at fused_render.py:909).
//
// What it computes: the parameter gradients dW/db of the 8x256 NeRF MLP
// for a loss on K1's outputs, given the per-ray rgb cotangent g_rgb and,
// optionally, the per-sample weights cotangent g_w (distortion loss), from
// K1's training residuals (bf16 position encodings, f32 raw predictions).
// Numerics follow the TPU kernel: the compositing is rebuilt as K1 has it
// (1e10 terminal delta, max(1-alpha,0)+1e-10, never reassociated);
//   dw_sum = g_w + sum_c g_rgb[c] * rgb_c
//   dalpha = trans * dw_sum - suffix_excl(w * dw_sum) / (max(1-alpha,0)+1e-10)
//   dsigma = dalpha * (delta * exp(-sigma*delta)) where sigma > 0
//            (the bracket first: with the 1e10 terminal delta, dalpha*delta
//            overflows before exp() cancels it)
//   dlogit_c = g_rgb[c] * alpha * trans * rgb_c * (1 - rgb_c)
// and the MLP's reverse walk takes bf16 operands with f32 accumulation;
// bias gradients sum the f32 dPre.  The weights cotangent is read only
// when the pointer is given.
//
// What bounds it: ~2.3 MFLOP of products per sample at full width (the
// forward recompute, the dX chain and dW; ~9 MFLOP at 8x512), with dW summed over every
// sample of the batch (655,360 at the bench step) into 595,844 f32
// parameters.  The TPU grid runs in order and keeps dW resident in VMEM;
// Hopper's blocks run in parallel with 227 KB of shared memory each, and
// one f32 atomic per parameter per tile would be ~6e9 atomics.  The first
// design (mma.sync on 64-row tiles, weights read from L2 by every warp)
// ran the rows kernel at ~11% of the bf16 peak, and its workspace (the
// bf16 layer inputs and dPre of every sample, 10,112 B each) was the peak
// memory of every training step.
//
// What the design does about that: four kernels on one stream, no
// atomics, the same sums in the same order on every run (deterministic).
//   1. composite_vjp_kernel: the per-ray compositing VJP from K1's stored
//      predictions (one warp per ray; the exclusive suffix sum is a chunk
//      per lane, a warp suffix scan, and a reverse walk of the chunk, not
//      the TPU's log-scan), giving dpreds (rgb logits, sigma) per sample.
//   Then, over chunks of whole rays in order (the workspace holds one
//   chunk, ops/kernels/fused_render.py: chunk_plan):
//   2. the rows kernel: per 128-sample tile of the chunk, the MLP's
//      recompute and reverse walk on nerf_wgmlp.cuh's wgmma product (two
//      consumer warpgroups, weights staged by a producer warpgroup with
//      bulk copies), direction features encoded per sample row; ReLU signs
//      as bits in shared memory; each layer's bf16 input (A) and dPre (D)
//      written to the chunk's workspace in the dW product's tiled layout;
//      bias sums in shared memory, added into one row per block.  A block
//      strides over the chunk's tiles (grid <= SMs).  Shared memory at
//      8x256: the 128 x 328 bf16 activation tile (83,968 B), the ReLU
//      bits of 9 layers (36,864 B), the bias sums (9,792 B), the
//      column-sum scratch (16,384 B) and a ring of 2 weight stages of 264
//      x 64 bf16 (67,584 B): 214,720 B, one block per SM.  Its epilogues
//      (masks, bf16 stores, column sums) take ~40% of its time on an H100
//      (PERF.md).  At hidden 512 (nerf_wgmlp.cuh's split tile: 64-row
//      tiles, each layer's columns split over the two warpgroups, the dX
//      products' too, 32-deep stages) each tile streams 9.09 MB of
//      weights (the forward pack for the recompute, the transposed pack for
//      the walk), so the blocks run in clusters of two that share every
//      stage (nerf_wgmlp.cuh, "Clusters"): the grid is whole clusters, at
//      most those that fit on the card at once, and both blocks of a
//      cluster walk the first block's count of tiles (a phantom tile past
//      the chunk's drains its stages).  Each block's bias sums go to its
//      row of db_blk in global memory (the same adds in the same order).
//      At 512 each stage's products are a fresh wgmma sum, part by part
//      (nerf_wgmlp.cuh: wg_product_staged), which leaves room for a third
//      stage: the 64 x 584 activation tile (74,752 B), the ReLU bits of 9
//      layers (36,864 B), the column-sum scratch of the tile's 4 row
//      groups (16,384 B) and 3 stages of 520 x 32 bf16 (99,840 B):
//      227,968 B.  A sample's workspace is 19,840 B there (10,112 at
//      8x256), so a chunk of DW_CHUNK_BYTES holds about half the samples.
//      At hidden 1024 (column passes of 256 summed as fresh sums of 64 k,
//      the groups of a sum in flight across its stages: wg_product_sums)
//      the 64 x 1,096 tile (140,288 B) and 5 stages of 16,896 B leave no
//      room for the park (64 x 768), the ReLU bits and the column-sum
//      scratch: they live in the block's global scratch (wg_glob_bytes:
//      204,800 B a block at 8x1024; the park and the bits are read only
//      by the warp that wrote them, the scratch after a barrier of the
//      consumers); a sample's workspace is 39,296 B (47 chunks at B =
//      4,096, S = 192).
//   3. mlp_dw_kernel (nerf_dw.cuh): dW = A^T D per layer on wgmma with
//      both operands MN-major in shared memory, stages of 64 samples
//      brought by bulk copies, split over sample ranges; each block adds
//      its partial tile into its slab (chunks in order: deterministic).
//      Above 256, mlp_dw_window_kernel (nerf_dw.cuh): the same product
//      and sums on a persistent grid walking the host's units of up to
//      128 x 256.
//   4. mlp_reduce_kernel (nerf_dw.cuh), once after the last chunk: sums
//      the dW slabs and the per-block bias rows in a fixed order.
// Orientation: the forward pack is W^T (row = output column); the dX
// products read W in the other orientation, so K2 has its own pack (row =
// layer input column, k = layer output), both in wgmma's core-matrix
// layout.  Ragged edges: rows past the chunk's last sample get zero
// dpreds and zero inputs, so their D is zero and they add nothing.  No
// TF32 anywhere (bf16 tensor-core products, f32 elsewhere), no fast math.
//
// The rows kernel has four modes, one __global__ each (one body):
//   * k2_rows_kernel (K2): position features from K1's x_enc residual.
//   * k3_rows_kernel (K3): replaces `_bwd_encode_kernel`
//     (fused_render.py:425, pl.pallas_call at :969), the
//     bwd_mode="recompute" backward.  The position features of each
//     64-sample tile are encoded again from (origins, dirs, t) with K1's
//     arithmetic (o + d*t as two roundings, encode_feature, bf16), so it
//     reads no x_enc: what a step holds between K1 and K3 is K1's f32
//     predictions (16 B per sample) against K2's 142 B.  Given the same
//     predictions its dW/db are K2's bit for bit.  The cost is the encode
//     twice per tile (layer 0 and the skip concat): ~120 sin/cos per
//     sample against ~2.3 MFLOP of products.
//   * k6_rows_kernel (K6's backward): replaces `_bwd_kernel`
//     (fused_render.py:350, pl.pallas_call at :592), the backward of
//     `apply_nerf_render_pallas`: position and direction encodings both
//     read per sample from the caller's (B*S, .) bf16 inputs, no weights
//     cotangent (the JAX entry's weights carry no gradient).
//   * k5_rows_kernel (K5's backward): replaces `_bwd_kernel`
//     (nerf_keras_tpu/ops/pallas/fused_mlp.py:260, with `_mlp_bwd_tile`
//     :163; pl.pallas_call at :393, entry `apply_nerf_mlp_pallas` at :430):
//     the gradients of the skip MLP over encodings given the cotangent g
//     (N, 4) f32 of its raw predictions.  K6's body with no compositing:
//     no VJP kernel runs, the walk starts from g row by row, and the chunks
//     are of samples (S = 1: K5 has no rays).  With input gradients (the
//     STOP_PDF_GRADIENT=false fine pass) its own instantiation walks with
//     the transposed pack of every input column (fused_render.py:
//     kernel_pack_bwd(input_grads=True)) and runs the three products K2
//     skips: the branch's direction columns (dd_enc), the x_enc columns
//     of each layer after a skip concat and layer 0's product (dx_enc).
//     Numerics as the TPU kernel's (fused_mlp.py:232-239, :253-257):
//     dx_enc's parts are summed in f32 from the top skip layer down, then
//     layer 0, and rounded to bf16 once; dd_enc is rounded once.  Where the
//     f32 sum lives: in registers.  Each of those products is its own
//     wgmma group of N = 64 columns (the x_enc columns, padded) read from
//     the same weight stage as the layer's hidden columns (at column H,
//     LBO = the stage's n_pad * 16 bytes), and wgmma accumulates it into
//     the same 32 f32 a thread (nerf_wgmlp.cuh: mlp_backward_wg), live
//     from the skip layer down to layer 0: 132 (acc) + 32 + 16 (A
//     fragments) of the consumers' 232 registers.  A 128 x 64 f32 tile in
//     shared memory (32 KB) does not fit: at 8x256 the activation tile, the
//     ReLU bits, the scratch and the bias sums take 147,136 B, and the
//     input-gradient pack widens a weight stage to 320 x 64 bf16 = 40,960
//     B (the skip layer's dX has H + 64 columns), so two stages leave
//     3,392 of 232,448 B.  dx_enc and dd_enc go out through the warp's
//     own rows of the activation tile, row by row in order.

#pragma once

#include "nerf_dw.cuh"
#include "nerf_wgmlp.cuh"

using namespace nkt;

namespace {

// Where the rows kernel takes the MLP's inputs from.
enum RowsMode {
  kResidual = 0,     // K2: x_enc residual, directions encoded per sample row
  kRecompute = 1,    // K3: x_enc encoded from (origins, dirs, t)
  kEncodingsIn = 2,  // K6: x_enc and d_enc per sample, as given
  kK5 = 3,           // K5: as K6, seeded from the caller's g (no compositing)
};

// ---- 1. The compositing VJP: composite_vjp_kernel (nerf_tile.cuh, shared
// with the float32 backward, fused_render_f32.cu).

struct RowParams {
  MlpBwdParams mb;             // wgmma packs, the chunk's workspaces, descriptors
  const __nv_bfloat16* x_res;  // (B*S, xyz_dim): K2's residual, K6's x_enc
  const float* origins;        // (B, 3): K3
  const float* dirs;           // (B, 3): K2, K3
  const __nv_bfloat16* d_enc;  // (B*S, dir_dim): K6
  const float* t_vals;         // (B, S)
  const float* dpreds;         // (B*S, 4): the VJP's, K5's g
  float* db_part;              // (grid, total_b)
  float* db_blk;               // (grid, total_b): the split tile's per-launch bias sums
  __nv_bfloat16* dx_out;       // (B*S, xyz_dim): K5 with input gradients, or null
  __nv_bfloat16* dd_out;       // (B*S, dir_dim): K5 with input gradients, or null
  unsigned char* glob;         // (grid, wg_glob_bytes): hidden 1024's park, ReLU bits, scratch
  long long n0;                // the chunk's first sample
  int nc, ntiles, S, total_b, accumulate, stages, stage_bytes, sld;
};

template <int H, int MODE, bool kIG = false, int kXC = 64, int kDC = 32>
__device__ __forceinline__ void rows_body(const RowParams& p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using T = WgTile<H>;
  constexpr int kRows = T::kRows;
  const MlpBwdParams& mb = p.mb;
  const MlpDims& m = mb.m;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ldx = m.ldx;
  const int L = m.num_layers;
  const int MW = mb.mask_words;
  const int S = p.S;

  WRing ring;
  ring.full = reinterpret_cast<uint64_t*>(smem);
  ring.empty = ring.full + kMaxStages;
  ring.buf = smem + kBarBytes;
  ring.stages = p.stages;
  ring.stage_bytes = p.stage_bytes;
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(ring.buf + p.stages * p.stage_bytes);
  // The ReLU bits ((L+1) x (rows, MW)) and the column-sum scratch (2 x
  // rows/16 x sld) follow the tile in shared memory, or at hidden 1024 the
  // park in the block's global scratch (no room beside the tile and the
  // ring): the park and the bits are read only by the warp that wrote
  // them, the scratch after a barrier of the consumers.
  __nv_bfloat16* park = reinterpret_cast<__nv_bfloat16*>(
      p.glob + (size_t)blockIdx.x * wg_glob_bytes(H, L, true));
  uint32_t* masks = reinterpret_cast<uint32_t*>(T::kParked ? reinterpret_cast<unsigned char*>(
                                                                 park + 64 * T::kParkCols)
                                                           : reinterpret_cast<unsigned char*>(
                                                                 act + kRows * ldx));
  float* scratch = reinterpret_cast<float*>(masks + (L + 1) * kRows * MW);
  // (total_b), the forward bias-pack layout: in shared memory, or on the
  // split tile the block's row of db_blk (its shared memory holds a third
  // weight stage instead).
  float* db = T::kSplit ? p.db_blk + (size_t)blockIdx.x * p.total_b
                        : scratch + 2 * T::kRowWarps * p.sld;
  const int steps = walk_steps<H>(p.ntiles);

  ring_peer<H>(ring);
  if (tid == 0) ring_init(ring);
  for (int i = tid; i < p.total_b; i += kWgThreads) db[i] = 0.f;
  block_sync<H>();

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one thread issues
    reg_dealloc<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      RingPos rp;
      for (int i = 0; i < steps; ++i)
        produce_backward<kIG>(mb, ring, rp, T::kKsTile, kIG ? ig_ks(kXC, kDC) : T::kKsTile);
    }
    block_exit<H>();
    return;
  }
  reg_alloc<kConsumerRegs>();

  const int wrow = row_warp<H>() * 16;
  __nv_bfloat16* wact = act + wrow * ldx;
  uint32_t* wmasks = masks + wrow * MW;
  __nv_bfloat16* wpark = T::kParked ? park + wrow * T::kParkCols : nullptr;
  RingPos rp;
  for (int i = 0, tile = blockIdx.x; i < steps; ++i, tile += gridDim.x) {
    if (tile >= p.ntiles) {  // a phantom tile (split tile only: no input gradients)
      drain_backward(mb, ring, rp, T::kKsTile, T::kKsTile);
      continue;
    }
    const int rbase = tile * kRows + wrow;          // workspace row of the warp's row 0
    const long long q0 = p.n0 + rbase;              // its sample
    const int valid = min(16, p.nc - rbase);        // may be <= 0
    const float* g = p.dpreds + q0 * 4;
    auto dir = [&](int row, int c) {
      if (row >= valid || c >= m.dir_dim) return __float2bfloat16_rn(0.f);
      const long long q = q0 + row;
      if (MODE == kEncodingsIn || MODE == kK5) return p.d_enc[q * m.dir_dim + c];
      return __float2bfloat16_rn(encode_feature(p.dirs + (q / S) * 3, c, m.dir_dim));
    };
    if constexpr (MODE == kRecompute) {
      // K1's encode of the sample (o + d*t as two roundings).
      auto xf = [&](int row, int c) {
        const long long q = q0 + row;
        const float* o = p.origins + (q / S) * 3;
        const float* d = p.dirs + (q / S) * 3;
        const float t = p.t_vals[q];
        const float x[3] = {__fadd_rn(o[0], __fmul_rn(d[0], t)),
                            __fadd_rn(o[1], __fmul_rn(d[1], t)),
                            __fadd_rn(o[2], __fmul_rn(d[2], t))};
        return __float2bfloat16_rn(encode_feature(x, c, m.xyz_dim));
      };
      mlp_backward_wg<H>(mb, wact, wmasks, scratch, p.sld, db, xf, dir, g, valid, rbase, ring,
                         rp, nullptr, nullptr, wpark);
    } else {
      auto xf = [&](int row, int c) { return p.x_res[(q0 + row) * m.xyz_dim + c]; };
      __nv_bfloat16* dx = kIG && p.dx_out != nullptr ? p.dx_out + q0 * m.xyz_dim : nullptr;
      __nv_bfloat16* dd = kIG && p.dd_out != nullptr ? p.dd_out + q0 * m.dir_dim : nullptr;
      mlp_backward_wg<H, kIG, kXC, kDC>(mb, wact, wmasks, scratch, p.sld, db, xf, dir, g,
                                        valid, rbase, ring, rp, dx, dd, wpark);
    }
  }
  consumer_sync(kWgConsumers);
  float* out = p.db_part + (size_t)blockIdx.x * p.total_b;
  for (int i = tid; i < p.total_b; i += kWgConsumers) out[i] = p.accumulate ? out[i] + db[i] : db[i];
  block_exit<H>();
}

template <int H>
__global__ void __launch_bounds__(kWgThreads, 1)
    k2_rows_kernel(const __grid_constant__ RowParams p) {
  rows_body<H, kResidual>(p);
}

template <int H>
__global__ void __launch_bounds__(kWgThreads, 1)
    k3_rows_kernel(const __grid_constant__ RowParams p) {
  rows_body<H, kRecompute>(p);
}

template <int H>
__global__ void __launch_bounds__(kWgThreads, 1)
    k6_rows_kernel(const __grid_constant__ RowParams p) {
  rows_body<H, kEncodingsIn>(p);
}

template <int H, bool kIG, int kXC = 64, int kDC = 32>
__global__ void __launch_bounds__(kWgThreads, 1)
    k5_rows_kernel(const __grid_constant__ RowParams p) {
  rows_body<H, kK5, kIG, kXC, kDC>(p);
}

template <int H>
void (*pick_ig(int kxc, int kdc))(const RowParams) {
  if constexpr (WgTile<H>::kSplit) {
    return nullptr;  // K5's input gradients run on 128-row tiles (refused on the host)
  } else {
    if (kxc == 64)
      return kdc == 32 ? k5_rows_kernel<H, true, 64, 32> : k5_rows_kernel<H, true, 64, 64>;
    return kdc == 32 ? k5_rows_kernel<H, true, 128, 32> : k5_rows_kernel<H, true, 128, 64>;
  }
}

template <int H>
void (*pick_rows(int mode, bool ig, int kxc, int kdc))(const RowParams) {
  switch (mode) {
    case kResidual: return k2_rows_kernel<H>;
    case kRecompute: return k3_rows_kernel<H>;
    case kEncodingsIn: return k6_rows_kernel<H>;
    default: return ig ? pick_ig<H>(kxc, kdc) : k5_rows_kernel<H, false>;
  }
}


// The rows kernel of `mode` at `hidden`, one of Hs (else null: refused).
template <int H, int... More>
void (*pick_width(int hidden, int mode, bool ig, int kxc, int kdc))(const RowParams) {
  if (hidden == H) return pick_rows<H>(mode, ig, kxc, kdc);
  if constexpr (sizeof...(More) > 0) return pick_width<More...>(hidden, mode, ig, kxc, kdc);
  return nullptr;
}

// The body of the plain C entry points (NKT_ROWS_ENTRY), loaded with
// ctypes, one library for each group of widths Hs.  `mode` picks the rows
// kernel:
// 0 = K2 (x_res and dirs given), 1 = K3 (origins and dirs given, x_res
// null), 2 = K6 (x_res = x_enc and d_enc given, dirs null), 3 = K5 (x_res
// = x_enc, d_enc and dpreds = the cotangent g (N, 4) given, as B = N rays
// of S = 1 sample; t_vals, preds, g_rgb, g_w, origins and dirs null: no
// compositing VJP runs).  K5 alone takes dx_out (N, xyz_dim) and dd_out
// (N, dir_dim) bf16: with either, its input-gradient walk, whose
// transposed pack holds every input column (wg_input_grads_ok).  Host arrays:
// `desc_fwd` (n_dense x 5: k_pad, n, n_pad, w_off, b_off of the forward
// wgmma pack), `desc_bwd` (the same for the transposed pack: k_pad =
// round16(n), n = dX columns), `desc_ws` (n_dense x 5: a_col, a_width,
// d_col, d_width, out_off), in the order trunk[0..num_layers), merged
// head, branch, rgb.  hidden is 64, 128, 256, 512 or 1024 (no input
// gradients above 256).  The batch runs in chunks of `chunk_rays` whole
// rays, in order; buffers (allocated by the caller): dpreds (B*S x 4) f32,
// written by the VJP (read, for K5); ws_a (rows_pad x sum a_width) and
// ws_d (rows_pad x sum d_width, above 256 with kDwUnitN x 64 elements more
// at its end) bf16 for one chunk, rows_pad >= round_up(chunk_rays * S,
// 128); db_part (grid x total_b, above 256 2 x grid x total_b) and dw_part
// (nsplit x total_out) f32, where grid <= the first chunk's tiles (above
// 256 rounded up to a cluster; the launch lowers it to the clusters that
// fit on the card); at hidden 1024 `glob`, grid x wg_glob_bytes(1024,
// num_layers, true) bytes (nerf_wgmlp.cuh), else ignored.  Above 256
// `dw_sched` is the dW product's schedule in device memory for
// `dw_blocks` blocks (nerf_dw.cuh: dw_win_plan), else null.  Outputs dw
// (total_out) and db (total_b) f32.  Launches on `stream`, returns the first
// CUDA error (0 on success); does not synchronise.
template <int... Hs>
inline int rows_launch(
    int mode, const void* x_res, const void* origins, const void* dirs, const void* d_enc,
    const void* t_vals, const void* preds, const void* g_rgb, const void* g_w,
    const void* w_pack, const void* b_pack, const void* desc_fwd, const void* wb_pack,
    const void* desc_bwd, const void* desc_ws, int n_dense, int num_layers, int skip_layer,
    int hidden, int l_xyz, int l_dir, int B, int S, int chunk_rays, int total_b,
    int total_out, void* dpreds, void* ws_a, void* ws_d, void* db_part, int grid,
    void* dw_part, int nsplit, const void* dw_sched, int dw_blocks, void* dw_out, void* db_out,
    void* dx_out, void* dd_out, void* glob, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool inputs_ok =
      (mode == kResidual && x_res != nullptr && dirs != nullptr) ||
      (mode == kRecompute && x_res == nullptr && origins != nullptr && dirs != nullptr) ||
      (mode == kEncodingsIn && x_res != nullptr && d_enc != nullptr && dirs == nullptr) ||
      (mode == kK5 && x_res != nullptr && d_enc != nullptr && dpreds != nullptr && S == 1 &&
       origins == nullptr && dirs == nullptr && t_vals == nullptr && preds == nullptr &&
       g_rgb == nullptr && g_w == nullptr);
  const bool ig = dx_out != nullptr || dd_out != nullptr;
  RowParams p;
  MlpBwdParams& mb = p.mb;
  const int rows = wg_rows(hidden);
  const bool split = hidden > kSplitAbove;
  const int first_tiles = (int)(((long long)chunk_rays * S + rows - 1) / rows);
  if (!inputs_ok || (ig && (mode != kK5 || rows != 128)) || B <= 0 || (S < 2 && mode != kK5) ||
      nsplit < 1 ||
      chunk_rays < 1 || grid < 1 ||
      grid > (split ? round_up(first_tiles, kCluster) : first_tiles) || !wg_hidden_ok(hidden) ||
      !mlp_dims_init(mb.m, static_cast<const int*>(desc_fwd), n_dense, num_layers,
                     skip_layer, hidden, l_xyz, l_dir) ||
      !wg_dims_ok(mb.m) ||
      !mlp_bwd_init(mb, static_cast<const int*>(desc_bwd), static_cast<const int*>(desc_ws),
                    n_dense) ||
      (ig && !wg_input_grads_ok(mb)) || (hidden > kPassCols && glob == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  mb.w = static_cast<const __nv_bfloat16*>(w_pack);
  mb.b = static_cast<const float*>(b_pack);
  mb.wb = static_cast<const __nv_bfloat16*>(wb_pack);
  mb.ws_a = static_cast<__nv_bfloat16*>(ws_a);
  mb.ws_d = static_cast<__nv_bfloat16*>(ws_d);
  const int rows_pad = first_tiles * rows;
  mb.N = rows_pad;
  p.x_res = static_cast<const __nv_bfloat16*>(x_res);
  p.origins = static_cast<const float*>(origins);
  p.dirs = static_cast<const float*>(dirs);
  p.d_enc = static_cast<const __nv_bfloat16*>(d_enc);
  p.t_vals = static_cast<const float*>(t_vals);
  p.dpreds = static_cast<const float*>(dpreds);
  p.db_part = static_cast<float*>(db_part);
  p.db_blk = split ? p.db_part + (size_t)grid * total_b : nullptr;
  p.dx_out = static_cast<__nv_bfloat16*>(dx_out);
  p.dd_out = static_cast<__nv_bfloat16*>(dd_out);
  p.glob = static_cast<unsigned char*>(glob);
  p.S = S;
  p.total_b = total_b;
  p.sld = hidden;
  const int kxc = ig_xcols(mb.m.xyz_dim), kdc = ig_dcols(mb.m.dir_dim);
  const int cols = wg_pass_cols(hidden);
  int sb = wg_stage_bytes(mb.m.dense, n_dense, wg_ks(hidden), cols);
  const int sbb =
      wg_stage_bytes(mb.bdense, n_dense, ig ? ig_ks(kxc, kdc) : wg_ks(hidden), cols);
  p.stage_bytes = sb > sbb ? sb : sbb;

  if (mode != kK5) {
    composite_vjp_kernel<float><<<(B + 7) / 8, 256, 0, st>>>(
        static_cast<const float*>(t_vals), static_cast<const float*>(preds),
        static_cast<const float*>(g_rgb), static_cast<const float*>(g_w),
        static_cast<float*>(dpreds), B, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  const bool parked = hidden > kPassCols;  // the ReLU bits and the scratch in `glob`
  const size_t rest =
      kBarBytes + sizeof(__nv_bfloat16) * (size_t)rows * mb.m.ldx +
      (parked ? 0
              : sizeof(uint32_t) * (size_t)(num_layers + 1) * rows * mb.mask_words +
                    sizeof(float) * ((size_t)2 * (rows / 16) * p.sld + (split ? 0 : total_b)));
  if (rest + 2 * (size_t)p.stage_bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const size_t fit = ((size_t)kMaxSmem - rest) / p.stage_bytes;
  p.stages = fit < (size_t)kMaxStages ? (int)fit : kMaxStages;
  const size_t smem = rest + (size_t)p.stages * p.stage_bytes;
  void (*kernel)(const RowParams) = pick_width<Hs...>(hidden, mode, ig, kxc, kdc);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // The split tile's grid: whole clusters, no more than fit on the card at
  // once (each chunk's launch then takes split_grid of it).
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int max_clusters = 0;
  if (split) {
    err = cluster_config(cfg, attr, kernel, grid, smem, st, &max_clusters);
    if (err != cudaSuccess) return (int)err;
    grid = split_grid(grid, first_tiles, max_clusters);
    if (grid < kCluster) return (int)cudaErrorInvalidClusterSize;
  }

  // The dW product (nerf_dw.cuh): a layer's whole d_width on the 128-row
  // tile, the host's walk of units on the split tile.
  DwPlan dw;
  DwWinPlan dww;
  if (split ? !dw_win_plan(dww, mb, n_dense, rows_pad, total_out, nsplit,
                           static_cast<float*>(dw_part), static_cast<const int*>(dw_sched),
                           dw_blocks)
            : dw_sched != nullptr || !dw_plan(dw, mb, n_dense, rows_pad, total_out, nsplit,
                                              static_cast<float*>(dw_part)))
    return (int)cudaErrorInvalidValue;
  for (int r0 = 0, chunk = 0; r0 < B; r0 += chunk_rays, ++chunk) {
    const int nr = B - r0 < chunk_rays ? B - r0 : chunk_rays;
    p.n0 = (long long)r0 * S;
    p.nc = nr * S;
    p.ntiles = (p.nc + rows - 1) / rows;
    p.accumulate = chunk > 0;
    if (split) {
      err = launch_clusters(kernel, split_grid(grid, p.ntiles, max_clusters), smem, st, p);
    } else {
      kernel<<<grid < p.ntiles ? grid : p.ntiles, kWgThreads, smem, st>>>(p);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return (int)err;
    const int nst = p.ntiles * (rows / kDwRows);
    err = split ? launch_dw_windows(dww, nst, chunk > 0, st)
                : launch_dw(dw, nst, chunk > 0, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_reduce(static_cast<float*>(dw_part), nsplit, total_out,
                            static_cast<float*>(dw_out), p.db_part, grid, total_b,
                            static_cast<float*>(db_out), st);
}

}  // namespace

// Defines the plain C entry point NAME over the rows kernels of the widths
// given (rows_launch): fused_render_bwd.cu (64, 128, 256),
// fused_render_bwd_512.cu and fused_render_bwd_1024.cu, compiled apart
// (and in parallel: ops/kernels/_build.py).
#define NKT_ROWS_ENTRY(NAME, ...) \
  extern "C" int NAME( \
    int mode, const void* x_res, const void* origins, const void* dirs, const void* d_enc, \
    const void* t_vals, const void* preds, const void* g_rgb, const void* g_w, \
    const void* w_pack, const void* b_pack, const void* desc_fwd, const void* wb_pack, \
    const void* desc_bwd, const void* desc_ws, int n_dense, int num_layers, int skip_layer, \
    int hidden, int l_xyz, int l_dir, int B, int S, int chunk_rays, int total_b, \
    int total_out, void* dpreds, void* ws_a, void* ws_d, void* db_part, int grid, \
    void* dw_part, int nsplit, const void* dw_sched, int dw_blocks, void* dw_out, void* db_out, \
    void* dx_out, void* dd_out, void* glob, int device, void* stream) { \
    return rows_launch<__VA_ARGS__>(mode, x_res, origins, dirs, d_enc, t_vals, preds, g_rgb, \
        g_w, w_pack, b_pack, desc_fwd, wb_pack, desc_bwd, desc_ws, n_dense, num_layers, \
        skip_layer, hidden, l_xyz, l_dir, B, S, chunk_rays, total_b, total_out, dpreds, ws_a, \
        ws_d, db_part, grid, dw_part, nsplit, dw_sched, dw_blocks, dw_out, db_out, \
        dx_out, dd_out, glob, device, stream); \
  }
