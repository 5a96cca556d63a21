// K1 forward on Hopper: the NeRF ray megakernel.
//
// Replaces the TPU kernel `_fwd_encode_kernel`
// (nerf_keras_tpu/ops/pallas/fused_render.py:709, launched by the
// pl.pallas_call at :810, entry `render_rays_fused` at :1004), in its
// forward form and in its training form (`emit_enc=True`, :724-735).
//
// What it computes, per ray, without leaving on-chip memory between steps:
//   points o + t*d (f32) -> Fourier encode of points (63 wide) and of the
//   ray direction (27 wide), f32 -> the trunk MLP (8x256, skip concat
//   [h, x_enc] after layer 4), the merged feature(256)+sigma(1) head, the
//   128-wide branch over [feature, d_enc] and the rgb head, as bf16
//   products with f32 accumulation -> relu(sigma), sigmoid(rgb), delta with
//   a 1e10 terminal, alpha, exclusive transmittance prod(max(1-alpha,0)
//   + 1e-10), weights, composited rgb.
// bf16 rounding sits where the reference puts it: the encodings, each
// post-ReLU hidden, and the feature before the concat.  sigma and rgb
// logits stay f32.
//
// Training mode (two optional outputs, null = not written):
//   * x_enc_out (B*S, 3+6L) bf16: the position encodings, the TPU kernel's
//     residual.  They are the values the first product already rounds, so
//     they change no numerics;
//   * preds_out (B*S, 4) f32: rgb logits and sigma per sample (16 B per
//     sample).  The TPU kernel holds whole rays in VMEM and its backward
//     recomputes the MLP once and composites in place; this kernel streams
//     64-sample tiles of a ray and composites at the end, so a backward
//     without the stored predictions would have to run the forward twice
//     (once for the ray's alpha/transmittance, once for the activations).
//     With them K2 runs the per-ray compositing VJP first and then one
//     recompute per tile.
//
// What bounds it on this card: about 1.19 MFLOP of matmul per sample at
// full width (8x256 trunk with the skip, heads and branch), against a few
// bytes of input per sample (o, d per ray; one t per sample) and two
// small outputs (plus 142 B per sample in training mode).  So the tensor
// cores bound it, not device memory; the first design (mma.sync on 64-row
// tiles, weight fragments read from L2 by every warp) reached ~17% of the
// bf16 peak.
//
// What the design does about that (nerf_wgmlp.cuh):
//   * A block owns R whole rays, R chosen so that R*S fills 128-row tiles
//     (at most 640 samples), and streams 128-sample tiles through the
//     whole MLP.  Activations stay in shared memory as one bf16 tile of
//     128 x (hidden+72), updated in place layer by layer.
//   * Products are wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate):
//     two consumer warpgroups of 64 rows each, A from registers, B (the
//     weights) from shared memory.
//   * A producer warpgroup (one thread of it issues; setmaxnreg gives its
//     registers to the consumers, 232 a thread) streams the weights (~1.2
//     MB bf16 per MLP, resident in L2) through a ring of shared-memory
//     stages with bulk copies and mbarriers, one 64-wide k-slice of a
//     layer per stage, ahead of the consumers; each staged byte feeds 128
//     rows.  The pack is built once per set of weights in wgmma's
//     core-matrix layout.
//   * Per-sample (sigma, rgb) go to shared memory; at the end one warp
//     per ray runs the transmittance scan in sample order (a chunk per
//     lane plus a multiplicative warp scan) and writes weights and rgb
//     (composite_rays, nerf_tile.cuh, shared with K4).
//   * Shared memory at 8x256 (H = 256, 227 KB a block, one block per SM):
//     activation tile 128 x 328 bf16 = 83,968 B; the x_enc tile for the
//     skip concat 128 x 64 bf16 = 16,384 B; R rays' direction features,
//     origins and directions, and R*S x 16 B of predictions (<= 10,240
//     B); the weight ring, 3 stages of 264 x 64 bf16 = 33,792 B each
//     (208,192 B in all at S=192).
//   * Measured on an H100 (PERF.md): ~30-35% of the bf16 peak at S=192.
//     Without the epilogues the products alone reach ~36%, and without
//     the weight stream ~34%: what holds it back is each warpgroup
//     waiting for its products stage by stage (more stages in flight,
//     warpgroups staggered by a layer, a 128-byte swizzled pack: no
//     gain measured), not the weight traffic.
// Hidden 512 (any width 257-512, zero-padded to it): 2,300,928
// multiply-adds a sample (4.60 MFLOP, 3.9x 8x256's), still bound by the
// products.  The 128-row tile does not fit there (nerf_wgmlp.cuh), so the
// block streams 64-row tiles whose two consumer warpgroups split every
// layer's output columns, and R follows the 64-row tile (one ray a block at
// S = 64 or 192).  Shared memory at 8x512, S = 192: the activation tile
// 64 x 584 bf16 = 74,752 B; the x_enc tile 64 x 64 bf16 = 8,192 B; the
// ray's direction features, origin, direction and 192 x 16 B of
// predictions (3,168 B); 4 stages of 520 x 32 bf16 = 33,280 B: 219,360 B.
// There each 64-row tile streams the whole 4.62 MB pack from L2 (56.7 GB
// a launch at B = 4,096, S = 192, ~6.9 TB/s: PERF.md), so the blocks run
// in clusters of two, blocks 2c and 2c + 1, that share every weight stage
// (nerf_wgmlp.cuh, "Clusters"): both walk the tiles of block 2c, and
// where block 2c + 1 has fewer (the last rays of the batch) its consumers
// drain the rest of the stages.  The grid is rounded up to whole clusters
// (a block past B walks only phantom tiles).  Each stage's wgmma group
// stays in flight while the next stage's is issued (wg_product_pipe).
// Hidden 1024 (513-1023 zero-padded to it): 9,058,304 multiply-adds a
// sample (18.1 MFLOP), on the same 64-row tile in column passes of 512
// (nerf_wgmlp.cuh: layer_passes): two 33,280 B stages beside the 64 x
// 1,096 activation tile (140,288 B); the first pass's outputs wait in the
// block's park in global memory, so the grid is at most the clusters the
// card holds at once and each block walks groups of rays (a group past B:
// phantom tiles only); each stage's products a sum of their own
// (wg_product_staged), two parts in flight.
// Not carried over from the TPU kernel: its one-hot selector matmuls,
// three-limb exact dots, the sin(z + pi/2) cos trick, the log-space
// cumsum and the padded-t ragged batch (the ragged edge is masked here).

// K6's forward is the same body over encodings: fused_render_enc_kernel
// replaces `_fwd_kernel` (nerf_keras_tpu/ops/pallas/fused_render.py:336,
// pl.pallas_call at :530; entry `apply_nerf_render_pallas` at :1083).  It
// reads x_enc (B*S, 3+6 L_XYZ) and d_enc (B*S, 3+6 L_DIR) bf16 per sample
// from the caller instead of encoding rays (d_enc per sample, as the JAX
// entry takes it), then runs the same MLP tile and compositing; in
// training mode it writes the f32 predictions for K6's backward
// (fused_render_bwd.cu, k6_rows_kernel).  It reads 180 B per sample more
// than K1 (its encodings), still far below the products' time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (never -use_fast_math: the top
//        octave's argument is 2^9*|p|, thousands of radians, where the
//        fast sin is wrong).

#include "nerf_wgmlp.cuh"

using namespace nkt;

namespace {

struct Params {
  const float* origins;  // (B, 3), K1
  const float* dirs;     // (B, 3), K1
  const float* t_vals;   // (B, S)
  const __nv_bfloat16* x_in;  // (B*S, xyz_dim), K6
  const __nv_bfloat16* d_in;  // (B*S, dir_dim), K6
  const __nv_bfloat16* w;     // the wgmma pack
  const float* b;
  float* rgb_out;           // (B, 3)
  float* w_out;             // (B, S)
  __nv_bfloat16* xenc_out;  // (B*S, xyz_dim) or null
  float* preds_out;         // (B*S, 4) or null
  __nv_bfloat16* park;      // (grid, 64, kPassCols): hidden 1024, else null
  int B, S, R, stages, stage_bytes;
  MlpDims m;
};

// kEncIn: K6 (encodings given per sample), else K1 (rays encoded here).
template <int H, bool kEncIn>
__device__ __forceinline__ void render_body(const Params& p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using T = WgTile<H>;
  constexpr int kRows = T::kRows;
  const MlpDims& m = p.m;
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
  ring.buf = smem + kBarBytes;
  ring.stages = p.stages;
  ring.stage_bytes = p.stage_bytes;
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(ring.buf + p.stages * p.stage_bytes);
  __nv_bfloat16* xenc = act + kRows * ldx;             // (rows, xyz_pad)
  __nv_bfloat16* denc = xenc + kRows * m.xyz_pad;      // (R, dir_pad)
  float* ray = reinterpret_cast<float*>(denc + round_up(R * m.dir_pad, 8));  // (R, 8): o, d
  float* sig = ray + R * 8;   // (R*S)
  float* rgbl = sig + R * S;  // (R*S, 3)

  // The groups of R rays the block walks: blockIdx.x, + gridDim.x, ...
  // (one a block unless hidden 1024, whose grid is at most the clusters
  // the card holds at once: their park is a block's); on the split tile
  // both blocks of a cluster walk as many groups as its first block, and a
  // group past B is a phantom.
  const int groups = (p.B + R - 1) / R;
  const int first = T::kSplit ? (int)(blockIdx.x & ~(kCluster - 1)) : (int)blockIdx.x;
  const int steps = groups > first ? (groups - first + gridDim.x - 1) / gridDim.x : 0;
  // The tiles of group g (0 past B): on the split tile its cluster's first
  // block's group's, which the producers stream for both blocks.
  auto group_tiles = [&](int g) { return (max(0, min(R, p.B - g * R)) * S + kRows - 1) / kRows; };

  ring_peer<H>(ring);
  if (tid == 0) ring_init(ring);
  block_sync<H>();

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one thread issues
    reg_dealloc<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      RingPos rp;
      for (int i = 0; i < steps; ++i)
        for (int tile = group_tiles(first + i * gridDim.x); tile > 0; --tile)
          produce_forward(m, p.w, ring, rp, T::kKsTile);
    }
    block_exit<H>();
    return;
  }
  reg_alloc<kConsumerRegs>();

  const int wrow = row_warp<H>() * 16;  // this warp's rows of every tile
  __nv_bfloat16* wact = act + wrow * ldx;
  __nv_bfloat16* wxenc = xenc + wrow * m.xyz_pad;
  __nv_bfloat16* wpark = T::kParked ? p.park + ((size_t)blockIdx.x * 64 + wrow) * kPassCols
                                    : nullptr;
  RingPos rp;
  for (int i = 0; i < steps; ++i) {
    const int r0 = (blockIdx.x + i * gridDim.x) * R;
    const int nrays = max(0, min(R, p.B - r0));  // 0: a phantom group
    const int P = nrays * S;
    const size_t s0 = (size_t)r0 * S;  // first sample of the group
    const int ntiles = (P + kRows - 1) / kRows;
    const int ctiles = group_tiles(first + i * gridDim.x);
    if (!kEncIn) {
      for (int j = tid; j < R * 3; j += kWgConsumers) {
        const int r = j / 3, c = j - r * 3;
        const bool ok = r < nrays;
        ray[r * 8 + c] = ok ? p.origins[(size_t)(r0 + r) * 3 + c] : 0.f;
        ray[r * 8 + 4 + c] = ok ? p.dirs[(size_t)(r0 + r) * 3 + c] : 0.f;
      }
      consumer_sync(kWgConsumers);
      // Direction features once per ray (every sample of a ray shares them).
      for (int j = tid; j < R * m.dir_pad; j += kWgConsumers) {
        const int r = j / m.dir_pad, c = j - r * m.dir_pad;
        denc[j] = __float2bfloat16_rn(encode_feature(ray + r * 8 + 4, c, m.dir_dim));
      }
      consumer_sync(kWgConsumers);
    }
    for (int tile = 0; tile < ntiles; ++tile) {
      const int q0 = tile * kRows + wrow;  // group sample of the warp's row 0
      const int valid = min(16, P - q0);   // may be <= 0 on the last tile
      for (int j = peer_lane<H>(); j < 16 * m.xyz_pad; j += T::kLanes) {
        const int row = j / m.xyz_pad, c = j - row * m.xyz_pad;
        const int q = q0 + row;
        __nv_bfloat16 v = __float2bfloat16_rn(0.f);
        if (row < valid && c < m.xyz_dim) {
          if (kEncIn) {
            v = p.x_in[(s0 + q) * m.xyz_dim + c];
          } else {
            const float* o = ray + (q / S) * 8;
            const float t = p.t_vals[s0 + q];
            // o + d*t rounded as two operations (no fma), as the plain path.
            const float x[3] = {__fadd_rn(o[0], __fmul_rn(o[4], t)),
                                __fadd_rn(o[1], __fmul_rn(o[5], t)),
                                __fadd_rn(o[2], __fmul_rn(o[6], t))};
            v = __float2bfloat16_rn(encode_feature(x, c, m.xyz_dim));
            if (p.xenc_out != nullptr) p.xenc_out[(s0 + q) * m.xyz_dim + c] = v;
          }
        }
        wact[row * ldx + c] = v;
        wxenc[j] = v;
      }
      rows_sync<H>();
      auto xf = [&](int row, int c) { return wxenc[row * m.xyz_pad + c]; };
      if (kEncIn) {
        auto dir = [&](int row, int c) {
          return row < valid && c < m.dir_dim ? p.d_in[(s0 + q0 + row) * m.dir_dim + c]
                                              : __float2bfloat16_rn(0.f);
        };
        mlp_forward_wg<H>(m, p.b, wact, xf, dir, sig + q0, rgbl + q0 * 3, valid, ring, rp,
                          wpark);
      } else {
        auto dir = [&](int row, int c) {
          return row < valid ? denc[((q0 + row) / S) * m.dir_pad + c] : __float2bfloat16_rn(0.f);
        };
        mlp_forward_wg<H>(m, p.b, wact, xf, dir, sig + q0, rgbl + q0 * 3, valid, ring, rp,
                          wpark);
      }
    }
    for (int tile = ntiles; tile < ctiles; ++tile) drain_forward(m, ring, rp, T::kKsTile);
    consumer_sync(kWgConsumers);
    if (p.preds_out != nullptr)
      for (int j = tid; j < P * 4; j += kWgConsumers) {
        const int q = j >> 2, c = j & 3;
        p.preds_out[s0 * 4 + j] = c < 3 ? rgbl[q * 3 + c] : sig[q];
      }
    composite_rays(p.t_vals + s0, sig, rgbl, nrays, S, p.w_out + s0,
                   p.rgb_out + (size_t)r0 * 3);
    consumer_sync(kWgConsumers);  // before the next group's rays and predictions
  }
  block_exit<H>();
}

template <int H>
__global__ void __launch_bounds__(kWgThreads, 1)
    fused_render_fwd_kernel(const __grid_constant__ Params p) {
  render_body<H, false>(p);
}

template <int H>
__global__ void __launch_bounds__(kWgThreads, 1)
    fused_render_enc_kernel(const __grid_constant__ Params p) {
  render_body<H, true>(p);
}

template <int H>
void (*pick_kernel(bool enc_in))(const Params) {
  return enc_in ? fused_render_enc_kernel<H> : fused_render_fwd_kernel<H>;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  K1 takes origins and dirs
// (x_in, d_in null); K6 takes x_in and d_in (origins, dirs and xenc_out
// null).  `w_pack` is the wgmma pack (pack_weights_wg); `dense_desc` is a
// HOST array of n_dense * 5 ints (k_pad, n, n_pad, w_off, b_off) in the
// order trunk[0..num_layers), merged feature+sigma head, branch, rgb.
// hidden is 64, 128, 256, 512 or 1024.  `xenc_out` and `preds_out` may be
// null (forward only).  At hidden 1024 `park` is the column passes' park
// (park_blocks x wg_glob_bytes(1024, ., false) bytes, nerf_wgmlp.cuh), and
// the grid is at most park_blocks (rounded down to a cluster) and the
// clusters the card holds at once; else both are ignored.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise and allocates nothing.
extern "C" int nkt_fused_render_fwd(
    const void* origins, const void* dirs, const void* t_vals, const void* x_in,
    const void* d_in, const void* w_pack, const void* b_pack, const void* dense_desc,
    int n_dense, int num_layers, int skip_layer, int hidden, int l_xyz,
    int l_dir, int B, int S, void* rgb_out, void* w_out, void* xenc_out,
    void* preds_out, void* park, int park_blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool enc_in = x_in != nullptr;
  const bool inputs_ok =
      enc_in ? d_in != nullptr && origins == nullptr && dirs == nullptr && xenc_out == nullptr
             : origins != nullptr && dirs != nullptr && d_in == nullptr;
  Params p;
  if (!inputs_ok || B <= 0 || S < 2 || !wg_hidden_ok(hidden) ||
      !mlp_dims_init(p.m, static_cast<const int*>(dense_desc), n_dense, num_layers,
                     skip_layer, hidden, l_xyz, l_dir) ||
      !wg_dims_ok(p.m))
    return (int)cudaErrorInvalidValue;
  p.origins = static_cast<const float*>(origins);
  p.dirs = static_cast<const float*>(dirs);
  p.t_vals = static_cast<const float*>(t_vals);
  p.x_in = static_cast<const __nv_bfloat16*>(x_in);
  p.d_in = static_cast<const __nv_bfloat16*>(d_in);
  p.w = static_cast<const __nv_bfloat16*>(w_pack);
  p.b = static_cast<const float*>(b_pack);
  p.rgb_out = static_cast<float*>(rgb_out);
  p.w_out = static_cast<float*>(w_out);
  p.xenc_out = static_cast<__nv_bfloat16*>(xenc_out);
  p.preds_out = static_cast<float*>(preds_out);
  p.park = static_cast<__nv_bfloat16*>(park);
  p.B = B;
  p.S = S;
  const int rows = wg_rows(hidden);
  p.R = wg_rays_per_block(S, rows);
  p.stage_bytes = wg_stage_bytes(p.m.dense, n_dense, wg_ks(hidden));

  const size_t rest =
      kBarBytes +
      sizeof(__nv_bfloat16) * ((size_t)rows * p.m.ldx + (size_t)rows * p.m.xyz_pad +
                               (size_t)round_up(p.R * p.m.dir_pad, 8)) +
      sizeof(float) * ((size_t)p.R * 8 + (size_t)p.R * S * 4);
  if (rest + 2 * (size_t)p.stage_bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const size_t fit = ((size_t)kMaxSmem - rest) / p.stage_bytes;
  p.stages = fit < (size_t)kMaxStages ? (int)fit : kMaxStages;
  const size_t smem = rest + (size_t)p.stages * p.stage_bytes;
  void (*kernel)(const Params) = hidden == 64    ? pick_kernel<64>(enc_in)
                                 : hidden == 128 ? pick_kernel<128>(enc_in)
                                 : hidden == 256 ? pick_kernel<256>(enc_in)
                                 : hidden == 512 ? pick_kernel<512>(enc_in)
                                                 : pick_kernel<1024>(enc_in);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (B + p.R - 1) / p.R;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hidden > kPassCols) {  // no more blocks than parks and clusters on the card
    if (park == nullptr || park_blocks < kCluster)
      return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int max_clusters = 0;
    err = cluster_config(cfg, attr, kernel, grid, smem, st, &max_clusters);
    if (err != cudaSuccess) return (int)err;
    grid = split_grid(grid, grid, max_clusters < park_blocks / kCluster
                                      ? max_clusters : park_blocks / kCluster);
    if (grid < kCluster) return (int)cudaErrorInvalidClusterSize;
    return (int)launch_clusters(kernel, grid, smem, st, p);
  }
  if (hidden > kSplitAbove)  // clusters of two blocks sharing each weight stage
    return (int)launch_clusters(kernel, round_up(grid, kCluster), smem, st, p);
  kernel<<<grid, kWgThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}
