// K5 forward on Hopper: the NeRF MLP over precomputed encodings.
//
// Replaces the TPU kernel `_fwd_kernel`
// (nerf_keras_tpu/ops/pallas/fused_mlp.py:148, launched by the
// pl.pallas_call at :330, entry `apply_nerf_mlp_pallas` at :430).
//
// What it computes: raw predictions (N, 4) f32 = [rgb logits, sigma] of
// the 8x256 skip MLP for N samples given their position encodings x_enc
// (N, 3+6*L_XYZ) and direction encodings d_enc (N, 3+6*L_DIR), both bf16
// (the compute dtype; the encodings are stored in it): the trunk with the
// skip concat [h, x_enc] after layer SKIP_LAYER, the merged
// feature(256)+sigma(1) head, the 128-wide branch over [feature, d_enc]
// and the rgb head, bf16 products with f32 accumulation.  bf16 rounding
// sits where the reference's apply_nerf_mlp puts it (each post-ReLU
// hidden, the feature before the concat); sigma and the rgb logits stay
// f32.
//
// What bounds it on this card: 593,408 multiply-adds per sample at 8x256
// (L_XYZ 10, L_DIR 4), 1.19 MFLOP, against 196 bytes of input and output
// per sample (126 + 54 in, 16 out): ~6,000 operations per byte, twenty
// times the ~295 where the H100's bf16 tensor cores stop waiting on
// memory.  So the tensor cores bound it; at N = 786,432 the least time is
// 0.934 TFLOP / 989 TFLOP/s = 0.94 ms, the bytes 0.05 ms.
//
// What the design does about that: K6's forward (fused_render_fwd.cu) on
// nerf_wgmlp.cuh's wgmma MLP, without the compositing.  A block (two
// consumer warpgroups, a producer warpgroup streaming every layer's weights
// through a ring of shared-memory stages: mlp_forward_wg and
// produce_forward) strides over 128-row tiles of samples (grid <= SMs).
// Each warp reads its 16 rows of x_enc and d_enc from global memory as the
// layers need them (the layer-0 input, the skip concat, the branch's
// direction columns); each tile's sigma and rgb logits go from the
// epilogues through 2 KB of shared memory straight to preds, no per-ray
// buffer.  Ragged N is masked in the kernel: rows past N load zeros and
// are not written.  Shared memory at 8x256: the 128 x 328 bf16 activation
// tile (83,968 B), the outputs (2,048 B) and a ring of 4 stages of 264 x
// 64 bf16 (135,168 B).  At 8x512 (nerf_wgmlp.cuh's split tile: 64 rows,
// each layer's columns split over the two warpgroups) the 64 x 584 tile
// (74,752 B), the outputs (1,024 B) and 4 stages of 520 x 32 bf16
// (133,120 B): 209,024 B; 4.60 MFLOP a sample; the blocks run in
// clusters of two that share every weight stage, as K1's and the rows
// kernel's (nerf_wgmlp.cuh, "Clusters").
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.

#include "nerf_wgmlp.cuh"

using namespace nkt;

namespace {

struct Params {
  const __nv_bfloat16* x_enc;  // (N, xyz_dim)
  const __nv_bfloat16* d_enc;  // (N, dir_dim)
  const __nv_bfloat16* w;      // the wgmma pack
  const float* b;
  float* preds;  // (N, 4)
  __nv_bfloat16* park;  // (grid, 64, kPassCols): hidden 1024, else null
  long long N;
  int ntiles, stages, stage_bytes;
  MlpDims m;
};

template <int H>
__global__ void __launch_bounds__(kWgThreads, 1)
    fused_mlp_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using T = WgTile<H>;
  constexpr int kRows = T::kRows;
  const MlpDims& m = p.m;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ldx = m.ldx;

  WRing ring;
  ring.full = reinterpret_cast<uint64_t*>(smem);
  ring.empty = ring.full + kMaxStages;
  ring.buf = smem + kBarBytes;
  ring.stages = p.stages;
  ring.stage_bytes = p.stage_bytes;
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(ring.buf + p.stages * p.stage_bytes);
  float* sig = reinterpret_cast<float*>(act + kRows * ldx);  // (rows)
  float* rgbl = sig + kRows;                                  // (rows, 3)

  const int steps = walk_steps<H>(p.ntiles);
  ring_peer<H>(ring);
  if (threadIdx.x == 0) ring_init(ring);
  block_sync<H>();

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one thread copies
    reg_dealloc<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      RingPos rp;
      for (int i = 0; i < steps; ++i) produce_forward(m, p.w, ring, rp, T::kKsTile);
    }
    block_exit<H>();
    return;
  }
  reg_alloc<kConsumerRegs>();

  const int wrow = row_warp<H>() * 16;  // this warp's rows of every tile
  __nv_bfloat16* wact = act + wrow * ldx;
  float* wsig = sig + wrow;
  float* wrgb = rgbl + wrow * 3;
  __nv_bfloat16* wpark = T::kParked ? p.park + ((size_t)blockIdx.x * 64 + wrow) * kPassCols
                                    : nullptr;
  RingPos rp;
  for (int i = 0, tile = blockIdx.x; i < steps; ++i, tile += gridDim.x) {
    if (tile >= p.ntiles) {  // a phantom tile of the split tile's cluster
      drain_forward(m, ring, rp, T::kKsTile);
      continue;
    }
    const long long q0 = (long long)tile * kRows + wrow;  // sample of the warp's row 0
    const int valid = (int)min(16LL, p.N - q0);              // may be <= 0
    auto xf = [&](int row, int c) {
      return row < valid && c < m.xyz_dim ? p.x_enc[(q0 + row) * m.xyz_dim + c]
                                          : __float2bfloat16_rn(0.f);
    };
    auto dir = [&](int row, int c) {
      return row < valid && c < m.dir_dim ? p.d_enc[(q0 + row) * m.dir_dim + c]
                                          : __float2bfloat16_rn(0.f);
    };
    for (int i = peer_lane<H>(); i < 16 * m.xyz_pad; i += T::kLanes) {
      const int row = i / m.xyz_pad, c = i - row * m.xyz_pad;
      wact[row * ldx + c] = xf(row, c);
    }
    rows_sync<H>();
    mlp_forward_wg<H>(m, p.b, wact, xf, dir, wsig, wrgb, valid, ring, rp, wpark);
    float* out = p.preds + q0 * 4;
    for (int i = peer_lane<H>(); i < valid * 4; i += T::kLanes) {
      const int row = i >> 2, c = i & 3;
      out[i] = c < 3 ? wrgb[row * 3 + c] : wsig[row];
    }
    __syncwarp();
  }
  block_exit<H>();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `w_pack` is the wgmma pack
// (ops/kernels/fused_render.py: pack_weights_wg); `dense_desc` is a HOST
// array of n_dense * 5 ints (k_pad, n, n_pad, w_off, b_off) in the order
// trunk[0..num_layers), merged feature+sigma head, branch, rgb.  hidden is
// 64, 128, 256, 512 or 1024.  `grid` blocks (at most the SMs) stride over
// the ceil(N / rows) tiles (wg_rows: 128, or 64 above 256); at hidden 1024
// `park` holds grid x wg_glob_bytes(1024, ., false) bytes (nerf_wgmlp.cuh:
// the column passes' park), else it is ignored.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise and allocates
// nothing.
extern "C" int nkt_fused_mlp_fwd(
    const void* x_enc, const void* d_enc, const void* w_pack, const void* b_pack,
    const void* dense_desc, int n_dense, int num_layers, int skip_layer, int hidden,
    int l_xyz, int l_dir, int N, int grid, void* preds_out, void* park, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  if (N <= 0 || grid <= 0 || !wg_hidden_ok(hidden) || (hidden > kPassCols && park == nullptr) ||
      !mlp_dims_init(p.m, static_cast<const int*>(dense_desc), n_dense, num_layers,
                     skip_layer, hidden, l_xyz, l_dir) ||
      !wg_dims_ok(p.m))
    return (int)cudaErrorInvalidValue;
  p.x_enc = static_cast<const __nv_bfloat16*>(x_enc);
  p.d_enc = static_cast<const __nv_bfloat16*>(d_enc);
  p.w = static_cast<const __nv_bfloat16*>(w_pack);
  p.b = static_cast<const float*>(b_pack);
  p.preds = static_cast<float*>(preds_out);
  p.park = static_cast<__nv_bfloat16*>(park);
  p.N = N;
  const int rows = wg_rows(hidden);
  p.ntiles = (N + rows - 1) / rows;
  p.stage_bytes = wg_stage_bytes(p.m.dense, n_dense, wg_ks(hidden));
  const size_t rest = kBarBytes + sizeof(__nv_bfloat16) * (size_t)rows * p.m.ldx +
                      sizeof(float) * (size_t)rows * 4;
  if (rest + 2 * (size_t)p.stage_bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const size_t fit = ((size_t)kMaxSmem - rest) / p.stage_bytes;
  p.stages = fit < (size_t)kMaxStages ? (int)fit : kMaxStages;
  const size_t smem = rest + (size_t)p.stages * p.stage_bytes;
  void (*kernel)(const Params) = fused_mlp_fwd_kernel<256>;
  if (hidden == 64) kernel = fused_mlp_fwd_kernel<64>;
  if (hidden == 128) kernel = fused_mlp_fwd_kernel<128>;
  if (hidden == 512) kernel = fused_mlp_fwd_kernel<512>;
  if (hidden == 1024) kernel = fused_mlp_fwd_kernel<1024>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hidden > kSplitAbove) {  // clusters of two blocks sharing each weight stage
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int max_clusters = 0;
    err = cluster_config(cfg, attr, kernel, grid, smem, st, &max_clusters);
    if (err != cudaSuccess) return (int)err;
    const int g = split_grid(grid, p.ntiles, max_clusters);
    return (int)(g < kCluster ? cudaErrorInvalidClusterSize
                              : launch_clusters(kernel, g, smem, st, p));
  }
  kernel<<<grid < p.ntiles ? grid : p.ntiles, kWgThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}
