// K5 backward on Hopper: the gradients of the NeRF MLP over encodings.
//
// Replaces the TPU kernel `_bwd_kernel`
// (nerf_keras_tpu/ops/pallas/fused_mlp.py:260, with `_mlp_bwd_tile` :163;
// pl.pallas_call at :393, entry `apply_nerf_mlp_pallas` at :430).
//
// What it computes: given the cotangent g (N, 4) f32 of K5's raw
// predictions [rgb logits, sigma] and the bf16 encodings the forward read,
// the parameter gradients dW/db of the 8x256 skip MLP and, with input
// gradients (the STOP_PDF_GRADIENT=false training mode, where the fine
// samples' t-values stay differentiable through sample_pdf):
//   dd_enc = the branch product's direction columns, per sample;
//   dx_enc = the skip part of each skip layer's input gradient
//            (fused_mlp.py:232-239) + the layer-0 product dPre_0 W_0^T,
//            summed in f32, then rounded once to bf16.
// Operands are bf16 with f32 accumulation; the dPre that feed products
// are bf16, bias gradients sum the f32 dPre, as the TPU kernel does.
//
// What bounds it: the backward's products at 8x256 (L_XYZ 10, L_DIR 4)
// are dW (593,408 MACs per sample) and the dX chain (593,408 with input
// gradients; 557,696 without, which skips the layer-0 product and the
// skip and direction columns): 2.37 MFLOP per sample with input
// gradients, plus the forward recompute (1.19 MFLOP).  dW is summed over
// every sample of the batch (786,432 at the parity step's fine pass) into
// 595,844 f32 parameters: the TPU grid runs in order and keeps dW resident
// in VMEM; Hopper's blocks run in parallel with 227 KB of shared memory.
//
// What the design does about that: K2's structure and code, seeded from
// the per-sample cotangent instead of the compositing VJP.
//   1. k5_rows_kernel: blocks stride over 64-row tiles; per tile
//      nerf_tile.cuh's mlp_backward_tile recomputes the activations from
//      the stored encodings, keeps the ReLU signs as bitmasks, walks the
//      layers in reverse, and writes each layer's bf16 input (A) and dPre
//      (D) to the workspace in nerf_dw.cuh's tiled layout; bias sums stay in shared memory,
//      one partial row per block.  With input gradients the transposed
//      pack carries every input column of every layer (layer 0's rows too,
//      which K2's pack omits), so the products' extra columns are the
//      encoding gradients: dx_enc accumulates in a (64, 64) f32 tile in
//      shared memory (129 KB in all at 8x256: one block per SM; 112 KB
//      without, two per SM), dd_enc goes out from the branch product's
//      tile.
//   2. mlp_dw_kernel and mlp_reduce_kernel (nerf_dw.cuh, K2's): dW = A^T D
//      per layer on wgmma, split over sample ranges, then a fixed-order
//      sum of the slabs and of the per-block bias rows.  K5 keeps one
//      workspace for all N samples (rows padded to 64), not K2's chunks.
// No atomics: the same sums in the same order on every run.  Ragged N is
// masked in the kernel (rows past N have zero cotangent and load zeros;
// their workspace rows are stored and add nothing to dW).  The rows
// kernel keeps nerf_tile.cuh's mma.sync tile; moving it to wgmma is
// queued after K2's.

#include "nerf_dw.cuh"

using namespace nkt;

namespace {

struct RowParams {
  MlpBwdParams mb;             // packs, workspaces, descriptors
  const __nv_bfloat16* x_enc;  // (N, xyz_dim)
  const __nv_bfloat16* d_enc;  // (N, dir_dim)
  const float* g;              // (N, 4)
  float* db_part;              // (grid, total_b)
  __nv_bfloat16* dx_out;       // (N, xyz_dim) or null
  __nv_bfloat16* dd_out;       // (N, dir_dim) or null
  int n, ntiles, total_b;  // samples, 64-row tiles, bias-pack length
};

__global__ void __launch_bounds__(kThreads, 2)
    k5_rows_kernel(const __grid_constant__ RowParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MlpDims& m = p.mb.m;
  const int tid = threadIdx.x;
  const int ldx = m.ldx;
  const int L = m.num_layers;
  const int MW = p.mb.mask_words;

  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf1 = buf0 + kTileRows * ldx;
  uint32_t* masks = reinterpret_cast<uint32_t*>(buf1 + kTileRows * ldx);
  //                 (L + 1) x (64, MW): trunk layers, then the branch
  float* db = reinterpret_cast<float*>(masks + (L + 1) * kTileRows * MW);  // (total_b)
  float* dx_acc = db + p.total_b;  // (64, xyz_pad), with dx_out only

  for (int i = tid; i < p.total_b; i += kThreads) db[i] = 0.f;
  // The first barrier inside mlp_backward_tile orders these writes.
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * kTileRows;
    const int nrows = min(kTileRows, p.n - tile * kTileRows);
    auto dir = [&](int row, int c) {
      return row < nrows && c < m.dir_dim ? p.d_enc[(row0 + row) * m.dir_dim + c]
                                          : __float2bfloat16_rn(0.f);
    };
    mlp_backward_tile(p.mb, buf0, buf1, masks, db, row0, nrows,
                      StoredXenc{p.x_enc, row0, m.xyz_dim}, dir, p.g + row0 * 4, dx_acc,
                      p.dx_out, p.dd_out);
  }
  __syncthreads();
  for (int i = tid; i < p.total_b; i += kThreads)
    p.db_part[(size_t)blockIdx.x * p.total_b + i] = db[i];
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Host arrays: `desc_fwd`
// (n_dense x 5: k_pad, n, n_pad, w_off, b_off of K1's pack), `desc_bwd`
// (the same for the transposed pack: K2's, or with dx_out/dd_out the
// full one whose every layer has all its input columns), `desc_ws`
// (n_dense x 5: a_col, a_width, d_col, d_width, out_off), in the order
// trunk[0..num_layers), merged head, branch, rgb.  Workspaces (allocated
// by the caller): ws_a (N64 x sum a_width) and ws_d (N64 x sum d_width)
// bf16, N64 = round_up(N, 64),
// db_part (grid x total_b) and dw_part (nsplit x total_out) f32.  Outputs
// dw (total_out) and db (total_b) f32, and where given dx_out (N, xyz_dim)
// and dd_out (N, dir_dim) bf16.  The workspaces hold round_up(N, 64) rows
// per layer in nerf_dw.cuh's tiled layout.  `grid` blocks stride over the ceil(N/64)
// tiles (at most that many).  Launches on `stream`, returns the first
// CUDA error (0 on success); does not synchronise.
extern "C" int nkt_fused_mlp_bwd(
    const void* x_enc, const void* d_enc, const void* g, const void* w_pack,
    const void* b_pack, const void* desc_fwd, const void* wb_pack, const void* desc_bwd,
    const void* desc_ws, int n_dense, int num_layers, int skip_layer, int hidden,
    int l_xyz, int l_dir, int N, int total_b, int total_out, void* ws_a, void* ws_d,
    void* db_part, int grid, void* dw_part, int nsplit, void* dw_out, void* db_out,
    void* dx_out, void* dd_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  RowParams p;
  MlpBwdParams& mb = p.mb;
  if (N <= 0 || nsplit < 1 || grid < 1 ||
      !mlp_dims_init(mb.m, static_cast<const int*>(desc_fwd), n_dense, num_layers,
                     skip_layer, hidden, l_xyz, l_dir) ||
      !mlp_bwd_init(mb, static_cast<const int*>(desc_bwd), static_cast<const int*>(desc_ws),
                    n_dense))
    return (int)cudaErrorInvalidValue;
  const MlpDims& m = mb.m;
  p.ntiles = (N + kTileRows - 1) / kTileRows;
  if (grid > p.ntiles) return (int)cudaErrorInvalidValue;
  // Input gradients need the full transposed pack: layer 0's rows, the
  // skip columns of every layer whose input is [h, x_enc], the branch's
  // direction columns.
  if (dx_out != nullptr) {
    if (mb.bdense[0].n != m.xyz_dim) return (int)cudaErrorInvalidValue;
    for (int i = 1; i <= num_layers; ++i)
      if (is_skip(i - 1, skip_layer) && mb.bdense[i].n != hidden + m.xyz_dim)
        return (int)cudaErrorInvalidValue;
  }
  if (dd_out != nullptr && mb.bdense[num_layers + 1].n != hidden + m.dir_dim)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  mb.w = static_cast<const __nv_bfloat16*>(w_pack);
  mb.b = static_cast<const float*>(b_pack);
  mb.wb = static_cast<const __nv_bfloat16*>(wb_pack);
  mb.ws_a = static_cast<__nv_bfloat16*>(ws_a);
  mb.ws_d = static_cast<__nv_bfloat16*>(ws_d);
  mb.N = round_up(N, kTileRows);
  p.n = N;
  p.x_enc = static_cast<const __nv_bfloat16*>(x_enc);
  p.d_enc = static_cast<const __nv_bfloat16*>(d_enc);
  p.g = static_cast<const float*>(g);
  p.db_part = static_cast<float*>(db_part);
  p.dx_out = static_cast<__nv_bfloat16*>(dx_out);
  p.dd_out = static_cast<__nv_bfloat16*>(dd_out);
  p.total_b = total_b;

  const size_t smem =
      sizeof(__nv_bfloat16) * (size_t)2 * kTileRows * m.ldx +
      sizeof(uint32_t) * (size_t)(num_layers + 1) * kTileRows * mb.mask_words +
      sizeof(float) * ((size_t)total_b +
                       (dx_out != nullptr ? (size_t)kTileRows * m.xyz_pad : 0));
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(k5_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  k5_rows_kernel<<<grid, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  DwPlan dw;
  if (!dw_plan(dw, mb, n_dense, mb.N, total_out, nsplit, static_cast<float*>(dw_part)))
    return (int)cudaErrorInvalidValue;
  err = launch_dw(dw, mb.N / kDwRows, false, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(static_cast<float*>(dw_part), nsplit, total_out,
                            static_cast<float*>(dw_out), p.db_part, grid, total_b,
                            static_cast<float*>(db_out), st);
}
