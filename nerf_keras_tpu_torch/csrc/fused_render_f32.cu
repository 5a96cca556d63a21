// The float32 kernels (COMPUTE_DTYPE=float32): K1, K2, K3, K5 and K6 with
// every product in true f32.
//
// Replaces the TPU kernels of nerf_keras_tpu/ops/pallas/fused_render.py
// and fused_mlp.py in their float32 instantiation, where the JAX package
// pins Precision.HIGHEST ("COMPUTE_DTYPE=float32 must mean true f32",
// fused_mlp.py:89-110): `_fwd_encode_kernel` (:709, K1, with its
// `emit_enc` residual), `_bwd_xres_kernel` (:453, K2), `_bwd_encode_kernel`
// (:425, K3), `_fwd_kernel`/`_bwd_kernel` (:336/:350, K6) and fused_mlp.py's
// `_fwd_kernel`/`_bwd_kernel` (:148/:260, K5, with input gradients).
//
// What it computes: the bf16 kernels' functions (fused_render_fwd.cu,
// fused_render_bwd.cu, fused_mlp_fwd.cu) with nothing rounded to bf16: the
// encodings, every activation, K1's x_enc residual (f32, 252 B a sample at
// L_XYZ 10), the cotangents, the dW workspaces and the weight gradients
// stay f32.  The compositing and its VJP are K1's and K2's device code
// (nerf_tile.cuh: encode_feature, composite_rays, composite_vjp_kernel),
// so the numerics of the 1e10 terminal delta, the delta * exp(-sigma *
// delta) bracket and max(1 - alpha, 0) + 1e-10 are theirs; the VJP runs in
// double here (a few operations a sample), because its cancelling terms
// would carry f32 rounding into the sigma head's gradient.  Any hidden
// width up to 256 and any encoding up to 128 position and 64 direction
// columns: the pack is built at the model's true widths.
//
// What bounds it on this card: the products.  Hopper has no f32 tensor-core
// product, and TF32 is off by the port's precision rule, so every
// multiply-add is an FFMA on the CUDA cores: 1.19 MFLOP a sample forward at
// 8x256, at a peak of SMs x 128 lanes x 2 x clock (~67 TFLOP/s on an H100
// SXM), about 15x below the bf16 tensor cores.  Device memory is far below
// that (a few hundred bytes a sample).
//
// What the design does about that (simple first; fast is later work):
//   * A block of 256 threads owns a tile of 64 samples and runs it through
//     the whole MLP.  The activations stay in shared memory as one f32
//     tile stored k-major (row k of the tile holds column k of all 64
//     samples, 68 floats apart), updated in place layer by layer.
//   * A layer's product streams the weights through shared memory in
//     stages of 16 rows (k), double-buffered with asynchronous copies
//     (cp.async), the next stage in flight while this one is multiplied.
//     It gives each thread a 4-sample x 4-column block of
//     every 64-column chunk of the output (up to 6 chunks: hidden 256 and
//     123 position columns, K5's skip layers with input gradients): per k
//     one 16-byte load of the tile and one 16-byte load of the weight row
//     per chunk feed 16 FFMAs per chunk.  The weights are (k, n)
//     row-major f32, padded to 64 columns, L2-resident (shared by every
//     block).
//   * The forward writes raw predictions (N, 4); a second kernel
//     composites one ray per warp (composite_rays).
//   * The backward recomputes the tile's forward, storing every layer's
//     input (A) in a workspace, walks back with the transposed matrices
//     (the ReLU masks read back from A), storing every dPre (D), and sums
//     the bias gradients per block; then an f32 product dW = A^T D per
//     layer over the chunk's samples, in 64 x 64 output tiles split over
//     sample ranges (each tile's 64-sample sums added with Kahan's
//     compensation), and the reduce of nerf_dw.cuh sums the splits and the
//     blocks in a fixed order.  No atomics: the same sums on every run.
//     The workspace holds one chunk of whole rays (chunk_plan), 4 bytes a
//     sample per layer input and output column (~20 KB at 8x256).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC, never -use_fast_math (the top octave's sin and
//        cos take thousands of radians).  FFMA contraction stays on.

#include "nerf_dw.cuh"
#include "nerf_tile.cuh"

using namespace nkt;

namespace {

constexpr int kRows = 64;        // samples per tile
constexpr int kTS = kRows + 4;   // the tile's row stride (floats): 16-byte rows, fewer conflicts
constexpr int kThreads = 256;
constexpr int kMaxChunks = 6;    // 64-column chunks of a product's output: up to 384
constexpr int kMaxWidth = 384;   // hidden 256 + 128 position columns
constexpr int kKT = 16;          // weight rows (k) per shared-memory stage
constexpr int kWStage = kKT * kMaxChunks * 64;  // floats per stage
constexpr int kWBuf = 2 * kWStage;              // the double-buffered stages

// One dense layer of the f32 pack (fused_render_f32.py's pack_f32): the
// forward matrix (k, round64(n)) and the transposed one (n, round64(k)),
// row-major, and the bias (n).
struct F32Layer {
  int k, n, f_off, t_off, b_off;
};

struct F32Net {
  int num_layers, skip_layer, hidden, xyz_dim, dir_dim, tile_rows;
  F32Layer L[kMaxDense];
};

__host__ __device__ inline int ld64(int x) { return round_up(x, 64); }

// Host: the network from the launch arguments and the pack's descriptors
// (a host array of n_dense x 5 ints: k, n, f_off, t_off, b_off); false when
// a shape is out of what the kernels take.
bool net_init(F32Net& m, const int* desc, int n_dense, int num_layers, int skip_layer,
              int hidden, int l_xyz, int l_dir) {
  if (num_layers < 1 || skip_layer < 1 || hidden < 1 || hidden > 256 || l_xyz < 0 ||
      l_dir < 0 || n_dense != num_layers + 3 || n_dense > kMaxDense)
    return false;
  m.num_layers = num_layers;
  m.skip_layer = skip_layer;
  m.hidden = hidden;
  m.xyz_dim = 3 + 6 * l_xyz;
  m.dir_dim = 3 + 6 * l_dir;
  if (m.xyz_dim > 128 || m.dir_dim > 64) return false;
  m.tile_rows = 0;
  for (int i = 0; i < n_dense; ++i) {
    F32Layer& d = m.L[i];
    d = F32Layer{desc[i * 5], desc[i * 5 + 1], desc[i * 5 + 2], desc[i * 5 + 3], desc[i * 5 + 4]};
    if (d.k < 1 || d.n < 1 || d.k > kMaxWidth || d.f_off % 4 || d.t_off % 4) return false;
    m.tile_rows = d.k > m.tile_rows ? d.k : m.tile_rows;
    m.tile_rows = d.n > m.tile_rows ? d.n : m.tile_rows;
  }
  const int H = hidden, L = num_layers;
  for (int i = 0; i < L; ++i) {
    const int k = i == 0 ? m.xyz_dim : (is_skip(i - 1, skip_layer) ? H + m.xyz_dim : H);
    if (m.L[i].k != k || m.L[i].n != H) return false;
  }
  const int kh = is_skip(L - 1, skip_layer) ? H + m.xyz_dim : H;
  if (m.L[L].k != kh || m.L[L].n != H + 1 || m.L[L + 1].k != H + m.dir_dim ||
      m.L[L + 1].n != H / 2 || m.L[L + 2].k != H / 2 || m.L[L + 2].n != 3)
    return false;
  // The walk's products write up to hidden + the position columns.
  const int widest = H + (m.xyz_dim > m.dir_dim ? m.xyz_dim : m.dir_dim);
  m.tile_rows = round_up(m.tile_rows > widest ? m.tile_rows : widest, 4);
  return m.tile_rows <= kMaxWidth;
}

// ---------------------------------------------------------------------------
// The product of a tile: acc[j][4 i + c] = sum_k tile[k][4 rg + i] * M[k][64 j
// + 4 cg + c] for j < nch (rg = tid / 16, cg = tid % 16); M (K, ldm) row-major.

using Acc = float[kMaxChunks][16];

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Rows [k0, k0 + kKT) of M (those below K), their first w columns, into
// the stage `buf` (row stride w), as 16-byte asynchronous copies.
__device__ __forceinline__ void stage_rows(float* buf, const float* M, int ldm, int k0, int K,
                                           int w) {
  const int rows = min(kKT, K - k0), vec = w >> 2;
  for (int i = threadIdx.x; i < rows * vec; i += kThreads) {
    const int r = i / vec, c = (i - r * vec) * 4;
    cp_async16(buf + r * w + c, M + (size_t)(k0 + r) * ldm + c);
  }
}

// The weights go through `wbuf` (kWBuf floats of shared memory) in stages
// of kKT rows, the next stage copied while this one is multiplied.  Every
// thread of the block calls it; it ends with a barrier.
__device__ __forceinline__ void tile_product(Acc& acc, const float* tile, int K, const float* M,
                                             int ldm, int nch, float* wbuf) {
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[j][e] = 0.f;
  const int w = 64 * nch;
  const float* ap = tile + 4 * rg;
  stage_rows(wbuf, M, ldm, 0, K, w);
  cp_async_commit();
  int cur = 0;
  for (int k0 = 0; k0 < K; k0 += kKT) {
    if (k0 + kKT < K) stage_rows(wbuf + (cur ^ 1) * kWStage, M, ldm, k0 + kKT, K, w);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* ws = wbuf + cur * kWStage + 4 * cg;
    const int kn = min(kKT, K - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(ap + (k0 + kk) * kTS);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        if (j < nch) {
          const float4 wv4 = *reinterpret_cast<const float4*>(ws + kk * w + 64 * j);
          const float wv[4] = {wv4.x, wv4.y, wv4.z, wv4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[j][4 * i + c] = fmaf(av[i], wv[c], acc[j][4 * i + c]);
        }
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

// epi(col, row0, v[4]) for each of the thread's output columns col < n:
// v holds rows row0 .. row0 + 3.
template <class Epi>
__device__ __forceinline__ void tile_epilogue(const Acc& acc, int n, Epi epi) {
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 64 * j + 4 * cg + c;
      if (col < n) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = acc[j][4 * i + c];
        epi(col, 4 * rg, v);
      }
    }
}

__device__ __forceinline__ int chunks(int n) { return (n + 63) / 64; }

__device__ __forceinline__ void store4(float* tile, int col, int row0, const float v[4]) {
  *reinterpret_cast<float4*>(tile + col * kTS + row0) = make_float4(v[0], v[1], v[2], v[3]);
}

// tile rows [col0, col0 + w) = f(r, c) for samples r < valid, else 0.
template <class F>
__device__ __forceinline__ void load_cols(float* tile, int col0, int w, int valid, F f) {
  for (int i = threadIdx.x; i < w * kRows; i += kThreads) {
    const int c = i / kRows, r = i - c * kRows;
    tile[(col0 + c) * kTS + r] = r < valid ? f(r, c) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// The forward of one tile.  xf(r, c) / df(r, c): the position and direction
// features of sample r (r < valid).  on_input(i): the tile holds layer i's
// input (rows [0, k)); a barrier follows.  Raw predictions of rows < valid
// go to preds (row stride 4) when it is given.
template <class XF, class DF, class OnInput>
__device__ void forward_tile(const F32Net& m, const float* pack, float* tile, float* wbuf,
                             XF xf, DF df, float* preds, int valid, OnInput on_input) {
  const int H = m.hidden, L = m.num_layers;
  load_cols(tile, 0, m.xyz_dim, valid, xf);
  __syncthreads();
  Acc acc;
  for (int i = 0; i < L; ++i) {
    const F32Layer& d = m.L[i];
    on_input(i);
    __syncthreads();
    tile_product(acc, tile, d.k, pack + d.f_off, ld64(d.n), chunks(d.n), wbuf);
    __syncthreads();
    const float* b = pack + d.b_off;
    tile_epilogue(acc, d.n, [&](int col, int row0, float* v) {
      for (int q = 0; q < 4; ++q) v[q] = fmaxf(v[q] + b[col], 0.f);
      store4(tile, col, row0, v);
    });
    if (is_skip(i, m.skip_layer)) load_cols(tile, H, m.xyz_dim, valid, xf);
    __syncthreads();
  }
  {  // the merged feature+sigma head: feature (no ReLU) in place, sigma out
    const F32Layer& d = m.L[L];
    on_input(L);
    __syncthreads();
    tile_product(acc, tile, d.k, pack + d.f_off, ld64(d.n), chunks(d.n), wbuf);
    __syncthreads();
    const float* b = pack + d.b_off;
    tile_epilogue(acc, d.n, [&](int col, int row0, float* v) {
      for (int q = 0; q < 4; ++q) v[q] += b[col];
      if (col < H) {
        store4(tile, col, row0, v);
      } else if (preds != nullptr) {
        for (int q = 0; q < 4; ++q)
          if (row0 + q < valid) preds[(row0 + q) * 4 + 3] = v[q];
      }
    });
    load_cols(tile, H, m.dir_dim, valid, df);
    __syncthreads();
  }
  {  // the branch over [feature, d_enc]
    const F32Layer& d = m.L[L + 1];
    on_input(L + 1);
    __syncthreads();
    tile_product(acc, tile, d.k, pack + d.f_off, ld64(d.n), chunks(d.n), wbuf);
    __syncthreads();
    const float* b = pack + d.b_off;
    tile_epilogue(acc, d.n, [&](int col, int row0, float* v) {
      for (int q = 0; q < 4; ++q) v[q] = fmaxf(v[q] + b[col], 0.f);
      store4(tile, col, row0, v);
    });
    __syncthreads();
  }
  {  // the rgb head
    const F32Layer& d = m.L[L + 2];
    on_input(L + 2);
    __syncthreads();
    tile_product(acc, tile, d.k, pack + d.f_off, ld64(d.n), 1, wbuf);
    __syncthreads();
    const float* b = pack + d.b_off;
    tile_epilogue(acc, d.n, [&](int col, int row0, float* v) {
      if (preds == nullptr) return;
      for (int q = 0; q < 4; ++q)
        if (row0 + q < valid) preds[(row0 + q) * 4 + col] = v[q] + b[col];
    });
    __syncthreads();
  }
}

// K1's point of sample q (o + d * t rounded as two operations, as the
// plain path and the bf16 kernels) and its position feature c.
__device__ __forceinline__ float ray_feature(const float* origins, const float* dirs,
                                             const float* t_vals, long long q, int S, int c,
                                             int dim) {
  const long long ray = q / S;
  const float* o = origins + ray * 3;
  const float* d = dirs + ray * 3;
  const float t = t_vals[q];
  const float x[3] = {__fadd_rn(o[0], __fmul_rn(d[0], t)), __fadd_rn(o[1], __fmul_rn(d[1], t)),
                      __fadd_rn(o[2], __fmul_rn(d[2], t))};
  return encode_feature(x, c, dim);
}

struct FwdParams {
  const float* origins;  // (B, 3): K1
  const float* dirs;     // (B, 3): K1
  const float* t_vals;   // (B, S): K1
  const float* x_in;     // (N, xyz_dim): K5, K6
  const float* d_in;     // (N, dir_dim): K5, K6
  const float* pack;
  float* xenc_out;       // (N, xyz_dim) or null: K1's training residual
  float* preds;          // (N, 4)
  long long N;
  int S;
  F32Net m;
};

__global__ void __launch_bounds__(kThreads, 1) f32_fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ __align__(16) float smem[];
  float* wbuf = smem;
  float* tile = smem + kWBuf;
  const F32Net& m = p.m;
  const long long q0 = (long long)blockIdx.x * kRows;
  const int valid = (int)min((long long)kRows, p.N - q0);
  auto none = [](int) {};
  if (p.x_in != nullptr) {
    auto xf = [&](int r, int c) { return p.x_in[(q0 + r) * m.xyz_dim + c]; };
    auto df = [&](int r, int c) { return p.d_in[(q0 + r) * m.dir_dim + c]; };
    forward_tile(m, p.pack, tile, wbuf, xf, df, p.preds + q0 * 4, valid, none);
    return;
  }
  auto xf = [&](int r, int c) {
    const float v = ray_feature(p.origins, p.dirs, p.t_vals, q0 + r, p.S, c, m.xyz_dim);
    if (p.xenc_out != nullptr) p.xenc_out[(q0 + r) * m.xyz_dim + c] = v;
    return v;
  };
  auto df = [&](int r, int c) {
    return encode_feature(p.dirs + ((q0 + r) / p.S) * 3, c, m.dir_dim);
  };
  forward_tile(m, p.pack, tile, wbuf, xf, df, p.preds + q0 * 4, valid, none);
}

// One warp per ray: weights and rgb from the (N, 4) predictions.
__global__ void __launch_bounds__(256) f32_composite_kernel(const float* t_vals,
                                                            const float* preds, int B, int S,
                                                            float* w_out, float* rgb_out) {
  const int r0 = blockIdx.x * kWarps;
  const size_t s0 = (size_t)r0 * S;
  composite_rays<4, 4>(t_vals + s0, preds + s0 * 4 + 3, preds + s0 * 4, min(kWarps, B - r0), S,
                       w_out + s0, rgb_out + (size_t)r0 * 3);
}

// ---------------------------------------------------------------------------
// The backward.

enum RowsMode {
  kResidual = 0,     // K2: x_enc residual (f32), directions encoded per sample
  kRecompute = 1,    // K3: x_enc encoded from (origins, dirs, t)
  kEncodingsIn = 2,  // K6: x_enc and d_enc per sample, as given
  kK5 = 3,           // K5: as K6, seeded from the caller's g (no compositing)
};

// Per dense layer, where its backward lives in the workspaces: A (input)
// of a_width = k columns at ws_a + N * a_col, D (dPre) of d_width = n at
// ws_d + N * d_col, each stored in 64-sample tiles, k-major within a tile
// (element (r, c) at (r / 64) * 64 * width + c * 64 + r % 64); dW (k, n)
// row-major at dw + out_off.
struct Ws {
  int a_col, a_width, d_col, d_width, out_off;
};

struct RowParams {
  F32Net m;
  Ws ws[kMaxDense];
  const float* pack;
  const float* x_res;   // (N, xyz_dim): K2's residual, K5's and K6's x_enc
  const float* origins;
  const float* dirs;
  const float* d_enc;   // (N, dir_dim): K5, K6
  const float* t_vals;
  const float* dpreds;  // (N, 4)
  float* ws_a;
  float* ws_d;
  float* db_part;       // (grid, total_b)
  float* dx_out;        // (N, xyz_dim) or null: K5's input gradients
  float* dd_out;        // (N, dir_dim) or null
  long long n0;         // the chunk's first sample
  long long rows_pad;   // workspace rows per layer
  int nc, ntiles, S, total_b, accumulate, mode;
};

__global__ void __launch_bounds__(kThreads, 1) f32_rows_kernel(const __grid_constant__ RowParams p) {
  extern __shared__ __align__(16) float smem[];
  const F32Net& m = p.m;
  const int H = m.hidden, L = m.num_layers;
  const bool ig = p.dx_out != nullptr || p.dd_out != nullptr;
  float* wbuf = smem;                                   // the weight stages
  float* tile = smem + kWBuf;                           // (tile_rows, kTS)
  float* db = tile + (size_t)m.tile_rows * kTS;          // (total_b)
  float* xs = db + round_up(p.total_b, 4);              // (xyz_dim, kTS): dx_enc, with ig
  for (int i = threadIdx.x; i < p.total_b; i += kThreads) db[i] = 0.f;
  __syncthreads();

  for (int tile_i = blockIdx.x; tile_i < p.ntiles; tile_i += gridDim.x) {
    const int rbase = tile_i * kRows;           // workspace row of the tile's sample 0
    const long long q0 = p.n0 + rbase;          // its sample
    const int valid = min(kRows, p.nc - rbase);
    const float* g = p.dpreds + q0 * 4;
    auto ws_a = [&](int i) { return p.ws_a + p.rows_pad * p.ws[i].a_col + (size_t)rbase * p.ws[i].a_width; };
    auto ws_d = [&](int i) { return p.ws_d + p.rows_pad * p.ws[i].d_col + (size_t)rbase * p.ws[i].d_width; };
    auto store_a = [&](int i) {
      float* dst = ws_a(i);
      for (int e = threadIdx.x; e < m.L[i].k * kRows; e += kThreads) {
        const int c = e / kRows, r = e - c * kRows;
        dst[e] = tile[c * kTS + r];
      }
    };
    auto xf = [&](int r, int c) -> float {
      const long long q = q0 + r;
      if (p.mode == kRecompute) return ray_feature(p.origins, p.dirs, p.t_vals, q, p.S, c, m.xyz_dim);
      return p.x_res[q * m.xyz_dim + c];
    };
    auto df = [&](int r, int c) -> float {
      const long long q = q0 + r;
      if (p.mode == kEncodingsIn || p.mode == kK5) return p.d_enc[q * m.dir_dim + c];
      return encode_feature(p.dirs + (q / p.S) * 3, c, m.dir_dim);
    };
    forward_tile(m, p.pack, tile, wbuf, xf, df, nullptr, valid, store_a);
    if (ig)
      for (int e = threadIdx.x; e < m.xyz_dim * kTS; e += kThreads) xs[e] = 0.f;

    // Store dPre of layer i (rows [0, n) of the tile) and add its column sums
    // into the bias gradients (rows >= valid are 0).
    auto finish = [&](int i) {
      const int n = m.L[i].n;
      float* dst = ws_d(i);
      for (int e = threadIdx.x; e < n * kRows; e += kThreads) {
        const int c = e / kRows, r = e - c * kRows;
        dst[e] = tile[c * kTS + r];
      }
      float* dbl = db + m.L[i].b_off - m.L[0].b_off;
      for (int c = threadIdx.x; c < n; c += kThreads) {
        float s = 0.f;
        for (int r = 0; r < kRows; ++r) s += tile[c * kTS + r];
        dbl[c] += s;
      }
      __syncthreads();
    };
    // dX of layer i: the columns below `xcol` (the hidden ones) masked by
    // the ReLU of the layer below (A of `mask_layer` > 0) into the tile, and
    // with ig the position columns (from `xcol`) added into xs.
    Acc acc;
    auto dx_product = [&](int i, int n_out, int mask_layer, int xcol) {
      const F32Layer& d = m.L[i];
      tile_product(acc, tile, d.n, p.pack + d.t_off, ld64(d.k), chunks(n_out), wbuf);
      __syncthreads();
      const float* a = ws_a(mask_layer);
      tile_epilogue(acc, n_out, [&](int col, int row0, float* v) {
        if (col >= xcol) {
          float* x = xs + (col - xcol) * kTS + row0;
          for (int q = 0; q < 4; ++q) x[q] += v[q];
        } else {
          for (int q = 0; q < 4; ++q)
            if (!(a[col * kRows + row0 + q] > 0.f)) v[q] = 0.f;
          store4(tile, col, row0, v);
        }
      });
      __syncthreads();
    };

    // ---- The walk.  d rgb logits.
    load_cols(tile, 0, 3, valid, [&](int r, int c) { return g[r * 4 + c]; });
    __syncthreads();
    finish(L + 2);
    // dh2 = drgb W_rgb^T, masked by h2 > 0 (A of the rgb head): the branch's dPre.
    dx_product(L + 2, H / 2, L + 2, kMaxWidth);
    finish(L + 1);
    {  // dfeature = dh2 W_br^T; with ig the direction columns: dd_enc.
      const F32Layer& d = m.L[L + 1];
      const int n_out = H + (p.dd_out != nullptr ? m.dir_dim : 0);
      tile_product(acc, tile, d.n, p.pack + d.t_off, ld64(d.k), chunks(n_out), wbuf);
      __syncthreads();
      tile_epilogue(acc, n_out, [&](int col, int row0, float* v) {
        if (col < H) {
          store4(tile, col, row0, v);
        } else {
          for (int q = 0; q < 4; ++q)
            if (row0 + q < valid) p.dd_out[(q0 + row0 + q) * m.dir_dim + col - H] = v[q];
        }
      });
      load_cols(tile, H, 1, valid, [&](int r, int) { return g[r * 4 + 3]; });
      __syncthreads();
    }
    finish(L);  // the merged head's dPre: [dfeature, dsigma]
    // dh_{L-1} = dfs W_fs^T (hidden columns), masked: dPre_{L-1}.
    const bool x_here = p.dx_out != nullptr;
    dx_product(L, H + (x_here && is_skip(L - 1, m.skip_layer) ? m.xyz_dim : 0), L, H);
    for (int i = L - 1; i >= 0; --i) {
      finish(i);
      if (i > 0) dx_product(i, H + (x_here && is_skip(i - 1, m.skip_layer) ? m.xyz_dim : 0), i, H);
    }
    if (x_here) {
      // Layer 0's input is the encoding alone: its product adds into xs.
      dx_product(0, m.xyz_dim, 0, 0);
      for (int e = threadIdx.x; e < valid * m.xyz_dim; e += kThreads) {
        const int r = e / m.xyz_dim, c = e - r * m.xyz_dim;
        p.dx_out[(q0 + r) * m.xyz_dim + c] = xs[c * kTS + r];
      }
      __syncthreads();
    }
  }
  float* out = p.db_part + (size_t)blockIdx.x * p.total_b;
  for (int i = threadIdx.x; i < p.total_b; i += kThreads)
    out[i] = p.accumulate ? out[i] + db[i] : db[i];
}

// dW = A^T D over a chunk: one 64 x 64 tile of one layer's dW per block
// (4 x 4 a thread), over the sample tiles [s * per, (s + 1) * per) of
// split s = blockIdx.y, written (or, for a later chunk, added) to the
// split's slab.
struct DwParams {
  Ws ws[kMaxDense];
  int tile_start[kMaxDense + 1];
  const float* ws_a;
  const float* ws_d;
  float* part;  // (nsplit, total_out)
  long long rows_pad;
  int n_layers, total_out, ntiles, per, accumulate;
};

__global__ void __launch_bounds__(kThreads) f32_dw_kernel(const __grid_constant__ DwParams p) {
  __shared__ __align__(16) float as[kRows * kTS];  // A: (k, sample), k-major
  __shared__ __align__(16) float ds[kRows * kTS];  // D: (sample, n), sample-major
  int li = 0;
  while (li + 1 < p.n_layers && (int)blockIdx.x >= p.tile_start[li + 1]) ++li;
  const Ws& w = p.ws[li];
  const int t = blockIdx.x - p.tile_start[li];
  const int ntn = (w.d_width + 63) / 64;
  const int k0 = (t / ntn) * 64, n0 = (t % ntn) * 64;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  // Per sample tile a fresh sum of 64 products, added into the total with
  // Kahan's compensation: the total over hundreds of thousands of samples
  // keeps f32 accuracy.
  float total[16], comp[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) total[e] = comp[e] = 0.f;
  const int s0 = blockIdx.y * p.per, s1 = min(s0 + p.per, p.ntiles);
  const float* a_base = p.ws_a + p.rows_pad * w.a_col;
  const float* d_base = p.ws_d + p.rows_pad * w.d_col;
  for (int st = s0; st < s1; ++st) {
    const float* a = a_base + (size_t)st * kRows * w.a_width;
    const float* d = d_base + (size_t)st * kRows * w.d_width;
    for (int e = tid; e < 64 * kRows; e += kThreads) {
      const int c = e / kRows, r = e - c * kRows;
      as[c * kTS + r] = k0 + c < w.a_width ? a[(size_t)(k0 + c) * kRows + r] : 0.f;
      ds[r * kTS + c] = n0 + c < w.d_width ? d[(size_t)(n0 + c) * kRows + r] : 0.f;
    }
    __syncthreads();
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      const float4 dv = *reinterpret_cast<const float4*>(ds + r * kTS + 4 * cg);
      const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = as[(4 * rg + i) * kTS + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[4 * i + c] = fmaf(av, dd[c], acc[4 * i + c]);
      }
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float y = __fsub_rn(acc[e], comp[e]);
      const float t = __fadd_rn(total[e], y);
      comp[e] = __fsub_rn(__fsub_rn(t, total[e]), y);
      total[e] = t;
    }
    __syncthreads();
  }
  float* out = p.part + (size_t)blockIdx.y * p.total_out + w.out_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * rg + i;
    if (k >= w.a_width) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + 4 * cg + c;
      if (n >= w.d_width) continue;
      float* o = out + (size_t)k * w.d_width + n;
      *o = p.accumulate ? *o + total[4 * i + c] : total[4 * i + c];
    }
  }
}

size_t rows_smem(const F32Net& m, int total_b, bool ig) {
  return sizeof(float) * ((size_t)kWBuf + (size_t)m.tile_rows * kTS + round_up(total_b, 4) +
                          (ig ? (size_t)m.xyz_dim * kTS : 0));
}

}  // namespace

// Plain C entry points, loaded with ctypes.  `pack` is the f32 pack
// (pack_f32) and `desc` a HOST array of n_dense x 5 ints (k, n, f_off,
// t_off, b_off) in the order trunk[0..num_layers), merged feature+sigma
// head, branch, rgb.  Each launches on `stream` and returns
// cudaGetLastError() (0 on success); neither synchronises or allocates.
//
// nkt_f32_fwd: K1 (origins, dirs given; x_in, d_in null), K6 (x_in, d_in
// per sample) or, with rgb_out and w_out null, K5's forward (x_in, d_in,
// S = 1).  preds_out (B*S, 4) is always written; xenc_out (K1 only) may be
// null.
extern "C" int nkt_f32_fwd(const void* origins, const void* dirs, const void* t_vals,
                           const void* x_in, const void* d_in, const void* pack,
                           const void* desc, int n_dense, int num_layers, int skip_layer,
                           int hidden, int l_xyz, int l_dir, int B, int S, void* rgb_out,
                           void* w_out, void* xenc_out, void* preds_out, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool enc_in = x_in != nullptr;
  const bool composite = rgb_out != nullptr;
  const bool ok = (enc_in ? d_in != nullptr && origins == nullptr && xenc_out == nullptr
                          : origins != nullptr && dirs != nullptr && t_vals != nullptr &&
                                d_in == nullptr && composite) &&
                  (composite == (w_out != nullptr)) && (!composite || t_vals != nullptr) &&
                  preds_out != nullptr && B > 0 && (composite ? S >= 2 : S == 1);
  FwdParams p;
  if (!ok || !net_init(p.m, static_cast<const int*>(desc), n_dense, num_layers, skip_layer,
                       hidden, l_xyz, l_dir))
    return (int)cudaErrorInvalidValue;
  p.origins = static_cast<const float*>(origins);
  p.dirs = static_cast<const float*>(dirs);
  p.t_vals = static_cast<const float*>(t_vals);
  p.x_in = static_cast<const float*>(x_in);
  p.d_in = static_cast<const float*>(d_in);
  p.pack = static_cast<const float*>(pack);
  p.xenc_out = static_cast<float*>(xenc_out);
  p.preds = static_cast<float*>(preds_out);
  p.N = (long long)B * S;
  p.S = S;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * ((size_t)kWBuf + (size_t)p.m.tile_rows * kTS);
  err = cudaFuncSetAttribute(f32_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  f32_fwd_kernel<<<(unsigned)((p.N + kRows - 1) / kRows), kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || !composite) return (int)err;
  f32_composite_kernel<<<(B + kWarps - 1) / kWarps, 256, 0, st>>>(
      p.t_vals, p.preds, B, S, static_cast<float*>(w_out), static_cast<float*>(rgb_out));
  return (int)cudaGetLastError();
}

// nkt_f32_bwd: the backward in `mode` (0 K2: x_res = K1's f32 residual and
// dirs; 1 K3: origins and dirs; 2 K6: x_res = x_enc and d_enc; 3 K5: x_res
// = x_enc, d_enc, dpreds = the caller's g (N, 4), S = 1, with dx_out /
// dd_out (f32) where given).  K2, K3 and K6 first run the compositing VJP
// from preds, g_rgb and g_w (may be null) into dpreds.  Then, per chunk of
// chunk_rays rays, the rows kernel (`grid` blocks, its bias sums into
// db_part) and the dW product (nsplit slabs of dw_part), and at the end the
// reduce into dw_out (total_out: every layer's (k, n) dW, row-major, at
// desc_ws's out_off) and db_out (total_b, the pack's bias layout from the
// first layer's b_off).  desc_ws: a HOST array of n_dense x 5 ints (a_col,
// a_width, d_col, d_width, out_off); ws_a and ws_d hold round64(chunk_rays
// * S) samples per layer.
extern "C" int nkt_f32_bwd(int mode, const void* x_res, const void* origins, const void* dirs,
                           const void* d_enc, const void* t_vals, const void* preds,
                           const void* g_rgb, const void* g_w, const void* pack,
                           const void* desc, const void* desc_ws, int n_dense, int num_layers,
                           int skip_layer, int hidden, int l_xyz, int l_dir, int B, int S,
                           int chunk_rays, int total_b, int total_out, void* dpreds, void* ws_a,
                           void* ws_d, void* db_part, int grid, void* dw_part, int nsplit,
                           void* dw_out, void* db_out, void* dx_out, void* dd_out, int device,
                           void* stream) {
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
  const int first_tiles = (int)(((long long)chunk_rays * S + kRows - 1) / kRows);
  if (!inputs_ok || (ig && mode != kK5) || B <= 0 || (S < 2 && mode != kK5) || nsplit < 1 ||
      chunk_rays < 1 || grid < 1 || grid > first_tiles ||
      !net_init(p.m, static_cast<const int*>(desc), n_dense, num_layers, skip_layer, hidden,
                l_xyz, l_dir))
    return (int)cudaErrorInvalidValue;
  const int* dws = static_cast<const int*>(desc_ws);
  DwParams dp;
  int tiles = 0;
  for (int i = 0; i < n_dense; ++i) {
    Ws& w = p.ws[i];
    w = Ws{dws[i * 5], dws[i * 5 + 1], dws[i * 5 + 2], dws[i * 5 + 3], dws[i * 5 + 4]};
    if (w.a_width != p.m.L[i].k || w.d_width != p.m.L[i].n ||
        w.out_off + w.a_width * w.d_width > total_out ||
        p.m.L[i].b_off - p.m.L[0].b_off + p.m.L[i].n > total_b)
      return (int)cudaErrorInvalidValue;
    dp.ws[i] = w;
    dp.tile_start[i] = tiles;
    tiles += ((w.a_width + 63) / 64) * ((w.d_width + 63) / 64);
  }
  dp.tile_start[n_dense] = tiles;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  p.pack = static_cast<const float*>(pack);
  p.x_res = static_cast<const float*>(x_res);
  p.origins = static_cast<const float*>(origins);
  p.dirs = static_cast<const float*>(dirs);
  p.d_enc = static_cast<const float*>(d_enc);
  p.t_vals = static_cast<const float*>(t_vals);
  p.dpreds = static_cast<const float*>(dpreds);
  p.ws_a = static_cast<float*>(ws_a);
  p.ws_d = static_cast<float*>(ws_d);
  p.db_part = static_cast<float*>(db_part);
  p.dx_out = static_cast<float*>(dx_out);
  p.dd_out = static_cast<float*>(dd_out);
  p.rows_pad = (long long)first_tiles * kRows;
  p.S = S;
  p.total_b = total_b;
  p.mode = mode;
  dp.ws_a = p.ws_a;
  dp.ws_d = p.ws_d;
  dp.part = static_cast<float*>(dw_part);
  dp.rows_pad = p.rows_pad;
  dp.n_layers = n_dense;
  dp.total_out = total_out;

  if (mode != kK5) {
    composite_vjp_kernel<double><<<(B + 7) / 8, 256, 0, st>>>(
        static_cast<const float*>(t_vals), static_cast<const float*>(preds),
        static_cast<const float*>(g_rgb), static_cast<const float*>(g_w),
        static_cast<float*>(dpreds), B, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = rows_smem(p.m, total_b, ig);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(f32_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int r0 = 0, chunk = 0; r0 < B; r0 += chunk_rays, ++chunk) {
    const int nr = B - r0 < chunk_rays ? B - r0 : chunk_rays;
    p.n0 = (long long)r0 * S;
    p.nc = nr * S;
    p.ntiles = (p.nc + kRows - 1) / kRows;
    p.accumulate = chunk > 0;
    const int g = grid < p.ntiles ? grid : p.ntiles;
    f32_rows_kernel<<<g, kThreads, smem, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dp.ntiles = p.ntiles;
    dp.per = (p.ntiles + nsplit - 1) / nsplit;
    dp.accumulate = chunk > 0;
    f32_dw_kernel<<<dim3(tiles, nsplit), kThreads, 0, st>>>(dp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_reduce(static_cast<float*>(dw_part), nsplit, total_out,
                            static_cast<float*>(dw_out), p.db_part, grid, total_b,
                            static_cast<float*>(db_out), st);
}
