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
// (nerf_tile.cuh: composite_rays, composite_vjp_kernel), so the numerics of
// the 1e10 terminal delta, the delta * exp(-sigma * delta) bracket and
// max(1 - alpha, 0) + 1e-10 are theirs; the VJP runs in double here (a few
// operations a sample), because its cancelling terms would carry f32
// rounding into the sigma head's gradient.  Any hidden width up to 256 and
// any encoding up to 128 position and 64 direction columns: the pack is
// built at the model's true widths.
//
// What bounds it on this card: the products.  Hopper has no f32 tensor-core
// product, and TF32 is off by the port's precision rule, so every
// multiply-add is an FFMA on the CUDA cores: 1.19 MFLOP a sample forward at
// 8x256, at a peak of SMs x 128 lanes x 2 x clock (~67 TFLOP/s on an H100
// SXM), about 15x below the bf16 tensor cores.  Device memory is far below
// that (a few hundred bytes a sample).
//
// On Hopper an SM's shared memory hands its threads 32 floats a cycle
// while its lanes do 128 FMAs, so a product keeps up only if each float a
// thread loads from shared memory feeds 4 FMAs or more.
//
// One product loop serves every kernel but the dW product.  A block of 8
// warps owns a tile of 64 samples at a time (grid-stride over the tiles,
// one block an SM), its activations in shared memory as one f32 tile
// stored k-major (row k holds column k of the 64 samples, 68 floats
// apart).  A kernel walks a list of products the host builds (Walk): each
// multiplies rows [a0, a0 + K) of the tile by a weight matrix of the pack,
// its first `ncols` columns.  Each thread holds 8 samples x 4 columns of
// each 128-column chunk (8 + 4 floats a weight row for 32 FMAs a chunk);
// the weights stream through a ring of three 32-row stages (16 where
// shared memory is short), one barrier a stage, running ahead across
// products and tiles; the operands of row k + 1 load before row k's FMAs.
//
// The forward (f32_fwd_kernel): the walk is the trunk, the merged head's
// feature columns and the branch.  Each sample's point is computed once
// and each octave's sine and cosine come from one sincosf, four threads a
// sample, into the tile's rows [H, H + xyz_dim), which layer 0 and the skip
// layers read; K5's and K6's encodings, and K1's x_enc residual, move as
// the contiguous block a tile owns, in 16-byte accesses.  The sigma column
// and the 3-column rgb head are dot products over the tile's rows (four
// threads a sample, summed in a fixed order), not chunks of the product.
// The forward writes raw predictions (N, 4); a second kernel composites one
// ray per warp (composite_rays).
//
// The backward (per chunk of whole rays, chunk_plan: the workspace holds 4
// bytes a sample per layer input and output column, ~20 KB at 8x256):
//   * f32_rows_kernel recomputes a 64-sample tile's forward, every layer's
//     input (A) to the workspace, and walks back with the transposed
//     matrices, every dPre (D) to the workspace, the bias gradients summed
//     per block.  Its walk is the forward's (the rgb head and the sigma
//     column are not needed), then the transposed products; the ReLU masks
//     stay in shared memory as bits; the tile's rows go to the workspace by
//     bulk copies of the TMA unit while the next product runs.
//   * f32_dw_kernel: dW = A^T D, 128 x 128 output tiles, 8 x 8 a thread
//     with 16-byte loads along the samples (16 loads for 256 FMAs), over
//     sample ranges split for whole waves of blocks (fused_f32.dw_splits);
//     each 64-sample tile's sums start afresh before they join the block's
//     totals.  The reduce of nerf_dw.cuh sums the splits and the blocks in
//     a fixed order.  No atomics: the same sums on every run.

// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC, never -use_fast_math (the top octave's sin and
//        cos take thousands of radians).  FFMA contraction stays on.

#include "nerf_dw.cuh"
#include "nerf_tile.cuh"

using namespace nkt;

namespace {

constexpr int kRows = 64;        // samples per tile
constexpr int kTS = kRows + 4;   // the tile's row stride (floats): 16-byte rows, fewer conflicts
constexpr int kThreads = 256;    // 8 warps: 2 groups of 32 samples x 4 of 32 columns
constexpr int kMaxWidth = 384;   // a tile's rows, a product's output: hidden 256 + 128 position
constexpr int kSub = 16;         // weight rows (k) a fully unrolled step of the product
constexpr int kRing = 3;         // stages in the ring: two in flight while one is multiplied
constexpr int kMaxProds = 2 * kMaxDense + 2;

// One dense layer of the f32 pack (fused_f32.py's pack_f32): the forward
// matrix (k, round64(n)) and the transposed one (n, round64(k)), row-major,
// and the bias (n).
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
  // The encodings sit in rows [H, H + xyz_dim or dir_dim); the backward's
  // products write up to hidden + the position columns.
  const int widest = H + (m.xyz_dim > m.dir_dim ? m.xyz_dim : m.dir_dim);
  m.tile_rows = round_up(m.tile_rows > widest ? m.tile_rows : widest, 4);
  return m.tile_rows <= kMaxWidth;
}

// ---------------------------------------------------------------------------
// The product loop.

// One product of a walk: rows [a0, a0 + K) of the tile times rows [0, K)
// of the matrix at pack + off (row stride ldm), its first `ncols` columns;
// the dense layer's forward matrix (fwd) or its transpose.
struct Prod {
  int off, ldm, K, ncols, layer, fwd, a0;
};

// A kernel's walk: its products in order, for every tile, and the ring's
// stages (of stage_rows weight rows, wmax floats a row) a tile takes.
struct Walk {
  Prod prods[kMaxProds];
  const float* pack;
  int nprod, stages, stage_rows, wmax;
};

// Host: appends layer li's forward product (K = k) or its transposed one
// (K = n), its first `ncols` columns, over the tile's rows from a0.
void walk_add(Walk& w, const F32Layer& d, int li, bool fwd, int ncols, int a0 = 0) {
  w.prods[w.nprod++] = fwd ? Prod{d.f_off, ld64(d.n), d.k, ncols, li, 1, a0}
                           : Prod{d.t_off, ld64(d.k), d.n, ncols, li, 0, a0};
  w.wmax = round_up(ncols, 32) > w.wmax ? round_up(ncols, 32) : w.wmax;
}

// Host: the ring's stages, 32 weight rows where shared memory holds them
// beside `fixed` other floats, else 16; and the stages a tile's walk
// takes.  Returns the block's shared memory in bytes.
size_t walk_plan(Walk& w, size_t fixed) {
  auto bytes = [&](int rows) { return sizeof(float) * ((size_t)kRing * rows * w.wmax + fixed); };
  w.stage_rows = bytes(2 * kSub) <= (size_t)kMaxSmem ? 2 * kSub : kSub;
  w.stages = 0;
  for (int i = 0; i < w.nprod; ++i) w.stages += (w.prods[i].K + w.stage_rows - 1) / w.stage_rows;
  return bytes(w.stage_rows);
}

// A thread's outputs of a product: samples s0 .. s0 + 7 of the tile and,
// per 128-column chunk j, columns 128 j + c0 .. + 3.  Per weight row a
// thread loads 8 + 4 NJ floats from shared memory for 32 NJ FMAs: at two
// chunks the card's shared-memory rate (32 floats a cycle an SM) just
// feeds its FMA rate (128 a cycle).
__device__ __forceinline__ int rows_s0() {
  return 32 * ((threadIdx.x >> 5) & 1) + 8 * ((threadIdx.x & 31) >> 3);
}
__device__ __forceinline__ int rows_c0() { return 32 * (threadIdx.x >> 6) + 4 * (threadIdx.x & 7); }

template <int NJ>
using Acc = float[NJ][32];

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// The tile's rows written by this thread, made visible to the TMA unit's
// reads (after a barrier); a thread's bulk copies, waited for until they
// have read shared memory, or until they are done.
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// The weight stream: every product's stages in the walk's order, tile after
// tile, `left` of them still to be issued by this block.
struct Stream {
  int pi, k0, left, issued;
};

// Issues the stream's next stage (rows [k0, k0 + stage_rows) of its
// product's matrix, round32(ncols) columns) into its ring slot; commits a
// group of asynchronous copies, empty once the stream is done.
__device__ __forceinline__ void issue_stage(const Walk& w, Stream& s, float* ring) {
  if (s.left > 0) {
    const Prod& q = w.prods[s.pi];
    float* dst = ring + (s.issued % kRing) * w.stage_rows * w.wmax;
    const int rows = min(w.stage_rows, q.K - s.k0), vec = round_up(q.ncols, 32) >> 2;
    const int dr = kThreads / vec, dc = kThreads - dr * vec;
    const float* src = w.pack + q.off + (size_t)s.k0 * q.ldm;
    for (int r = threadIdx.x / vec, c = threadIdx.x - r * vec; r < rows; r += dr, c += dc) {
      if (c >= vec) {
        c -= vec;
        ++r;
        if (r >= rows) break;
      }
      cp_async16(dst + (r * vec + c) * 4, src + (size_t)r * q.ldm + c * 4);
    }
    s.k0 += w.stage_rows;
    if (s.k0 >= q.K) {
      s.k0 = 0;
      s.pi = s.pi + 1 == w.nprod ? 0 : s.pi + 1;
    }
    --s.left;
  }
  ++s.issued;
  cp_async_commit();
}

// acc[j][4 i + c] += sum over kn <= kSub rows k of tile[k][s0 + i] *
// W[k][128 j + c0 + c], j < NJ; tp, wp: the thread's first operands.  A
// full step loads row k + 1's operands before it multiplies row k's, so the
// loads' latency hides behind the warp's own FMAs.  The only FMA loop of
// the products.
template <int NJ, int NA>
__device__ __forceinline__ void sub_fma(Acc<NA>& acc, const float* tp, const float* wp, int w,
                                        int kn) {
  float4 a[2][2], b[2][NJ];
  auto load = [&](int buf, int kk) {
    a[buf][0] = *reinterpret_cast<const float4*>(tp + kk * kTS);
    a[buf][1] = *reinterpret_cast<const float4*>(tp + kk * kTS + 4);
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[buf][j] = *reinterpret_cast<const float4*>(wp + kk * w + 128 * j);
  };
  auto fma_row = [&](int buf) {
    const float av[8] = {a[buf][0].x, a[buf][0].y, a[buf][0].z, a[buf][0].w,
                         a[buf][1].x, a[buf][1].y, a[buf][1].z, a[buf][1].w};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float bv[4] = {b[buf][j].x, b[buf][j].y, b[buf][j].z, b[buf][j].w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][4 * i + c] = fmaf(av[i], bv[c], acc[j][4 * i + c]);
    }
  };
  if (kn == kSub) {
    load(0, 0);
#pragma unroll
    for (int kk = 0; kk < kSub; ++kk) {
      if (kk + 1 < kSub) load((kk + 1) & 1, kk + 1);
      fma_row(kk & 1);
    }
  } else {
    for (int kk = 0; kk < kn; ++kk) {
      load(0, kk);
      fma_row(0);
    }
  }
}

// Product q of the walk into acc (NA chunks, enough for its ncols): its
// stages from the ring, each opening with one barrier after which the
// stream's next stage is issued into the slot the previous stage freed.  A
// warp multiplies only the 128-column chunks that reach its columns.
// Every thread calls it; it ends with a barrier, once this thread's bulk
// copies have read the tile: the tile may then be overwritten.
template <int NA>
__device__ __forceinline__ void walk_product(const Walk& wk, const Prod& q, Stream& st, int& gs,
                                             float* ring, const float* tile, Acc<NA>& acc) {
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
  const int c0 = rows_c0(), w = round_up(q.ncols, 32);
  const int nj = min(NA, max(0, (q.ncols - (c0 & ~31) + 127) / 128));
  for (int k0 = 0; k0 < q.K; k0 += wk.stage_rows) {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    issue_stage(wk, st, ring);
    const float* slot = ring + (gs % kRing) * wk.stage_rows * wk.wmax + c0;
    const int kn = min(wk.stage_rows, q.K - k0);
    for (int kb = 0; kb < kn; kb += kSub) {
      const float* wp = slot + kb * w;
      const float* tp = tile + (q.a0 + k0 + kb) * kTS + rows_s0();
      const int ks = min(kSub, kn - kb);
      if (nj == 1) {
        sub_fma<1>(acc, tp, wp, w, ks);
      } else if (nj == 2) {
        sub_fma<2>(acc, tp, wp, w, ks);
      } else if constexpr (NA == 3) {
        if (nj == 3) sub_fma<3>(acc, tp, wp, w, ks);
      }
    }
    ++gs;
  }
  bulk_wait_read();
  __syncthreads();
}

// f(j, c, col, v) for each of the thread's output columns: v[i] is sample
// s0 + i.
template <int NA, class F>
__device__ __forceinline__ void each_output(const Acc<NA>& acc, F f) {
  const int c0 = rows_c0();
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = acc[j][4 * i + c];
      f(j, c, 128 * j + c0 + c, v);
    }
}

__device__ __forceinline__ void store8(float* t, const float v[8]) {
  *reinterpret_cast<float4*>(t) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(t + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// ---------------------------------------------------------------------------
// The forward.

// K1's point of sample q (o + d * t rounded as two operations, as the
// plain path and the bf16 kernels).
__device__ __forceinline__ void ray_point(const float* origins, const float* dirs,
                                          const float* t_vals, long long q, int S, float x[3]) {
  const long long ray = q / S;
  const float* o = origins + ray * 3;
  const float* d = dirs + ray * 3;
  const float t = t_vals[q];
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = __fadd_rn(o[i], __fmul_rn(d[i], t));
}

// Rows [0, dim) of `rows` (row stride kTS; column r is sample r): the
// encoding of each sample's point(r, x) in encode_feature's layout, each
// octave's sine and cosine from one sincosf (full precision).  Four
// threads a sample, the octaves dealt round among them; samples from
// `valid` on encode the origin.
template <class Point>
__device__ __forceinline__ void encode_rows(float* rows, int dim, int valid, Point point) {
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  float x[3] = {0.f, 0.f, 0.f};
  if (r < valid) point(r, x);
  if (part == 0)
#pragma unroll
    for (int d = 0; d < 3; ++d) rows[d * kTS + r] = x[d];
  for (int o = part; 6 * o + 3 < dim; o += 4) {
    const float scale = __int_as_float((127 + o) << 23);  // 2^o, exact
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float sn, cs;
      sincosf(__fmul_rn(x[d], scale), &sn, &cs);
      rows[(3 + 6 * o + d) * kTS + r] = sn;
      rows[(6 + 6 * o + d) * kTS + r] = cs;
    }
  }
}

// The tile's block of `valid` samples x w floats, row-major and contiguous
// at g in global memory, <-> rows [0, w) of `rows` (column r: sample r).
// 16-byte accesses where g is 16-byte aligned; loads fill the samples from
// `valid` on with 0.
__device__ __forceinline__ bool aligned16(const void* g) {
  return (reinterpret_cast<uintptr_t>(g) & 15) == 0;
}
__device__ __forceinline__ void block_to_rows(float* rows, int w, int valid, const float* g) {
  const int n = valid * w;
  auto put = [&](int i, float v) {
    const int r = i / w;
    rows[(i - r * w) * kTS + r] = v;
  };
  const int step = aligned16(g) ? 4 : 1;
  for (int i = step * threadIdx.x; i < n; i += step * kThreads) {
    if (step == 4 && i + 4 <= n) {
      const float4 v = *reinterpret_cast<const float4*>(g + i);
      put(i, v.x);
      put(i + 1, v.y);
      put(i + 2, v.z);
      put(i + 3, v.w);
    } else {
      for (int e = i; e < min(i + step, n); ++e) put(e, g[e]);
    }
  }
  for (int i = n + threadIdx.x; i < kRows * w; i += kThreads) put(i, 0.f);
}
__device__ __forceinline__ void rows_to_block(const float* rows, int w, int valid, float* g) {
  const int n = valid * w;
  auto get = [&](int i) {
    const int r = i / w;
    return rows[(i - r * w) * kTS + r];
  };
  const int step = aligned16(g) ? 4 : 1;
  for (int i = step * threadIdx.x; i < n; i += step * kThreads) {
    if (step == 4 && i + 4 <= n) {
      *reinterpret_cast<float4*>(g + i) = make_float4(get(i), get(i + 1), get(i + 2), get(i + 3));
    } else {
      for (int e = i; e < min(i + step, n); ++e) g[e] = get(e);
    }
  }
}

// This thread's share of NC dot products of the tile's rows [0, K) (from
// `rows`) with the columns of wt (shared memory, column-major, K apart):
// sample r = tid % 64 over rows part, part + 4, ... (part = tid / 64), into
// out[(part * NC + c) * 64 + r].
template <int NC>
__device__ __forceinline__ void dot_part(const float* rows, int K, const float* wt, float* out) {
  const int r = threadIdx.x & 63, part = threadIdx.x >> 6;
  float s[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) s[c] = 0.f;
  for (int k = part; k < K; k += 4) {
    const float a = rows[k * kTS + r];
#pragma unroll
    for (int c = 0; c < NC; ++c) s[c] = fmaf(a, wt[c * K + k], s[c]);
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) out[(part * NC + c) * kRows + r] = s[c];
}

struct FwdParams {
  F32Net m;
  Walk w;                // the trunk, the merged head's feature columns, the branch
  const float* origins;  // (B, 3): K1
  const float* dirs;     // (B, 3): K1
  const float* t_vals;   // (B, S): K1
  const float* x_in;     // (N, xyz_dim): K5, K6
  const float* d_in;     // (N, dir_dim): K5, K6
  float* xenc_out;       // (N, xyz_dim) or null: K1's training residual
  float* preds;          // (N, 4)
  long long N;
  int S, ntiles;
};

// The forward, one 64-sample tile at a time (grid-stride): the position
// encodings into the tile's rows [H, H + xyz_dim), the walk (each product's
// output, ReLU'd but at the merged head, into rows [0, ncols)), the
// direction encodings into rows [H, H + dir_dim) once the head has read the
// position rows; the sigma column from the head's input rows and the rgb
// head from the branch's output rows as dot products, into the raw
// predictions.
__global__ void __launch_bounds__(kThreads, 1) f32_fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const F32Net& m = p.m;
  const int H = m.hidden, L = m.num_layers, tid = threadIdx.x;
  const F32Layer& head = m.L[L];
  const F32Layer& rgb = m.L[L + 2];
  float* ring = smem;                                        // kRing x (stage_rows, wmax)
  float* tile = ring + kRing * p.w.stage_rows * p.w.wmax;    // (tile_rows, kTS)
  float* w_sig = tile + (size_t)m.tile_rows * kTS;           // the head's sigma column (head.k)
  float* w_rgb = w_sig + round_up(head.k, 4);                // the rgb head, column-major
  float* s_sig = w_rgb + round_up(3 * rgb.k, 4);             // (4, 64): dot partials
  float* s_rgb = s_sig + 4 * kRows;                          // (4, 3, 64)
  for (int k = tid; k < head.k; k += kThreads)
    w_sig[k] = p.w.pack[head.f_off + (size_t)k * ld64(head.n) + H];
  for (int i = tid; i < 3 * rgb.k; i += kThreads) {
    const int c = i / rgb.k, k = i - c * rgb.k;
    w_rgb[i] = p.w.pack[rgb.f_off + (size_t)k * ld64(rgb.n) + c];
  }
  const float* b_head = p.w.pack + head.b_off;
  const float* b_rgb = p.w.pack + rgb.b_off;
  const int my_tiles = (int)blockIdx.x < p.ntiles ? (p.ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  Stream st{0, 0, my_tiles * p.w.stages, 0};
  for (int i = 0; i < kRing - 1; ++i) issue_stage(p.w, st, ring);
  int gs = 0;
  Acc<2> acc;
  const int s0 = rows_s0();
  float* enc = tile + H * kTS;  // the encodings' rows

  for (int tile_i = blockIdx.x; tile_i < p.ntiles; tile_i += gridDim.x) {
    const long long q0 = (long long)tile_i * kRows;
    const int valid = (int)min((long long)kRows, p.N - q0);
    if (p.x_in != nullptr) {
      block_to_rows(enc, m.xyz_dim, valid, p.x_in + q0 * m.xyz_dim);
    } else {
      encode_rows(enc, m.xyz_dim, valid, [&](int r, float* x) {
        ray_point(p.origins, p.dirs, p.t_vals, q0 + r, p.S, x);
      });
    }
    for (int pi = 0; pi < p.w.nprod; ++pi) {
      const Prod& q = p.w.prods[pi];
      const int li = q.layer;
      if (li == L) {  // sigma: the head's input rows, before the product
        __syncthreads();
        dot_part<1>(tile, head.k, w_sig, s_sig);
      }
      walk_product(p.w, q, st, gs, ring, tile, acc);
      const float* b = p.w.pack + m.L[li].b_off;
      const bool relu = li != L;
      each_output(acc, [&](int, int, int col, float* v) {
        if (col >= q.ncols) return;
        const float bc = b[col];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = relu ? fmaxf(v[i] + bc, 0.f) : v[i] + bc;
        store8(tile + col * kTS + s0, v);
      });
      if (li == 0 && p.xenc_out != nullptr) {
        rows_to_block(enc, m.xyz_dim, valid, p.xenc_out + q0 * m.xyz_dim);
      } else if (li == L) {
        if (p.d_in != nullptr) {
          block_to_rows(enc, m.dir_dim, valid, p.d_in + q0 * m.dir_dim);
        } else {
          encode_rows(enc, m.dir_dim, valid, [&](int r, float* x) {
            const float* d = p.dirs + ((q0 + r) / p.S) * 3;
#pragma unroll
            for (int i = 0; i < 3; ++i) x[i] = d[i];
          });
        }
      }
    }
    // The rgb head over the branch's output, then the predictions: one
    // thread a sample and column, the four partial sums in a fixed order.
    __syncthreads();
    dot_part<3>(tile, rgb.k, w_rgb, s_rgb);
    __syncthreads();
    {
      const int c = tid >> 6, r = tid & 63;
      const float* part = c < 3 ? s_rgb + c * kRows + r : s_sig + r;
      const int stride = (c < 3 ? 3 : 1) * kRows;
      const float v = ((part[0] + part[stride]) + (part[2 * stride] + part[3 * stride])) +
                      (c < 3 ? b_rgb[c] : b_head[H]);
      if (r < valid) p.preds[(q0 + r) * 4 + c] = v;
    }
  }
  cp_async_wait<0>();
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
  Walk w;               // the forward but the rgb head, then back
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
  int tile_rows, xs0;
};

// Rows [0, n) of the tile (64 samples each) to the workspace columns at g
// (k-major: row r at g + 64 r), one bulk copy of the TMA unit a row.  After
// fence_to_async and a barrier.
__device__ __forceinline__ void rows_to_ws(const float* tile, int n, float* g) {
  if ((int)threadIdx.x >= n) return;
  for (int r = threadIdx.x; r < n; r += kThreads)
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], 256;\n" ::"l"(
                     g + r * kRows),
                 "r"(smem_u32(tile + r * kTS))
                 : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// K2's, K3's point of sample q: its position feature c.
__device__ __forceinline__ float ray_feature(const float* origins, const float* dirs,
                                             const float* t_vals, long long q, int S, int c,
                                             int dim) {
  float x[3];
  ray_point(origins, dirs, t_vals, q, S, x);
  return encode_feature(x, c, dim);
}

// The tile's rows [col0, col0 + w) = f(r, c) for samples r < valid, else 0,
// and the same into the workspace columns at g (k-major: g[c * 64 + r]).
template <class F>
__device__ __forceinline__ void load_ws(float* tile, int col0, int w, int valid, F f, float* g) {
  for (int i = threadIdx.x; i < w * kRows; i += kThreads) {
    const int c = i >> 6, r = i & 63;
    const float v = r < valid ? f(r, c) : 0.f;
    tile[(col0 + c) * kTS + r] = v;
    g[i] = v;
  }
}

// db[c] += the sum of tile row col0 + c over the 64 samples, c < w <= 16:
// one warp a row, in a fixed order.
__device__ __forceinline__ void row_sums(const float* tile, int col0, int w, float* db) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= w) return;
  const float* row = tile + (col0 + warp) * kTS;
  float s = row[lane] + row[lane + 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) db[warp] += s;
}

// The backward of one chunk, one 64-sample tile at a time (grid-stride):
// the tile's forward again, every layer's input (A) to the workspace and
// the ReLU masks as bits in shared memory, then the walk back with the
// transposed matrices, every dPre (D) to the workspace and the bias
// gradients summed per block.  The walk is the host's list of products,
// run by one loop: each streams its weights through the ring
// (walk_product), which runs ahead across products and tiles; the tile's
// rows go to the workspace by bulk copies while the next product runs.
__global__ void __launch_bounds__(kThreads, 1)
    f32_rows_kernel(const __grid_constant__ RowParams p) {
  extern __shared__ __align__(16) float smem[];
  const F32Net& m = p.m;
  const int H = m.hidden, L = m.num_layers, tid = threadIdx.x, lane = tid & 31;
  const bool x_here = p.dx_out != nullptr;
  float* ring = smem;                                        // kRing x (stage_rows, wmax)
  float* tile = ring + kRing * p.w.stage_rows * p.w.wmax;        // (tile_rows, kTS)
  float* part = tile + (size_t)p.tile_rows * kTS;            // (2, kMaxWidth): bias sums
  float* db = part + 2 * kMaxWidth;                           // (total_b)
  uint64_t* masks = reinterpret_cast<uint64_t*>(db + round_up(p.total_b, 4));  // (L + 3, 256)
  const int s0 = rows_s0(), half = (tid >> 5) & 1;
  for (int i = tid; i < p.total_b; i += kThreads) db[i] = 0.f;
  const int my_tiles = (int)blockIdx.x < p.ntiles ? (p.ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  Stream st{0, 0, my_tiles * p.w.stages, 0};
  for (int i = 0; i < kRing - 1; ++i) issue_stage(p.w, st, ring);
  int gs = 0;
  Acc<3> acc;

  for (int tile_i = blockIdx.x; tile_i < p.ntiles; tile_i += gridDim.x) {
    const int rbase = tile_i * kRows;           // workspace row of the tile's sample 0
    const long long q0 = p.n0 + rbase;          // its sample
    const int valid = min(kRows, p.nc - rbase);
    const float* g = p.dpreds + q0 * 4;
    auto ws_a = [&](int i) { return p.ws_a + p.rows_pad * p.ws[i].a_col + (size_t)rbase * p.ws[i].a_width; };
    auto ws_d = [&](int i) { return p.ws_d + p.rows_pad * p.ws[i].d_col + (size_t)rbase * p.ws[i].d_width; };
    auto dbl = [&](int i) { return db + m.L[i].b_off - m.L[0].b_off; };
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

    load_ws(tile, 0, m.xyz_dim, valid, xf, ws_a(0));
    for (int pi = 0; pi < p.w.nprod; ++pi) {
      const Prod& q = p.w.prods[pi];
      const int li = q.layer;
      walk_product(p.w, q, st, gs, ring, tile, acc);
      if (q.fwd) {
        // Layer li's output + its bias, ReLU'd but at the merged head (its
        // feature columns), into the tile's rows [0, ncols) and its ReLU
        // bits, then to the workspace: A of the next layer (the rgb head's
        // after the branch).
        const int next = li == L + 1 ? L + 2 : li + 1;
        const bool relu = li != L;
        const float* b = p.w.pack + m.L[li].b_off;
        uint64_t bits = 0;
        each_output(acc, [&](int j, int c, int col, float* v) {
          if (col >= q.ncols) return;
          const float bc = b[col];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            v[i] += bc;
            if (relu) v[i] = fmaxf(v[i], 0.f);
            if (j < 2 && v[i] > 0.f) bits |= 1ull << (32 * j + 4 * i + c);
          }
          float* t = tile + col * kTS + s0;
          *reinterpret_cast<float4*>(t) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(t + 4) = make_float4(v[4], v[5], v[6], v[7]);
        });
        if (relu) masks[next * kThreads + tid] = bits;
        fence_to_async();
        __syncthreads();
        rows_to_ws(tile, q.ncols, ws_a(next));
        if (li < L && is_skip(li, m.skip_layer)) {
          load_ws(tile, H, m.xyz_dim, valid, xf, ws_a(li + 1) + H * kRows);
        } else if (li == L) {
          load_ws(tile, H, m.dir_dim, valid, df, ws_a(L + 1) + H * kRows);
        } else if (li == L + 1) {
          // The walk back, once h2's rows are copied out: d rgb logits.
          bulk_wait_read();
          __syncthreads();
          if (x_here)
            for (int e = tid; e < m.xyz_dim * kRows; e += kThreads)
              tile[(p.xs0 + (e >> 6)) * kTS + (e & 63)] = 0.f;
          load_ws(tile, 0, 3, valid, [&](int r, int c) { return g[r * 4 + c]; }, ws_d(L + 2));
          __syncthreads();
          row_sums(tile, 0, 3, dbl(L + 2));
        }
        continue;
      }
      // dX of layer li: its columns below xcol are the dPre of layer `out`
      // (masked by A_li > 0 but at the branch, whose feature input has no
      // ReLU): into the tile's rows, their sums over the samples into the
      // bias gradients (a warp's four sample groups by shuffles, then the
      // two warps' in a fixed order), the rows to the workspace.  Columns
      // [xcol, ncols): the branch's into dd_out, the skip layers' and layer
      // 0's added into the dx_enc rows.
      const int out = li == L + 2 ? L + 1 : li - 1;
      const int xcol = li == L + 2 ? H / 2 : (li == 0 ? 0 : H);
      const bool to_dd = li == L + 1;
      const uint64_t bits = li == L + 1 || li == 0 ? ~0ull : masks[li * kThreads + tid];
      each_output(acc, [&](int j, int c, int col, float* v) {
        float sum = 0.f;
        if (col < xcol) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (!(j < 2 && ((bits >> (32 * j + 4 * i + c)) & 1u))) v[i] = 0.f;
          float* t = tile + col * kTS + s0;
          *reinterpret_cast<float4*>(t) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(t + 4) = make_float4(v[4], v[5], v[6], v[7]);
          sum = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
        } else if (col < q.ncols) {
          if (to_dd) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
              if (s0 + i < valid) p.dd_out[(q0 + s0 + i) * m.dir_dim + col - xcol] = v[i];
          } else {
            float* x = tile + (p.xs0 + col - xcol) * kTS + s0;
#pragma unroll
            for (int i = 0; i < 8; ++i) x[i] += v[i];
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 8);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        if (lane < 8 && col < xcol) part[half * kMaxWidth + col] = sum;
      });
      fence_to_async();
      __syncthreads();
      if (out >= 0) {
        rows_to_ws(tile, xcol, ws_d(out));
        float* d = dbl(out);
        for (int col = tid; col < xcol; col += kThreads) d[col] += part[col] + part[kMaxWidth + col];
      }
      if (li == L + 1) {  // dsigma: the merged head's last dPre column
        load_ws(tile, H, 1, valid, [&](int r, int) { return g[r * 4 + 3]; }, ws_d(L) + H * kRows);
        __syncthreads();
        row_sums(tile, H, 1, dbl(L) + H);
      } else if (li == 0) {
        for (int e = tid; e < valid * m.xyz_dim; e += kThreads) {
          const int r = e / m.xyz_dim, c = e - r * m.xyz_dim;
          p.dx_out[(q0 + r) * m.xyz_dim + c] = tile[(p.xs0 + c) * kTS + r];
        }
      }
    }
    // The last rows copied out before the next tile overwrites them.
    bulk_wait_read();
    __syncthreads();
  }
  cp_async_wait<0>();
  bulk_wait();
  float* out = p.db_part + (size_t)blockIdx.x * p.total_b;
  for (int i = tid; i < p.total_b; i += kThreads)
    out[i] = p.accumulate ? out[i] + db[i] : db[i];
}


// dW = A^T D over a chunk.  A block owns a 128 x 128 tile of one layer's
// dW (8 x 8 a thread: rows tm + 16 i, columns tn + 16 j) over the sample
// tiles [s * per, (s + 1) * per) of split s = blockIdx.y, and writes (or,
// for a later chunk, adds) it to the split's slab.  The workspaces are
// k-major, so both operands are copied as they lie (cp.async, 16 bytes, a
// ring of four 32-sample stages) and each thread reads four samples of one
// row with one 16-byte load: per four samples 8 + 8 loads (64 floats) feed
// 256 FMAs, which the card's shared-memory rate just feeds.  Each 64-sample
// tile's sums start afresh and are then added to the block's totals; the
// splits and the chunks add in a fixed order (no atomics: the same sums on
// every run).
constexpr int kDwBM = 128;                    // dW rows (k) a block
constexpr int kDwBN = 128;                    // dW columns (n) a block
constexpr int kDwSS = 32;                     // samples a stage
constexpr int kDwTS = kDwSS + 4;              // a stage row's stride (floats): no bank conflicts
constexpr int kDwRing = 4;
constexpr int kDwStage = (kDwBM + kDwBN) * kDwTS;  // floats
constexpr int kDwBlock = 256;

struct DwParams {
  Ws ws[kMaxDense];
  int tile_start[kMaxDense + 1];
  const float* ws_a;
  const float* ws_d;
  float* part;  // (nsplit, total_out)
  long long rows_pad;
  int n_layers, total_out, ntiles, per, accumulate;
};

__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__global__ void __launch_bounds__(kDwBlock, 1) f32_dw_kernel(const __grid_constant__ DwParams p) {
  extern __shared__ __align__(16) float smem[];
  int li = 0;
  while (li + 1 < p.n_layers && (int)blockIdx.x >= p.tile_start[li + 1]) ++li;
  const Ws& w = p.ws[li];
  const int t = blockIdx.x - p.tile_start[li];
  const int ntn = (w.d_width + kDwBN - 1) / kDwBN;
  const int k0 = (t / ntn) * kDwBM, n0 = (t % ntn) * kDwBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tm = 4 * (warp & 3) + (lane >> 3), tn = 8 * (warp >> 2) + (lane & 7);
  const int t0 = blockIdx.y * p.per, t1 = min(t0 + p.per, p.ntiles);
  const int nst = 2 * max(0, t1 - t0);  // 32-sample stages
  const float* a_base = p.ws_a + p.rows_pad * w.a_col;
  const float* d_base = p.ws_d + p.rows_pad * w.d_col;
  // This thread's copies of a stage: 16 bytes at sample (tid % 8) * 4 of
  // rows tid / 8 + 32 i of A and of D (i < 4); rows past the layer's width
  // are zero-filled.
  const int crow = tid >> 3, cq = (tid & 7) * 4;
  unsigned ok = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ok |= (k0 + crow + 32 * i < w.a_width ? 1u : 0u) << i;
    ok |= (n0 + crow + 32 * i < w.d_width ? 1u : 0u) << (4 + i);
  }
  const float* a_src = a_base + (size_t)(k0 + crow) * kRows + cq;
  const float* d_src = d_base + (size_t)(n0 + crow) * kRows + cq;
  auto issue = [&](int s) {
    if (s < nst) {
      float* dst = smem + (s % kDwRing) * kDwStage + crow * kDwTS + cq;
      const size_t st = t0 + (s >> 1), half = (s & 1) * kDwSS;
      const float* a = a_src + st * kRows * w.a_width + half;
      const float* d = d_src + st * kRows * w.d_width + half;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool oa = (ok >> i) & 1u, od = (ok >> (4 + i)) & 1u;
        cp_async16_zfill(dst + 32 * i * kDwTS, oa ? a + 32 * i * kRows : a_base, oa);
        cp_async16_zfill(dst + (kDwBM + 32 * i) * kDwTS, od ? d + 32 * i * kRows : d_base, od);
      }
    }
    cp_async_commit();
  };
  float acc[8][8], total[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = total[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < kDwRing - 1; ++s) issue(s);
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kDwRing - 2>();
    __syncthreads();
    issue(s + kDwRing - 1);
    const float* buf = smem + (s % kDwRing) * kDwStage;
    const float* ap = buf + tm * kDwTS;
    const float* dp = buf + (kDwBM + tn) * kDwTS;
    // Four samples a step; the next step's D operands and the next row's A
    // operand are loaded before this one's FMAs.
    float4 dv[2][8], av[2];
#pragma unroll
    for (int j = 0; j < 8; ++j) dv[0][j] = *reinterpret_cast<const float4*>(dp + 16 * j * kDwTS);
    av[0] = *reinterpret_cast<const float4*>(ap);
#pragma unroll
    for (int t = 0; t < kDwSS / 4; ++t) {
      const int cur = t & 1, q = 4 * t;
      if (t + 1 < kDwSS / 4)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dv[cur ^ 1][j] = *reinterpret_cast<const float4*>(dp + 16 * j * kDwTS + q + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ai = (8 * t + i) & 1;
        if (i + 1 < 8)
          av[ai ^ 1] = *reinterpret_cast<const float4*>(ap + 16 * (i + 1) * kDwTS + q);
        else if (t + 1 < kDwSS / 4)
          av[ai ^ 1] = *reinterpret_cast<const float4*>(ap + q + 4);
        const float4 x = av[ai];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 y = dv[cur][j];
          acc[i][j] = fmaf(x.x, y.x, acc[i][j]);
          acc[i][j] = fmaf(x.y, y.y, acc[i][j]);
          acc[i][j] = fmaf(x.z, y.z, acc[i][j]);
          acc[i][j] = fmaf(x.w, y.w, acc[i][j]);
        }
      }
    }
    if (s & 1) {  // a whole 64-sample tile: its sums into the totals
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          total[i][j] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
  }
  float* out = p.part + (size_t)blockIdx.y * p.total_out + w.out_off;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + tm + 16 * i;
    if (k >= w.a_width) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tn + 16 * j;
      if (n >= w.d_width) continue;
      float* o = out + (size_t)k * w.d_width + n;
      *o = p.accumulate ? *o + total[i][j] : total[i][j];
    }
  }
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
  // The walk: the trunk (layer 0 over the position rows at H), the merged
  // head's feature columns, the branch.
  const F32Net& m = p.m;
  const int H = m.hidden, L = m.num_layers;
  p.w.nprod = p.w.wmax = 0;
  for (int i = 0; i <= L + 1; ++i) walk_add(p.w, m.L[i], i, true, i == L + 1 ? H / 2 : H, i ? 0 : H);
  p.w.pack = static_cast<const float*>(pack);
  const size_t smem = walk_plan(p.w, (size_t)m.tile_rows * kTS + round_up(m.L[L].k, 4) +
                                         round_up(3 * m.L[L + 2].k, 4) + 16 * kRows);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  p.origins = static_cast<const float*>(origins);
  p.dirs = static_cast<const float*>(dirs);
  p.t_vals = static_cast<const float*>(t_vals);
  p.x_in = static_cast<const float*>(x_in);
  p.d_in = static_cast<const float*>(d_in);
  p.xenc_out = static_cast<float*>(xenc_out);
  p.preds = static_cast<float*>(preds_out);
  p.N = (long long)B * S;
  p.S = S;
  p.ntiles = (int)((p.N + kRows - 1) / kRows);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaFuncSetAttribute(f32_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  f32_fwd_kernel<<<p.ntiles < sms ? p.ntiles : sms, kThreads, smem, st>>>(p);
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
    tiles += ((w.a_width + kDwBM - 1) / kDwBM) * ((w.d_width + kDwBN - 1) / kDwBN);
  }
  dp.tile_start[n_dense] = tiles;
  // The walk's products, in the order f32_rows_kernel runs them: the
  // forward's (the forward matrices, K = k) but the rgb head's, then the
  // transposed ones back (K = n), with the position columns at the skip
  // layers and layer 0 where dx_enc is asked for, the direction columns at
  // the branch where dd_enc is.
  {
    const F32Net& m = p.m;
    const int H = m.hidden, L = m.num_layers;
    const bool x_here = dx_out != nullptr;
    Walk& w = p.w;
    w.nprod = w.wmax = 0;
    for (int i = 0; i <= L + 1; ++i) walk_add(w, m.L[i], i, true, i == L + 1 ? H / 2 : H);
    walk_add(w, m.L[L + 2], L + 2, false, H / 2);
    walk_add(w, m.L[L + 1], L + 1, false, H + (dd_out != nullptr ? m.dir_dim : 0));
    for (int i = L; i >= 1; --i)
      walk_add(w, m.L[i], i, false, H + (x_here && is_skip(i - 1, m.skip_layer) ? m.xyz_dim : 0));
    if (x_here) walk_add(w, m.L[0], 0, false, m.xyz_dim);
    int widest = H + 1;
    for (int i = 0; i < w.nprod; ++i) widest = w.prods[i].K > widest ? w.prods[i].K : widest;
    p.xs0 = round_up(H + 1, 4);
    p.tile_rows = round_up(x_here && p.xs0 + m.xyz_dim > widest ? p.xs0 + m.xyz_dim : widest, 4);
  }
  const size_t smem = walk_plan(p.w, (size_t)p.tile_rows * kTS + 2 * kMaxWidth +
                                         round_up(total_b, 4) +
                                         (size_t)(num_layers + 3) * kThreads * 2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  p.w.pack = static_cast<const float*>(pack);
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
  const int dw_smem = (int)sizeof(float) * kDwRing * kDwStage;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(f32_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(f32_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
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
    f32_dw_kernel<<<dim3(tiles, nsplit), kDwBlock, dw_smem, st>>>(dp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_reduce(static_cast<float*>(dw_part), nsplit, total_out,
                            static_cast<float*>(dw_out), p.db_part, grid, total_b,
                            static_cast<float*>(db_out), st);
}
