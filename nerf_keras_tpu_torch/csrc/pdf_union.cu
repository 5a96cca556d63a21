// K7 on Hopper: inverse-CDF importance sampling fused with the sorted union
// of coarse and fine sample distances.
//
// Replaces the TPU kernel `_pdf_union_kernel` (experimental/pdf_union.py:54,
// launched by the pl.pallas_call at :210; entries `sample_pdf_union` :141
// and `sample_pdf_union_eval` :228).
//
// What it computes, per ray, the same function as
// sorted_union(t, sample_pdf(t_mid, w, NF, u)) with t_mid the midpoints of
// t:  pdf = (w + floor) / sum(w + floor) (floor 1e-5); cdf = [0, inclusive
// cumsum(pdf)] (S + 1 entries); per u the bin k with cdf[k] <= u <
// cdf[k+1] (+inf beyond the last), its 'above' neighbour min(k+1, S), the
// midpoints extended by their last entry, a denominator under 1e-5
// replaced by 1, t_f = t_b + (u - cdf_b) / denom * (t_a - t_b); then the
// ascending union of t (copied, never recomputed) and t_f.  u is sorted
// per ray (the eval grid, or sorted uniforms: sorting iid uniforms keeps
// the multiset of fine samples, and only the union is read downstream), so
// t_f is ascending and the union is a two-way merge by rank:
//   pos_c[i] = i + #{t_f < t_c[i]},  pos_f[j] = j + #{t_c <= t_f[j]}
// (strict and non-strict, so ties take distinct positions).
//
// What bounds it on this card: bytes.  At the render chunk (B = 16384, S =
// 64, NF = 128) it reads t and w (8 MB) and writes the union (12.6 MB):
// ~6 us at 3.35 TB/s.  Its arithmetic is a few hundred operations per ray.
//
// What the design does about that: one warp per ray, the ray's arrays in
// shared memory, every global read and the output row's store coalesced.
// The TPU kernel's O((S + NF)^2) compare loops (a VPU formulation: bin
// windows over the static cdf axis, rank counts, a scatter by equality)
// become a warp scan and binary searches:
//   * the sum of the floored weights by a warp reduction, the cdf by a
//     chunk per lane plus a warp exclusive scan of the chunk sums, both in
//     double and rounded once per entry: a draw's t moves by cdf error x
//     (bin width) / (bin mass), and bins hold as little as 1e-5, so one
//     float ulp of the cdf can move t by ~4e-4.  Accumulating in double
//     keeps the kernel's cdf within half an ulp of exact, so what differs
//     from the float32 chain is the chain's own rounding;
//   * per u (strided over lanes) an upper-bound binary search of the cdf;
//   * per coarse value a lower-bound search of t_f, per fine value an
//     upper-bound search of t, and a scatter to the shared output row.
// The arithmetic of the lookup is rounded operation by operation (no
// contraction), as the plain chain computes it.  `w_floor` is the weight
// floor, 1e-5 from the wrapper (a parameter so a check can show a kernel
// without it fails).  No block-level sync: warps are independent.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRayWarps = 8;  // rays per block
constexpr int kMaxSmem = 232448;

struct Params {
  const float* t;  // (B, S) ascending
  const float* w;  // (B, S)
  const float* u;  // (B, NF) sorted per ray, or one row shared by all (u_stride 0)
  long long u_stride;
  float* out;  // (B, S + NF)
  int B, S, NF;
  float w_floor;
};

// First index i in [0, n) with a[i] > v (n if none).
__device__ __forceinline__ int upper_bound(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// First index i in [0, n) with a[i] >= v (n if none).
__device__ __forceinline__ int lower_bound(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kRayWarps * 32)
    pdf_union_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = p.S, NF = p.NF, M = S + NF, K = S + 1;
  float* ts = smem + (size_t)warp * (S + K + NF + M);  // (S) coarse t
  float* cdf = ts + S;                                   // (S + 1)
  float* tf = cdf + K;                                   // (NF) fine t
  float* row = tf + NF;                                  // (S + NF) the union
  const int ray = blockIdx.x * kRayWarps + warp;
  if (ray >= p.B) return;  // warp-uniform
  const float* tr = p.t + (size_t)ray * S;
  const float* wr = p.w + (size_t)ray * S;

  // ---- pdf and cdf, accumulated in double and rounded once per entry.
  double part = 0.0;
  for (int j = lane; j < S; j += 32) {
    ts[j] = tr[j];
    part += (double)(wr[j] + p.w_floor);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  const double total = part;
  const int chunk = (S + 31) / 32;
  const int j0 = min(lane * chunk, S);
  const int j1 = min(j0 + chunk, S);
  double csum = 0.0;
  for (int j = j0; j < j1; ++j) csum += (double)(wr[j] + p.w_floor) / total;
  double incl = csum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  double run = __shfl_up_sync(0xffffffffu, incl, 1);  // exclusive prefix
  if (lane == 0) run = 0.0;
  for (int j = j0; j < j1; ++j) {
    run += (double)(wr[j] + p.w_floor) / total;
    cdf[j + 1] = (float)run;
  }
  if (lane == 0) cdf[0] = 0.f;
  __syncwarp();

  // ---- Inverse CDF: t_mid(k) = 0.5 * (t[k+1] + t[k]), extended by its last.
  auto t_mid = [&](int k) {
    const int kk = min(k, S - 2);
    return __fmul_rn(0.5f, __fadd_rn(ts[kk + 1], ts[kk]));
  };
  const float* ur = p.u + (size_t)ray * p.u_stride;
  for (int j = lane; j < NF; j += 32) {
    const float u = ur[j];
    const int below = max(0, min(upper_bound(cdf, K, u) - 1, K - 1));
    const int above = min(below + 1, K - 1);
    const float cb = cdf[below];
    const float tb = t_mid(below);
    float denom = __fsub_rn(cdf[above], cb);
    if (denom < 1e-5f) denom = 1.f;
    const float frac = __fdiv_rn(__fsub_rn(u, cb), denom);
    tf[j] = __fadd_rn(tb, __fmul_rn(frac, __fsub_rn(t_mid(above), tb)));
  }
  __syncwarp();

  // ---- Merge by rank into the shared row, then one coalesced store.
  for (int i = lane; i < S; i += 32) row[i + lower_bound(tf, NF, ts[i])] = ts[i];
  for (int j = lane; j < NF; j += 32) row[j + upper_bound(ts, S, tf[j])] = tf[j];
  __syncwarp();
  float* out = p.out + (size_t)ray * M;
  for (int k = lane; k < M; k += 32) out[k] = row[k];
}

}  // namespace

// Plain C entry point, loaded with ctypes.  t, w (B, S) f32 with S >= 2,
// u (B, NF) f32 sorted per ray with row stride u_stride (0: one row for
// every ray), out (B, S + NF) f32.  Launches on `stream`, returns
// cudaGetLastError() (0 on success); does not synchronise and allocates
// nothing.
extern "C" int nkt_pdf_union(const void* t, const void* w, const void* u, long long u_stride,
                             int B, int S, int NF, float w_floor, void* out, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S < 2 || NF < 1 || u_stride < 0) return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(t), static_cast<const float*>(w),
           static_cast<const float*>(u), u_stride, static_cast<float*>(out), B, S, NF,
           w_floor};
  const size_t smem = sizeof(float) * kRayWarps * ((size_t)S + (S + 1) + NF + (S + NF));
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(pdf_union_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kRayWarps - 1) / kRayWarps;
  pdf_union_kernel<<<grid, kRayWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
