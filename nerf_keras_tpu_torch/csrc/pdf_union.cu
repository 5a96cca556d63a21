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
// t_f is ascending too.
//
// What bounds it on this card: bytes.  At the render chunk (B = 16384, S =
// 64, NF = 128) it reads t and w (8 MB) and writes the union (12.6 MB):
// 6.3 us at 3.35 TB/s.  Its arithmetic is a few hundred operations per
// ray, so at the byte bound the card can dispatch ~350 warp instructions
// for each ray: the design is about instructions and dependent latency.
//
// What the design does about that.  Both steps are merges of two sorted
// sequences, not searches:
//   * the bin lookup merges u with the cdf; taking u[j] after i cdf
//     entries says #{cdf <= u[j]} = i (a cdf entry goes first on a tie);
//   * the union merges t with t_f; a coarse value goes first on a tie, so
//     pos_c[i] = i + #{t_f < t[i]} and pos_f[j] = j + #{t <= t_f[j]}, the
//     ranks the TPU kernel computed with O((S + NF)^2) compares.
// Half a warp serves a ray (two rays a warp; S = 64 is 16 lanes of
// float4).  Each lane owns a contiguous range of ~(S + NF) / 16 merge
// outputs: one diagonal binary search (merge path) finds where its range
// starts, then it walks the range, loading one element a step; each input
// ends in a +inf sentinel, so a step has no branch: two loads, a compare.  Every
// lane does the same number of steps whatever the weights, where a search
// per value did ~7 dependent loads for each of ~10 values a lane.
// Measured on the card (exp_k7), a ray's work is a chain of dependent
// latencies more than an instruction budget, so the design shortens the
// chain:
//   * every global load of a ray is in flight at once (one round trip to
//     memory, not one per array): t and u by cp.async straight into shared
//     memory (u through L1: the eval grid is one row that every ray reads,
//     and without L1 every SM queues on the same few L2 lines), w into
//     registers, and the cdf is computed meanwhile;
//   * the cdf: the floored weights, held in registers, summed in double
//     over a contiguous chunk per lane, an inclusive shuffle scan of the
//     chunk sums, one double reciprocal of the total (`__drcp_rn`, no
//     division), and one rounding to float per entry.  A draw's t moves
//     by cdf error x (bin width) / (bin mass), and bins hold as little as
//     1e-5, so one float ulp of the cdf can move t by ~4e-4; in double the
//     cdf is within half an ulp of exact, so what differs from the float32
//     chain is the chain's own rounding;
//   * the lookup's arithmetic is rounded operation by operation (no
//     contraction), as the plain chain computes it; the cdf and the
//     extended midpoints sit side by side (float2), one load per bin edge;
//   * shared memory per ray: t, u, (cdf, midpoint) pairs, the fine values
//     (u and the pairs' space becomes the union's row).  The row leaves in
//     float4 stores, coalesced; t, w and u arrive in float4 loads where S,
//     NF and the pointers allow.
// `w_floor` is the weight floor, 1e-5 from the wrapper (a parameter so a
// check can show a kernel without it fails).  No block-level sync: each
// half warp is independent.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kLanes = 16;                   // lanes per ray
constexpr int kWarps = 8;                    // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRays = kThreads / kLanes;     // rays per block
constexpr unsigned kGroupMask = kLanes == 32 ? 0xffffffffu : (1u << kLanes) - 1u;
constexpr int kMinBlocks = 6;                // 48 resident warps per SM
constexpr int kMaxS = 256;                   // S <= kLanes * 16
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

struct Params {
  const float* t;  // (B, S) ascending
  const float* w;  // (B, S)
  const float* u;  // (B, NF) sorted per ray, or one row shared by all (u_stride 0)
  long long u_stride;
  float* out;  // (B, S + NF)
  int B, S, NF;
  float w_floor;
  int off_u, off_cm, off_tf, stride;  // per-ray shared layout, in floats (see layout())
  int vec_tw, vec_u, vec_out;         // float4 paths allowed
};

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// Per-ray shared memory, in floats, each array ended by a +inf sentinel:
// t (S + 1) | u (NF + 1) | (cdf, midpoint) pairs (S + 2) | t_f (NF + 1).  The
// union's row (S + NF) takes the place of u and the pairs once both are read.
void layout(Params& p) {
  p.off_u = pad4(p.S + 1);
  p.off_cm = p.off_u + pad4(p.NF + 1);
  p.off_tf = p.off_cm + pad4(2 * (p.S + 2));
  p.stride = p.off_tf + pad4(p.NF + 1);
}

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// 16 bytes global -> shared without registers (completes at cp_async_wait),
// through L1 (kL1: the eval grid, one row that every ray reads) or not.
template <bool kL1>
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kL1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Merge path: how many elements of a (na, stride SA) are among the first
// `diag` outputs of merging a with b (nb), a going first on ties.
template <int SA>
__device__ __forceinline__ int merge_path(const float* a, int na, const float* b, int nb,
                                          int diag) {
  int lo = max(0, diag - nb), hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool in = a[mid * SA] <= b[diag - 1 - mid];
    lo = in ? mid + 1 : lo;
    hi = in ? hi : mid;
  }
  return lo;
}

// C: the t and w values a lane holds in registers (S <= kLanes * C).  C = 4
// serves S <= 64 at 48 resident warps a SM; C = 16 (S <= 256) is there for
// larger S, where shared memory limits the blocks anyway.
template <int C>
__global__ void __launch_bounds__(kThreads, C == 4 ? kMinBlocks : 2)
    pdf_union_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  const int slot = threadIdx.x / kLanes;
  const int hl = threadIdx.x % kLanes;
  const unsigned mask = kGroupMask << ((threadIdx.x & 31) & ~(kLanes - 1));
  const int ray = blockIdx.x * kRays + slot;
  if (ray >= p.B) return;  // uniform over the ray's lanes
  const int S = p.S, NF = p.NF, K = S + 1, M = S + NF;
  float* ts = smem + (size_t)slot * p.stride;               // (S) coarse t
  float* us = ts + p.off_u;                                 // (NF) u
  float2* cm = reinterpret_cast<float2*>(ts + p.off_cm);    // (K) cdf, midpoint
  float* tf = ts + p.off_tf;                                // (NF) bins, then fine t
  float* row = us;                                          // (S + NF) the union

  // ---- Every global load first (one round trip): t and u straight into
  // shared memory (cp.async), w into registers, a lane's [j0, j0 + C).
  // The cdf is computed while the copies are in flight.
  const int j0 = hl * C;
  const float* tg = p.t + (size_t)ray * S;
  const float* wg = p.w + (size_t)ray * S;
  const float* ug = p.u + (size_t)ray * p.u_stride;
  float wv[C];
  if (p.vec_tw) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + 4 * q < S) {
        cp_async16<false>(ts + j0 + 4 * q, tg + j0 + 4 * q);
        b = __ldg(reinterpret_cast<const float4*>(wg + j0) + q);
      }
      wv[4 * q] = b.x, wv[4 * q + 1] = b.y, wv[4 * q + 2] = b.z, wv[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) wv[c] = j0 + c < S ? __ldg(wg + j0 + c) : 0.f;
  }
  if (p.vec_u) {
    for (int k = hl; k < (NF >> 2); k += kLanes) cp_async16<true>(us + 4 * k, ug + 4 * k);
  }

  // ---- pdf and cdf, accumulated in double and rounded once per entry.
  double part = 0.0;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (j0 + c < S) part += (double)(wv[c] + p.w_floor);
  double incl = part;
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const double v = __shfl_up_sync(mask, incl, off, kLanes);
    if (hl >= off) incl += v;
  }
  const double inv = __drcp_rn(__shfl_sync(mask, incl, kLanes - 1, kLanes));
  double run = __shfl_up_sync(mask, incl, 1, kLanes);  // exclusive prefix
  if (hl == 0) run = 0.0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (j0 + c < S) {
      run += (double)(wv[c] + p.w_floor);
      cm[j0 + c + 1].x = (float)(run * inv);
    }
  }
  if (hl == 0) cm[0].x = 0.f, cm[K].x = inf();
  if (!p.vec_tw)
    for (int k = hl; k < S; k += kLanes) ts[k] = __ldg(tg + k);
  if (!p.vec_u)
    for (int k = hl; k < NF; k += kLanes) us[k] = __ldg(ug + k);
  if (hl == 0) ts[S] = us[NF] = inf();
  cp_async_wait();
  __syncwarp(mask);  // loaded
  // t_mid(k) = 0.5 * (t[k+1] + t[k]), extended by its last entry.
  for (int k = hl; k < K; k += kLanes) {
    const int kk = min(k, S - 2);
    cm[k].y = __fmul_rn(0.5f, __fadd_rn(ts[kk + 1], ts[kk]));
  }
  __syncwarp(mask);  // cdf

  // ---- Bin lookup: merge the cdf (a) with u (b).  Taking u[j] after i cdf
  // entries records #{cdf <= u[j]} = i in tf[j] (as the float's bits).  The
  // sentinels end each input and a step has no branch: both loads, one
  // compare, a store (to the spare slot tf[NF] when a cdf entry is taken).
  {
    const int n = K + NF, per = (n + kLanes - 1) / kLanes;
    const int d0 = min(hl * per, n), d1 = min(d0 + per, n);
    int i = merge_path<2>(&cm[0].x, K, us, NF, d0), j = d0 - i;
    for (int d = d0; d < d1; ++d) {
      const bool take_a = cm[i].x <= us[j];
      tf[take_a ? NF : j] = __int_as_float(i);
      i += take_a;
      j += !take_a;
    }
  }
  __syncwarp(mask);  // bins

  // ---- Inverse CDF per u, in place of its bin.
  for (int j = hl; j < NF; j += kLanes) {
    const int below = max(__float_as_int(tf[j]) - 1, 0);
    const int above = min(below + 1, K - 1);
    const float2 b = cm[below], a = cm[above];
    float denom = __fsub_rn(a.x, b.x);
    if (denom < 1e-5f) denom = 1.f;
    const float frac = __fdiv_rn(__fsub_rn(us[j], b.x), denom);
    tf[j] = __fadd_rn(b.y, __fmul_rn(frac, __fsub_rn(a.y, b.y)));
  }
  if (hl == 0) tf[NF] = inf();
  __syncwarp(mask);  // fine

  // ---- Union: merge t (a) with t_f (b) into the row, then store it.
  {
    const int per = (M + kLanes - 1) / kLanes;
    const int d0 = min(hl * per, M), d1 = min(d0 + per, M);
    int i = merge_path<1>(ts, S, tf, NF, d0), j = d0 - i;
    for (int d = d0; d < d1; ++d) {
      const float av = ts[i], bv = tf[j];
      const bool take_a = av <= bv;
      row[d] = take_a ? av : bv;
      i += take_a;
      j += !take_a;
    }
  }
  __syncwarp(mask);  // union
  float* out = p.out + (size_t)ray * M;
  if (p.vec_out) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int k = hl; k < (M >> 2); k += kLanes) o4[k] = r4[k];
  } else {
    for (int k = hl; k < M; k += kLanes) out[k] = row[k];
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

template <int C>
int launch(const Params& p, int device, cudaStream_t stream) {
  static std::atomic<bool> opened[kMaxDevices];
  if (!opened[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        pdf_union_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opened[device].store(true, std::memory_order_release);
  }
  const size_t smem = sizeof(float) * (size_t)kRays * p.stride;
  pdf_union_kernel<C><<<(p.B + kRays - 1) / kRays, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  t, w (B, S) f32 with S >= 2,
// u (B, NF) f32 sorted per ray with row stride u_stride (0: one row for
// every ray), out (B, S + NF) f32.  Launches on `stream`, returns
// cudaGetLastError() (0 on success); does not synchronise and allocates
// nothing.  The kernel's shared-memory limit is raised once per device.
extern "C" int nkt_pdf_union(const void* t, const void* w, const void* u, long long u_stride,
                             int B, int S, int NF, float w_floor, void* out, int device,
                             void* stream) {
  if (B <= 0 || S < 2 || S > kMaxS || NF < 1 || u_stride < 0 || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  Params p{static_cast<const float*>(t), static_cast<const float*>(w),
           static_cast<const float*>(u), u_stride, static_cast<float*>(out), B, S, NF,
           w_floor};
  layout(p);
  if (sizeof(float) * (size_t)kRays * p.stride > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  p.vec_tw = S % 4 == 0 && aligned16(t) && aligned16(w);
  p.vec_u = NF % 4 == 0 && u_stride % 4 == 0 && aligned16(u);
  p.vec_out = (S + NF) % 4 == 0 && aligned16(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return S <= kLanes * 4 ? launch<4>(p, device, st) : launch<16>(p, device, st);
}
