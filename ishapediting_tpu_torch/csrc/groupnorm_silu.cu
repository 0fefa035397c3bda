// Fused GroupNorm + optional FiLM scale-shift + SiLU over NHWC activations.
//
// Replaces: ishapediting_tpu/ops/pallas_kernels.py::groupnorm_silu, i.e. the
// two Pallas kernels _gn_stats_kernel (per-(batch, group) fp32 sum and sum of
// squares carried across a sequential row-tile grid) and _gn_norm_kernel
// (silu((x-mean)*rsqrt(var+eps)*gamma+beta [*(1+fs)+fb]), cast back to x's
// dtype).
//
// Bound on this card: memory. The function reads x once and writes y once
// (4 bytes per element in bf16, 8 in fp32); its arithmetic is a few dozen
// flops per element, far below the ~295 flops/byte where an H100 turns
// compute-bound. The least time is (read x + write y) / 3.35 TB/s.
//
// Design. CUDA blocks run in parallel and in no order, so the TPU's carried
// accumulator does not translate. Two launches instead:
//   1. gn_stats: the block shape of gn_norm, blockDim = (C/VEC, rows), with
//      long-lived blocks. Each thread owns one 16-byte channel vector (8 bf16
//      or 4 fp32; cg % VEC == 0, so all its channels lie in one group) for
//      its whole life and walks the rows with a grid stride, four rows in
//      flight, so a warp reads contiguous 128-byte lines of NHWC rows
//      whatever cg is. Per element there is no divide: every thread sums
//      d = x - p and d^2, where the pivot p is the group's value at row 0,
//      one pivot for the whole (sample, group). The shift is what keeps
//      Chan's precision: p lies within the group's spread, so
//      sum(d^2) - sum(d)^2/n cancels no more than M2 itself (the cancellation
//      of E[x^2] - E[x]^2 comes from a mean far from zero, which the shift
//      removes). With one pivot, merging threads, blocks and CTAs is a plain
//      sum: per group, a warp adds its threads' sums in shared memory and
//      divides once, so each block writes one (count, mean, M2) partial per
//      group, at most 32 blocks per sample. Where 32 blocks would leave each
//      thread many rows (the 64^2 and 128^2 inputs), the blocks of a sample
//      form thread block clusters along the rows: each CTA stores its group
//      sums into the leader's shared memory (distributed shared memory,
//      map_shared_rank), and after one cluster barrier the leader adds them
//      (a lane per CTA) and writes the partial, so there are still at most 32
//      per (sample, group). A cluster launch costs about 1 us of device time
//      on an H100 (PERF.md), so smaller inputs take a plain launch. No
//      atomics: the same result on every run. Partials: fp32 [N, G, S, 3].
//      Unaligned inputs and cg % VEC != 0 take VEC = 1, one channel per
//      thread; widths whose vectors do not fit one block split C over
//      blockIdx.y, and each channel block writes its own partials (count 0
//      for the groups it does not touch).
//   2. gn_norm: a streaming FMA + SiLU. Long-lived blocks of up to 512
//      threads, two per SM (2 x 132 in all, one wave); each thread owns one
//      channel vector (8 bf16 or 4 fp32, 16-byte loads and stores along C)
//      for its whole life and walks the rows with a grid stride, four rows
//      in flight. Loads that do not need the statistics (the thread's
//      parameters and first rows) are issued before the merge.
//      The block shape follows C: blockDim = (C/VEC, rows), so every chairs
//      width (C/8 from 32 to 256, including 96, 160, 192 and 224, which no
//      fixed 256-thread block divides) keeps each thread on one vector.
//      Per block, once: the G x S partials are merged in parallel (a warp per
//      group, Chan's merge over the splits in a shuffle tree, no atomics: the
//      same result on every run), and each thread folds the group statistics,
//      the affine and FiLM into two coefficients per channel in registers,
//      a = rstd*gamma*(1+fs) and b = (beta - mean*rstd*gamma)*(1+fs) + fb.
//      Per element the body is then y = silu(x*a + b): one FMA, the fast
//      exponential and a fast reciprocal, with no divide and no parameter
//      load. Widths whose vectors do not fit one block (or unaligned,
//      C % VEC != 0 inputs, VEC = 1) split C over blockIdx.y.
// The partial statistics are (count, mean, M2) merged with Chan's formula
// rather than E[x^2]-E[x]^2: the same function with less cancellation when
// the mean is large against the spread. All arithmetic is fp32.
// x is read twice (once per pass); at the main path's sizes (up to 32 MB per
// call) the second read is partly served from the 50 MB L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kStatsThreads = 1024;  // most threads of a gn_stats block
constexpr int kMaxCluster = 8;       // CTAs per cluster, at most (the portable size)
constexpr int kMaxPushBytes = 227 * 1024 - 16 * kStatsThreads;  // gn_stats dynamic smem, at most
constexpr int kNormThreads = 512;  // most threads of a gn_norm block
constexpr int kMaxGroups = 1024;

struct Stat {
  float n, mean, m2;
};

__device__ __forceinline__ void chan_merge(Stat& a, const Stat& b) {
  if (b.n == 0.f) return;
  float n = a.n + b.n;
  float delta = b.mean - a.mean;
  float frac = b.n / n;
  a.mean += delta * frac;
  a.m2 += b.m2 + delta * delta * a.n * frac;
  a.n = n;
}

// Sums of a (sample, group) around its pivot: count, sum(x - p),
// sum((x - p)^2). Merged by adding.
struct Sums {
  float n, s1, s2;
  __device__ __forceinline__ Sums& operator+=(const Sums& o) {
    n += o.n;
    s1 += o.s1;
    s2 += o.s2;
    return *this;
  }
};

__device__ __forceinline__ Sums warp_sum(Sums a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a.n += __shfl_down_sync(0xffffffffu, a.n, off);
    a.s1 += __shfl_down_sync(0xffffffffu, a.s1, off);
    a.s2 += __shfl_down_sync(0xffffffffu, a.s2, off);
  }
  return a;
}

__device__ __forceinline__ Stat shfl_down_stat(const Stat& s, int off) {
  Stat o;
  o.n = __shfl_down_sync(0xffffffffu, s.n, off);
  o.mean = __shfl_down_sync(0xffffffffu, s.mean, off);
  o.m2 = __shfl_down_sync(0xffffffffu, s.m2, off);
  return o;
}

__device__ __forceinline__ float load_scalar(const float* p) { return *p; }
__device__ __forceinline__ float load_scalar(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Thread block cluster barrier, split: arrive (relaxed: orders nothing; or
// release) now, wait (acquire) later. Every thread of every CTA calls both.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Raw 16-byte (or one-element) vectors, kept packed while a load is in
// flight and unpacked to floats when used.
template <typename T, int VEC>
struct RawVec;
template <>
struct RawVec<__nv_bfloat16, 8> { using type = uint4; };
template <>
struct RawVec<__nv_bfloat16, 1> { using type = __nv_bfloat16; };
template <>
struct RawVec<float, 4> { using type = float4; };
template <>
struct RawVec<float, 1> { using type = float; };

__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const __nv_bfloat16& r, float (&v)[1]) { v[0] = __bfloat162float(r); }
__device__ __forceinline__ void unpack(const float4& r, float (&v)[4]) {
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void unpack(const float& r, float (&v)[1]) { v[0] = r; }

// VEC elements of T starting at p (16-byte aligned when VEC > 1) into floats:
// one load into a register copy (a reference into global memory would let
// the compiler split it into one load per pair), then unpacked.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  const typename RawVec<T, VEC>::type r = *reinterpret_cast<const typename RawVec<T, VEC>::type*>(p);
  unpack(r, v);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* v);

template <>
__device__ __forceinline__ void store_vec<float, 4>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store_vec<float, 1>(float* p, const float* v) {
  *p = v[0];
}
template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 8>(__nv_bfloat16* p, const float* v) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = r;
}
template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 1>(__nv_bfloat16* p, const float* v) {
  *p = __float2bfloat16_rn(v[0]);
}

// silu(t) = t / (1 + e^-t) with the fast exponential and reciprocal. For
// t << 0, e^-t overflows to +inf, rcp.approx(inf) = 0 and the result is -0;
// for t >> 0 it is t.
__device__ __forceinline__ float silu_fast(float t) {
  return t * __fdividef(1.f, 1.f + __expf(-t));
}

// (count, mean, M2) of one (sample, group) partial from its sums around
// the pivot p; zeros for a group with no elements here.
__device__ __forceinline__ void write_partial(float* out, const Sums& a, float p) {
  const float sh = a.n > 0.f ? a.s1 / a.n : 0.f;
  out[0] = a.n;
  out[1] = a.n > 0.f ? p + sh : 0.f;
  out[2] = fmaxf(0.f, a.s2 - a.s1 * sh);
}

// Pass 1. Block (bdx, bdy), grid (grid_x row blocks, grid_c channel
// blocks, N); with CLUSTER, clusters of cs blocks along x. Thread (tx, ty)
// of block (bx, cb) owns channel vector v = cb*bdx + tx and rows
// bx*bdy + ty + k*step, step = grid_x*bdy, as in gn_norm. Partial
// s = cb*clusters + bx/cs (cs = 1 without CLUSTER) of every group g goes to
// part[((n*G + g)*S + s)*3].
template <typename T, int VEC, bool CLUSTER>
__global__ void __launch_bounds__(kStatsThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int HW, int C, int G, int S,
                int clusters) {
  __shared__ Sums s_thr[kStatsThreads];  // one per thread, column tx*bdy + ty
  __shared__ float s_piv[kStatsThreads];  // the pivot of each group touched
  extern __shared__ Sums s_push[];        // CLUSTER, the leader's: [rank][group touched]
  if (CLUSTER) cluster_arrive_relaxed();  // this CTA has started; waited on before remote stores
  const int n = blockIdx.z;
  const int vpr = C / VEC;  // a row, in vectors
  const int cgs = C / G;
  const int v0 = blockIdx.y * blockDim.x;
  const int v1 = min(vpr, v0 + (int)blockDim.x);
  const int g_lo = v0 * VEC / cgs, g_hi = (v1 * VEC - 1) / cgs;  // groups this block touches
  const int v = v0 + threadIdx.x;
  const bool owner = v < vpr;
  const T* xn = x + (long long)n * HW * C;

  // Sums of d = x - p and d^2 over this thread's channels and rows, where
  // the pivot p is the group's value at row 0 (shared by every thread and
  // block of the (sample, group)): no divide per element, and merging is a
  // plain sum. One division per group at the end gives the mean p + s1/n
  // and M2 = s2 - s1^2/n.
  using Raw = typename RawVec<T, VEC>::type;
  const long long step = (long long)gridDim.x * blockDim.y;
  const Raw* xs = reinterpret_cast<const Raw*>(xn + (long long)v * VEC);
  long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;
  int rows = 0;
  const int g_own = v * VEC / cgs;
  const float p = owner ? load_scalar(xn + g_own * cgs) : 0.f;
  for (; owner && r < HW; r += 4 * step) {
    Raw u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = r + i * step < HW ? xs[(r + i * step) * vpr] : Raw{};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r + i * step >= HW) break;
      float w[VEC];
      unpack(u[i], w);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = w[k] - p;
        s1[k] += d;
        s2[k] = fmaf(d, d, s2[k]);
      }
      ++rows;
    }
  }
  Sums st = {(float)(rows * VEC), 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    st.s1 += s1[k];
    st.s2 += s2[k];
  }
  s_thr[threadIdx.x * blockDim.y + threadIdx.y] = st;
  // The group's first vector in this block records the pivot.
  if (owner && threadIdx.y == 0 && (v == v0 || (v * VEC) % cgs < VEC)) s_piv[g_own - g_lo] = p;
  __syncthreads();

  // Sum per group, one full warp per group: group g's vectors in this block
  // are [a, b) (cg % VEC == 0 where VEC > 1), their sums s_thr[a*bdy ..
  // b*bdy). Without CLUSTER lane 0 writes the partial; with it, lane 0
  // pushes the sums into the leader's s_push[rank][g - g_lo] (a store into
  // distributed shared memory: no latency waits on it).
  const int ng = g_hi - g_lo + 1;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x * blockDim.y, full_warps = nthreads >> 5;
  const int cs = CLUSTER ? (int)cg::this_cluster().num_blocks() : 1;
  const int rank = CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const int s = blockIdx.y * clusters + blockIdx.x / cs;
  float* pn = part + (long long)n * G * S * 3;
  Sums* push = nullptr;
  if (CLUSTER) {
    push = cg::this_cluster().map_shared_rank(s_push, 0) + rank * ng;
    cluster_wait();  // every CTA of the cluster has started: the leader's memory is there
  }
  for (int jg = warp; warp < full_warps && jg < ng; jg += full_warps) {
    const int g = g_lo + jg;
    const int a = max(v0, g * cgs / VEC) - v0;
    const int b = min(v1, (g + 1) * cgs / VEC) - v0;
    Sums acc = {0.f, 0.f, 0.f};
    for (int i = a * blockDim.y + lane; i < b * blockDim.y; i += 32) acc += s_thr[i];
    acc = warp_sum(acc);
    if (lane == 0) {
      if (CLUSTER) push[jg] = acc;
      else write_partial(pn + ((long long)g * S + s) * 3, acc, s_piv[jg]);
    }
  }
  if (CLUSTER) {
    cluster_arrive();  // release: the pushes are visible to the leader after its wait
    cluster_wait();
    if (rank != 0) return;
    // The leader sums the pushes, one warp per group, one lane per CTA.
    for (int jg = warp; warp < full_warps && jg < ng; jg += full_warps) {
      Sums acc = {0.f, 0.f, 0.f};
      if (lane < cs) acc = s_push[lane * ng + jg];
      acc = warp_sum(acc);
      if (lane == 0) write_partial(pn + ((long long)(g_lo + jg) * S + s) * 3, acc, s_piv[jg]);
    }
  }
  // Count 0 for the groups outside this channel block (C split over grid y).
  if (gridDim.y > 1)
    for (int g = tid; g < G; g += nthreads)
      if (g < g_lo || g > g_hi) write_partial(pn + ((long long)g * S + s) * 3, Sums{0.f, 0.f, 0.f}, 0.f);
}

// Pass 2. block (bdx, bdy), grid (row blocks, channel blocks, N). Thread
// (tx, ty) of block (bx, cb) owns the channel vector v = cb*bdx + tx (VEC
// channels from v*VEC) of sample n for its whole life, and walks rows
// bx*bdy + ty, then a grid stride of gridDim.x*bdy rows, so every row of the
// sample is visited once. gamma, beta: [C] fp32; film: [N, 2, C] fp32 (scale
// row first) or null.
template <typename T, int VEC>
__global__ void __launch_bounds__(kNormThreads, 2)
gn_norm_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ part,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               const float* __restrict__ film, int HW, int C, int G, int S, float eps) {
  __shared__ float s_mean[kMaxGroups];
  __shared__ float s_rstd[kMaxGroups];
  const int n = blockIdx.z;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  const bool owner = v * VEC < C;

  // Loads that do not depend on the statistics go out first, so that their
  // latency hides behind the merge: this thread's affine terms and its first
  // two rows.
  using Raw = typename RawVec<T, VEC>::type;
  float a[VEC], b[VEC];
  const long long step = (long long)gridDim.x * blockDim.y;
  const Raw* xs = reinterpret_cast<const Raw*>(x + (long long)n * HW * C + (long long)v * VEC);
  Raw* ys = reinterpret_cast<Raw*>(y + (long long)n * HW * C + (long long)v * VEC);
  const long long row = C / VEC;  // a row, in vectors
  long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  Raw u0 = {}, u1 = {};
  if (owner) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = v * VEC + k;
      a[k] = gamma[c];
      b[k] = beta[c];
    }
    if (r < HW) u0 = xs[r * row];
    if (r + step < HW) u1 = xs[(r + step) * row];
  }

  // Merge the S partials of every group, one warp per group (lanes take
  // splits s = lane, lane + 32, ...; then a shuffle tree). Threads of a
  // last, partial warp sit this out.
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int full_warps = (blockDim.x * blockDim.y) >> 5;
  for (int g = warp; warp < full_warps && g < G; g += full_warps) {
    const float* p = part + ((long long)n * G + g) * S * 3;
    Stat acc = {0.f, 0.f, 0.f};
    for (int s = lane; s < S; s += 32) {
      const Stat st = {p[3 * s], p[3 * s + 1], p[3 * s + 2]};
      chan_merge(acc, st);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) chan_merge(acc, shfl_down_stat(acc, off));
    if (lane == 0) {
      s_mean[g] = acc.mean;
      s_rstd[g] = rsqrtf(acc.m2 / acc.n + eps);
    }
  }
  __syncthreads();
  if (!owner) return;

  // Fold statistics, affine and FiLM into two coefficients per channel, so
  // that the body is y = silu(x*a + b):
  // a = rstd*gamma*(1+fs), b = (beta - mean*rstd*gamma)*(1+fs) + fb.
  const int cg = C / G;
  const float* fs = film ? film + (long long)n * 2 * C : nullptr;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int c = v * VEC + k;
    const int g = c / cg;
    const float ga = a[k] * s_rstd[g];
    const float f1 = fs ? 1.f + fs[c] : 1.f;
    a[k] = ga * f1;
    b[k] = (b[k] - s_mean[g] * ga) * f1 + (fs ? fs[C + c] : 0.f);
  }

  // Body: two rows at hand, the next two in flight.
  for (; r < HW; r += 2 * step) {
    const long long rn = r + 2 * step;
    Raw n0 = {}, n1 = {};
    if (rn < HW) n0 = xs[rn * row];
    if (rn + step < HW) n1 = xs[(rn + step) * row];
    float w0[VEC], w1[VEC];
    unpack(u0, w0);
    unpack(u1, w1);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      w0[k] = silu_fast(fmaf(w0[k], a[k], b[k]));
      w1[k] = silu_fast(fmaf(w1[k], a[k], b[k]));
    }
    store_vec<T, VEC>(reinterpret_cast<T*>(ys + r * row), w0);
    if (r + step < HW) store_vec<T, VEC>(reinterpret_cast<T*>(ys + (r + step) * row), w1);
    u0 = n0;
    u1 = n1;
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int VEC>
int launch_stats(const void* x, void* part, int HW, int C, int G, int S, int clusters,
                 dim3 block, dim3 grid, int cs, int push_bytes, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  float* pp = static_cast<float*>(part);
  if (cs == 1) {  // no cluster: each block writes its own partials
    gn_stats_kernel<T, VEC, false><<<grid, block, 0, stream>>>(xp, pp, HW, C, G, S, clusters);
    return (int)cudaSuccess;
  }
  static const cudaError_t smem_attr = cudaFuncSetAttribute(
      gn_stats_kernel<T, VEC, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxPushBytes);
  if (smem_attr != cudaSuccess) return (int)smem_attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = push_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gn_stats_kernel<T, VEC, true>, xp, pp, HW, C, G, S, clusters);
}

template <typename T, int VEC>
void launch_norm(const void* x, void* y, const void* part, const void* gamma,
                 const void* beta, const void* film, int N, int HW, int C, int G,
                 int S, float eps, dim3 block, dim3 grid, cudaStream_t stream) {
  gn_norm_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const float*>(part),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(film), HW, C, G, S, eps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; vec: channels per thread (bf16 8 or 1,
// fp32 4 or 1); block (bdx, bdy), grid (grid_x row blocks, grid_c channel
// blocks, N), clusters of cs blocks along x (cs = 1: a plain launch),
// clusters per channel block and S = grid_c * clusters partials per
// (sample, group), all from ops/hopper_kernels.py gn_stats_geometry.
// Returns the launch's error code, or cudaGetLastError() after it.
extern "C" int ishape_gn_stats(const void* x, void* part, int dtype, int N, int HW, int C,
                               int G, int S, int vec, int bdx, int bdy, int grid_x, int grid_c,
                               int cs, int clusters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > kMaxGroups || C % G != 0 || (C / G) % vec != 0) return (int)cudaErrorInvalidValue;
  if (bdx < 1 || bdy < 1 || bdx * bdy > kStatsThreads || bdx * bdy < 32 || cs < 1 ||
      cs > kMaxCluster || grid_x != cs * clusters || S != grid_c * clusters ||
      (long long)grid_c * bdx * vec < C || (long long)(grid_c - 1) * bdx * vec >= C)
    return (int)cudaErrorInvalidValue;
  // The leader's push area: cs CTAs x the most groups one block touches.
  const int cgs = C / G, vpr = C / vec;
  int ng = 0;
  for (int cb = 0; cb < grid_c; ++cb) {
    const int v0 = cb * bdx, v1 = v0 + bdx < vpr ? v0 + bdx : vpr;
    const int span = (v1 * vec - 1) / cgs - v0 * vec / cgs + 1;
    ng = span > ng ? span : ng;
  }
  const int push_bytes = cs * ng * (int)sizeof(Sums);
  if (push_bytes > kMaxPushBytes) return (int)cudaErrorInvalidValue;
  const dim3 block(bdx, bdy), grid(grid_x, grid_c, N);
  int rc;
  if (dtype == 1 && vec == 8 && aligned16(x))
    rc = launch_stats<__nv_bfloat16, 8>(x, part, HW, C, G, S, clusters, block, grid, cs, push_bytes, st);
  else if (dtype == 1 && vec == 1)
    rc = launch_stats<__nv_bfloat16, 1>(x, part, HW, C, G, S, clusters, block, grid, cs, push_bytes, st);
  else if (dtype == 0 && vec == 4 && aligned16(x))
    rc = launch_stats<float, 4>(x, part, HW, C, G, S, clusters, block, grid, cs, push_bytes, st);
  else if (dtype == 0 && vec == 1)
    rc = launch_stats<float, 1>(x, part, HW, C, G, S, clusters, block, grid, cs, push_bytes, st);
  else
    return (int)cudaErrorInvalidValue;
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// vec: channels per thread (bf16 8 or 1, fp32 4 or 1); block (bdx, bdy) and
// grid (grid_x row blocks, grid_c channel blocks, N) from
// ops/hopper_kernels.py gn_norm_geometry: grid_c*bdx*vec >= C, bdx*bdy >= 32.
extern "C" int ishape_gn_norm(const void* x, void* y, const void* part, const void* gamma,
                              const void* beta, const void* film, int dtype, int N,
                              int HW, int C, int G, int S, float eps, int vec, int bdx,
                              int bdy, int grid_x, int grid_c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > kMaxGroups || C % G != 0 || C % vec != 0) return (int)cudaErrorInvalidValue;
  if (bdx < 1 || bdy < 1 || bdx * bdy > kNormThreads || bdx * bdy < 32 || grid_x < 1 ||
      (long long)grid_c * bdx * vec < C)
    return (int)cudaErrorInvalidValue;
  const bool al = aligned16(x) && aligned16(y);
  const dim3 block(bdx, bdy), grid(grid_x, grid_c, N);
  if (dtype == 1 && vec == 8 && al)
    launch_norm<__nv_bfloat16, 8>(x, y, part, gamma, beta, film, N, HW, C, G, S, eps, block, grid, st);
  else if (dtype == 1 && vec == 1)
    launch_norm<__nv_bfloat16, 1>(x, y, part, gamma, beta, film, N, HW, C, G, S, eps, block, grid, st);
  else if (dtype == 0 && vec == 4 && al)
    launch_norm<float, 4>(x, y, part, gamma, beta, film, N, HW, C, G, S, eps, block, grid, st);
  else if (dtype == 0 && vec == 1)
    launch_norm<float, 1>(x, y, part, gamma, beta, film, N, HW, C, G, S, eps, block, grid, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* ishape_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ---------------------------------------------------------------------------
// Backward: the VJP of groupnorm_silu, in place of
// ishapediting_tpu/ops/pallas_kernels.py::_gn_silu_bwd, in two launches and
// nothing else (ops/hopper_kernels.py::gn_silu_bwd_cuda).
//
// With xhat = (x - mean)*rstd (the forward's statistics), a = xhat*gamma +
// beta, z = a*t1 + fb (t1 = 1 + fs; z = a without FiLM) and the SiLU
// y = z*sigmoid(z), the cotangent at z is
// gz = gy*sigmoid(z) + gy*z*(1 - sigmoid(z))*sigmoid(z). gz is evaluated at
// the rounding points in x's dtype of eager PyTorch's backward of the port's
// plain composition on the card (a, a*t1, z, sigmoid(z), each product,
// 1 - sigmoid(z) and the sum rounded to bf16, as PyTorch's CUDA bf16 sigmoid
// backward rounds after each op; t1 = 1 + fs formed in fs's dtype; no
// rounding in fp32). That backward is the reference of chip_smoke.py's 1e-2
// gate (GRAD_TOL), and its own bf16 rounding puts an exact fp32 gradient
// near the gate's edge. The JAX package's VJP rounds elsewhere: it
// differentiates _gn_silu_reference, which forms a*(1 + fs) + fb in fp32 and
// rounds once. Per (sample, channel), S1 = sum_hw gz and S2 = sum_hw
// gz*xhat give every gradient but dx: dfb = S1, dfs = gamma*S2 + beta*S1,
// dbeta = sum_n t1*S1, dgamma = sum_n t1*S2; with A, B the group means of
// k*S1 and k*S2 over the group's hw*cg elements (k = gamma*t1),
// dx = rstd*(k*gz - A - xhat*B).
//   3. gn_bwd_reduce: a block per (row block, channel block, sample), each
//      channel block whole groups (the block's statistics and gradients stay
//      in it); each thread owns one channel vector and walks rows with a
//      grid stride, the next row's loads in flight while it computes one,
//      and sums gz and gz*xhat in registers; the block's rows are summed in
//      shared memory into one (S1, S2) partial per row block. The last block
//      of a (sample, channel block) to arrive (an integer counter) sums the
//      partials in row-block order and writes dfs, dfb, t1*S1, t1*S2 and,
//      per group, (mean, rstd, A, B); the last of a channel block's samples
//      then sums t1*S1 and t1*S2 over the samples in order into dbeta and
//      dgamma. The counters only pick which block finishes: every sum is
//      taken in a fixed order, so one input gives the same bits on every run.
//      The finishing blocks reset their counters to 0 for the next launch.
//   4. gn_bwd_apply: the same launch shape and row walk; reads (mean, rstd,
//      A, B) of its thread's group and writes dx. Neither kernel merges
//      statistics outside the reduce (a warp per group of its channel block,
//      as gn_norm merges them, bit for bit).
// Arithmetic: a bf16 op on two bf16 operands is one bf16x2 instruction
// rounded once (mul/add/sub.rn.bf16x2), which is the op in fp32 rounded to
// bf16: a product of two bf16 values is exact in fp32 (above its subnormal
// range, where fp32 would round twice), and a sum is exact unless the
// smaller term lies below the larger's last bf16 bit, where both give the
// larger. So only a (from fp32 xhat) and sigmoid(z) are converted, two
// values per cvt.rn.bf16x2.f32: per element about 3 conversion or MUFU ops
// where the one-value form took 12 (10 roundings, exp and reciprocal). NaN
// stays NaN and inf inf through every step, as with __float2bfloat16_rn.
// Per-channel terms (gamma, beta, t1, fb; the apply's rstd*gamma*t1) sit in
// shared memory, so that a 512-thread block fits 64 registers a thread and
// two blocks are resident on each SM: the grid is one wave (gn_bwd_geometry
// launches no more blocks than two per SM).
//
// Bound on this card: memory. reduce reads x and gy, apply reads them again
// and writes dx: five x-sized passes (the second read partly from the 50 MB
// L2), against a few dozen operations per element.

// The arguments of both backward launches; ops/hopper_kernels.py::_GnBwdArgs
// mirrors this layout field by field. dtype codes: 0 = float32, 1 = bfloat16;
// a gradient takes its input's.
struct GnBwdArgs {
  const void* x;      // [N, HW, C]
  const void* gy;     // its cotangent: x's shape and dtype
  const float* part;  // the forward's statistics partials [N, G, S, 3]
  const void* gamma;  // [C]
  const void* beta;   // [C]
  const void* fs;     // FiLM scale [N, C], rows fs_ld apart; null without FiLM
  const void* fb;     // FiLM shift [N, C], rows fb_ld apart
  float* sums;        // workspace: (S1, S2) partials [N, grid_x, 2, C]
  float* fin;         // workspace: (t1*S1, t1*S2) [N, 2, C]
  float* stats;       // [N, 4, G]: mean, rstd, A, B
  unsigned* count;    // [N*grid_c + grid_c] arrival counters: 0 on entry, 0 on exit
  void* dgamma;       // [C]; null where not wanted, as the next three
  void* dbeta;        // [C]
  void* dfs;          // [N, C], contiguous
  void* dfb;          // [N, C], contiguous
  void* dx;           // x's shape and dtype
  long long fs_ld, fb_ld;
  int dtype, gamma_t, beta_t, fs_t, fb_t;
  int N, HW, C, G, S;
  float eps;
  int vec, bdx, bdy, grid_x, grid_c;
};

namespace {

constexpr int kBwdThreads = 512;   // threads of a backward block, at most (two resident per SM)
constexpr int kBwdMaxWidth = 512;  // channels of a backward block, at most

__device__ __forceinline__ float load_param(const void* p, int dtype, long long i) {
  return dtype == 1 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                    : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store_param(void* p, int dtype, long long i, float v) {
  if (dtype == 1)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// bf16x2 arithmetic on packed pairs (low half: the first element), each op
// rounded once to nearest even; .rn keeps ptxas from fusing a product and a
// sum into one rounding.
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// Two floats rounded to bf16 and packed: lo in the low half.
__device__ __forceinline__ uint32_t bf2_pack(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ float sigmoid_fast(float z) { return __fdividef(1.f, 1.f + __expf(-z)); }

// gz of two bf16 elements from their xhat (fp32) and packed cotangents gy2,
// at the plain composition's rounding points (the fast exponential and
// reciprocal; z << 0: sigmoid 0, gz 0). t12, fb2: packed t1 and fb.
__device__ __forceinline__ uint32_t gz_bf16x2(float xh0, float xh1, uint32_t gy2, float g0, float g1,
                                              float be0, float be1, uint32_t t12, uint32_t fb2,
                                              bool film) {
  uint32_t z = bf2_pack(fmaf(xh0, g0, be0), fmaf(xh1, g1, be1));
  if (film) z = bf2_add(bf2_mul(z, t12), fb2);
  const uint32_t sg = bf2_pack(sigmoid_fast(bf_lo(z)), sigmoid_fast(bf_hi(z)));
  const uint32_t one = 0x3f803f80u;  // (1, 1)
  return bf2_add(bf2_mul(gy2, sg), bf2_mul(bf2_mul(bf2_mul(gy2, z), bf2_sub(one, sg)), sg));
}

// gz of one fp32 element.
__device__ __forceinline__ float gz_f32(float xh, float gy, float g, float be, float t1, float fb,
                                        bool film) {
  const float a = fmaf(xh, g, be);
  const float z = film ? a * t1 + fb : a;
  const float sg = sigmoid_fast(z);
  return gy * sg + gy * z * (1.f - sg) * sg;
}

// Where channel j = tx*VEC + k of a block of bdx vectors keeps its terms in
// shared memory: groups of four channels k/4 apart by bdx, so that the
// threads of a warp read consecutive words (no bank conflicts).
template <int VEC>
__device__ __forceinline__ int term_at(int j, int bdx) {
  if (VEC < 4) return j;
  const int tx = j / VEC, k = j % VEC;
  return ((k >> 2) * bdx + tx) * 4 + (k & 3);
}

// The per-channel terms of a block's channels [c0, c0 + width) of sample n
// into shared memory, channel j at term_at(j): gamma, beta (fp32), t1 =
// 1 + fs (in fs's dtype) and fb as T (bf16 where x is bf16, which the entry
// points require of fs and fb). No barrier.
template <typename T, int VEC>
__device__ __forceinline__ void load_terms(const GnBwdArgs& a, int n, int c0, int width, float* s_g,
                                           float* s_be, T* s_t1, T* s_fb) {
  const int nthreads = blockDim.x * blockDim.y;
  for (int j = threadIdx.y * blockDim.x + threadIdx.x; j < width; j += nthreads) {
    const int c = c0 + j, at = term_at<VEC>(j, blockDim.x);
    s_g[at] = load_param(a.gamma, a.gamma_t, c);
    s_be[at] = load_param(a.beta, a.beta_t, c);
    if (a.fs != nullptr) {
      float t1 = 1.f + load_param(a.fs, a.fs_t, (long long)n * a.fs_ld + c);
      if (a.fs_t == 1) t1 = __bfloat162float(__float2bfloat16_rn(t1));
      const float fb = load_param(a.fb, a.fb_t, (long long)n * a.fb_ld + c);
      if constexpr (sizeof(T) == 2) {
        s_t1[at] = __float2bfloat16_rn(t1);
        s_fb[at] = __float2bfloat16_rn(fb);
      } else {
        s_t1[at] = t1;
        s_fb[at] = fb;
      }
    }
  }
}

// The (mean, rstd) of groups g0 .. g0 + ng - 1 of sample n from the
// forward's partials into s_mean[jg], s_rstd[jg], merged as gn_norm merges
// them (a warp per group, Chan's merge over the splits in a shuffle tree).
// No barrier.
__device__ __forceinline__ void merge_groups(const float* __restrict__ part, int n, int G, int S,
                                             float eps, int g0, int ng, float* s_mean, float* s_rstd) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int full_warps = (blockDim.x * blockDim.y) >> 5;
  for (int jg = warp; warp < full_warps && jg < ng; jg += full_warps) {
    const float* p = part + ((long long)n * G + g0 + jg) * S * 3;
    Stat acc = {0.f, 0.f, 0.f};
    for (int s = lane; s < S; s += 32) {
      const Stat st = {p[3 * s], p[3 * s + 1], p[3 * s + 2]};
      chan_merge(acc, st);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) chan_merge(acc, shfl_down_stat(acc, off));
    if (lane == 0) {
      s_mean[jg] = acc.mean;
      s_rstd[jg] = rsqrtf(acc.m2 / acc.n + eps);
    }
  }
}

// A thread's rows r, r + step, ... < hw of x and gy (vectors xs[r*row],
// gs[r*row]). prime() issues the first row's loads; walk(body) calls
// body(r, ux, ug) for each row in order, the next row's loads in flight
// while body computes one.
template <typename T, int VEC>
struct Rows {
  using Raw = typename RawVec<T, VEC>::type;
  const Raw* xs;
  const Raw* gs;
  long long r, step, row, hw;
  Raw ux = {}, ug = {};

  __device__ __forceinline__ void prime() {
    if (r < hw) {
      ux = xs[r * row];
      ug = gs[r * row];
    }
  }
  template <typename F>
  __device__ __forceinline__ void walk(F&& body) {
    for (; r < hw; r += step) {
      Raw nx = {}, ng = {};
      if (r + step < hw) {
        nx = xs[(r + step) * row];
        ng = gs[(r + step) * row];
      }
      body(r, ux, ug);
      ux = nx;
      ug = ng;
    }
  }
};

// One row of a thread's channel vector: x and gy as loaded (Raw), the terms
// from shared memory; calls f(k, xhat, gz) for each channel k.
template <typename T, int VEC>
struct Row;

template <int VEC>
struct Row<__nv_bfloat16, VEC> {
  using Raw = typename RawVec<__nv_bfloat16, VEC>::type;
  template <typename F>
  __device__ __forceinline__ static void run(const Raw& ux, const Raw& ug, float r, float mr,
                                             const float* s_g, const float* s_be,
                                             const __nv_bfloat16* s_t1, const __nv_bfloat16* s_fb,
                                             bool film, F&& f) {
    const int tx = threadIdx.x;
    float xf[VEC];
    unpack(ux, xf);
    if constexpr (VEC == 8) {
      const uint32_t gy2[4] = {ug.x, ug.y, ug.z, ug.w};
      // Four channels at a time: their terms are two 16-byte words and two
      // 8-byte words of shared memory (at term_at), loaded where used.
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 g = *reinterpret_cast<const float4*>(s_g + (q * blockDim.x + tx) * 4);
        const float4 be = *reinterpret_cast<const float4*>(s_be + (q * blockDim.x + tx) * 4);
        uint2 t1 = {}, fb = {};
        if (film) {
          t1 = *reinterpret_cast<const uint2*>(s_t1 + (q * blockDim.x + tx) * 4);
          fb = *reinterpret_cast<const uint2*>(s_fb + (q * blockDim.x + tx) * 4);
        }
        const int k = 4 * q;
        float xh[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xh[i] = fmaf(xf[k + i], r, mr);
        const uint32_t z0 = gz_bf16x2(xh[0], xh[1], gy2[2 * q], g.x, g.y, be.x, be.y, t1.x, fb.x, film);
        const uint32_t z1 = gz_bf16x2(xh[2], xh[3], gy2[2 * q + 1], g.z, g.w, be.z, be.w, t1.y, fb.y, film);
        f(k, xh[0], bf_lo(z0));
        f(k + 1, xh[1], bf_hi(z0));
        f(k + 2, xh[2], bf_lo(z1));
        f(k + 3, xh[3], bf_hi(z1));
      }
    } else {  // one channel: both halves of each pair carry it
      const uint32_t h = __bfloat16_as_ushort(ug);
      uint32_t t12 = 0, fb2 = 0;
      if (film) {
        const uint32_t t = __bfloat16_as_ushort(s_t1[tx]), b = __bfloat16_as_ushort(s_fb[tx]);
        t12 = t | (t << 16);
        fb2 = b | (b << 16);
      }
      const float xh = fmaf(xf[0], r, mr);
      f(0, xh, bf_lo(gz_bf16x2(xh, xh, h | (h << 16), s_g[tx], s_g[tx], s_be[tx], s_be[tx], t12, fb2, film)));
    }
  }
};

template <int VEC>
struct Row<float, VEC> {
  using Raw = typename RawVec<float, VEC>::type;
  template <typename F>
  __device__ __forceinline__ static void run(const Raw& ux, const Raw& ug, float r, float mr,
                                             const float* s_g, const float* s_be, const float* s_t1,
                                             const float* s_fb, bool film, F&& f) {
    const int tx = threadIdx.x;
    float xf[VEC], gyf[VEC];
    unpack(ux, xf);
    unpack(ug, gyf);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int j = tx * VEC + k;  // fp32 vectors are four channels: term_at(j) = j
      const float xh = fmaf(xf[k], r, mr);
      f(k, xh, gz_f32(xh, gyf[k], s_g[j], s_be[j], film ? s_t1[j] : 1.f, film ? s_fb[j] : 0.f, film));
    }
  }
};

// dst[j] = src[0][j] + src[1][j] + ... + src[rows - 1][j] in that order, for
// the cols columns j of rows ld floats apart in global memory, column j at
// src + j for j < half and src + skip + j - half past it (the S1 and S2
// halves of a partial). Rows are staged in shared memory (buf, cap floats,
// at least cols) a chunk at a time by every thread of the block, so a chunk
// costs one round of loads whatever the row count; ends with a barrier.
__device__ __forceinline__ void sum_rows_in_order(const float* src, long long ld, int rows, int cols, int half,
                                                  int skip, float* buf, int cap, float* dst) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nthreads = blockDim.x * blockDim.y;
  const int chunk = cap / cols;
  for (int b0 = 0; b0 < rows; b0 += chunk) {
    const int nr = min(chunk, rows - b0);
    for (int i = tid; i < nr * cols; i += nthreads) {
      const int r = i / cols, j = i - r * cols;
      buf[i] = __ldcg(src + (long long)(b0 + r) * ld + (j < half ? j : skip + j - half));
    }
    __syncthreads();
    for (int j = tid; j < cols; j += nthreads) {
      float acc = b0 == 0 ? buf[j] : dst[j] + buf[j];
      for (int r = 1; r < nr; ++r) acc += buf[r * cols + j];
      dst[j] = acc;
    }
    __syncthreads();
  }
}

// Pass 3. Block (bdx, bdy), grid (grid_x row blocks, grid_c channel blocks,
// N); bdx a multiple of the vectors of one group. Thread (tx, ty) of block
// (bx, cb) owns channel vector cb*bdx + tx of sample n and rows
// bx*bdy + ty + k*grid_x*bdy.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads, 2) gn_bwd_reduce_kernel(const GnBwdArgs a) {
  constexpr int kRed = 2 * kBwdThreads * VEC > 4 * kBwdMaxWidth ? 2 * kBwdThreads * VEC : 4 * kBwdMaxWidth;
  __shared__ float s_red[kRed];  // [2][bdy][bdx*VEC] row sums, then the finishing block's terms
  __shared__ float s_mean[kBwdMaxWidth], s_rstd[kBwdMaxWidth];  // per group of the block
  __shared__ __align__(16) float s_g[kBwdMaxWidth], s_be[kBwdMaxWidth];
  __shared__ __align__(16) T s_t1[kBwdMaxWidth], s_fb[kBwdMaxWidth];
  __shared__ float s_col[kBwdThreads];  // the row sums' parts, a few threads per column
  __shared__ int s_last;
  using Raw = typename Row<T, VEC>::Raw;
  const int n = blockIdx.z, cb = blockIdx.y, bdx = blockDim.x, bdy = blockDim.y;
  const int C = a.C, HW = a.HW, cgs = C / a.G;
  const int c0 = cb * bdx * VEC, width = min(bdx * VEC, C - c0);  // whole groups
  const int g0 = c0 / cgs, ng = width / cgs;
  const int tid = threadIdx.y * bdx + threadIdx.x, nthreads = bdx * bdy;
  const bool owner = (int)threadIdx.x * VEC < width, film = a.fs != nullptr;

  // The first rows' loads go out before the statistics are merged.
  const long long base = (long long)n * HW * C + c0 + threadIdx.x * VEC;
  Rows<T, VEC> rows{reinterpret_cast<const Raw*>(static_cast<const T*>(a.x) + base),
                    reinterpret_cast<const Raw*>(static_cast<const T*>(a.gy) + base),
                    owner ? (long long)blockIdx.x * bdy + threadIdx.y : HW, (long long)gridDim.x * bdy, C / VEC,
                    HW};
  rows.prime();
  merge_groups(a.part, n, a.G, a.S, a.eps, g0, ng, s_mean, s_rstd);
  load_terms<T, VEC>(a, n, c0, width, s_g, s_be, s_t1, s_fb);
  __syncthreads();

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;
  const int jg = (int)threadIdx.x * VEC / cgs;
  const float rs = owner ? s_rstd[jg] : 0.f, mr = owner ? -s_mean[jg] * rs : 0.f;
  rows.walk([&](long long, const Raw& ux, const Raw& ug) {
    Row<T, VEC>::run(ux, ug, rs, mr, s_g, s_be, s_t1, s_fb, film, [&](int k, float xh, float gz) {
      s1[k] += gz;
      s2[k] = fmaf(gz, xh, s2[k]);
    });
  });

  // The block's rows of each channel: column j = tx*VEC + k, row ty (S1),
  // then the same for S2 a plane further; summed in a fixed order, per
  // threads a column each taking span rows, then the per parts in turn.
  const int W = bdx * VEC, plane = bdy * W;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s_red[threadIdx.y * W + threadIdx.x * VEC + k] = s1[k];
    s_red[plane + threadIdx.y * W + threadIdx.x * VEC + k] = s2[k];
  }
  __syncthreads();
  const int C2 = 2 * C, cols = 2 * width;
  const int per = max(1, nthreads / cols), span = (bdy + per - 1) / per;
  float* out = a.sums + ((long long)n * gridDim.x + blockIdx.x) * C2 + c0;
  for (int t = tid; t < per * cols; t += nthreads) {
    const int p = t / cols, j = t - p * cols;
    const float* col = s_red + (j < width ? j : plane + j - width);
    float acc = 0.f;
    for (int y = p * span; y < min(bdy, (p + 1) * span); ++y) acc += col[y * W];
    if (per == 1)
      out[j < width ? j : C + j - width] = acc;
    else
      s_col[t] = acc;
  }
  if (per > 1) {
    __syncthreads();
    for (int j = tid; j < cols; j += nthreads) {
      float acc = s_col[j];
      for (int p = 1; p < per; ++p) acc += s_col[p * cols + j];
      out[j < width ? j : C + j - width] = acc;
    }
  }

  // Arrival: the last block of this (sample, channel block) finishes it.
  // One thread fences and counts for the block, after the barrier (the
  // pattern of a cooperative grid sync).
  __syncthreads();
  unsigned* cnt = a.count + n * gridDim.y + cb;
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(cnt, 1u) == gridDim.x - 1;
    if (s_last) {
      *cnt = 0u;
      __threadfence();
    }
  }
  __syncthreads();
  if (!s_last) return;

  // S1 (s_red[j]) and S2 (s_red[width + j]): the partials in row-block order.
  sum_rows_in_order(a.sums + (long long)n * gridDim.x * C2 + c0, C2, gridDim.x, 2 * width, width, C,
                    s_red + 2 * width, kRed - 2 * width, s_red);
  // Per channel: dfb, dfs, the terms summed over samples, k*S1 and k*S2
  // (s_red[2*width + j], s_red[3*width + j]). Products and sums rounded one
  // by one (no fused multiply-add), as the plain twin's torch ops round.
  // One sample: the sums over samples are its own terms, stored here.
  const bool over_n = a.dgamma != nullptr || a.dbeta != nullptr, one = gridDim.z == 1;
  for (int j = tid; j < width; j += nthreads) {
    const float S1 = s_red[j], S2 = s_red[width + j];
    const int at = term_at<VEC>(j, bdx);
    const float g = s_g[at], be = s_be[at];
    float t1 = 1.f;
    if (film) {
      if constexpr (sizeof(T) == 2)
        t1 = __bfloat162float(s_t1[at]);
      else
        t1 = s_t1[at];
    }
    const long long cn = (long long)n * C + c0 + j;
    if (a.dfb != nullptr) store_param(a.dfb, a.fb_t, cn, S1);
    if (a.dfs != nullptr) store_param(a.dfs, a.fs_t, cn, __fadd_rn(__fmul_rn(g, S2), __fmul_rn(be, S1)));
    if (over_n && one) {
      if (a.dbeta != nullptr) store_param(a.dbeta, a.beta_t, c0 + j, __fmul_rn(t1, S1));
      if (a.dgamma != nullptr) store_param(a.dgamma, a.gamma_t, c0 + j, __fmul_rn(t1, S2));
    } else if (over_n) {
      a.fin[(long long)n * C2 + c0 + j] = __fmul_rn(t1, S1);
      a.fin[(long long)n * C2 + C + c0 + j] = __fmul_rn(t1, S2);
    }
    const float k = __fmul_rn(g, t1);
    s_red[2 * width + j] = __fmul_rn(k, S1);
    s_red[3 * width + j] = __fmul_rn(k, S2);
  }
  __syncthreads();
  // Per group: A and B, the group's sums in channel order over hw*cg.
  const float cnt_el = (float)((long long)HW * cgs);
  float* st = a.stats + (long long)n * 4 * a.G;
  for (int jg = tid; jg < ng; jg += nthreads) {
    const float* ka = s_red + 2 * width + jg * cgs;
    const float* kb = s_red + 3 * width + jg * cgs;
    float sa = ka[0], sb = kb[0];
    for (int i = 1; i < cgs; ++i) {
      sa += ka[i];
      sb += kb[i];
    }
    const int gg = g0 + jg;
    st[gg] = s_mean[jg];
    st[a.G + gg] = s_rstd[jg];
    st[2 * a.G + gg] = sa / cnt_el;
    st[3 * a.G + gg] = sb / cnt_el;
  }
  if (!over_n || one) return;

  // The last sample of this channel block to finish sums the samples' terms
  // in sample order into dbeta and dgamma.
  __syncthreads();
  unsigned* cnt2 = a.count + gridDim.z * gridDim.y + cb;
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(cnt2, 1u) == gridDim.z - 1;
    if (s_last) {
      *cnt2 = 0u;
      __threadfence();
    }
  }
  __syncthreads();
  if (!s_last) return;
  sum_rows_in_order(a.fin + c0, C2, gridDim.z, 2 * width, width, C, s_red + 2 * width, kRed - 2 * width, s_red);
  for (int j = tid; j < width; j += nthreads) {
    if (a.dbeta != nullptr) store_param(a.dbeta, a.beta_t, c0 + j, s_red[j]);
    if (a.dgamma != nullptr) store_param(a.dgamma, a.gamma_t, c0 + j, s_red[width + j]);
  }
}

// Pass 4. The reduce's launch shape and row walk. dx = rstd*(k*gz - A -
// xhat*B) = kr*gz + qa + qb*xhat in fp32, rounded once to x's dtype.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads, 2) gn_bwd_apply_kernel(const GnBwdArgs a) {
  __shared__ __align__(16) float s_g[kBwdMaxWidth], s_be[kBwdMaxWidth], s_kr[kBwdMaxWidth];
  __shared__ __align__(16) T s_t1[kBwdMaxWidth], s_fb[kBwdMaxWidth];
  using Raw = typename Row<T, VEC>::Raw;
  const int n = blockIdx.z, cb = blockIdx.y, bdx = blockDim.x, bdy = blockDim.y;
  const int C = a.C, HW = a.HW, G = a.G, cgs = C / G;
  const int c0 = cb * bdx * VEC, width = min(bdx * VEC, C - c0);
  const int tid = threadIdx.y * bdx + threadIdx.x, nthreads = bdx * bdy;
  const bool owner = (int)threadIdx.x * VEC < width, film = a.fs != nullptr;

  const long long row = C / VEC;
  const long long base = (long long)n * HW * C + c0 + threadIdx.x * VEC;
  Raw* ds = reinterpret_cast<Raw*>(static_cast<T*>(a.dx) + base);
  Rows<T, VEC> rows{reinterpret_cast<const Raw*>(static_cast<const T*>(a.x) + base),
                    reinterpret_cast<const Raw*>(static_cast<const T*>(a.gy) + base),
                    owner ? (long long)blockIdx.x * bdy + threadIdx.y : HW, (long long)gridDim.x * bdy, row, HW};
  rows.prime();
  const float* st = a.stats + (long long)n * 4 * G;
  load_terms<T, VEC>(a, n, c0, width, s_g, s_be, s_t1, s_fb);
  for (int j = tid; j < width; j += nthreads) {  // the same thread wrote s_g[at] and s_t1[at]
    const int at = term_at<VEC>(j, bdx);
    float t1 = 1.f;
    if (film) {
      if constexpr (sizeof(T) == 2)
        t1 = __bfloat162float(s_t1[at]);
      else
        t1 = s_t1[at];
    }
    s_kr[at] = st[G + (c0 + j) / cgs] * s_g[at] * t1;
  }
  __syncthreads();
  if (!owner) return;
  const int g = (c0 + (int)threadIdx.x * VEC) / cgs;
  const float rs = st[G + g], mr = -st[g] * rs, qa = -rs * st[2 * G + g], qb = -rs * st[3 * G + g];
  rows.walk([&](long long r, const Raw& ux, const Raw& ug) {
    float d[VEC];
    Row<T, VEC>::run(ux, ug, rs, mr, s_g, s_be, s_t1, s_fb, film, [&](int k, float xh, float gz) {
      d[k] = fmaf(s_kr[term_at<VEC>(threadIdx.x * VEC + k, bdx)], gz, fmaf(qb, xh, qa));
    });
    store_vec<T, VEC>(reinterpret_cast<T*>(ds + r * row), d);
  });
}

template <typename T, int VEC>
void launch_bwd(const GnBwdArgs& a, bool reduce, dim3 grid, dim3 block, cudaStream_t st) {
  if (reduce)
    gn_bwd_reduce_kernel<T, VEC><<<grid, block, 0, st>>>(a);
  else
    gn_bwd_apply_kernel<T, VEC><<<grid, block, 0, st>>>(a);
}

int launch_bwd_checked(const GnBwdArgs* args, bool reduce, void* stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const GnBwdArgs& a = *args;
  const int vec = a.vec;
  if (a.G < 1 || a.C % a.G != 0 || vec < 1 || (a.C / a.G) % vec != 0 || a.C / a.G > kBwdMaxWidth)
    return (int)cudaErrorInvalidValue;
  const int vg = a.C / a.G / vec;  // vectors per group
  if (a.bdx < 1 || a.bdy < 1 || a.bdx % vg != 0 || a.bdx * vec > kBwdMaxWidth ||
      a.bdx * a.bdy > kBwdThreads || a.bdx * a.bdy < 32 || a.grid_x < 1 || a.N < 1 ||
      (long long)a.grid_c * a.bdx * vec < a.C || (long long)(a.grid_c - 1) * a.bdx * vec >= a.C)
    return (int)cudaErrorInvalidValue;
  const int codes = a.dtype | a.gamma_t | a.beta_t | a.fs_t | a.fb_t;
  if (codes & ~1) return (int)cudaErrorInvalidValue;  // every dtype code 0 or 1
  const bool film = a.fs != nullptr;
  if (film && (a.fb == nullptr || (a.dtype == 1 && (a.fs_t != 1 || a.fb_t != 1))))
    return (int)cudaErrorInvalidValue;  // bf16 x: FiLM terms in bf16 (the bf16x2 products)
  if (!film && (a.dfs != nullptr || a.dfb != nullptr)) return (int)cudaErrorInvalidValue;
  const bool al = aligned16(a.x) && aligned16(a.gy) && (reduce || aligned16(a.dx));
  const dim3 block(a.bdx, a.bdy), grid(a.grid_x, a.grid_c, a.N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.dtype == 1 && vec == 8 && al)
    launch_bwd<__nv_bfloat16, 8>(a, reduce, grid, block, st);
  else if (a.dtype == 1 && vec == 1)
    launch_bwd<__nv_bfloat16, 1>(a, reduce, grid, block, st);
  else if (a.dtype == 0 && vec == 4 && al)
    launch_bwd<float, 4>(a, reduce, grid, block, st);
  else if (a.dtype == 0 && vec == 1)
    launch_bwd<float, 1>(a, reduce, grid, block, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// Both backward passes, on the arguments in *args (launch shape from
// ops/hopper_kernels.py gn_bwd_geometry). Return the launch's error code,
// or cudaGetLastError() after it.
extern "C" int ishape_gn_bwd_reduce(const GnBwdArgs* args, void* stream) {
  return launch_bwd_checked(args, true, stream);
}

extern "C" int ishape_gn_bwd_apply(const GnBwdArgs* args, void* stream) {
  return launch_bwd_checked(args, false, stream);
}
