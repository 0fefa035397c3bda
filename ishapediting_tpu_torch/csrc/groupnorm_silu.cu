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
