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
//   1. gn_stats: one block per (n, group, row split). Each block reduces its
//      slice to fp32 (count, mean, M2) and writes it to a [N, G, S, 3]
//      scratch. Splitting rows keeps ~1000 blocks in flight even at batch 1
//      (N*G = 32 groups alone would leave most of the 132 SMs idle).
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

__device__ __forceinline__ Stat shfl_down_stat(const Stat& s, int off) {
  Stat o;
  o.n = __shfl_down_sync(0xffffffffu, s.n, off);
  o.mean = __shfl_down_sync(0xffffffffu, s.mean, off);
  o.m2 = __shfl_down_sync(0xffffffffu, s.m2, off);
  return o;
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

// Pass 1. grid (S, G, N); block reduces rows [s*rows, (s+1)*rows) of group g
// of sample n to (count, mean, M2) at part[((n*G + g)*S + s)*3].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int HW, int C,
                int G, int S, int rows_per_split) {
  const int s = blockIdx.x, g = blockIdx.y, n = blockIdx.z;
  const int cg = C / G;
  const int vpr = cg / VEC;  // vectors per row within the group
  const int r0 = s * rows_per_split;
  const int r1 = min(HW, r0 + rows_per_split);
  const long long nvec = (long long)max(0, r1 - r0) * vpr;
  const T* base = x + ((long long)n * HW + r0) * C + (long long)g * cg;

  Stat acc = {0.f, 0.f, 0.f};
  for (long long i = threadIdx.x; i < nvec; i += kThreads) {
    const long long r = i / vpr;
    const int v = (int)(i - r * vpr);
    float vals[VEC];
    load_vec<T, VEC>(base + r * C + v * VEC, vals);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) sum += vals[k];
    Stat loc;
    loc.n = (float)VEC;
    loc.mean = sum / VEC;
    loc.m2 = 0.f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float d = vals[k] - loc.mean;
      loc.m2 += d * d;
    }
    chan_merge(acc, loc);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) chan_merge(acc, shfl_down_stat(acc, off));

  __shared__ Stat warp_stats[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_stats[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    Stat tot = warp_stats[0];
    for (int w = 1; w < kThreads / 32; ++w) chan_merge(tot, warp_stats[w]);
    float* out = part + (((long long)n * G + g) * S + s) * 3;
    out[0] = tot.n;
    out[1] = tot.mean;
    out[2] = tot.m2;
  }
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
void launch_stats(const void* x, void* part, int N, int HW, int C, int G, int S,
                  int rows_per_split, cudaStream_t stream) {
  dim3 grid(S, G, N);
  gn_stats_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), HW, C, G, S, rows_per_split);
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

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
extern "C" int ishape_gn_stats(const void* x, void* part, int dtype, int N, int HW,
                               int C, int G, int S, int rows_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || C % G != 0) return (int)cudaErrorInvalidValue;
  const int cg = C / G;
  if (dtype == 1) {
    if (cg % 8 == 0 && aligned16(x))
      launch_stats<__nv_bfloat16, 8>(x, part, N, HW, C, G, S, rows_per_split, st);
    else
      launch_stats<__nv_bfloat16, 1>(x, part, N, HW, C, G, S, rows_per_split, st);
  } else if (dtype == 0) {
    if (cg % 4 == 0 && aligned16(x))
      launch_stats<float, 4>(x, part, N, HW, C, G, S, rows_per_split, st);
    else
      launch_stats<float, 1>(x, part, N, HW, C, G, S, rows_per_split, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
