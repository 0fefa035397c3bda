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
//   2. gn_norm: one block per (n, row tile) over all C channels, so loads and
//      stores are contiguous 16-byte vectors. Each block first merges its
//      groups' S partials (Chan's parallel merge, no atomics: the result is
//      the same on every run), then normalizes, applies the affine and FiLM,
//      SiLU, and stores in x's dtype.
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

// VEC elements of T starting at p (16-byte aligned when VEC > 1) into floats.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* v);

template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p, float* v) {
  float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p, float* v) {
  v[0] = *p;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 8>(const __nv_bfloat16* p, float* v) {
  uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(const __nv_bfloat16* p, float* v) {
  v[0] = __bfloat162float(*p);
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

// Pass 2. grid (num_tiles, N); block normalizes rows [tile*rows, ...) of
// sample n over all C channels. gamma, beta: [C] fp32; film: [N, 2, C] fp32
// (scale row first) or null.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_norm_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ part,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               const float* __restrict__ film, int HW, int C, int G, int S,
               int rows_per_tile, float eps) {
  const int tile = blockIdx.x, n = blockIdx.y;
  __shared__ float s_mean[kMaxGroups];
  __shared__ float s_rstd[kMaxGroups];
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const float* p = part + ((long long)n * G + g) * S * 3;
    Stat tot = {p[0], p[1], p[2]};
    for (int s = 1; s < S; ++s) {
      Stat b = {p[3 * s], p[3 * s + 1], p[3 * s + 2]};
      chan_merge(tot, b);
    }
    s_mean[g] = tot.mean;
    s_rstd[g] = rsqrtf(tot.m2 / tot.n + eps);
  }
  __syncthreads();

  const int cg = C / G;
  const int vpr = C / VEC;
  const int r0 = tile * rows_per_tile;
  const int r1 = min(HW, r0 + rows_per_tile);
  const long long nvec = (long long)max(0, r1 - r0) * vpr;
  const long long base = ((long long)n * HW + r0) * C;
  const float* fs = film ? film + (long long)n * 2 * C : nullptr;

  for (long long i = threadIdx.x; i < nvec; i += kThreads) {
    const long long r = i / vpr;
    const int c0 = (int)(i - r * vpr) * VEC;
    const long long off = base + r * C + c0;
    float v[VEC];
    load_vec<T, VEC>(x + off, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = c0 + k;
      const int g = c / cg;
      float t = (v[k] - s_mean[g]) * s_rstd[g];
      t = t * __ldg(gamma + c) + __ldg(beta + c);
      if (fs) t = t * (1.f + __ldg(fs + c)) + __ldg(fs + C + c);
      v[k] = t / (1.f + expf(-t));  // SiLU
    }
    store_vec<T, VEC>(y + off, v);
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
                 int S, int rows_per_tile, float eps, cudaStream_t stream) {
  dim3 grid((HW + rows_per_tile - 1) / rows_per_tile, N);
  gn_norm_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const float*>(part),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(film), HW, C, G, S, rows_per_tile, eps);
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

extern "C" int ishape_gn_norm(const void* x, void* y, const void* part, const void* gamma,
                              const void* beta, const void* film, int dtype, int N,
                              int HW, int C, int G, int S, int rows_per_tile, float eps,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > kMaxGroups || C % G != 0) return (int)cudaErrorInvalidValue;
  const bool al = aligned16(x) && aligned16(y);
  if (dtype == 1) {
    if (C % 8 == 0 && al)
      launch_norm<__nv_bfloat16, 8>(x, y, part, gamma, beta, film, N, HW, C, G, S,
                                    rows_per_tile, eps, st);
    else
      launch_norm<__nv_bfloat16, 1>(x, y, part, gamma, beta, film, N, HW, C, G, S,
                                    rows_per_tile, eps, st);
  } else if (dtype == 0) {
    if (C % 4 == 0 && al)
      launch_norm<float, 4>(x, y, part, gamma, beta, film, N, HW, C, G, S,
                            rows_per_tile, eps, st);
    else
      launch_norm<float, 1>(x, y, part, gamma, beta, film, N, HW, C, G, S,
                            rows_per_tile, eps, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ishape_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
