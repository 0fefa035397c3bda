// The bias epilogue of the UNet's products (every convolution and dense
// layer), with the residual add that follows a ResBlock's last convolution
// or an attention block's projection folded into it.
//
// Replaces no TPU kernel: the JAX package leaves these adds to XLA, which
// fuses them into the ops around them. Eager PyTorch runs each as its own
// pass over device memory, so the port fuses them by hand here.
//
// Over a contiguous [rows, C] tensor y (an NHWC product flattened) in its
// dtype T (bf16 or fp32) and a bias b [C] as the layer stores it (fp32),
// one launch computes one of
//   plain:   out = rnd(y + rnd(b))
//   fused:   out = rnd(res + rnd(y + rnd(b)))
//   fused2:  out = rnd(rnd(res + rnd(rb)) + rnd(y + rnd(b)))   (res is
//            itself a raw product, the 1x1 skip convolution's, with its own
//            bias rb)
// where every add is one fp32 add and rnd the round to nearest even to T:
// exactly what eager PyTorch computes for `b.to(T)`, `y + that`, then
// `res + that`, so the result is bit-equal to the port's former
// composition and keeps the JAX package's rounding points. Reading the
// bias as stored spares each layer a cast launch.
//
// Bound on this card: memory. Plain reads y and writes out (b is C
// elements); fused also reads res. The least time is their bytes /
// 3.35 TB/s. Eager PyTorch's `y + b` broadcasts b, which its elementwise
// kernel does not vectorize, so every element pays an index computation;
// the adds after it read again what the bias add has just written.
//
// Design. Block (bdx, bdy), grid (row blocks, channel blocks), long-lived
// blocks, two per SM (one wave). Thread (tx, ty) of block (bx, cb) owns
// the channel vector v = cb*bdx + tx (VEC channels from v*VEC) for its
// whole life, holds its VEC bias values (and rb's), rounded to T, in
// registers (loaded one by one once, so b needs no alignment), and walks
// rows bx*bdy + ty, then a grid stride of gridDim.x*bdy rows, up to four
// 16-byte loads in flight (four rows plain, two fused: y and res each, one
// with the skip's bias), all in flight before the first store. bdx =
// C/VEC where that fits one block, so a warp reads contiguous bytes of
// consecutive rows whatever C is (C = 6 fp32 at VEC 2: bdx 3). VEC is
// chosen on the host from what the input shows (the largest of 16, 8, 4
// bytes or one element that divides C and to which out, y and res are
// aligned); wider C splits over blockIdx.y. out may be y itself (the
// no-grad path writes into the product's own buffer): each element is read
// and then written by the same thread, so y and out carry no __restrict__.
// Two kernel names: bias_add_kernel (plain) and bias_residual_kernel (both
// fused forms), as the launch counters LAUNCHES["bias_add"] and
// LAUNCHES["bias_residual"] name them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // most threads of a block (the launch bound)

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// rnd(a + b) back in fp32: one fp32 add, one rounding to T.
template <typename T>
__device__ __forceinline__ float add_rnd(float a, float b) {
  return to_f(from_f<T>(a + b));
}

// MODE 0 plain, 1 fused, 2 fused with rb.
template <typename T, int VEC, int MODE>
__device__ __forceinline__ void epilogue(T* out, const T* y, const float* __restrict__ b, const T* __restrict__ res,
                                         const float* __restrict__ rb, int rows, int C) {
  using P = Pack<T, VEC>;
  // Rows a thread loads before it stores: four 16-byte loads in flight
  // plain, four fused (y and res of two rows), two with rb (whose second
  // bias vector leaves no registers for more). More would spill: two blocks
  // of 512 threads an SM leave a thread 64 registers.
  constexpr int kRowsInFlight = MODE == 0 ? 4 : MODE == 1 ? 2 : 1;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v * VEC >= C) return;
  // The thread's bias vectors rounded to T, held in registers packed (half
  // the registers of fp32 in bf16), widened where used.
  P bias, rbias = {};
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    bias.v[k] = from_f<T>(b[v * VEC + k]);
    if (MODE == 2) rbias.v[k] = from_f<T>(rb[v * VEC + k]);
  }
  const long long row = C / VEC;  // a row, in vectors
  const P* ys = reinterpret_cast<const P*>(y) + v;
  const P* rs = reinterpret_cast<const P*>(res) + v;
  P* os = reinterpret_cast<P*>(out) + v;
  const int step = gridDim.x * blockDim.y;
  for (int r = blockIdx.x * blockDim.y + threadIdx.y; r < rows; r += kRowsInFlight * step) {
    P yv[kRowsInFlight], rv[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const long long ru = r + (long long)u * step;
      if (ru < rows) {
        yv[u] = ys[ru * row];
        if (MODE != 0) rv[u] = rs[ru * row];
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const long long ru = r + (long long)u * step;
      if (ru >= rows) break;
      P o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float h = add_rnd<T>(to_f(yv[u].v[k]), to_f(bias.v[k]));
        if (MODE != 0) {
          float x = to_f(rv[u].v[k]);
          if (MODE == 2) x = add_rnd<T>(x, to_f(rbias.v[k]));
          h = x + h;
        }
        o.v[k] = from_f<T>(h);
      }
      os[ru * row] = o;
    }
  }
}

// One kernel name per form, as the launch counters name them.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
bias_add_kernel(T* out, const T* y, const float* __restrict__ b, int rows, int C) {
  epilogue<T, VEC, 0>(out, y, b, nullptr, nullptr, rows, C);
}

template <typename T, int VEC, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
bias_residual_kernel(T* out, const T* y, const float* __restrict__ b, const T* __restrict__ res,
                     const float* __restrict__ rb, int rows, int C) {
  epilogue<T, VEC, MODE>(out, y, b, res, rb, rows, C);
}

template <typename T, int VEC>
void launch(void* out, const void* y, const float* b, const void* res, const float* rb, int rows, int C,
            dim3 block, dim3 grid, cudaStream_t st) {
  T* o = static_cast<T*>(out);
  const T* yp = static_cast<const T*>(y);
  const T* rp = static_cast<const T*>(res);
  if (res == nullptr)
    bias_add_kernel<T, VEC><<<grid, block, 0, st>>>(o, yp, b, rows, C);
  else if (rb == nullptr)
    bias_residual_kernel<T, VEC, 1><<<grid, block, 0, st>>>(o, yp, b, rp, rb, rows, C);
  else
    bias_residual_kernel<T, VEC, 2><<<grid, block, 0, st>>>(o, yp, b, rp, rb, rows, C);
}

inline bool aligned(const void* p, int bytes) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

// out, y, res: [rows, C] contiguous; b, rb: [C] fp32; res null for the
// plain form, rb null unless res is a raw product with its own bias. dtype
// (of y, res, out): 0 = float32, 1 = bfloat16;
// vec: channels per thread (a power of two of at most 16 bytes, dividing
// C, out, y and res aligned to vec elements);
// block (bdx, bdy) and grid (grid_x row blocks, grid_c channel blocks)
// from ops/hopper_kernels.py bias_epilogue_geometry.
// Returns cudaGetLastError() after the launch.
extern "C" int ishape_bias_epilogue(void* out, const void* y, const float* b, const void* res, const float* rb,
                                    int dtype, int rows, int C, int vec, int bdx, int bdy, int grid_x, int grid_c,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int esize = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || vec < 1 || vec * esize > 16 || (vec & (vec - 1)) || C % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (rows < 1 || bdx < 1 || bdy < 1 || bdx * bdy > kThreads || grid_x < 1 || grid_c < 1 ||
      (long long)grid_c * bdx * vec < C || (rb != nullptr && res == nullptr) || out == nullptr ||
      y == nullptr || b == nullptr)
    return (int)cudaErrorInvalidValue;
  const int al = vec * esize;
  if (!aligned(out, al) || !aligned(y, al) || !aligned(res, al) || !aligned(b, 4) || !aligned(rb, 4))
    return (int)cudaErrorMisalignedAddress;
  const dim3 block(bdx, bdy), grid(grid_x, grid_c);
  if (dtype == 1) {
    switch (vec) {
      case 8: launch<__nv_bfloat16, 8>(out, y, b, res, rb, rows, C, block, grid, st); break;
      case 4: launch<__nv_bfloat16, 4>(out, y, b, res, rb, rows, C, block, grid, st); break;
      case 2: launch<__nv_bfloat16, 2>(out, y, b, res, rb, rows, C, block, grid, st); break;
      default: launch<__nv_bfloat16, 1>(out, y, b, res, rb, rows, C, block, grid, st); break;
    }
  } else {
    switch (vec) {
      case 4: launch<float, 4>(out, y, b, res, rb, rows, C, block, grid, st); break;
      case 2: launch<float, 2>(out, y, b, res, rb, rows, C, block, grid, st); break;
      default: launch<float, 1>(out, y, b, res, rb, rows, C, block, grid, st); break;
    }
  }
  return (int)cudaGetLastError();
}
