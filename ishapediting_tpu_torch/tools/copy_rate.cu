// Per-SM copy rate of the two ways the generic attention kernel
// (csrc/attention_generic.cu) fills its K/V ring, with no compute: 16-byte
// cp.async per thread into padded rows, and TMA boxes (64 bf16 channels by
// 32 rows, 128-byte swizzle) completing on mbarriers. Each CTA streams the
// K and V of one head (ch 192, bf16, rows of a [T, 2304] buffer: the
// heads-by-count chairs shape) through a 4-stage ring of 32-key tiles;
// printed per CTA count and T: kernel time, mean time per CTA (globaltimer)
// and GB/s per SM. Built and run by tools/copy_rate.py on one CUDA card.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdio.h>
#include <stdint.h>
__device__ __forceinline__ uint32_t su(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
__device__ __forceinline__ long long gt() { long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
__device__ long long g_t[1024];
constexpr int ST = 4, KEYS = 32, CH = 192, W = 2304, SS = CH + 8;
__global__ void __launch_bounds__(128) k_cpasync(const __nv_bfloat16* x, int T, float* sink) {
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  long long t0 = gt();
  const int h = blockIdx.x % 4; const __nv_bfloat16* base = x + h * 576 + 192;
  const int nt = T / KEYS; float acc = 0;
  auto load = [&](int tile) {
    __nv_bfloat16* d = sm + (tile % ST) * 2 * KEYS * SS;
    for (int i = threadIdx.x; i < KEYS * 24 * 2; i += 128) {
      int kv = i / (KEYS * 24), j = i % (KEYS * 24), r = j / 24, c = (j % 24) * 8;
      const __nv_bfloat16* s = base + (long long)(tile * KEYS + r) * W + kv * CH + c;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(su(d + kv * KEYS * SS + r * SS + c)), "l"(s) : "memory");
    }
  };
  for (int i = 0; i < ST - 1; ++i) { if (i < nt) load(i); asm volatile("cp.async.commit_group;\n" ::: "memory"); }
  for (int it = 0; it < nt; ++it) {
    if (it + ST - 1 < nt) load(it + ST - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" :: "n"(ST - 1) : "memory");
    __syncthreads();
    acc += __bfloat162float(sm[(it % ST) * 2 * KEYS * SS + threadIdx.x]);
    __syncthreads();
  }
  if (acc == 12345.f) sink[0] = acc;
  if (threadIdx.x == 0) { g_t[2 * blockIdx.x] = t0; g_t[2 * blockIdx.x + 1] = gt(); }
}
__global__ void __launch_bounds__(128) k_tma(const __grid_constant__ CUtensorMap map, int T, float* sink) {
  extern __shared__ __align__(1024) unsigned char smr[];
  __shared__ __align__(8) uint64_t bar[ST];
  long long t0 = gt();
  unsigned char* sm = (unsigned char*)(((uintptr_t)smr + 1023) & ~(uintptr_t)1023);
  const int h = blockIdx.x % 4; const int col = h * 576 + 192;
  const int nt = T / KEYS; float acc = 0;
  if (threadIdx.x == 0) { for (int i = 0; i < ST; ++i) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(su(&bar[i]))); asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
  __syncthreads();
  auto load = [&](int tile) {
    const int s = tile % ST; uint32_t b = su(&bar[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(b), "r"(6 * 4096) : "memory");
    for (int q = 0; q < 6; ++q) {
      int c = col + (q / 3) * CH + (q % 3) * 64;
      asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(su(sm + s * 6 * 4096 + q * 4096)), "l"((uint64_t)&map), "r"(b), "r"(c), "r"(tile * KEYS) : "memory");
    }
  };
  if (threadIdx.x == 0) for (int i = 0; i < ST - 1 && i < nt; ++i) load(i);
  for (int it = 0; it < nt; ++it) {
    if (threadIdx.x == 0 && it + ST - 1 < nt) load(it + ST - 1);
    uint32_t done = 0, b = su(&bar[it % ST]), par = (it / ST) & 1;
    while (!done) asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(b), "r"(par) : "memory");
    acc += (float)sm[(it % ST) * 6 * 4096 + threadIdx.x];
    __syncthreads();
  }
  if (acc == 12345.f) sink[0] = acc;
  if (threadIdx.x == 0) { g_t[2 * blockIdx.x] = t0; g_t[2 * blockIdx.x + 1] = gt(); }
}
typedef CUresult (*Enc)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*, const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
int main() {
  const int Tmax = 4096; __nv_bfloat16* x; float* sink;
  cudaMalloc(&x, (size_t)Tmax * W * 2); cudaMemset(x, 0, (size_t)Tmax * W * 2); cudaMalloc(&sink, 4);
  void* p = nullptr; cudaDriverEntryPointQueryResult q;
  cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
  Enc enc = (Enc)p;
  int smem_a = ST * 2 * KEYS * SS * 2, smem_b = ST * 6 * 4096 + 1024;
  cudaFuncSetAttribute(k_cpasync, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  cudaFuncSetAttribute(k_tma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  for (int T : {256, 2048}) {
    CUtensorMap map; cuuint64_t dims[2] = {W, (cuuint64_t)T}; cuuint64_t str[1] = {W * 2}; cuuint32_t box[2] = {64, KEYS}, el[2] = {1, 1};
    CUresult r = enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims, str, box, el, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r) { printf("encode failed %d\n", r); return 1; }
    for (int n : {8, 32, 64, 128}) {
      for (int kind = 0; kind < 2; ++kind) {
        cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
        auto run = [&]() { if (kind == 0) k_cpasync<<<n, 128, smem_a>>>(x, T, sink); else k_tma<<<n, 128, smem_b>>>(map, T, sink); };
        for (int i = 0; i < 3; ++i) run();
        cudaEventRecord(a); for (int i = 0; i < 20; ++i) run(); cudaEventRecord(b); cudaEventSynchronize(b);
        float ms; cudaEventElapsedTime(&ms, a, b);
        long long h[256]; cudaMemcpyFromSymbol(h, g_t, sizeof(long long) * 2 * n);
        double mean = 0; for (int i = 0; i < n; ++i) mean += (h[2 * i + 1] - h[2 * i]) / 1e3; mean /= n;
        double bytes = (double)T * CH * 2 * 2;
        printf("T=%d ctas=%d %s: kernel %.2f us, per CTA %.2f us, %.1f GB/s per SM (err %s)\n", T, n, kind ? "tma" : "cp.async", ms / 20 * 1e3, mean, bytes / mean / 1e3, cudaGetErrorString(cudaGetLastError()));
      }
    }
  }
  return 0;
}
