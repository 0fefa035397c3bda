// Fused ADM QKV attention (QKVAttentionLegacy) over the legacy per-head
// q|k|v layout, bf16 in and out.
//
// Replaces: ishapediting_tpu/ops/pallas_kernels.py::attention_qkv, i.e. the
// Pallas kernel _attn_kernel (one program per batch*head:
// softmax_fp32((q*ch^-1/4)(k*ch^-1/4)^T), probabilities cast to v's dtype,
// @ v with fp32 accumulation).
//
// Bound on this card: at the main path's shapes (T = 1024, 256, 64 tokens,
// head dim 64) the function does 4*T^2*ch flops per (batch, head) against
// 8*T*ch bytes of qkv and output, i.e. T/2 flops per byte: compute-bound at
// T = 1024 (512 flops/byte against the ~295 where an H100 turns
// compute-bound), memory-bound at T <= 256. The least time is the larger of
// flops / 989 TFLOP/s (bf16 tensor cores) and bytes / 3.35 TB/s. Besides
// the products, each logit costs one exp2 on the SFU, which at T = 1024 is
// about as much time as the tensor-core work.
//
// Design (Hopper: TMA + mbarrier ring + wgmma, warp-specialised).
// - One CTA per (64 query rows, batch*head): one consumer warpgroup and one
//   producer warp. Two CTAs fit on an SM (registers and shared memory), so
//   at T = 1024, batch 2 (B*H = 16) the 256 CTAs run in one wave, and one
//   CTA's softmax overlaps the other's products. (Two consumer warpgroups
//   per CTA sharing each K/V tile, taking turns on the tensor cores, measured
//   slower on an H100: PERF.md.)
// - One 3-D tensor map over qkv, [B, T, H*3*ch], box {min(ch, 64), 64, 1},
//   encoded on the host at each call (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint so the library needs no -lcuda) and passed as a
//   __grid_constant__ parameter. Q, K and V are the same map at columns
//   h*3ch, +ch, +2ch. Rows past T are zero-filled per sample by TMA; keys past
//   T are masked to -inf in the softmax (a zero key would give logit 0).
// - The 128-byte swizzle (64-byte for ch = 32; two column boxes for ch =
//   128) puts each row in the canonical wgmma layout: Q is the K-major A
//   operand, a K tile [keys][ch] is the K-major B operand of S = Q K^T, and a
//   V tile [keys][ch] is the MN-major B operand of O += P V (transpose flag),
//   so nothing is transposed by hand.
// - The producer warp loads Q once, then keeps K/V tiles in flight through a
//   3-stage ring: a "full" mbarrier per stage completes on the TMA bytes
//   (complete_tx), an "empty" one when every consumer thread is done. Tiles
//   are 128 keys (fewer, larger products and softmax steps), 64 where T <= 64
//   (no half-empty tile) and at ch = 128 (registers).
// - Consumer: S = Q K^T by wgmma m64n{keys}k16 from shared memory; the online
//   softmax on the fp32 accumulator fragment, with ch^-1/2*log2(e) folded into
//   one scale and ex2.approx; P rounded to bf16 (as the TPU kernel rounds
//   its probabilities) is repacked in registers as the A operand of
//   O += P V (wgmma m64n{ch}k16, A from registers). The product S_j of one
//   tile and P_{j-1} V_{j-1} of the one before are issued together, so the
//   softmax of S_j overlaps P V on the tensor cores. The output is
//   normalised and written as bf16 straight into [B, T, H*ch].

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;    // query rows per CTA (wgmma M), rows per TMA box
constexpr int kStages = 3;   // K/V ring depth

// Shared-memory tile of ROWS rows and CH bf16 columns: NBOX column boxes,
// each [ROWS][BOX] with rows of the swizzle span (ROW_BYTES), which is the
// canonical wgmma layout (8-row atoms, 8*ROW_BYTES apart).
template <int CH, int ROWS>
struct Tile {
  static constexpr int BOX = CH < 64 ? CH : 64;
  static constexpr int NBOX = CH / BOX;
  static constexpr int ROW_BYTES = BOX * 2;
  static constexpr int BOX_BYTES = ROWS * ROW_BYTES;
  static constexpr int BYTES = NBOX * BOX_BYTES;
  static constexpr uint64_t LAYOUT = ROW_BYTES == 128 ? 1 : 2;  // descriptor: 128B / 64B swizzle
};

template <int CH, int KEYS>
constexpr int smem_bytes() {
  // 1 KB of slack to align the tiles to the 1024-byte swizzle atom, the Q
  // tile, K and V tiles per stage, then 2*kStages+1 mbarriers.
  return 1024 + Tile<CH, kRows>::BYTES + 2 * kStages * Tile<CH, KEYS>::BYTES + 8 * (2 * kStages + 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of the given parity has completed. A wait
// of over ~10^10 cycles (seconds; a lost TMA transfer or a miscounted
// barrier) traps, so that a fault ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 10000000000LL) __trap();
  }
}

// One TMA box {c0, c1, c2} of the tensor map into shared memory at dst;
// completion is counted in bytes on the mbarrier.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching (or reusing) registers that an async wgmma
// reads or writes before the wait that ends it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D[64 x 64] (+)= A[64 x 16] (shared, K-major) * B[64 x 16]^T (shared, K-major);
// scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] (shared, K-major) * B[128 x 16]^T (shared, K-major);
// scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 32] += A[64 x 16] (registers) * B[16 x 32] (shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] (registers) * B[16 x 64] (shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] (registers) * B[16 x 128] (shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T for one key tile: 16 columns of ch per wgmma; within a box a
// k-step advances the start address by 32 bytes (the hardware applies the
// swizzle to the address), the next column box is BOX_BYTES on.
template <int CH, int KEYS>
__device__ __forceinline__ void issue_qk(float (&sc)[KEYS / 2], uint32_t q_tile, uint32_t k_tile) {
  using Q = Tile<CH, kRows>;
  using K = Tile<CH, KEYS>;
#pragma unroll
  for (int kc = 0; kc < CH / 16; ++kc) {
    const uint32_t in_row = (kc * 32) % Q::ROW_BYTES, box = (kc * 32) / Q::ROW_BYTES;
    wgmma_ss(sc, smem_desc(q_tile + box * Q::BOX_BYTES + in_row, 16, 8 * Q::ROW_BYTES, Q::LAYOUT),
             smem_desc(k_tile + box * K::BOX_BYTES + in_row, 16, 8 * K::ROW_BYTES, K::LAYOUT),
             kc > 0);
  }
}

// O += P V for one key tile: V [keys][ch] is the MN-major B operand; 16 keys
// per wgmma (two 8-row swizzle atoms), column boxes LBO = BOX_BYTES apart.
template <int CH, int KEYS>
__device__ __forceinline__ void issue_pv(float (&o)[CH / 2], const uint32_t (&pa)[KEYS / 16][4],
                                         uint32_t v_tile) {
  using V = Tile<CH, KEYS>;
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk)
    wgmma_rs(o, pa[kk],
             smem_desc(v_tile + kk * 16 * V::ROW_BYTES, V::BOX_BYTES, 8 * V::ROW_BYTES, V::LAYOUT));
}

// Online-softmax step on one tile of raw scores (accumulator fragment:
// element 4j+e is row lo (e < 2) or hi (e >= 2), key key0 + 8j + 2*quad +
// (e & 1)). Masks keys >= T, raises the running row max m (log2 units),
// returns in c the factor that rescales earlier terms, folds the tile into
// the running sums l, and writes P in bf16 as the register A operand of
// P V: keys 16kk..16kk+15 are elements 8kk..8kk+7, already in the A
// fragment's order.
template <int KEYS>
__device__ __forceinline__ void softmax_tile(float (&sc)[KEYS / 2], uint32_t (&pa)[KEYS / 16][4],
                                             float (&m)[2], float (&l)[2], float (&c)[2],
                                             int key0, int T, int quad, float scale_log2) {
  if (key0 + KEYS > T) {
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i)
      if (key0 + 8 * (i >> 2) + 2 * quad + (i & 1) >= T) sc[i] = -CUDART_INF_F;
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    const float mn = fmaxf(m[r], mx[r] * scale_log2);
    c[r] = ex2(m[r] - mn);
    m[r] = mn;
    l[r] *= c[r];
  }
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float p0 = ex2(fmaf(sc[8 * kk + 2 * r], scale_log2, -m[r & 1]));
      const float p1 = ex2(fmaf(sc[8 * kk + 2 * r + 1], scale_log2, -m[r & 1]));
      l[r & 1] += p0 + p1;
      pa[kk][r] = pack_bf16(p0, p1);
    }
  }
}

template <int CH, int KEYS>
__global__ void __launch_bounds__(160)
attention_kernel(__grid_constant__ const CUtensorMap qkv_map, __nv_bfloat16* __restrict__ out,
                 int T, int H, float scale_log2) {
  using Q = Tile<CH, kRows>;
  using KV = Tile<CH, KEYS>;
  constexpr int NO = CH / 2;  // O accumulator floats per thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;  // the Q tile
  const uint32_t kv_s = q_s + Q::BYTES;         // stage s: K at +2s tiles, V after it
  const uint32_t bars = kv_s + 2 * kStages * KV::BYTES;
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (kStages + s); };
  const uint32_t q_bar = bars + 8u * (2 * kStages);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kRows;
  const int col_q = h * 3 * CH;
  const int ntiles = (T + KEYS - 1) / KEYS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 128);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // producer warp: one lane issues every TMA load
    if (lane == 0) {
      mbar_expect_tx(q_bar, Q::BYTES);
      for (int j = 0; j < Q::NBOX; ++j)
        tma_load_3d(q_s + j * Q::BOX_BYTES, &qkv_map, q_bar, col_q + j * Q::BOX, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty_bar(s), ((it / kStages) - 1) & 1);
        mbar_expect_tx(full_bar(s), 2 * KV::BYTES);
        const uint32_t k_s = kv_s + 2 * s * KV::BYTES, v_s = k_s + KV::BYTES;
        for (int j = 0; j < KV::NBOX; ++j)
          for (int r = 0; r < KEYS; r += kRows) {  // boxes of 64 rows
            const uint32_t off = j * KV::BOX_BYTES + r * KV::ROW_BYTES;
            tma_load_3d(k_s + off, &qkv_map, full_bar(s), col_q + CH + j * KV::BOX, it * KEYS + r, b);
            tma_load_3d(v_s + off, &qkv_map, full_bar(s), col_q + 2 * CH + j * KV::BOX,
                        it * KEYS + r, b);
          }
      }
    }
    return;
  }

  // The consumer warpgroup owns query rows q0 .. q0+63. Accumulator
  // fragment (wgmma m64nN f32): element 4j+e of a thread is row
  // r_lo (e < 2) or r_lo+8 (e >= 2), column 8j + 2*quad + (e & 1).
  const int tid = threadIdx.x;
  const int r_lo = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int quad = tid & 3;

  auto k_tile = [&](int s) { return kv_s + 2u * s * KV::BYTES; };
  auto v_tile = [&](int s) { return kv_s + (2u * s + 1) * KV::BYTES; };

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running row max (log2 units), rows lo, hi
  float l[2] = {0.f, 0.f};  // running row sums over this thread's columns
  float c[2];
  float sc[KEYS / 2];
  uint32_t pa[KEYS / 16][4];

  // Tile 0: S, softmax. Then for each later tile j, S_j = Q K_j^T and
  // O += P_{j-1} V_{j-1} run on the tensor cores together; the softmax of
  // S_j overlaps the P V product; O is rescaled once that product is done.
  mbar_wait(q_bar, 0);
  mbar_wait(full_bar(0), 0);
  wgmma_fence();
  issue_qk<CH, KEYS>(sc, q_s, k_tile(0));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(sc);
  softmax_tile<KEYS>(sc, pa, m, l, c, 0, T, quad, scale_log2);
  for (int it = 1; it < ntiles; ++it) {
    const int s = it % kStages, sp = (it - 1) % kStages;
    mbar_wait(full_bar(s), (it / kStages) & 1);
    wgmma_fence();
    issue_qk<CH, KEYS>(sc, q_s, k_tile(s));
    wgmma_commit();
    issue_pv<CH, KEYS>(o, pa, v_tile(sp));
    wgmma_commit();
    wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
    reg_fence(sc);
    uint32_t pn[KEYS / 16][4];
    softmax_tile<KEYS>(sc, pn, m, l, c, it * KEYS, T, quad, scale_log2);
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(pa);  // P_{j-1} stays in its registers until its product is done
    mbar_arrive(empty_bar(sp));
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= c[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pn[kk][r];
  }
  wgmma_fence();
  issue_pv<CH, KEYS>(o, pa, v_tile((ntiles - 1) % kStages));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(o);

#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
  const float inv_lo = 1.f / l[0], inv_hi = 1.f / l[1];
  const int row_lo = q0 + r_lo, row_hi = row_lo + 8;
  const long long out_stride = (long long)H * CH;
  __nv_bfloat16* obase = out + (long long)b * T * out_stride + (long long)h * CH + 2 * quad;
#pragma unroll
  for (int j = 0; j < CH / 8; ++j) {
    if (row_lo < T)
      *reinterpret_cast<uint32_t*>(obase + row_lo * out_stride + 8 * j) =
          pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
    if (row_hi < T)
      *reinterpret_cast<uint32_t*>(obase + row_hi * out_stride + 8 * j) =
          pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// does not link the driver library itself.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

template <int CH, int KEYS>
int launch(const void* qkv, void* out, int B, int T, int H, cudaStream_t stream) {
  using Q = Tile<CH, kRows>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t width = (cuuint64_t)H * 3 * CH;
  const cuuint64_t dims[3] = {width, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {width * 2, width * 2 * (cuuint64_t)T};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {(cuuint32_t)Q::BOX, (cuuint32_t)kRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUtensorMap map;
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            Q::ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<CH, KEYS>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_kernel<CH, KEYS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((T + kRows - 1) / kRows, B * H);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)CH);  // log2(e) * (ch^-1/4)^2
  attention_kernel<CH, KEYS><<<grid, 160, smem, stream>>>(
      map, static_cast<__nv_bfloat16*>(out), T, H, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: [B, T, H*3*ch] bf16, contiguous, 16-byte aligned; out: [B, T, H*ch].
// keys: keys per K/V tile (ops/hopper_kernels.py attention_geometry).
// Returns cudaGetLastError() after the launch.
extern "C" int ishape_attention(const void* qkv, void* out, int B, int T, int H, int ch,
                                int keys, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || B < 1 || H < 1 || (reinterpret_cast<uintptr_t>(qkv) & 15)) return (int)cudaErrorInvalidValue;
  if (ch == 32 && keys == 64) return launch<32, 64>(qkv, out, B, T, H, st);
  if (ch == 32 && keys == 128) return launch<32, 128>(qkv, out, B, T, H, st);
  if (ch == 64 && keys == 64) return launch<64, 64>(qkv, out, B, T, H, st);
  if (ch == 64 && keys == 128) return launch<64, 128>(qkv, out, B, T, H, st);
  if (ch == 128 && keys == 64) return launch<128, 64>(qkv, out, B, T, H, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a launch with head dim ch and K/V tiles of keys
// keys, in bytes (0 for combinations the kernel does not take).
extern "C" int ishape_attention_smem(int ch, int keys) {
  if (ch == 32 && keys == 64) return smem_bytes<32, 64>();
  if (ch == 32 && keys == 128) return smem_bytes<32, 128>();
  if (ch == 64 && keys == 64) return smem_bytes<64, 64>();
  if (ch == 64 && keys == 128) return smem_bytes<64, 128>();
  if (ch == 128 && keys == 64) return smem_bytes<128, 64>();
  return 0;
}
