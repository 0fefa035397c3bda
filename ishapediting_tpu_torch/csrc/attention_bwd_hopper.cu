// The backward of ADM QKV attention on Hopper: bf16 at head dim 32, 64 or
// 128, every attention call of the chairs/cars/planes UNets (the route split
// the forward makes between attention.cu and attention_generic.cu). Reached
// through ishape_attn_bwd_dq / ishape_attn_bwd_dkdv (attention_bwd.cu),
// which pick this route; fp32 and bf16 at any other head dim stay on the
// generic kernels there.
//
// Replaces: ishapediting_tpu/ops/pallas_kernels.py::_attn_bwd, the VJP of
// the Pallas kernel _attn_kernel. It computes what attention_bwd.cu's
// generic kernels compute, at the same rounding points: with s = ch^-1/4,
// sQ = rnd(s q), sK = rnd(s k), the logits rnd(sQ sK^T), dP = rnd(dO V^T),
// P = exp(logits - lse), D = rowsum(dO * O), dS = P (dP - D) and P rounded to
// bf16 as product operands; dQ = s dS sK, dK = s dS^T sQ, dV = P^T dO
// (eager PyTorch's backward of the port's dense composition on the card).
//
// Bound on this card: seven T^2*ch products per (batch, head) over the two
// launches (S, dP and dQ in attn_bwd_dq; S, dP, dV and dK in attn_bwd_dkdv)
// on the bf16 tensor cores, against about 8 fp32 operations per logit and
// per launch on the FMA and SFU units: operations at T = 1024, bytes at
// T <= 256. At ch = 64 the elementwise work per logit takes about as many
// issue slots as the products take tensor-core time, so the design keeps
// both busy at once.
//
// Design (TMA + mbarrier ring + wgmma; one CTA per 64 own rows and
// batch*head, 288 threads, one CTA per SM):
// - Two 3-D tensor maps, over qkv [N, T, H*3*ch] and over the cotangent
//   dO [N, T, H*ch], with boxes {min(ch, 64), rows, 1} and the 128-byte
//   swizzle (64-byte at ch = 32), encoded per call through
//   cudaGetDriverEntryPoint (no -lcuda), so each tile lands in the canonical
//   wgmma layout. Rows past T arrive as zeros; swept keys past T are masked
//   (attn_bwd_dq), swept queries past T get lse = +inf, so P = 0
//   (attn_bwd_dkdv).
// - A producer warp loads the CTA's own two tiles once (Q and dO in
//   attn_bwd_dq, K and V in attn_bwd_dkdv), then keeps the swept tiles (K, V;
//   or Q, dO) in flight through a 4-stage ring with full/empty mbarriers.
// - Two consumer warpgroups split the swept tiles between them (even and odd
//   tiles; stages 0, 2 and 1, 3), so that one warpgroup's elementwise work
//   overlaps the other's products on the tensor cores and a batch-1 call's
//   128 CTAs still keep every SM busy. At the end the second warpgroup hands
//   its partial sums through shared memory and the first adds them in a
//   fixed order: no atomics, the same bits at any batch size.
// - The scaled operands rnd(s q) and rnd(s k): applied in place to a landed
//   tile by the warpgroup that uses it (the own tile by both), then
//   fence.proxy.async and a named barrier before wgmma reads it. Each Q tile
//   is some attn_bwd_dq CTA's own tile: scaled there once, it goes by TMA
//   store to a bf16 scratch sQ [N, T, H*ch], which attn_bwd_dkdv sweeps
//   already scaled. K is scaled per swept tile in attn_bwd_dq, and once per
//   CTA (its own tile) in attn_bwd_dkdv.
// - attn_bwd_dq, one key sweep: S = Q K^T and dP = dO V^T by wgmma from
//   shared memory (K and V K-major), an online log-sum-exp on the fp32
//   fragments (the dQ accumulator rescaled when a row's maximum in the warp
//   moves; keys masked on the last tile only), dS = exp(S - m) (dP - D)
//   rounded to bf16 into the register A operand of dQ += dS K (K as the
//   MN-major B operand, transpose flag), divided by the row sum at the end.
//   D comes from O and dO at the start; the log-sum-exp and D go to the
//   fp32 workspace [N, H, T] for attn_bwd_dkdv.
// - The elementwise work per logit is what bounds both kernels: the logits
//   and dP are rounded to bf16 by integer arithmetic (rnd), leaving the
//   conversion pipe to ex2 and the operand packing. Each warpgroup waits
//   for its products before its elementwise work and the other warpgroup's
//   fills the gap (issuing the next tile's products behind the last tile's
//   output products measured slower on the card: PERF.md).
// - attn_bwd_dkdv: S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T sit in
//   the accumulator fragments and become the register A operands of
//   dV += P^T dO and dK += dS^T Q (dO and Q MN-major B operands). Each swept
//   query tile's lse and D are copied from the workspace to shared memory
//   beside it (loaded one tile ahead). At ch = 128 the query tiles are 32
//   rows, to keep dK and dV in registers.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;        // own rows per CTA (wgmma M)
constexpr int kStages = 4;       // swept-tile ring: two stages per consumer warpgroup
constexpr int kConsumers = 2;    // consumer warpgroups; swept tiles alternate between them
constexpr int kThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory tile of ROWS rows and CH bf16 columns: NBOX column boxes,
// each [ROWS][BOX] with rows of the swizzle span (ROW_BYTES): the canonical
// wgmma layout (8-row atoms, 8*ROW_BYTES apart).
template <int CH, int ROWS>
struct Tile {
  static constexpr int BOX = CH < 64 ? CH : 64;
  static constexpr int NBOX = CH / BOX;
  static constexpr int ROW_BYTES = BOX * 2;
  static constexpr int BOX_BYTES = ROWS * ROW_BYTES;
  static constexpr int BYTES = NBOX * BOX_BYTES;
  static constexpr uint64_t LAYOUT = ROW_BYTES == 128 ? 1 : 2;  // descriptor: 128B / 64B swizzle
};

// Swept rows per tile: 32 for attn_bwd_dkdv at ch = 128 (registers), else 64.
template <int CH, bool DKDV>
constexpr int sweep_rows() { return DKDV && CH == 128 ? 32 : 64; }

// Dynamic shared memory, from a 1024-byte aligned base: the two own tiles,
// the ring (two swept tiles per stage), the row values (attn_bwd_dkdv: each
// stage's lse*log2(e) and D; attn_bwd_dq: the own rows' D), the second
// warpgroup's partial sums ([floats][128 threads]), then the mbarriers.
template <int CH, bool DKDV>
struct Layout {
  static constexpr int SW = sweep_rows<CH, DKDV>();
  using X = Tile<CH, kRows>;
  using Y = Tile<CH, SW>;
  static constexpr int STAGES = 2 * X::BYTES;
  static constexpr int STAGE = 2 * Y::BYTES;
  static constexpr int ROWVALS = STAGES + kStages * STAGE;
  static constexpr int ROWVALS_BYTES = DKDV ? kStages * 2 * SW * 4 : kRows * 4;
  static constexpr int MERGE = ROWVALS + ROWVALS_BYTES;
  static constexpr int MERGE_FLOATS = DKDV ? CH : CH / 2 + 4;  // dK and dV; or dQ, m and l
  static constexpr int BARS = MERGE + 128 * MERGE_FLOATS * 4;
  static constexpr int BYTES = 1024 + BARS + 8 * (2 * kStages + 1);
};

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
// of over ~10^10 cycles (seconds: a lost TMA transfer or a miscounted
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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Rows [r0, r0 + ROWS) and columns [c0, c0 + CH) of sample b into the tile
// at dst, in boxes of BOXROWS rows (the map's box height).
template <int CH, int ROWS, int BOXROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                          int r0, int b) {
  using L = Tile<CH, ROWS>;
#pragma unroll
  for (int j = 0; j < L::NBOX; ++j)
#pragma unroll
    for (int r = 0; r < ROWS; r += BOXROWS)
      tma_load_3d(dst + j * L::BOX_BYTES + r * L::ROW_BYTES, map, bar, c0 + j * L::BOX, r0 + r, b);
}

// The tile at src (the map's box layout) to columns c0.., rows r0.. of
// sample b; rows past the map's extent are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Order this thread's shared-memory writes before later async-proxy reads
// (wgmma) and writes (TMA) of the same bytes.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

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
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

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

// x rounded to bf16 (to nearest, ties to even) and back, by integer
// arithmetic: a conversion would take the pipe that also runs ex2 and the
// operand packing (5-8% of a kernel at T = 1024 on the card).
__device__ __forceinline__ float rnd(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// D[64 x 32] (+)= A[64 x 16] (shared, K-major) * B[32 x 16]^T (shared, K-major);
// scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] (shared, K-major) * B[64 x 16]^T (shared, K-major).
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

// C = A B^T over the CH channels: A the 64-row own tile, B a swept tile of
// SW rows, both K-major (16 channels per wgmma: within a column box a
// k-step advances the start address by 32 bytes, the hardware applies the
// swizzle; the next box is BOX_BYTES on).
template <int CH, int SW>
__device__ __forceinline__ void issue_nt(float (&c)[SW / 2], uint32_t a_tile, uint32_t b_tile) {
  using A = Tile<CH, kRows>;
  using B = Tile<CH, SW>;
#pragma unroll
  for (int kc = 0; kc < CH / 16; ++kc) {
    const uint32_t in_row = (kc * 32) % A::ROW_BYTES, box = (kc * 32) / A::ROW_BYTES;
    wgmma_ss(c, smem_desc(a_tile + box * A::BOX_BYTES + in_row, 16, 8 * A::ROW_BYTES, A::LAYOUT),
             smem_desc(b_tile + box * B::BOX_BYTES + in_row, 16, 8 * B::ROW_BYTES, B::LAYOUT), kc > 0);
  }
}

// O += P B: P [64 x SW] in registers (bf16 A fragments), B a swept tile
// [SW rows][CH] as the MN-major B operand (16 rows per wgmma, column boxes
// LBO = BOX_BYTES apart).
template <int CH, int SW>
__device__ __forceinline__ void issue_pb(float (&o)[CH / 2], const uint32_t (&pa)[SW / 16][4],
                                         uint32_t b_tile) {
  using B = Tile<CH, SW>;
#pragma unroll
  for (int kk = 0; kk < SW / 16; ++kk)
    wgmma_rs(o, pa[kk], smem_desc(b_tile + kk * 16 * B::ROW_BYTES, B::BOX_BYTES, 8 * B::ROW_BYTES, B::LAYOUT));
}

// Every bf16 of a landed tile (bytes at p) times mul, rounded to bf16, by
// threads t, t + nt, ... (16 bytes each): an elementwise pass, so the
// swizzle does not matter.
__device__ __forceinline__ void scale_tile(uint8_t* p, int bytes, float mul, int t, int nt) {
  for (int i = t; i < bytes / 16; i += nt) {
    uint4 v = reinterpret_cast<uint4*>(p)[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      h[k] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
    }
    reinterpret_cast<uint4*>(p)[i] = v;
  }
}

// Accumulator fragment of wgmma m64nN f32: element 4j+e of a thread is row
// r_lo (e < 2) or r_lo + 8 (e >= 2), column 8j + 2*quad + (e & 1). Columns
// 16kk..16kk+15 are elements 8kk..8kk+7, already in the order of the A
// fragment of a product over those columns.

// attn_bwd_dq. grid (query tiles of 64, N*H); lse, dd [N, H, T] fp32.
template <int CH>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap qkv_map, const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap sq_map,
                         const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ gout,
                         __nv_bfloat16* __restrict__ dqkv, float* __restrict__ lse_ws,
                         float* __restrict__ d_ws, int T, int H, float s4) {
  using L = Layout<CH, false>;
  constexpr int SW = L::SW;
  using X = typename L::X;
  using Y = typename L::Y;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t q_s = base, do_s = base + X::BYTES;
  auto k_s = [&](int s) { return base + L::STAGES + s * L::STAGE; };
  auto v_s = [&](int s) { return k_s(s) + Y::BYTES; };
  const uint32_t bars = base + L::BARS;
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (kStages + s); };
  const uint32_t own_bar = bars + 8u * (2 * kStages);
  float* d_s = reinterpret_cast<float*>(gbase + L::ROWVALS);
  float* merge = reinterpret_cast<float*>(gbase + L::MERGE);

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int x0 = blockIdx.x * kRows;
  const int col = h * 3 * CH;
  const int ntiles = (T + SW - 1) / SW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 128);
    }
    mbar_init(own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // producer warp: one lane issues every TMA load
    if (lane == 0) {
      mbar_expect_tx(own_bar, 2 * X::BYTES);
      load_tile<CH, kRows, SW>(q_s, &qkv_map, own_bar, col, x0, b);
      load_tile<CH, kRows, SW>(do_s, &do_map, own_bar, h * CH, x0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty_bar(s), ((it / kStages) - 1) & 1);
        mbar_expect_tx(full_bar(s), 2 * Y::BYTES);
        load_tile<CH, SW, SW>(k_s(s), &qkv_map, full_bar(s), col + CH, it * SW, b);
        load_tile<CH, SW, SW>(v_s(s), &qkv_map, full_bar(s), col + 2 * CH, it * SW, b);
      }
    }
    return;
  }

  const int wg = warp >> 2, tid = threadIdx.x & 127;
  const int r_lo = 16 * (warp & 3) + (lane >> 2), quad = lane & 3;
  const long long W = 3LL * H * CH, Wo = (long long)H * CH;

  // D = rowsum(dO * O) of the 64 own rows, by both warpgroups: 16 bytes of
  // each per lane, CH/8 lanes per row.
  {
    constexpr int LPR = CH / 8, RPP = 128 * kConsumers / LPR;
    const int sub = threadIdx.x % LPR;
    for (int r = threadIdx.x / LPR; r < kRows; r += RPP) {
      float acc = 0.f;
      if (x0 + r < T) {
        const long long off = ((long long)b * T + x0 + r) * Wo + h * CH + sub * 8;
        uint4 a = __ldg(reinterpret_cast<const uint4*>(out + off));
        uint4 g = __ldg(reinterpret_cast<const uint4*>(gout + off));
        const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 fa = __bfloat1622float2(ah[k]), fg = __bfloat1622float2(gh[k]);
          acc = fmaf(fa.x, fg.x, acc);
          acc = fmaf(fa.y, fg.y, acc);
        }
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (sub == 0) d_s[r] = acc;
    }
  }
  // The own Q tile times s, by both warpgroups; then stored to the scratch
  // sQ [N, T, H*ch] from which attn_bwd_dkdv sweeps it.
  mbar_wait(own_bar, 0);
  scale_tile(gbase, X::BYTES, s4, threadIdx.x, 128 * kConsumers);
  fence_async_shared();
  named_sync(1, 128 * kConsumers);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < X::NBOX; ++j) tma_store_3d(&sq_map, q_s + j * X::BOX_BYTES, h * CH + j * X::BOX, x0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  const float dr[2] = {d_s[r_lo], d_s[r_lo + 8]};

  float dq[CH / 2];
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) dq[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running row max, log2 units
  float l[2] = {0.f, 0.f};                      // running row sums, this thread's columns
  for (int it = wg; it < ntiles; it += kConsumers) {
    const int s = it % kStages;
    mbar_wait(full_bar(s), (it / kStages) & 1);
    scale_tile(gbase + (k_s(s) - base), Y::BYTES, s4, tid, 128);
    fence_async_shared();
    named_sync(2 + wg, 128);
    float sc[SW / 2], dp[SW / 2];
    wgmma_fence();
    issue_nt<CH, SW>(sc, q_s, k_s(s));
    issue_nt<CH, SW>(dp, do_s, v_s(s));
    wgmma_commit();
    wgmma_wait0();
    reg_fence(sc);
    reg_fence(dp);
    // The logits rounded to bf16, keys past T masked (the last tile only);
    // the online maximum.
    const int key0 = it * SW;
#pragma unroll
    for (int i = 0; i < SW / 2; ++i) sc[i] = rnd(sc[i]);
    if (key0 + SW > T) {
#pragma unroll
      for (int i = 0; i < SW / 2; ++i)
        if (key0 + 8 * (i >> 2) + 2 * quad + (i & 1) >= T) sc[i] = -CUDART_INF_F;
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < SW / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float c[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r] * kLog2e);
      c[r] = ex2(m[r] - mn);  // 0 on a warpgroup's first tile (m = -inf)
      m[r] = mn;
      l[r] *= c[r];
    }
    // dS = exp(S - m) (dP - D), rounded to bf16 as the A operand of dS K.
    uint32_t da[SW / 16][4];
#pragma unroll
    for (int kk = 0; kk < SW / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, row = r & 1;
        const float p0 = ex2(fmaf(sc[i], kLog2e, -m[row]));
        const float p1 = ex2(fmaf(sc[i + 1], kLog2e, -m[row]));
        l[row] += p0 + p1;
        da[kk][r] = pack_bf16(p0 * (rnd(dp[i]) - dr[row]), p1 * (rnd(dp[i + 1]) - dr[row]));
      }
    if (__any_sync(0xffffffffu, c[0] != 1.f || c[1] != 1.f)) {  // a row maximum moved
#pragma unroll
      for (int i = 0; i < CH / 2; ++i) dq[i] *= c[(i >> 1) & 1];
    }
    wgmma_fence();
    issue_pb<CH, SW>(dq, da, k_s(s));
    wgmma_commit();
    wgmma_wait0();
    reg_fence(dq);
    reg_fence(da);  // the A operand stays in its registers until the product is done
    mbar_arrive(empty_bar(s));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // The second warpgroup's (dQ, m, l) to the first, which merges them in a
  // fixed order and stores.
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) merge[i * 128 + tid] = dq[i];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      merge[(CH / 2 + r) * 128 + tid] = m[r];
      merge[(CH / 2 + 2 + r) * 128 + tid] = l[r];
    }
  }
  named_sync(1, 128 * kConsumers);
  if (wg == 1) return;
  float c0[2], c1[2], lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = merge[(CH / 2 + r) * 128 + tid], l1 = merge[(CH / 2 + 2 + r) * 128 + tid];
    const float mt = fmaxf(m[r], m1);
    const float lt = l[r] * ex2(m[r] - mt) + l1 * ex2(m1 - mt);  // 0 * 0 where the second had no tile
    lse[r] = mt * kLn2 + logf(lt);
    c0[r] = ex2(m[r] - mt) * (s4 / lt);
    c1[r] = ex2(m1 - mt) * (s4 / lt);
  }
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) {
    const int row = (i >> 1) & 1;
    dq[i] = dq[i] * c0[row] + merge[i * 128 + tid] * c1[row];
  }
  __nv_bfloat16* dst = dqkv + (long long)b * T * W + col + 2 * quad;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = x0 + r_lo + 8 * r;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < CH / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + row * W + 8 * j) = pack_bf16(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    if (quad == 0) {
      lse_ws[(long long)bh * T + row] = lse[r];
      d_ws[(long long)bh * T + row] = dr[r];
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // sQ has left
}

// attn_bwd_dkdv. grid (key tiles of 64, N*H); lse, dd from attn_bwd_dq.
template <int CH>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_kernel_wgmma(const __grid_constant__ CUtensorMap qkv_map, const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap sq_map, const float* __restrict__ lse_ws, const float* __restrict__ d_ws,
                           __nv_bfloat16* __restrict__ dqkv, int T, int H, float s4) {
  using L = Layout<CH, true>;
  constexpr int SW = L::SW;
  using X = typename L::X;
  using Y = typename L::Y;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + X::BYTES;
  auto q_s = [&](int s) { return base + L::STAGES + s * L::STAGE; };
  auto do_s = [&](int s) { return q_s(s) + Y::BYTES; };
  const uint32_t bars = base + L::BARS;
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (kStages + s); };
  const uint32_t own_bar = bars + 8u * (2 * kStages);
  // stage s: lse*log2(e) of its SW queries, then their D
  auto rowvals = [&](int s) { return reinterpret_cast<float*>(gbase + L::ROWVALS) + s * 2 * SW; };
  float* merge = reinterpret_cast<float*>(gbase + L::MERGE);

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int x0 = blockIdx.x * kRows;
  const int col = h * 3 * CH;
  const int ntiles = (T + SW - 1) / SW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 128);
    }
    mbar_init(own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // producer warp
    if (lane == 0) {
      mbar_expect_tx(own_bar, 2 * X::BYTES);
      load_tile<CH, kRows, SW>(k_s, &qkv_map, own_bar, col + CH, x0, b);
      load_tile<CH, kRows, SW>(v_s, &qkv_map, own_bar, col + 2 * CH, x0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty_bar(s), ((it / kStages) - 1) & 1);
        mbar_expect_tx(full_bar(s), 2 * Y::BYTES);
        load_tile<CH, SW, SW>(q_s(s), &sq_map, full_bar(s), h * CH, it * SW, b);
        load_tile<CH, SW, SW>(do_s(s), &do_map, full_bar(s), h * CH, it * SW, b);
      }
    }
    return;
  }

  const int wg = warp >> 2, tid = threadIdx.x & 127;
  const int r_lo = 16 * (warp & 3) + (lane >> 2), quad = lane & 3;
  const long long W = 3LL * H * CH;
  // This thread's share of a swept tile's row values: lse*log2(e) of query
  // tid (+inf past T: P = 0), or D of query tid - SW (0 past T).
  auto row_value = [&](int it) -> float {
    const int q = it * SW + (tid < SW ? tid : tid - SW);
    if (tid < SW) return q < T ? lse_ws[(long long)bh * T + q] * kLog2e : CUDART_INF_F;
    if (tid < 2 * SW) return q < T ? d_ws[(long long)bh * T + q] : 0.f;
    return 0.f;
  };
  float next = wg < ntiles ? row_value(wg) : 0.f;

  // The own K tile times s, by both warpgroups.
  mbar_wait(own_bar, 0);
  scale_tile(gbase, X::BYTES, s4, threadIdx.x, 128 * kConsumers);
  fence_async_shared();
  named_sync(1, 128 * kConsumers);

  float dk[CH / 2], dv[CH / 2];
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) dk[i] = dv[i] = 0.f;
  for (int it = wg; it < ntiles; it += kConsumers) {
    const int s = it % kStages;
    float* rv = rowvals(s);
    mbar_wait(full_bar(s), (it / kStages) & 1);  // sQ comes scaled
    if (tid < 2 * SW) rv[tid] = next;
    fence_async_shared();
    named_sync(2 + wg, 128);
    if (it + kConsumers < ntiles) next = row_value(it + kConsumers);  // lands during the products
    float st[SW / 2], dpt[SW / 2];
    wgmma_fence();
    issue_nt<CH, SW>(st, k_s, q_s(s));
    issue_nt<CH, SW>(dpt, v_s, do_s(s));
    wgmma_commit();
    wgmma_wait0();
    reg_fence(st);
    reg_fence(dpt);
    // P^T and dS^T: the columns are queries; rounded to bf16 as the A
    // operands of P^T dO and dS^T Q.
    uint32_t pa[SW / 16][4], da[SW / 16][4];
#pragma unroll
    for (int kk = 0; kk < SW / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const int q = 8 * (2 * kk + (r >> 1)) + 2 * quad;  // the column of element i (and q + 1)
        const float2 lq = *reinterpret_cast<const float2*>(rv + q);
        const float2 dd = *reinterpret_cast<const float2*>(rv + SW + q);
        const float p0 = ex2(fmaf(rnd(st[i]), kLog2e, -lq.x));
        const float p1 = ex2(fmaf(rnd(st[i + 1]), kLog2e, -lq.y));
        pa[kk][r] = pack_bf16(p0, p1);
        da[kk][r] = pack_bf16(p0 * (rnd(dpt[i]) - dd.x), p1 * (rnd(dpt[i + 1]) - dd.y));
      }
    wgmma_fence();
    issue_pb<CH, SW>(dv, pa, do_s(s));
    issue_pb<CH, SW>(dk, da, q_s(s));
    wgmma_commit();
    wgmma_wait0();
    reg_fence(dv);
    reg_fence(dk);
    reg_fence(pa);
    reg_fence(da);
    mbar_arrive(empty_bar(s));
  }

  // The second warpgroup's dK and dV to the first, which adds them in a
  // fixed order and stores.
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) {
      merge[i * 128 + tid] = dk[i];
      merge[(CH / 2 + i) * 128 + tid] = dv[i];
    }
  }
  named_sync(1, 128 * kConsumers);
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) {
    dk[i] = (dk[i] + merge[i * 128 + tid]) * s4;
    dv[i] += merge[(CH / 2 + i) * 128 + tid];
  }
  __nv_bfloat16* dst = dqkv + (long long)b * T * W + col + 2 * quad;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = x0 + r_lo + 8 * r;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < CH / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + row * W + CH + 8 * j) = pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dst + row * W + 2 * CH + 8 * j) =
          pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
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

// A map over a bf16 [B, T, width] tensor, boxes of CH columns (in boxes of
// at most 64) by rows rows.
template <int CH>
cudaError_t encode(CUtensorMap* map, const void* ptr, int B, int T, long long width, int rows) {
  using L = Tile<CH, kRows>;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)width * 2 * (cuuint64_t)T};
  const cuuint32_t box[3] = {(cuuint32_t)L::BOX, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        L::ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int CH>
int launch_dq(const void* qkv, const void* out, const void* gout, void* dqkv, void* lse, void* dd, void* sq,
              int N, int T, int H, cudaStream_t st) {
  using L = Layout<CH, false>;
  CUtensorMap qmap, dmap, smap;
  cudaError_t e = encode<CH>(&qmap, qkv, N, T, 3LL * H * CH, L::SW);
  if (e == cudaSuccess) e = encode<CH>(&dmap, gout, N, T, (long long)H * CH, L::SW);
  if (e == cudaSuccess) e = encode<CH>(&smap, sq, N, T, (long long)H * CH, L::SW);
  if (e != cudaSuccess) return (int)e;
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_bwd_dq_kernel_wgmma<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((T + kRows - 1) / kRows, N * H);
  attn_bwd_dq_kernel_wgmma<CH><<<grid, kThreads, L::BYTES, st>>>(
      qmap, dmap, smap, static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(gout),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(lse), static_cast<float*>(dd), T, H,
      (float)pow((double)CH, -0.25));
  return (int)cudaGetLastError();
}

template <int CH>
int launch_dkdv(const void* qkv, const void* gout, const void* lse, const void* dd, const void* sq, void* dqkv,
                int N, int T, int H, cudaStream_t st) {
  using L = Layout<CH, true>;
  CUtensorMap qmap, dmap, smap;
  cudaError_t e = encode<CH>(&qmap, qkv, N, T, 3LL * H * CH, L::SW);
  if (e == cudaSuccess) e = encode<CH>(&dmap, gout, N, T, (long long)H * CH, L::SW);
  if (e == cudaSuccess) e = encode<CH>(&smap, sq, N, T, (long long)H * CH, L::SW);
  if (e != cudaSuccess) return (int)e;
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_bwd_dkdv_kernel_wgmma<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((T + kRows - 1) / kRows, N * H);
  attn_bwd_dkdv_kernel_wgmma<CH><<<grid, kThreads, L::BYTES, st>>>(
      qmap, dmap, smap, static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<__nv_bfloat16*>(dqkv), T, H, (float)pow((double)CH, -0.25));
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The Hopper route of ishape_attn_bwd_dq (bf16, ch 32, 64 or 128; qkv, out,
// gout, dqkv and sq 16-byte aligned): also writes sQ = rnd(s q) to sq
// [N, T, H*ch] bf16 for attn_bwd_dkdv.
extern "C" int ishape_attn_bwd_dq_wgmma(const void* qkv, const void* out, const void* gout, void* dqkv,
                                        void* lse, void* dd, void* sq, int N, int T, int H, int ch,
                                        cudaStream_t st) {
  if (!aligned16(qkv) || !aligned16(out) || !aligned16(gout) || !aligned16(dqkv) || !aligned16(sq))
    return (int)cudaErrorInvalidValue;
  if (ch == 32) return launch_dq<32>(qkv, out, gout, dqkv, lse, dd, sq, N, T, H, st);
  if (ch == 64) return launch_dq<64>(qkv, out, gout, dqkv, lse, dd, sq, N, T, H, st);
  if (ch == 128) return launch_dq<128>(qkv, out, gout, dqkv, lse, dd, sq, N, T, H, st);
  return (int)cudaErrorInvalidValue;
}

// The Hopper route of ishape_attn_bwd_dkdv, sweeping the sQ of
// ishape_attn_bwd_dq_wgmma.
extern "C" int ishape_attn_bwd_dkdv_wgmma(const void* qkv, const void* gout, const void* lse, const void* dd,
                                          const void* sq, void* dqkv, int N, int T, int H, int ch,
                                          cudaStream_t st) {
  if (!aligned16(qkv) || !aligned16(gout) || !aligned16(dqkv) || !aligned16(sq)) return (int)cudaErrorInvalidValue;
  if (ch == 32) return launch_dkdv<32>(qkv, gout, lse, dd, sq, dqkv, N, T, H, st);
  if (ch == 64) return launch_dkdv<64>(qkv, gout, lse, dd, sq, dqkv, N, T, H, st);
  if (ch == 128) return launch_dkdv<128>(qkv, gout, lse, dd, sq, dqkv, N, T, H, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the Hopper route's attn_bwd_dq (dkdv = 0) or
// attn_bwd_dkdv (dkdv = 1) at head dim ch, in bytes (0 for other ch).
extern "C" int ishape_attn_bwd_wgmma_smem(int dkdv, int ch) {
  if (ch == 32) return dkdv ? Layout<32, true>::BYTES : Layout<32, false>::BYTES;
  if (ch == 64) return dkdv ? Layout<64, true>::BYTES : Layout<64, false>::BYTES;
  if (ch == 128) return dkdv ? Layout<128, true>::BYTES : Layout<128, false>::BYTES;
  return 0;
}
