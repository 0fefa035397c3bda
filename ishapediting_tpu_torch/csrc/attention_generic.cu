// ADM QKV attention (QKVAttentionLegacy) at any head dim, in fp32 or bf16:
// the counterpart of the wgmma kernel (attention.cu) for what it does not
// take, i.e. fp32 at any ch and bf16 at ch outside {32, 64, 128}.
//
// Replaces: ishapediting_tpu/ops/pallas_kernels.py::attention_qkv, i.e. the
// Pallas kernel _attn_kernel, which is dtype- and head-dim-generic: q and k
// each scaled by ch^-1/4 in fp32, fp32 logits and softmax, the weights cast
// to v's dtype (a no-op in fp32), P V accumulated in fp32, the output in
// qkv's dtype. fp32 here does the same (q and k scaled, rounded to fp32,
// before the product); bf16 feeds the raw q and k to the tensor cores and
// scales the fp32 logits by ch^-1/2, as the wgmma kernel does.
//
// Bound on this card: 4*T^2*ch flops per (batch, head) against 8*T*ch
// elements of qkv and output. bf16: both products on the bf16 tensor cores
// (989 TFLOP/s) or the bytes at 3.35 TB/s, whichever is longer; at the
// heads-by-count shapes (T <= 256, 8 to 32 CTAs) the bytes, and in practice
// the latency of the K/V copies. fp32: the kernel is held to 1e-4 against
// the plain fp32 version, so plain TF32 (about 3 decimal digits) is out. Of
// the two fp32 routes, plain FMA (67 TFLOP/s) or 3xTF32 on the tensor
// cores, this kernel takes 3xTF32: each operand x = hi + lo with
// hi = tf32(x), lo = tf32(x - hi) (x to 22 bits), and each product is
// lo*hi + hi*lo + hi*hi (lo*lo, ~2^-22 relative, dropped). Its bound is
// three TF32 passes at 495 TFLOP/s, 2.5x under the FMA bound, and the same
// mma.sync skeleton serves both dtypes.
//
// Design (FlashAttention-2 on mma.sync, one kernel for both dtypes):
// - One CTA of 4 warps per (64 query rows, batch*head); warp w owns rows
//   16w..16w+15 through both products, so the online softmax needs only
//   shuffles among the 4 lanes that hold a row. S and O stay in registers
//   (the m16n8 accumulator fragments); the S fragment of a key tile is the
//   A operand of P V without going through shared memory: for bf16 as is
//   (m16n8k16), for fp32 by reading P's key pairs (2t, 2t+1) as the k
//   indices (t, t+4) of m16n8k8 and V's rows in the same order.
// - The head dim is padded to chp, the next multiple of 16 (zeros past ch).
//   The O accumulator is sized by a bucket (16, 32, 48, 64, 96, 128, and for
//   bf16 192, 256), so the main path's head dims (8, 16, 40, 64, 192, 256)
//   pay for no channel past chp. P V runs over the whole bucket without a
//   branch (one would split the unrolled mma chain and serialise its
//   loads); an n-tile past chp reads valid columns and is never stored.
// - Q is loaded once; K/V tiles go through a ring, 4 stages deep for bf16
//   (3 for fp32), so at T <= 256, where each CTA has little work to hide a
//   copy behind, up to 3 tiles are in flight. bf16 at ch 192 and 256 (the
//   heads-by-count head dims) copies by TMA: 64-channel boxes of 32 rows
//   into 128-byte swizzled blocks, one mbarrier per stage (one SM pulls
//   72-81 GB/s so, against 37-40 GB/s by per-thread 16-byte cp.async, in a
//   copy-only probe on an H100); the fragment loads undo the swizzle. Other
//   head dims copy by cp.async into rows of chp + 16 bytes, which keep the
//   fragment loads (ldmatrix for bf16, 32-bit loads for fp32)
//   conflict-free. bf16: tiles of 64 keys (32 past bucket 128, for
//   registers); shared memory (64 + 8 keys) rows, at most 168,960 bytes.
// - A small grid (the heads-by-count shapes run 8 to 32 CTAs on 132 SMs)
//   waits on how fast each SM pulls its K/V tiles, so the key tiles of a
//   query tile are shared by a thread block cluster of up to 4 CTAs (grid
//   z), doubled while the grid stays within half the SMs (so that every
//   cluster is resident at once: with 1 CTA per SM, clusters of 4 over a
//   full card waited for a second wave) and each CTA keeps two key tiles
//   or more (split_of). Each CTA leaves its unnormalized O, max and sum in
//   shared memory; after a cluster barrier each merges a quarter (half) of
//   the rows from the others' shared memory (DSMEM) and writes them along
//   the channels, coalesced. The merge takes about 5 of 12 us at T = 256,
//   ch = 192; pushing the partials into the merging CTA's shared memory
//   before one barrier, or merging channels from registers instead of
//   rows, measured no faster (and the latter slowed the unsplit tiny fp32
//   shape by its registers).
//   Without a split, each thread stores its own fragments.
//   No workspace in device memory, so the launch contract is unchanged.
// - fp32: the 3xTF32 split is made once per element in shared memory (hi in
//   place, lo beside it) after a tile lands, not once per warp and use; the
//   three passes of a step are issued over all fragments in turn
//   (independent mma chains), the first with a zero accumulator, and each
//   step's sum is added to the fp32 accumulator outside the tensor cores:
//   their fp32 sums round toward zero, and a sum kept in the mma accumulator
//   over many steps drifts (1.7e-4 at T = 130, ch = 100, logits of size 50).
//   Tiles of 32 keys; shared memory Q and its lo, three K/V stages and the
//   K/V lo: 384 rows, at most 202,752 bytes (chp = 128).
// - Past those (fp32 chp > 128, bf16 chp > 256; no configuration of the JAX
//   package, but the TPU kernel takes them): a chunked path. A third grid
//   axis splits the output channels into slices of 256; each CTA recomputes
//   the logits over 64-channel chunks of Q and K loaded for every key tile,
//   then adds P times its slice of V. Correct at any ch, with no copy
//   overlap: not a main-path shape.
// - Softmax in fp32: the row max is subtracted in natural units before the
//   one multiply by log2(e) and ex2.approx, so the rounding of that multiply
//   is relative to s - max, small for the weights that count. Keys past T
//   get -inf; every key tile holds a key < T, so a row's running max is
//   finite after the first tile. For bf16 the weights are rounded to bf16
//   before P V, as the TPU kernel casts them to v's dtype.
// - Loads are 16-byte cp.async where ch is a whole number of 16-byte vectors
//   and qkv is 16-byte aligned, else element by element (odd ch).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;  // four warps
constexpr int kRows = 64;      // query rows per CTA, 16 per warp
constexpr int kChunk = 64;     // Q/K channels per chunk of the chunked path
constexpr int kSlice = 256;    // output channels per CTA of the chunked path
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSplit = 4;   // CTAs per cluster that share a query tile's keys, at most
constexpr int kNumSMs = 132;   // H100 SXM

template <typename T>
struct Elt;
template <>
struct Elt<float> {
  static constexpr int kVec = 4;     // elements per 16 bytes
  static constexpr int kPad = 4;     // row padding: rows of 16*odd bytes
  static constexpr int kFast = 128;  // largest chp of the fast path
  static constexpr int kStages = 3;  // K/V ring depth
  static constexpr bool kSplit = true;
};
template <>
struct Elt<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kPad = 8;
  static constexpr int kFast = 256;
  static constexpr int kStages = 4;
  static constexpr bool kSplit = false;
};

// Keys per K/V tile.
template <typename T, int CHMAX>
struct Keys {
  static constexpr int value = Elt<T>::kSplit || CHMAX > 128 ? 32 : 64;
};

// Dynamic shared memory in bytes, in rows of chp + pad elements (chunked:
// rows of 64 + pad and 256 + pad). Fast path: Q [64], K and V [stages]
// [keys]; fp32 also the lo of Q [64] and of K and V [keys]. Chunked: Q [64]
// and K [keys] chunks, V [keys] slice; fp32 each with its lo.
template <typename T, int CHMAX, bool CHUNKED>
constexpr int smem_bytes(int chp) {
  constexpr int keys = Keys<T, CHMAX>::value, pad = Elt<T>::kPad;
  constexpr int lo = Elt<T>::kSplit ? 2 : 1;
  return CHUNKED
             ? (int)sizeof(T) * lo * ((kRows + keys) * (kChunk + pad) + keys * (kSlice + pad))
             : (int)sizeof(T) * (lo * kRows + 2 * Elt<T>::kStages * keys + (lo - 1) * 2 * keys) *
                   (chp + pad);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) { ldsm_x4(r, smem_u32(p)); }
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) { ldsm_x4_t(r, smem_u32(p)); }

// Order this thread's earlier shared-memory accesses (generic proxy) before
// its later copies into shared memory (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed. A wait
// of over ~10^10 cycles (seconds: a lost copy or a miscounted barrier)
// traps, so that a fault ends the launch with an error instead of hanging
// the card.
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

// D += A B, m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A B, m16n8k8, tf32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A B (zero accumulator), m16n8k8, tf32 in.
__device__ __forceinline__ void mma_tf32_z(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  asm volatile(
      "{\n.reg .f32 z;\nmov.f32 z, 0f00000000;\n"
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {z, z, z, z};\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// Rows [r0, r0 + NROWS) and columns [c0, c0 + ncols) of one head's q, k or
// v (src points at its column 0 in row 0; rows are width apart) into dst
// [NROWS][dstride], zero where row >= Tn or column >= ch. ncols is a
// multiple of 16. vec: 16-byte cp.async (ch a multiple of the vector and qkv
// aligned), else element by element.
template <typename T, int NROWS>
__device__ __forceinline__ void load_tile(T* dst, int dstride, const T* src, long long width,
                                          int r0, int Tn, int c0, int ncols, int ch, bool vec) {
  const int V = vec ? Elt<T>::kVec : 1;
  const int cpr = ncols / V;  // copies per row
  const int dr = kThreads / cpr, dc = kThreads - dr * cpr;
  int r = threadIdx.x / cpr, c = threadIdx.x - r * cpr;
  for (; r < NROWS; r += dr, c += dc) {
    if (c >= cpr) {
      c -= cpr;
      ++r;
      if (r >= NROWS) break;
    }
    T* d = dst + r * dstride + c * V;
    const bool in = r0 + r < Tn && c0 + c * V < ch;
    const T* s = src + (long long)(r0 + r) * width + c0 + c * V;
    if (vec) {
      if (in)
        cp_async16(d, s);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      *d = in ? *s : T();
    }
  }
}

// fp32 rows [0, nrows) x [0, ncols) of x (stride `stride`), times `scale`
// (rounded to fp32, as the reference scales q and k), split in place:
// x -> hi = tf32(x), and lo = tf32(x - hi) into lo at the same offsets.
__device__ __forceinline__ void split_tile(float* x, float* lo, int stride, int nrows, int ncols,
                                           float scale) {
  const int cpr = ncols / 4;
  for (int i = threadIdx.x; i < nrows * cpr; i += kThreads) {
    const int r = i / cpr, c = (i - r * cpr) * 4;
    float4* p = reinterpret_cast<float4*>(x + r * stride + c);
    float4 v = *p;
    v = make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
    const float4 h = make_float4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w));
    *p = h;
    *reinterpret_cast<float4*>(lo + r * stride + c) =
        make_float4(to_tf32(v.x - h.x), to_tf32(v.y - h.y), to_tf32(v.z - h.z), to_tf32(v.w - h.w));
  }
}

// S += Q K^T over `cols` channels for this warp's 16 rows (sq) and a tile
// of KEYS keys (sk). S fragment s[j]: rows g, g+8 and keys 8j+2t, 8j+2t+1
// (g = lane/4, t = lane%4).
template <int KEYS>
__device__ __forceinline__ void qk(float (&s)[KEYS / 8][4], const __nv_bfloat16* sq, int sqs,
                                   const __nv_bfloat16* sk, int sks, int cols, int lane) {
  const __nv_bfloat16* qrow = sq + (lane & 15) * sqs + (lane >> 4) * 8;
  const __nv_bfloat16* krow = sk + ((lane & 7) + ((lane >> 4) << 3)) * sks + ((lane >> 3) & 1) * 8;
#pragma unroll 2
  for (int kk = 0; kk < cols; kk += 16) {
    uint32_t a[4], b[KEYS / 16][4];
    ldsm_x4(a, qrow + kk);
#pragma unroll
    for (int j = 0; j < KEYS / 16; ++j) ldsm_x4(b[j], krow + j * 16 * sks + kk);
#pragma unroll
    for (int j = 0; j < KEYS / 16; ++j) {
      mma_bf16(s[2 * j], a, b[j][0], b[j][1]);
      mma_bf16(s[2 * j + 1], a, b[j][2], b[j][3]);
    }
  }
}

// fp32, from the split tiles (hi: sq, sk; lo: sql, skl; same strides):
// each 8-channel step in 3xTF32 into a fresh fragment, then added to S.
template <int KEYS>
__device__ __forceinline__ void qk(float (&s)[KEYS / 8][4], const float* sq, const float* sql,
                                   int sqs, const float* sk, const float* skl, int sks, int cols,
                                   int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int qo = g * sqs + t, ko = g * sks + t;
#pragma unroll 2
  for (int kk = 0; kk < cols; kk += 8) {
    const uint32_t ah[4] = {bits(sq[qo + kk]), bits(sq[qo + 8 * sqs + kk]), bits(sq[qo + kk + 4]),
                            bits(sq[qo + 8 * sqs + kk + 4])};
    const uint32_t al[4] = {bits(sql[qo + kk]), bits(sql[qo + 8 * sqs + kk]),
                            bits(sql[qo + kk + 4]), bits(sql[qo + 8 * sqs + kk + 4])};
    uint32_t bh[KEYS / 8][2], bl[KEYS / 8][2];
    float acc[KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      const int o = ko + j * 8 * sks + kk;
      bh[j][0] = bits(sk[o]);
      bh[j][1] = bits(sk[o + 4]);
      bl[j][0] = bits(skl[o]);
      bl[j][1] = bits(skl[o + 4]);
    }
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) mma_tf32_z(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += acc[j][e];
  }
}

// The same two products from the TMA layout (bf16, ch a multiple of 64):
// 64-channel column blocks of 128-byte rows in the 128-byte swizzle, the
// 16-byte chunk c of row r at chunk c ^ (r % 8); Q blocks of 64 rows (sq),
// K and V blocks of KEYS rows (sk, sv), as shared-memory addresses.
template <int KEYS>
__device__ __forceinline__ void qk_sw(float (&s)[KEYS / 8][4], uint32_t sq, uint32_t sk, int cols,
                                      int warp, int lane) {
  const int r = 16 * warp + (lane & 15);
  const uint32_t qa = sq + r * 128, qx = r & 7, qhi = lane >> 4;
  const uint32_t ka = sk + ((lane & 7) + ((lane >> 4) << 3)) * 128, kx = lane & 7;
  const uint32_t khi = (lane >> 3) & 1;
#pragma unroll 4
  for (int kk = 0; kk < cols; kk += 16) {
    const uint32_t blk = kk >> 6, c = (kk & 63) >> 3;
    uint32_t a[4], b[KEYS / 16][4];
    ldsm_x4(a, qa + blk * (kRows * 128) + (((c + qhi) ^ qx) << 4));
#pragma unroll
    for (int j = 0; j < KEYS / 16; ++j)
      ldsm_x4(b[j], ka + blk * (KEYS * 128) + j * 16 * 128 + (((c + khi) ^ kx) << 4));
#pragma unroll
    for (int j = 0; j < KEYS / 16; ++j) {
      mma_bf16(s[2 * j], a, b[j][0], b[j][1]);
      mma_bf16(s[2 * j + 1], a, b[j][2], b[j][3]);
    }
  }
}

template <int KEYS, int NO>
__device__ __forceinline__ void pv_sw(float (&o)[NO / 8][4], const float (&p)[KEYS / 8][4],
                                      uint32_t sv, int lane) {
  const uint32_t va = sv + ((lane & 7) + ((lane >> 3) & 1) * 8) * 128, vx = lane & 7;
  const uint32_t vhi = lane >> 4;
#pragma unroll
  for (int i = 0; i < KEYS / 16; ++i) {
    const uint32_t a[4] = {pack_bf16(p[2 * i][0], p[2 * i][1]), pack_bf16(p[2 * i][2], p[2 * i][3]),
                           pack_bf16(p[2 * i + 1][0], p[2 * i + 1][1]),
                           pack_bf16(p[2 * i + 1][2], p[2 * i + 1][3])};
#pragma unroll
    for (int n = 0; n < NO / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, va + (n >> 3) * (KEYS * 128) + 16 * i * 128 + ((((n & 7) + vhi) ^ vx) << 4));
      mma_bf16(o[n], a, b[0], b[1]);
      mma_bf16(o[n + 1], a, b[2], b[3]);
    }
  }
}

// O += P V over a tile of KEYS keys (sv [KEYS][svs]), all NO output
// channels in registers, of which [0, ocols) are real (ocols a multiple of
// 16): a pair of n-tiles at or past ocols reads the last real pair instead
// and is never stored. O fragment o[n]: rows g, g+8 and channels 8n+2t,
// 8n+2t+1.
template <int KEYS, int NO>
__device__ __forceinline__ void pv(float (&o)[NO / 8][4], const float (&p)[KEYS / 8][4],
                                   const __nv_bfloat16* sv, int svs, int ocols, int lane) {
  const __nv_bfloat16* vrow = sv + ((lane & 7) + ((lane >> 3) & 1) * 8) * svs + (lane >> 4) * 8;
#pragma unroll
  for (int i = 0; i < KEYS / 16; ++i) {
    // The weights in v's dtype, as the TPU kernel casts them.
    const uint32_t a[4] = {pack_bf16(p[2 * i][0], p[2 * i][1]), pack_bf16(p[2 * i][2], p[2 * i][3]),
                           pack_bf16(p[2 * i + 1][0], p[2 * i + 1][1]),
                           pack_bf16(p[2 * i + 1][2], p[2 * i + 1][3])};
#pragma unroll
    for (int n = 0; n < NO / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, vrow + 16 * i * svs + min(n * 8, ocols - 16));
      mma_bf16(o[n], a, b[0], b[1]);
      mma_bf16(o[n + 1], a, b[2], b[3]);
    }
  }
}

// fp32, from the split V tile (hi sv, lo svl): per group of G n-tiles,
// each key step's three passes into fresh fragments, then added to O. An
// n-tile at or past ocols reads the last real one and is never stored.
template <int KEYS, int NO>
__device__ __forceinline__ void pv(float (&o)[NO / 8][4], const float (&p)[KEYS / 8][4],
                                   const float* sv, const float* svl, int svs, int ocols,
                                   int lane) {
  constexpr int NT = NO / 8;
  constexpr int G = NT <= 8 ? NT : (NT % 8 == 0 ? 8 : 6);  // n-tiles per group
  const int g = lane >> 2, t = lane & 3;
  const int vo = 2 * t * svs + g;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    // P's keys 8j+2t, 8j+2t+1 are the k indices t, t+4 of m16n8k8.
    const float pj[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = to_tf32(pj[e]);
      ah[e] = bits(h);
      al[e] = bits(to_tf32(pj[e] - h));
    }
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += G) {
      uint32_t bh[G][2], bl[G][2];
      float acc[G][4];
#pragma unroll
      for (int n = 0; n < G; ++n) {
        const int off = vo + 8 * j * svs + min(8 * (n0 + n), ocols - 8);
        bh[n][0] = bits(sv[off]);
        bh[n][1] = bits(sv[off + svs]);
        bl[n][0] = bits(svl[off]);
        bl[n][1] = bits(svl[off + svs]);
      }
#pragma unroll
      for (int n = 0; n < G; ++n) mma_tf32_z(acc[n], al, bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < G; ++n) mma_tf32(acc[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < G; ++n) mma_tf32(acc[n], ah, bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < G; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n0 + n][e] += acc[n][e];
    }
  }
}

// Online softmax over one key tile (keys k0..k0+KEYS-1). s holds the
// logits times 1/sc (SCALED: multiplied by sc here; else already in
// natural units) and becomes the unnormalized weights exp(s - m); m, l are
// the running max and this lane's share of the running sum of rows g and
// g+8; o is rescaled to the new max.
template <int KEYS, int NO, bool SCALED>
__device__ __forceinline__ void softmax_step(float (&s)[KEYS / 8][4], float (&o)[NO / 8][4],
                                             float (&m)[2], float (&l)[2], int k0, int Tn,
                                             float sc, int t) {
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (SCALED) s[j][e] *= sc;
      if (k0 + KEYS > Tn && k0 + 8 * j + 2 * t + (e & 1) >= Tn) s[j][e] = -CUDART_INF_F;
    }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    corr[r] = ex2((m[r] - mn) * kLog2e);  // 0 on the first tile (m = -inf)
    m[r] = mn;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = ex2((s[j][e] - m[e >> 1]) * kLog2e);
      l[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int n = 0; n < NO / 8; ++n) {
    o[n][0] *= corr[0];
    o[n][1] *= corr[0];
    o[n][2] *= corr[1];
    o[n][3] *= corr[1];
  }
}

template <int KEYS>
__device__ __forceinline__ void zero(float (&s)[KEYS / 8][4]) {
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
}

// Two output channels c, c+1 of a row (c + 1 < ch), as one store where the
// pair is aligned.
__device__ __forceinline__ void store2(float* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    p[1] = b;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    p[1] = __float2bfloat16_rn(b);
  }
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

// The end of a fast-path CTA of a cluster of cs > 1: its unnormalized O
// (registers), running max m and lane share of the sum l of its 64 query
// rows over its key tiles go to shared memory (part [64][chp + 4], then
// (m, l) [64][2], then the merge weights [64][kMaxSplit]: within the K/V
// ring, which is no longer read). After a cluster barrier, rank r merges
// rows [r*64/cs, (r+1)*64/cs) of the cs partials (read from the others'
// shared memory) with weights exp(m_j - M) / sum_j l_j exp(m_j - M),
// M = max_j m_j, and writes them with the threads along the channels
// (coalesced); a second barrier keeps every partial alive until read.
template <typename T, int NO>
__device__ __forceinline__ void combine_store(const float (&o)[NO / 8][4], const float (&m)[2],
                                              float (&l)[2], float* part, T* out, int q0, int Tn,
                                              int H, int ch, int chp, int b, int h, int cs,
                                              int rank) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ps = chp + 4;
  float* ml = part + kRows * ps;
  float* wts = ml + 2 * kRows;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int n = 0; n < NO / 8; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < chp)
        *reinterpret_cast<float2*>(part + row * ps + c) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
    }
    if (t == 0) {
      ml[2 * row] = m[r];
      ml[2 * row + 1] = l[r];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = kRows / cs, row0 = rank * rows;
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const int row = row0 + i;
    float mj[kMaxSplit], mx = -CUDART_INF_F, sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j) {
      mj[j] = j < cs ? cluster.map_shared_rank(ml, j)[2 * row] : -CUDART_INF_F;
      mx = fmaxf(mx, mj[j]);
    }
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j) {
      if (j < cs) {
        mj[j] = ex2((mj[j] - mx) * kLog2e);
        sum += mj[j] * cluster.map_shared_rank(ml, j)[2 * row + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j)
      if (j < cs) wts[i * kMaxSplit + j] = mj[j] / sum;
  }
  __syncthreads();
  // Channel pairs (c, c + 1) along the threads, rows in turn; eight pairs
  // per thread in flight, so that the remote loads overlap (one at a time,
  // the merge took 6.8 us of a 21 us call at T = 256, ch = 192).
  const float* pj[kMaxSplit];
#pragma unroll
  for (int j = 0; j < kMaxSplit; ++j) pj[j] = cluster.map_shared_rank(part, j < cs ? j : 0);
  const int cpr = (ch + 1) / 2, total = rows * cpr;
  const bool pairs = (ch & 1) == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
  constexpr int kU = 8;
  for (int i0 = threadIdx.x; i0 < total; i0 += kU * kThreads) {
    float2 v[kU][kMaxSplit];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = min(i0 + u * kThreads, total - 1), r = i / cpr, c = i - r * cpr;
#pragma unroll
      for (int j = 0; j < kMaxSplit; ++j)
        if (j < cs) v[u][j] = *reinterpret_cast<const float2*>(pj[j] + (row0 + r) * ps + 2 * c);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads, r = i / cpr, c = i - r * cpr;
      if (i >= total || q0 + row0 + r >= Tn) continue;
      float a = 0.f, e = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxSplit; ++j) {
        if (j < cs) {
          a += wts[r * kMaxSplit + j] * v[u][j].x;
          e += wts[r * kMaxSplit + j] * v[u][j].y;
        }
      }
      T* orow = out + ((long long)b * Tn + q0 + row0 + r) * H * ch + (long long)h * ch;
      if (2 * c + 1 < ch)
        store2(orow + 2 * c, a, e, pairs);
      else
        store1(orow + 2 * c, a);
    }
  }
  cluster.sync();  // the partials are read: the CTAs may leave
}

// grid (query tiles, B*H, output slices); qkv [B, T, H*3*ch], out [B, T, H*ch].
// sc: the logit scale, ch^-1/2 for bf16 (applied to the logits) and
// ch^-1/4 for fp32 (applied to q and k, as the reference does). TMA: the
// copies are TMA boxes of ``map`` (bf16, ch = chp a multiple of 64).
template <typename T, int CHMAX, bool CHUNKED, bool TMA>
__global__ void __launch_bounds__(kThreads)
attention_generic_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ qkv,
                         T* __restrict__ out, int Tn, int H, int ch, int chp, float sc, int vec) {
  constexpr int KEYS = Keys<T, CHMAX>::value;
  constexpr int PAD = Elt<T>::kPad;
  constexpr int STAGES = Elt<T>::kStages;
  constexpr bool SPLIT = Elt<T>::kSplit;
  constexpr int NO = CHUNKED ? kSlice : CHMAX;  // output channels in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kRows;
  const long long width = (long long)H * 3 * ch;
  const T* base = qkv + (long long)b * Tn * width + (long long)h * 3 * ch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int o0 = CHUNKED ? blockIdx.z * kSlice : 0;  // first output channel of this CTA
  // Fast path: the cs CTAs of a cluster (grid z) share a query tile's key
  // tiles, rank r taking tiles r, r + cs, ...
  const int cs = CHUNKED ? 1 : gridDim.z, rank = CHUNKED ? 0 : blockIdx.z;
  const int ocols = CHUNKED ? min(kSlice, chp - o0) : chp;
  const int ntiles = (Tn + KEYS - 1) / KEYS;

  float o[NO / 8][4];
#pragma unroll
  for (int n = 0; n < NO / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  if constexpr (TMA) {
    // Q [ch/64 blocks][64 rows], K and V [STAGES][ch/64 blocks][KEYS rows]
    // of 128 bytes, from a 1024-byte aligned base (the swizzle's period);
    // one mbarrier per stage counts a tile's bytes (tile 0's also Q's).
    static_assert(kRows == 2 * KEYS, "Q is two boxes of KEYS rows per column block");
    __shared__ __align__(8) uint64_t full[STAGES];
    const int nb = ch / 64, col = h * 3 * ch;
    const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t sk = sq + nb * kRows * 128, sv = sk + STAGES * nb * KEYS * 128;
    const int nl = (ntiles - rank + cs - 1) / cs;  // this CTA's key tiles
    if (threadIdx.x == 0) {
      for (int i = 0; i < STAGES; ++i) mbar_init(smem_u32(&full[i]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    auto fill = [&](int i) {  // thread 0: this CTA's i-th key tile (and Q with the first)
      const int stage = i % STAGES, k0 = (rank + i * cs) * KEYS;
      const uint32_t bar = smem_u32(&full[stage]);
      fence_proxy_async();  // the stage's last reads (generic proxy) before the copy's writes
      mbar_expect_tx(bar, (2 * nb * KEYS + (i == 0 ? nb * kRows : 0)) * 128);
      for (int j = 0; j < nb; ++j) {
        const uint32_t blk = (stage * nb + j) * KEYS * 128;
        tma_load_3d(sk + blk, &map, bar, col + ch + 64 * j, k0, b);
        tma_load_3d(sv + blk, &map, bar, col + 2 * ch + 64 * j, k0, b);
        if (i == 0) {
          tma_load_3d(sq + j * kRows * 128, &map, bar, col + 64 * j, q0, b);
          tma_load_3d(sq + j * kRows * 128 + KEYS * 128, &map, bar, col + 64 * j, q0 + KEYS, b);
        }
      }
    };
    if (threadIdx.x == 0)
      for (int i = 0; i < STAGES - 1 && i < nl; ++i) fill(i);
    for (int it = 0; it < nl; ++it) {
      if (threadIdx.x == 0 && it + STAGES - 1 < nl) fill(it + STAGES - 1);
      mbar_wait(smem_u32(&full[it % STAGES]), (it / STAGES) & 1);
      const int k0 = (rank + it * cs) * KEYS;
      float p[KEYS / 8][4];
      zero<KEYS>(p);
      qk_sw<KEYS>(p, sq, sk + (it % STAGES) * nb * KEYS * 128, chp, warp, lane);
      softmax_step<KEYS, NO, true>(p, o, m, l, k0, Tn, sc, t);
      pv_sw<KEYS, NO>(o, p, sv + (it % STAGES) * nb * KEYS * 128, lane);
      __syncthreads();  // this stage is refilled next
    }
    if (cs > 1) {
      combine_store<T, NO>(o, m, l, reinterpret_cast<float*>(smem_raw), out, q0, Tn, H, ch, chp,
                           b, h, cs, rank);
      return;
    }
  } else if constexpr (!CHUNKED) {
    const int st = chp + PAD;
    T* sq = smem;
    T* sk = sq + kRows * st;           // [STAGES][KEYS][st]
    T* sv = sk + STAGES * KEYS * st;   // [STAGES][KEYS][st]
    T* sql = sv + STAGES * KEYS * st;  // fp32: Q lo [64][st], then K lo, V lo [KEYS][st]
    T* skl = sql + kRows * st;
    T* svl = skl + KEYS * st;
    const int nl = (ntiles - rank + cs - 1) / cs;  // this CTA's key tiles
    auto load_kv = [&](int i) {  // this CTA's i-th key tile
      const int stage = i % STAGES, k0 = (rank + i * cs) * KEYS;
      load_tile<T, KEYS>(sk + stage * KEYS * st, st, base + ch, width, k0, Tn, 0, chp, ch, vec);
      load_tile<T, KEYS>(sv + stage * KEYS * st, st, base + 2 * ch, width, k0, Tn, 0, chp, ch,
                         vec);
    };
    // Prologue: Q and tiles 0..STAGES-2, one commit group per tile (empty
    // groups past the last tile keep the count uniform).
    load_tile<T, kRows>(sq, st, base, width, q0, Tn, 0, chp, ch, vec);
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < nl) load_kv(i);
      cp_async_commit();
    }
    for (int it = 0; it < nl; ++it) {
      // Tile it + STAGES - 1 into the stage tile it - 1 left; then tile it
      // has landed once at most STAGES - 1 groups are pending.
      if (it + STAGES - 1 < nl) load_kv(it + STAGES - 1);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();
      __syncthreads();
      const int k0 = (rank + it * cs) * KEYS;
      T* ks = sk + (it % STAGES) * KEYS * st;
      T* vs = sv + (it % STAGES) * KEYS * st;
      float p[KEYS / 8][4];
      zero<KEYS>(p);
      if constexpr (SPLIT) {
        if (it == 0) split_tile(sq, sql, st, kRows, chp, sc);
        split_tile(ks, skl, st, KEYS, chp, sc);
        split_tile(vs, svl, st, KEYS, chp, 1.f);
        __syncthreads();
        qk<KEYS>(p, sq + 16 * warp * st, sql + 16 * warp * st, st, ks, skl, st, chp, lane);
        softmax_step<KEYS, NO, false>(p, o, m, l, k0, Tn, sc, t);
        pv<KEYS, NO>(o, p, vs, svl, st, ocols, lane);
      } else {
        qk<KEYS>(p, sq + 16 * warp * st, st, ks, st, chp, lane);
        softmax_step<KEYS, NO, true>(p, o, m, l, k0, Tn, sc, t);
        pv<KEYS, NO>(o, p, vs, st, ocols, lane);
      }
      __syncthreads();  // this stage (and the lo tiles) are refilled next
    }
    if (cs > 1) {
      combine_store<T, NO>(o, m, l, reinterpret_cast<float*>(smem_raw), out, q0, Tn, H, ch, chp,
                           b, h, cs, rank);
      return;
    }
  } else {
    constexpr int CS = kChunk + PAD, VS = kSlice + PAD;
    T* sq = smem;
    T* sk = sq + kRows * CS;
    T* sv = sk + KEYS * CS;
    T* sql = sv + KEYS * VS;  // fp32: the lo of each
    T* skl = sql + kRows * CS;
    T* svl = skl + KEYS * CS;
    for (int it = 0; it < ntiles; ++it) {
      const int k0 = it * KEYS;
      float p[KEYS / 8][4];
      zero<KEYS>(p);
      for (int c0 = 0; c0 < chp; c0 += kChunk) {
        const int cols = min(kChunk, chp - c0);
        __syncthreads();  // the previous chunk (and tile) is no longer read
        load_tile<T, kRows>(sq, CS, base, width, q0, Tn, c0, cols, ch, vec);
        load_tile<T, KEYS>(sk, CS, base + ch, width, k0, Tn, c0, cols, ch, vec);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if constexpr (SPLIT) {
          split_tile(sq, sql, CS, kRows, cols, sc);
          split_tile(sk, skl, CS, KEYS, cols, sc);
          __syncthreads();
          qk<KEYS>(p, sq + 16 * warp * CS, sql + 16 * warp * CS, CS, sk, skl, CS, cols, lane);
        } else {
          qk<KEYS>(p, sq + 16 * warp * CS, CS, sk, CS, cols, lane);
        }
      }
      softmax_step<KEYS, NO, !SPLIT>(p, o, m, l, k0, Tn, sc, t);
      load_tile<T, KEYS>(sv, VS, base + 2 * ch, width, k0, Tn, o0, ocols, ch, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (SPLIT) {
        split_tile(sv, svl, VS, KEYS, ocols, 1.f);
        __syncthreads();
        pv<KEYS, NO>(o, p, sv, svl, VS, ocols, lane);
      } else {
        pv<KEYS, NO>(o, p, sv, VS, ocols, lane);
      }
    }
  }

  const bool pairs = (ch & 1) == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / l[r];
    const int q = q0 + 16 * warp + g + 8 * r;
    if (q >= Tn) continue;
    T* orow = out + ((long long)b * Tn + q) * H * ch + (long long)h * ch;
#pragma unroll
    for (int n = 0; n < NO / 8; ++n) {
      const int c = o0 + 8 * n + 2 * t;
      if (c + 1 < ch)
        store2(orow + c, o[n][2 * r] * inv, o[n][2 * r + 1] * inv, pairs);
      else if (c < ch)
        store1(orow + c, o[n][2 * r] * inv);
    }
  }
}

// CTAs per cluster sharing a query tile's keys: doubled (up to kMaxSplit)
// while the doubled grid stays within half the SMs, so that every cluster
// is resident at once, and each CTA keeps at least two key tiles, so that
// its copies still overlap its products. A small grid (the heads-by-count
// shapes: 8 to 32 CTAs) is bound by how fast each SM pulls its K/V tiles;
// splitting the keys puts more SMs on them. (At one tile per CTA, bf16
// ch 256 over T = 64, the split measured slower: 13.4 against 10.3 us.)
int split_of(int ctas, int ntiles) {
  int cs = 1;
  while (cs < kMaxSplit && 2 * cs * ctas <= kNumSMs / 2 && 4 * cs <= ntiles) cs *= 2;
  return cs;
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

// The TMA path's copies: bf16 qkv [B, T, W] as a 3-D map, boxes of 64
// channels (128 bytes, the 128-byte swizzle) by `keys` rows; rows past T
// zero-filled per sample.
int encode_qkv_map(CUtensorMap* map, const void* qkv, int B, int Tn, int H, int ch, int keys) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t width = (cuuint64_t)H * 3 * ch;
  const cuuint64_t dims[3] = {width, (cuuint64_t)Tn, (cuuint64_t)B};
  const cuuint64_t strides[2] = {width * 2, width * 2 * (cuuint64_t)Tn};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {64, (cuuint32_t)keys, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the TMA path: 1 KB of slack for the 1024-byte
// alignment, Q [64 rows] and the K/V ring [2 * stages * keys rows] of ch
// bf16 each.
constexpr int smem_tma(int ch) {
  return 1024 + 2 * (kRows + 2 * Elt<__nv_bfloat16>::kStages * 32) * ch;
}

template <typename T, int CHMAX, bool CHUNKED, bool TMA = false>
int launch(const void* qkv, void* out, int B, int Tn, int H, int ch, int chp, cudaStream_t st) {
  constexpr int KEYS = Keys<T, CHMAX>::value;
  // The most shared memory this instantiation takes: its bucket's (fast
  // path, TMA path) or the fixed layout (chunked).
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_generic_kernel<T, CHMAX, CHUNKED, TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TMA ? smem_tma(CHMAX) : smem_bytes<T, CHMAX, CHUNKED>(CHMAX));
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap map = {};
  if (TMA) {
    const int rc = encode_qkv_map(&map, qkv, B, Tn, H, ch, KEYS);
    if (rc != cudaSuccess) return rc;
  }
  const int vec = ch % Elt<T>::kVec == 0 && reinterpret_cast<uintptr_t>(qkv) % 16 == 0;
  const int ctas = (Tn + kRows - 1) / kRows * B * H;
  const int cs = CHUNKED ? 1 : split_of(ctas, (Tn + KEYS - 1) / KEYS);
  const int smem = TMA ? smem_tma(ch) : smem_bytes<T, CHMAX, CHUNKED>(chp);
  const dim3 grid((Tn + kRows - 1) / kRows, B * H, CHUNKED ? (chp + kSlice - 1) / kSlice : cs);
  // bf16: ch^-1/2 on the logits; fp32: ch^-1/4 on q and on k, rounded to
  // fp32 as the reference rounds it.
  const float sc =
      Elt<T>::kSplit ? (float)(1.0 / pow((double)ch, 0.25)) : (float)(1.0 / sqrt((double)ch));
  const T* q = static_cast<const T*>(qkv);
  T* o = static_cast<T*>(out);
  if (cs == 1) {
    attention_generic_kernel<T, CHMAX, CHUNKED, TMA><<<grid, kThreads, smem, st>>>(
        map, q, o, Tn, H, ch, chp, sc, vec);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr_c[1];
  attr_c[0].id = cudaLaunchAttributeClusterDimension;
  attr_c[0].val.clusterDim.x = 1;
  attr_c[0].val.clusterDim.y = 1;
  attr_c[0].val.clusterDim.z = cs;
  cfg.attrs = attr_c;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, attention_generic_kernel<T, CHMAX, CHUNKED, TMA>, map, q, o,
                                 Tn, H, ch, chp, sc, vec);
}

// bf16 rows of whole 64-channel boxes up to 256 (the heads-by-count head
// dims 192 and 256) from an aligned qkv: the TMA path.
template <typename T>
bool tma_ok(const void* qkv, int ch) {
  return !Elt<T>::kSplit && ch % 64 == 0 && ch > 128 && ch <= 256 &&
         reinterpret_cast<uintptr_t>(qkv) % 16 == 0;
}

// The O-accumulator buckets: the least one >= chp takes the launch.
template <typename T>
int dispatch(const void* qkv, void* out, int B, int Tn, int H, int ch, int chp, cudaStream_t st) {
  if (chp <= 16) return launch<T, 16, false>(qkv, out, B, Tn, H, ch, chp, st);
  if (chp <= 32) return launch<T, 32, false>(qkv, out, B, Tn, H, ch, chp, st);
  if (chp <= 48) return launch<T, 48, false>(qkv, out, B, Tn, H, ch, chp, st);
  if (chp <= 64) return launch<T, 64, false>(qkv, out, B, Tn, H, ch, chp, st);
  if (chp <= 96) return launch<T, 96, false>(qkv, out, B, Tn, H, ch, chp, st);
  if (chp <= 128) return launch<T, 128, false>(qkv, out, B, Tn, H, ch, chp, st);
  if constexpr (Elt<T>::kFast > 128) {
    if (tma_ok<T>(qkv, ch))
      return ch == 192 ? launch<T, 192, false, true>(qkv, out, B, Tn, H, ch, chp, st)
                       : launch<T, 256, false, true>(qkv, out, B, Tn, H, ch, chp, st);
    if (chp <= 192) return launch<T, 192, false>(qkv, out, B, Tn, H, ch, chp, st);
    if (chp <= 256) return launch<T, 256, false>(qkv, out, B, Tn, H, ch, chp, st);
  }
  return launch<T, kSlice, true>(qkv, out, B, Tn, H, ch, chp, st);
}

template <typename T>
int smem_of(int ch, int chp) {
  if (chp > Elt<T>::kFast) return smem_bytes<T, kSlice, true>(chp);
  if (!Elt<T>::kSplit && ch % 64 == 0 && ch > 128) return smem_tma(ch);
  if (chp > 128) return smem_bytes<T, 256, false>(chp);  // bucket 192 or 256: tiles of 32 keys
  return smem_bytes<T, 128, false>(chp);                 // buckets up to 128: the same keys
}

bool valid_chp(int ch, int chp) { return ch >= 1 && chp >= ch && chp % 16 == 0 && chp < ch + 16; }

}  // namespace

// qkv: [B, T, H*3*ch] contiguous, dtype 0 = float32, 1 = bfloat16; out:
// [B, T, H*ch] of the same dtype. chp: the head dim padded to the next
// multiple of 16 (ops/hopper_kernels.py attention_generic_geometry).
// Returns cudaGetLastError() after the launch.
extern "C" int ishape_attention_generic(const void* qkv, void* out, int dtype, int B, int T,
                                        int H, int ch, int chp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || B < 1 || H < 1 || !valid_chp(ch, chp)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(qkv, out, B, T, H, ch, chp, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(qkv, out, B, T, H, ch, chp, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a launch at head dim ch and dtype (0 = float32,
// 1 = bfloat16) from an aligned qkv, in bytes; 0 for a ch < 1 or a dtype
// the kernel does not take.
extern "C" int ishape_attention_generic_smem(int ch, int dtype) {
  if (ch < 1) return 0;
  const int chp = (ch + 15) / 16 * 16;
  if (dtype == 0) return smem_of<float>(ch, chp);
  if (dtype == 1) return smem_of<__nv_bfloat16>(ch, chp);
  return 0;
}
