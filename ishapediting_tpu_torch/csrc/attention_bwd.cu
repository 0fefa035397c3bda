// The backward of ADM QKV attention (QKVAttentionLegacy) at every dtype and
// head dim the forward kernels take (attention.cu, attention_generic.cu).
//
// Replaces: ishapediting_tpu/ops/pallas_kernels.py::_attn_bwd, the VJP of the
// Pallas kernel _attn_kernel, which differentiates the dense composition.
// With s = ch^-1/4 on q and k, P = softmax((sQ)(sK)^T), O = P V and the
// cotangent dO: D = rowsum(dO * O), dV = P^T dO, dS = P * (dO V^T - D),
// dQ = s dS (sK), dK = s dS^T (sQ). The values are those of eager PyTorch's
// backward of the port's dense composition on the card, at its rounding
// points in qkv's dtype: sQ, sK, the logits and dP = dO V^T rounded to it,
// P and dS rounded to it as product operands (nothing rounds in fp32). That
// backward is the reference of chip_smoke.py's 1e-2 gate (GRAD_TOL), and its
// own bf16 rounding puts an exact fp32 gradient near the gate's edge. Two
// launches, each with two routes picked by the entry points below:
//   attn_bwd_dq: a CTA per (64 query rows, batch*head[, output slice]). One
//     sweep over the key tiles with an online log-sum-exp (the dQ sums
//     rescaled when a row's maximum moves, dS = exp(S - m) (dP - D) rounded
//     before its product, divided by the row sum at the end); D comes from
//     the forward's output and the cotangent. It writes the log-sum-exp and
//     D to an fp32 workspace [N, H, T].
//   attn_bwd_dkdv: a CTA per (64 key rows, batch*head[, output slice]). It
//     sweeps the query tiles, rebuilds P^T from the workspace, and sums
//     dV = P^T dO and dK = dS^T Q.
// Both write straight into dqkv in qkv's [N, T, H*3*ch] layout.
//   The Hopper route, bf16 at ch 32, 64 and 128 (every attention call of the
// chairs/cars/planes UNets): attention_bwd_hopper.cu (TMA, an mbarrier ring,
// wgmma, two consumer warpgroups per CTA; its workspace also holds
// sQ = rnd(s q), written by attn_bwd_dq). The generic route, fp32 at any ch
// and bf16 at any other ch: the kernels in this file.
//
// Bound on this card: seven T^2*ch products per (batch, head) (the logits
// and dP in both launches, dQ, dK, dV) against reading qkv, out and dO and
// writing dqkv once: operations at the chairs shapes (T = 1024), bytes at
// T = 64. The generic route runs bf16 products on the tensor cores
// (mma.sync m16n8k16, fp32 accumulators) and fp32 (the tiny preset and the
// fp32 UNets, T <= 256) on the FMA units in fp32, exact to 1e-5 where TF32
// is not.
//
// Generic design (simple: no copy pipelining, no wgmma):
// - A CTA of four warps owns 64 rows (16 per warp) of its own tile and
//   sweeps 64-row tiles of the other operand. The logit-type products
//   (S = X1 Y1^T, dP = X2 Y2^T, X the own rows, Y the swept rows) run over
//   the channels in chunks of 64 through four shared-memory tiles
//   [64][64 + 16 bytes]; at ch <= 64 the own tiles load once. Any ch:
//   channels past ch are zero in shared memory, and past 64 the products
//   loop over chunks.
// - The output-type products (dQ += dS K, dV += P^T dO, dK += dS^T Q) keep
//   out_cols (16, 32, 64 or, past 64 channels, 128) output channels per
//   thread in registers; past 128 channels grid z slices the outputs by 128
//   and each slice recomputes the logits (ch 192 and 256: two slices). A
//   128-channel slice runs its output products in two halves of 64.
// - Where a tile per chunk of every operand fits in shared memory (bf16 to
//   ch 384, fp32 to ch 192), the own tiles load once and each swept tile in
//   one round, and the output products read the swept tile's chunks where
//   they lie: per swept tile one round of loads, where a chunk at a time
//   took five at ch 192 (the latency that bounds a batch-1 call). Past that
//   the chunks stream through one tile per operand.
// - bf16: S and dP are m16n8 accumulator fragments; P and dS become the A
//   operand of the output product from registers (rounded to bf16, as the
//   forward rounds the weights), the B operand by ldmatrix.trans. fp32: the
//   same fragment ownership computed by FMA; P and dS go through a
//   per-warp shared-memory scratch.
// - Any T: rows past T load as zeros; keys past T get P = 0 in the dq
//   launch, queries past T a log-sum-exp of +inf (so P = 0) in dkdv.
// - Softmax in fp32 in natural units, each exponent (s - m) times log2 e
//   through ex2.approx.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kRows = 64;      // own rows per CTA, and rows per swept tile
constexpr int kChunk = 64;     // channels per chunk of the logit products
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Elt;
template <>
struct Elt<float> {
  static constexpr int kVec = 4;  // elements per 16 bytes
  static constexpr int kPad = 4;  // row padding: rows of 16*odd bytes
};
template <>
struct Elt<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kPad = 8;
};
template <typename T>
__host__ __device__ constexpr int tile_stride() { return kChunk + Elt<T>::kPad; }
constexpr int kScratch = kRows + 4;  // fp32 scratch row stride

constexpr int kMaxSmem = 232448;  // the most dynamic shared memory one block may use

// Dynamic shared memory: nb chunk tiles [64][stride] of each of the four
// operands (own x1, x2, swept y1, y2); dkdv the swept tile's log-sum-exp and
// D; fp32 a [16][68] scratch per warp.
template <typename T>
constexpr int smem_bytes(bool dkdv, int nb) {
  return 4 * nb * kRows * tile_stride<T>() * (int)sizeof(T) +
         (sizeof(T) == 4 ? 4 * 16 * kScratch * 4 : 0) + (dkdv ? 2 * kRows * 4 : 0);
}

// Chunk tiles per operand: every chunk where they fit (the own tiles load
// once, each swept tile in one round, and the output products read the
// swept tile's chunks where they lie), else one (the chunks stream through
// it: ch past 384 in bf16, past 192 in fp32).
template <typename T>
int chunk_buffers(int ch, bool dkdv) {
  const int chunks = (ch + kChunk - 1) / kChunk;
  return smem_bytes<T>(dkdv, chunks) <= kMaxSmem ? chunks : 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A value rounded to T and back (no-op for fp32).
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// Each element of a 16-byte vector times mul, rounded to T (mul 1: as is).
__device__ __forceinline__ uint4 scale_vec(uint4 v, float mul, float) {
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] *= mul;
  return v;
}
__device__ __forceinline__ uint4 scale_vec(uint4 v, float mul, __nv_bfloat16) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    h[i] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
  }
  return v;
}

// Rows [r0, r0 + 64) and columns [c0, c0 + ncols) (ncols a multiple of 16,
// at most 64) of one head's q, k, v or o block (src: its row 0, column 0;
// rows ld elements apart), times mul and rounded to T, into dst
// [64][stride], zero where row >= Tn or column >= ch. vec: 16-byte loads
// (ch a multiple of the vector, pointers aligned), else element by element.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, long long ld, int r0,
                                          int Tn, int c0, int ncols, int ch, bool vec, float mul) {
  constexpr int S = tile_stride<T>();
  if (vec) {
    constexpr int V = Elt<T>::kVec;
    const int cpr = ncols / V;
    for (int i = threadIdx.x; i < kRows * cpr; i += kThreads) {
      const int r = i / cpr, c = (i - r * cpr) * V;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < Tn && c0 + c < ch)
        val = scale_vec(*reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ld + c0 + c), mul, T());
      *reinterpret_cast<uint4*>(dst + r * S + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < kRows * ncols; i += kThreads) {
      const int r = i / ncols, c = i - r * ncols;
      T val = T(0.f);
      if (r0 + r < Tn && c0 + c < ch) val = T(to_float(src[(long long)(r0 + r) * ld + c0 + c]) * mul);
      dst[r * S + c] = val;
    }
  }
}

// C += A B^T over `cols` channels (a multiple of 16 in bf16): A this warp's
// 16 own rows (sa), B the 64 swept rows (sb). Fragment c[j]: own rows g,
// g+8, swept rows 8j+2t, 8j+2t+1 (g = lane/4, t = lane%4).
__device__ __forceinline__ void mm_nt(float (&c)[8][4], const __nv_bfloat16* sa,
                                      const __nv_bfloat16* sb, int cols, int lane) {
  constexpr int S = tile_stride<__nv_bfloat16>();
  const __nv_bfloat16* arow = sa + (lane & 15) * S + (lane >> 4) * 8;
  const __nv_bfloat16* brow = sb + ((lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
  for (int kk = 0; kk < cols; kk += 16) {
    uint32_t a[4], b[4][4];
    ldsm_x4(a, arow + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j) ldsm_x4(b[j], brow + j * 16 * S + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mma_bf16(c[2 * j], a, b[j][0], b[j][1]);
      mma_bf16(c[2 * j + 1], a, b[j][2], b[j][3]);
    }
  }
}

__device__ __forceinline__ void mm_nt(float (&c)[8][4], const float* sa, const float* sb, int cols,
                                      int lane) {
  constexpr int S = tile_stride<float>();
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = sa + g * S;
  const float* a1 = a0 + 8 * S;
  const float* b = sb + 2 * t * S;
  for (int k = 0; k < cols; ++k) {
    const float x0 = a0[k], x1 = a1[k];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b0 = b[8 * j * S + k], b1 = b[(8 * j + 1) * S + k];
      c[j][0] = fmaf(x0, b0, c[j][0]);
      c[j][1] = fmaf(x0, b1, c[j][1]);
      c[j][2] = fmaf(x1, b0, c[j][2]);
      c[j][3] = fmaf(x1, b1, c[j][3]);
    }
  }
}

// O += P B: P the 16 x 64 fragments of a logit-type product (own rows by
// swept rows), B the swept tile's first NO channels (sb, [64 swept rows]
// [stride]). O fragment o[n]: own rows g, g+8, channels 8n+2t, 8n+2t+1.
// bf16: P rounded to bf16 as the A operand from registers, B by
// ldmatrix.trans. fp32: P through this warp's scratch [16][68], then FMA.
template <int NO>
__device__ __forceinline__ void mm_pv(float (&o)[NO / 8][4], const float (&p)[8][4],
                                      const __nv_bfloat16* sb, float*, int lane) {
  constexpr int S = tile_stride<__nv_bfloat16>();
  const __nv_bfloat16* vrow = sb + ((lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a[4] = {pack_bf16(p[2 * i][0], p[2 * i][1]), pack_bf16(p[2 * i][2], p[2 * i][3]),
                           pack_bf16(p[2 * i + 1][0], p[2 * i + 1][1]),
                           pack_bf16(p[2 * i + 1][2], p[2 * i + 1][3])};
#pragma unroll
    for (int n = 0; n < NO / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, vrow + 16 * i * S + n * 8);
      mma_bf16(o[n], a, b[0], b[1]);
      mma_bf16(o[n + 1], a, b[2], b[3]);
    }
  }
}

template <int NO>
__device__ __forceinline__ void mm_pv(float (&o)[NO / 8][4], const float (&p)[8][4],
                                      const float* sb, float* scratch, int lane) {
  constexpr int S = tile_stride<float>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(scratch + g * kScratch + 8 * j + 2 * t) = make_float2(p[j][0], p[j][1]);
    *reinterpret_cast<float2*>(scratch + (g + 8) * kScratch + 8 * j + 2 * t) =
        make_float2(p[j][2], p[j][3]);
  }
  __syncwarp();
  for (int k = 0; k < kRows; ++k) {
    const float x0 = scratch[g * kScratch + k], x1 = scratch[(g + 8) * kScratch + k];
    const float* brow = sb + k * S + 2 * t;
#pragma unroll
    for (int n = 0; n < NO / 8; ++n) {
      const float2 b = *reinterpret_cast<const float2*>(brow + 8 * n);
      o[n][0] = fmaf(x0, b.x, o[n][0]);
      o[n][1] = fmaf(x0, b.y, o[n][1]);
      o[n][2] = fmaf(x1, b.x, o[n][2]);
      o[n][3] = fmaf(x1, b.y, o[n][3]);
    }
  }
  __syncwarp();  // the scratch is rewritten by the next call
}

// Channels [64h, 64h + 64) of a 128-channel accumulator.
__device__ __forceinline__ float (&half64(float (&o)[16][4], int h))[8][4] {
  return *reinterpret_cast<float(*)[8][4]>(&o[8 * h]);
}

// One head's operands: the own rows' blocks x1, x2 and the swept rows'
// blocks y1, y2 (each at its row 0, column 0), their row strides, T and ch;
// x1 and y1 (q and k) load times s = ch^-1/4, rounded to T.
template <typename T>
struct Operands {
  const T* x1;
  const T* x2;
  const T* y1;
  const T* y2;
  long long ldx1, ldx2, ldy1, ldy2;
  int Tn, ch, chunks;
  int nb;  // chunk tiles per operand: chunks (resident) or 1 (streamed)
  bool vec;
  float s;
};

// S = X1 Y1^T and, with DP, dP = X2 Y2^T, for this warp's 16 of the own
// rows [x0, x0 + 64) and the swept rows [y0, y0 + 64), over every chunk of
// 64 channels, each rounded to T. Resident (op.nb == op.chunks): the own
// tiles hold every chunk (the caller loads them once), the swept tile's
// chunks load in one round and stay until the next call. Streamed: the own
// and swept chunks go through one tile each, chunk by chunk.
template <typename T, bool DP>
__device__ __forceinline__ void logits(float (&s)[8][4], float (&dp)[8][4], T* sx1, T* sx2, T* sy1,
                                       T* sy2, const Operands<T>& op, int x0, int y0) {
  constexpr int S = tile_stride<T>(), TS = kRows * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool resident = op.nb == op.chunks;
  zero(s);
  if (DP) zero(dp);
  if (resident) {
    __syncthreads();  // every warp is done with the swept tiles about to be overwritten
    for (int c = 0; c < op.chunks; ++c) {
      load_tile(sy1 + c * TS, op.y1, op.ldy1, y0, op.Tn, c * kChunk, kChunk, op.ch, op.vec, op.s);
      if (DP) load_tile(sy2 + c * TS, op.y2, op.ldy2, y0, op.Tn, c * kChunk, kChunk, op.ch, op.vec, 1.f);
    }
    __syncthreads();
  }
  for (int c = 0; c < op.chunks; ++c) {
    const int c0 = c * kChunk, b = resident ? c * TS : 0;
    if (!resident) {
      __syncthreads();  // every warp is done with the tiles about to be overwritten
      load_tile(sx1, op.x1, op.ldx1, x0, op.Tn, c0, kChunk, op.ch, op.vec, op.s);
      if (DP) load_tile(sx2, op.x2, op.ldx2, x0, op.Tn, c0, kChunk, op.ch, op.vec, 1.f);
      load_tile(sy1, op.y1, op.ldy1, y0, op.Tn, c0, kChunk, op.ch, op.vec, op.s);
      if (DP) load_tile(sy2, op.y2, op.ldy2, y0, op.Tn, c0, kChunk, op.ch, op.vec, 1.f);
      __syncthreads();
    }
    // bf16: whole k-steps of 16 (zeros past ch); fp32: exactly the channels
    const int rest = op.ch - c0;
    const int cols = sizeof(T) == 2 ? min(kChunk, 16 * ((rest + 15) / 16)) : min(kChunk, rest);
    mm_nt(s, sx1 + b + 16 * warp * S, sy1 + b, cols, lane);
    if (DP) mm_nt(dp, sx2 + b + 16 * warp * S, sy2 + b, cols, lane);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = rnd<T>(s[j][e]);
      if (DP) dp[j][e] = rnd<T>(dp[j][e]);
    }
}

// The own tiles' every chunk, loaded once (resident operands).
template <typename T>
__device__ __forceinline__ void load_own(T* sx1, T* sx2, const Operands<T>& op, int x0) {
  constexpr int TS = kRows * tile_stride<T>();
  for (int c = 0; c < op.chunks; ++c) {
    load_tile(sx1 + c * TS, op.x1, op.ldx1, x0, op.Tn, c * kChunk, kChunk, op.ch, op.vec, op.s);
    load_tile(sx2 + c * TS, op.x2, op.ldx2, x0, op.Tn, c * kChunk, kChunk, op.ch, op.vec, 1.f);
  }
}

// The NO output channels [c0, c0 + NO) of this warp's rows g, g+8 (rows
// r0 + 16*warp + ...), times mul[0] (row g) or mul[1] (row g+8), into the
// column block dst (row 0, column 0; rows ld apart) where row < Tn and
// column < ch.
template <typename T, int NO>
__device__ __forceinline__ void store_rows(T* dst, long long ld, const float (&o)[NO / 8][4],
                                           const float (&mul)[2], int r0, int c0, int Tn, int ch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NO / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 16 * warp + g + 8 * (e >> 1), c = c0 + 8 * n + 2 * t + (e & 1);
      if (row < Tn && c < ch) store1(dst + (long long)row * ld + c, o[n][e] * mul[e >> 1]);
    }
}

// attn_bwd_dq. grid (query tiles, N*H, output slices of NO); qkv, dqkv
// [N, T, H*3*ch]; out, gout [N, T, H*ch]; lse, dd [N, H, T] fp32.
template <typename T, int NO>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ out, const T* __restrict__ gout,
                   T* __restrict__ dqkv, float* __restrict__ lse_ws, float* __restrict__ d_ws,
                   int Tn, int H, int ch, int nb, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TS = kRows * tile_stride<T>();
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + nb * TS;
  T* sk = sdo + nb * TS;
  T* sv = sk + nb * TS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* scratch = reinterpret_cast<float*>(sv + nb * TS) + warp * 16 * kScratch;
  const int bh = blockIdx.y, n = bh / H, h = bh - n * H;
  const int x0 = blockIdx.x * kRows, z = blockIdx.z;
  const long long W = 3LL * H * ch, Wo = (long long)H * ch;
  const T* qh = qkv + (long long)n * Tn * W + (long long)h * 3 * ch;
  const T* doh = gout + (long long)n * Tn * Wo + (long long)h * ch;
  const T* oh = out + (long long)n * Tn * Wo + (long long)h * ch;
  const float s4 = rsqrtf(sqrtf((float)ch));  // s = ch^-1/4
  const Operands<T> op = {qh, doh, qh + ch, qh + 2 * ch, W, Wo, W, W, Tn, ch, (ch + kChunk - 1) / kChunk,
                          nb, vec, s4};

  // D of this thread's rows g, g+8: rowsum(dO * O) over all channels.
  float dr[2] = {0.f, 0.f};
  for (int rr = 0; rr < 16; ++rr) {
    const int row = x0 + 16 * warp + rr;
    float acc = 0.f;
    if (row < Tn)
      for (int c = lane; c < ch; c += 32)
        acc = fmaf(to_float(doh[(long long)row * Wo + c]), to_float(oh[(long long)row * Wo + c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (rr == g) dr[0] = acc;
    if (rr == g + 8) dr[1] = acc;
  }
  if (nb == op.chunks) load_own(sq, sdo, op, x0);

  // One sweep: the running max m and sum l (this lane's share) of each row,
  // P relative to m, dS = P (dP - D), and dQ += dS K for this CTA's output
  // slice, rescaled whenever m moves.
  float s[8][4], dp[8][4], dq[NO / 8][4];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  zero(dq);
  for (int y0 = 0; y0 < Tn; y0 += kRows) {
    logits<T, true>(s, dp, sq, sdo, sk, sv, op, x0, y0);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = y0 + 8 * j + 2 * t + (e & 1) < Tn ? s[j][e] : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float c[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      c[r] = ex2((m[r] - mn) * kLog2e);  // 0 on the first tile (m = -inf)
      l[r] *= c[r];
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2((s[j][e] - m[e >> 1]) * kLog2e);  // 0 past T
        l[e >> 1] += p;
        s[j][e] = p * (dp[j][e] - dr[e >> 1]);
      }
#pragma unroll
    for (int k = 0; k < NO / 8; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[k][e] *= c[e >> 1];
    if constexpr (NO == 128) {  // this CTA's slice of K, 64 channels at a time
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = 2 * z + hf;  // its chunk
        if (c >= op.chunks) break;
        if (nb == op.chunks) {  // resident: the chunk is loaded
          mm_pv<64>(half64(dq, hf), s, sk + c * TS, scratch, lane);
        } else {  // streamed: sk holds the last chunk
          __syncthreads();
          load_tile(sk, op.y1, op.ldy1, y0, Tn, c * kChunk, kChunk, ch, vec, s4);
          __syncthreads();
          mm_pv<64>(half64(dq, hf), s, sk, scratch, lane);
        }
      }
    } else {  // ch <= 64: sk holds every channel
      mm_pv<NO>(dq, s, sk, scratch, lane);
    }
  }
  float lse[2], mul[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lse[r] = m[r] + logf(l[r]);
    mul[r] = s4 / l[r];
    const int row = x0 + 16 * warp + g + 8 * r;
    if (z == 0 && t == 0 && row < Tn) {
      lse_ws[(long long)bh * Tn + row] = lse[r];
      d_ws[(long long)bh * Tn + row] = dr[r];
    }
  }
  store_rows<T, NO>(dqkv + (long long)n * Tn * W + (long long)h * 3 * ch, W, dq, mul, x0, z * NO, Tn, ch);
}

// attn_bwd_dkdv. grid (key tiles, N*H, output slices of NO); lse, dd from
// attn_bwd_dq.
template <typename T, int NO>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ gout,
                     const float* __restrict__ lse_ws, const float* __restrict__ d_ws,
                     T* __restrict__ dqkv, int Tn, int H, int ch, int nb, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TS = kRows * tile_stride<T>();
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + nb * TS;
  T* sq = sv + nb * TS;
  T* sdo = sq + nb * TS;
  float* s_lse = reinterpret_cast<float*>(sdo + nb * TS);
  float* s_d = s_lse + kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  float* scratch = s_d + kRows + warp * 16 * kScratch;
  const int bh = blockIdx.y, n = bh / H, h = bh - n * H;
  const int x0 = blockIdx.x * kRows, z = blockIdx.z;
  const long long W = 3LL * H * ch, Wo = (long long)H * ch;
  const T* qh = qkv + (long long)n * Tn * W + (long long)h * 3 * ch;
  const T* doh = gout + (long long)n * Tn * Wo + (long long)h * ch;
  const float s4 = rsqrtf(sqrtf((float)ch));  // s = ch^-1/4
  const Operands<T> op = {qh + ch, qh + 2 * ch, qh, doh, W, W, W, Wo, Tn, ch, (ch + kChunk - 1) / kChunk,
                          nb, vec, s4};
  if (nb == op.chunks) load_own(sk, sv, op, x0);

  float st[8][4], dpt[8][4], dk[NO / 8][4], dv[NO / 8][4];
  zero(dk);
  zero(dv);
  for (int y0 = 0; y0 < Tn; y0 += kRows) {
    __syncthreads();  // the last tile's log-sum-exp and D are read
    if (threadIdx.x < kRows) {
      const int q = y0 + threadIdx.x;
      s_lse[threadIdx.x] = q < Tn ? lse_ws[(long long)bh * Tn + q] : CUDART_INF_F;
      s_d[threadIdx.x] = q < Tn ? d_ws[(long long)bh * Tn + q] : 0.f;
    }
    logits<T, true>(st, dpt, sk, sv, sq, sdo, op, x0, y0);  // its first barrier publishes s_lse
    // P^T and dS^T: the columns are queries y0 + 8j + 2t + (e & 1).
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        st[j][e] = ex2((st[j][e] - s_lse[qi]) * kLog2e);  // 0 past T (lse +inf)
        dpt[j][e] = st[j][e] * (dpt[j][e] - s_d[qi]);
      }
    if constexpr (NO == 128) {  // this CTA's slice of Q and dO, 64 channels at a time
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = 2 * z + hf;  // its chunk
        if (c >= op.chunks) break;
        int b = c * TS;  // resident: the chunk is loaded
        if (nb != op.chunks) {  // streamed: sq and sdo hold the last chunk
          __syncthreads();
          load_tile(sq, op.y1, op.ldy1, y0, Tn, c * kChunk, kChunk, ch, vec, s4);
          load_tile(sdo, op.y2, op.ldy2, y0, Tn, c * kChunk, kChunk, ch, vec, 1.f);
          __syncthreads();
          b = 0;
        }
        mm_pv<64>(half64(dv, hf), st, sdo + b, scratch, lane);
        mm_pv<64>(half64(dk, hf), dpt, sq + b, scratch, lane);
      }
    } else {  // ch <= 64: sq and sdo hold every channel
      mm_pv<NO>(dv, st, sdo, scratch, lane);
      mm_pv<NO>(dk, dpt, sq, scratch, lane);
    }
  }
  T* base = dqkv + (long long)n * Tn * W + (long long)h * 3 * ch;
  const float ks[2] = {s4, s4}, vs[2] = {1.f, 1.f};
  store_rows<T, NO>(base + ch, W, dk, ks, x0, z * NO, Tn, ch);
  store_rows<T, NO>(base + 2 * ch, W, dv, vs, x0, z * NO, Tn, ch);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int NO>
int launch_dq(const void* qkv, const void* out, const void* gout, void* dqkv, void* lse, void* dd,
              int N, int Tn, int H, int ch, bool vec, cudaStream_t st) {
  const int nb = chunk_buffers<T>(ch, false), bytes = smem_bytes<T>(false, nb);
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<T, NO>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Tn + kRows - 1) / kRows, N * H, (ch + NO - 1) / NO);
  attn_bwd_dq_kernel<T, NO><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(out), static_cast<const T*>(gout),
      static_cast<T*>(dqkv), static_cast<float*>(lse), static_cast<float*>(dd), Tn, H, ch, nb, vec);
  return (int)cudaGetLastError();
}

template <typename T, int NO>
int launch_dkdv(const void* qkv, const void* gout, const void* lse, const void* dd, void* dqkv,
                int N, int Tn, int H, int ch, bool vec, cudaStream_t st) {
  const int nb = chunk_buffers<T>(ch, true), bytes = smem_bytes<T>(true, nb);
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_bwd_dkdv_kernel<T, NO>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Tn + kRows - 1) / kRows, N * H, (ch + NO - 1) / NO);
  attn_bwd_dkdv_kernel<T, NO><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(gout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<T*>(dqkv), Tn, H, ch, nb, vec);
  return (int)cudaGetLastError();
}

template <typename T>
bool vec_ok(int ch, const void* a, const void* b, const void* c) {
  return ch % Elt<T>::kVec == 0 && aligned16(a) && aligned16(b) && aligned16(c);
}

}  // namespace

// The Hopper route (attention_bwd_hopper.cu).
extern "C" int ishape_attn_bwd_dq_wgmma(const void* qkv, const void* out, const void* gout, void* dqkv,
                                        void* lse, void* dd, void* sq, int N, int T, int H, int ch,
                                        cudaStream_t st);
extern "C" int ishape_attn_bwd_dkdv_wgmma(const void* qkv, const void* gout, const void* lse, const void* dd,
                                          const void* sq, void* dqkv, int N, int T, int H, int ch,
                                          cudaStream_t st);

namespace {

// The route of a call: the Hopper kernels for bf16 at ch 32, 64 and 128
// (ops/hopper_kernels.py attention_bwd_route), else the generic ones.
bool hopper_route(int dtype, int ch) { return dtype == 1 && (ch == 32 || ch == 64 || ch == 128); }

// A generic launch's output channels per CTA: 16, 32 or 64 up to 64
// channels, 128 past them.
bool generic_slice_ok(int ch, int no) {
  return ch > 64 ? no == 128 : (no == 16 || no == 32 || no == 64);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; no: the generic route's output channels
// per CTA (ops/hopper_kernels.py attention_bwd_geometry; the Hopper route
// ignores it). Writes the q columns of dqkv and the workspace: lse, dd
// [N, H, T] fp32 and, on the Hopper route, sq [N, T, H*ch] bf16 (sQ; the
// generic route takes a null sq).
extern "C" int ishape_attn_bwd_dq(const void* qkv, const void* out, const void* gout, void* dqkv,
                                  void* lse, void* dd, void* sq, int dtype, int N, int T, int H, int ch,
                                  int no, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || T < 1 || H < 1 || ch < 1 || N * H > 65535) return (int)cudaErrorInvalidValue;
  if (hopper_route(dtype, ch))
    return ishape_attn_bwd_dq_wgmma(qkv, out, gout, dqkv, lse, dd, sq, N, T, H, ch, st);
  if (!generic_slice_ok(ch, no)) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const bool vec = vec_ok<__nv_bfloat16>(ch, qkv, out, gout);
    if (no == 16) return launch_dq<__nv_bfloat16, 16>(qkv, out, gout, dqkv, lse, dd, N, T, H, ch, vec, st);
    if (no == 32) return launch_dq<__nv_bfloat16, 32>(qkv, out, gout, dqkv, lse, dd, N, T, H, ch, vec, st);
    if (no == 64) return launch_dq<__nv_bfloat16, 64>(qkv, out, gout, dqkv, lse, dd, N, T, H, ch, vec, st);
    return launch_dq<__nv_bfloat16, 128>(qkv, out, gout, dqkv, lse, dd, N, T, H, ch, vec, st);
  }
  if (dtype == 0) {
    const bool vec = vec_ok<float>(ch, qkv, out, gout);
    if (no == 16) return launch_dq<float, 16>(qkv, out, gout, dqkv, lse, dd, N, T, H, ch, vec, st);
    if (no == 32) return launch_dq<float, 32>(qkv, out, gout, dqkv, lse, dd, N, T, H, ch, vec, st);
    if (no == 64) return launch_dq<float, 64>(qkv, out, gout, dqkv, lse, dd, N, T, H, ch, vec, st);
    return launch_dq<float, 128>(qkv, out, gout, dqkv, lse, dd, N, T, H, ch, vec, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Writes the k and v columns of dqkv from the workspace of ishape_attn_bwd_dq.
extern "C" int ishape_attn_bwd_dkdv(const void* qkv, const void* gout, const void* lse,
                                    const void* dd, const void* sq, void* dqkv, int dtype, int N, int T,
                                    int H, int ch, int no, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || T < 1 || H < 1 || ch < 1 || N * H > 65535) return (int)cudaErrorInvalidValue;
  if (hopper_route(dtype, ch))
    return ishape_attn_bwd_dkdv_wgmma(qkv, gout, lse, dd, sq, dqkv, N, T, H, ch, st);
  if (!generic_slice_ok(ch, no)) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const bool vec = vec_ok<__nv_bfloat16>(ch, qkv, gout, gout);
    if (no == 16) return launch_dkdv<__nv_bfloat16, 16>(qkv, gout, lse, dd, dqkv, N, T, H, ch, vec, st);
    if (no == 32) return launch_dkdv<__nv_bfloat16, 32>(qkv, gout, lse, dd, dqkv, N, T, H, ch, vec, st);
    if (no == 64) return launch_dkdv<__nv_bfloat16, 64>(qkv, gout, lse, dd, dqkv, N, T, H, ch, vec, st);
    return launch_dkdv<__nv_bfloat16, 128>(qkv, gout, lse, dd, dqkv, N, T, H, ch, vec, st);
  }
  if (dtype == 0) {
    const bool vec = vec_ok<float>(ch, qkv, gout, gout);
    if (no == 16) return launch_dkdv<float, 16>(qkv, gout, lse, dd, dqkv, N, T, H, ch, vec, st);
    if (no == 32) return launch_dkdv<float, 32>(qkv, gout, lse, dd, dqkv, N, T, H, ch, vec, st);
    if (no == 64) return launch_dkdv<float, 64>(qkv, gout, lse, dd, dqkv, N, T, H, ch, vec, st);
    return launch_dkdv<float, 128>(qkv, gout, lse, dd, dqkv, N, T, H, ch, vec, st);
  }
  return (int)cudaErrorInvalidValue;
}
