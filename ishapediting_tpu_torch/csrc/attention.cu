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
// flops / 989 TFLOP/s (bf16 tensor cores) and bytes / 3.35 TB/s.
//
// Design. One block of 4 warps per (query tile of 64 tokens, batch*head);
// each warp owns 16 query rows. The kernel reads q, k and v straight from
// the [B, T, H*3*ch] projection through its own offsets (q at h*3ch, k at
// +ch, v at +2ch) and writes [B, T, H*ch] directly, so the transposes the
// TPU wrapper needs to fold heads into its grid disappear. Keys and values
// stream through shared memory in tiles of 64 tokens (a whole head's K and V
// at T = 1024 would be 256 KB, over the 227 KB a block may use); V is stored
// transposed so that its mma fragments are contiguous pairs. Both products
// run on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate).
// The softmax is the flash-style online form in fp32: a running row max and
// sum, the output rescaled when the max grows. As on the TPU, the
// probabilities are rounded to bf16 before the P.V product. This first
// version does not double-buffer the K/V tiles; wgmma and TMA come later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block
constexpr int kBlockK = 64;           // keys per shared-memory tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int CH>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                 int T, int H, float scale2) {
  static_assert(CH % 16 == 0, "head dim must be a multiple of 16");
  constexpr int KP = CH + 8;       // padded K row (bf16): conflict-free fragments
  constexpr int VP = kBlockK + 8;  // padded V^T row (bf16)
  constexpr int NB = CH / 8;       // 8-wide output column blocks
  constexpr int KC = CH / 16;      // 16-deep chunks of the head dim
  constexpr int SB = kBlockK / 8;  // 8-wide key blocks per tile

  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK * KP];
  __shared__ __align__(16) __nv_bfloat16 vt_s[CH * VP];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const long long row_stride = (long long)H * 3 * CH;
  const __nv_bfloat16* base = qkv + (long long)b * T * row_stride + (long long)h * 3 * CH;

  // Q fragments (A operand) for rows q0+grp and q0+grp+8, straight from global.
  const int q0 = blockIdx.x * kBlockQ + warp * 16;
  const int qr0 = q0 + grp, qr1 = q0 + grp + 8;
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int d = kc * 16 + tig * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int dd = d + half * 8;
      qf[kc][0 + 2 * half] = qr0 < T
          ? *reinterpret_cast<const uint32_t*>(base + (long long)qr0 * row_stride + dd) : 0u;
      qf[kc][1 + 2 * half] = qr1 < T
          ? *reinterpret_cast<const uint32_t*>(base + (long long)qr1 * row_stride + dd) : 0u;
    }
  }

  float o[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running row max, rows grp, grp+8
  float l0 = 0.f, l1 = 0.f;  // running row sum over this thread's columns

  constexpr int VEC = 8;  // bf16 per 16-byte load
  constexpr int VPR = CH / VEC;
  for (int k0 = 0; k0 < T; k0 += kBlockK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < kBlockK * VPR; i += kWarps * 32) {
      const int r = i / VPR, c = (i - r * VPR) * VEC;
      const int key = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < T) {
        const __nv_bfloat16* rowp = base + (long long)key * row_stride;
        kv = *reinterpret_cast<const uint4*>(rowp + CH + c);
        vv = *reinterpret_cast<const uint4*>(rowp + 2 * CH + c);
      }
      *reinterpret_cast<uint4*>(&k_s[r * KP + c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) vt_s[(c + j) * VP + r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[SB][4];
#pragma unroll
    for (int sb = 0; sb < SB; ++sb) {
      s[sb][0] = s[sb][1] = s[sb][2] = s[sb][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const __nv_bfloat16* kp = &k_s[(sb * 8 + grp) * KP + kc * 16 + tig * 2];
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(kp);
        bf[1] = *reinterpret_cast<const uint32_t*>(kp + 8);
        mma_bf16_16816(s[sb], qf[kc], bf);
      }
    }

    // Online softmax in fp32. Fragment element (sb, e) is row grp (e < 2) or
    // grp+8 (e >= 2), key k0 + sb*8 + tig*2 + (e & 1).
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int sb = 0; sb < SB; ++sb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + sb * 8 + tig * 2 + (e & 1);
        float v = key < T ? s[sb][e] * scale2 : -CUDART_INF_F;
        s[sb][e] = v;
        if (e < 2) mx0 = fmaxf(mx0, v); else mx1 = fmaxf(mx1, v);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      o[nb][0] *= c0; o[nb][1] *= c0;
      o[nb][2] *= c1; o[nb][3] *= c1;
    }

    // P (rounded to bf16) as A fragments, 16 keys per mma; then O += P V.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = __expf(s[2 * kk + j][e] - (e < 2 ? m0 : m1));
          p[j][e] = v;
          if (e < 2) l0 += v; else l1 += v;
        }
      }
      uint32_t pa[4];
      pa[0] = pack_bf16(p[0][0], p[0][1]);  // row grp,   keys +tig*2
      pa[1] = pack_bf16(p[0][2], p[0][3]);  // row grp+8, keys +tig*2
      pa[2] = pack_bf16(p[1][0], p[1][1]);  // row grp,   keys +8+tig*2
      pa[3] = pack_bf16(p[1][2], p[1][3]);  // row grp+8, keys +8+tig*2
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const __nv_bfloat16* vp = &vt_s[(nb * 8 + grp) * VP + kk * 16 + tig * 2];
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(vp);
        bf[1] = *reinterpret_cast<const uint32_t*>(vp + 8);
        mma_bf16_16816(o[nb], pa, bf);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const long long out_stride = (long long)H * CH;
  __nv_bfloat16* obase = out + (long long)b * T * out_stride + (long long)h * CH;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int d = nb * 8 + tig * 2;
    if (qr0 < T)
      *reinterpret_cast<uint32_t*>(obase + (long long)qr0 * out_stride + d) =
          pack_bf16(o[nb][0] * inv0, o[nb][1] * inv0);
    if (qr1 < T)
      *reinterpret_cast<uint32_t*>(obase + (long long)qr1 * out_stride + d) =
          pack_bf16(o[nb][2] * inv1, o[nb][3] * inv1);
  }
}

template <int CH>
void launch(const void* qkv, void* out, int B, int T, int H, cudaStream_t stream) {
  dim3 grid((T + kBlockQ - 1) / kBlockQ, B * H);
  const float scale2 = 1.0f / sqrtf((float)CH);  // (ch^-1/4)^2
  attention_kernel<CH><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), T, H, scale2);
}

}  // namespace

// qkv: [B, T, H*3*ch] bf16, contiguous, 16-byte aligned; out: [B, T, H*ch].
// Returns cudaGetLastError() after the launch.
extern "C" int ishape_attention(const void* qkv, void* out, int B, int T, int H, int ch,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  switch (ch) {
    case 32: launch<32>(qkv, out, B, T, H, st); break;
    case 64: launch<64>(qkv, out, B, T, H, st); break;
    case 128: launch<128>(qkv, out, B, T, H, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
