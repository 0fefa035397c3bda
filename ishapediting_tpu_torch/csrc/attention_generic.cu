// ADM QKV attention (QKVAttentionLegacy) at any head dim from 1 to 128, in
// fp32 or bf16: the counterpart of the wgmma kernel (attention.cu) for what
// it does not take, i.e. fp32 at any ch and bf16 at ch outside {32, 64, 128}.
//
// Replaces: ishapediting_tpu/ops/pallas_kernels.py::attention_qkv, i.e. the
// Pallas kernel _attn_kernel, which is dtype- and head-dim-generic: q and k
// each scaled by ch^-1/4 in fp32, fp32 logits and softmax, the weights cast
// to v's dtype (a no-op in fp32), P V accumulated in fp32, the output in
// qkv's dtype. This kernel computes the same with plain fp32 FMA (no TF32:
// the reference is full fp32).
//
// Bound on this card: 4*T^2*ch flops per (batch, head) against 8*T*ch
// elements of qkv and output, all on the fp32 FMA units (67 TFLOP/s): at the
// chairs shapes in fp32 (T = 1024, ch = 64) operations bound it; at T <= 64
// (the tiny preset) bytes and the launch do.
//
// Design (register tiles, as an SGEMM): one CTA of 256 threads per (64 query
// rows, batch*head). K/V tiles of 64 keys are staged through shared memory as
// fp32 (zero past T and past ch), Q once, pre-scaled. Thread (tr, tc), tr =
// tid/16, tc = tid%16, owns query rows 4tr..4tr+3 in both products:
// - S: the 4 x 4 logits of those rows and keys 4tc..4tc+3. Q and K are
//   stored transposed ([channel][row]), so each channel step is two 16-byte
//   shared loads for 16 FMAs.
// - Online softmax: a row's max and sum are shuffles among the 16 lanes of
//   its half-warp, and its running max and sum stay in the same registers
//   through every tile. P goes through shared memory, transposed, rounded to
//   bf16 for a bf16 input (as the TPU kernel rounds its weights).
// - O += P V: the rows' output channels nc*tc .. nc*tc+nc-1 (nc = chv/16),
//   one 16-byte P load and nc/4 V loads per key.
// The head dim is padded to CHP, a power of two from 8 to 128 (V and O to
// at least 16 channels). Keys past T get logit -inf; every tile holds at
// least one key < T, so the running max is finite after the first tile.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // query rows per CTA
constexpr int kKeys = 64;   // keys per K/V tile
constexpr int kLanes = 16;  // lanes that share a row group (a half-warp)
constexpr int kRT = 4;      // query rows per thread
constexpr int kKT = 4;      // keys per thread per tile
constexpr int kTS = 68;     // row stride of the transposed Q, K and P tiles (16-byte aligned)

// Shared-memory layout, in floats: Q^T [CHP][kTS], K^T [CHP][kTS],
// V [kKeys][CHV + 4], P^T [kKeys][kTS].
template <int CHP>
struct Layout {
  static constexpr int CHV = CHP < kLanes ? kLanes : CHP;  // V and O channels
  static constexpr int NC = CHV / kLanes;                   // output channels per thread
  static constexpr int VS = CHV + 4;
  static constexpr int Q = 0;
  static constexpr int K = Q + CHP * kTS;
  static constexpr int V = K + CHP * kTS;
  static constexpr int P = V + kKeys * VS;
  static constexpr int BYTES = 4 * (P + kKeys * kTS);
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// The weights in v's dtype, as the TPU kernel casts them before P V.
__device__ __forceinline__ float weight_in(float p, const float*) { return p; }
__device__ __forceinline__ float weight_in(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// NC consecutive floats of shared memory (NC = 1, 2, 4 or 8) into registers.
template <int NC>
__device__ __forceinline__ void ld_nc(const float* p, float (&v)[NC]) {
  if constexpr (NC == 1) {
    v[0] = p[0];
  } else if constexpr (NC == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < NC; i += 4) {
      const float4 a = ld4(p + i);
      v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
    }
  }
}

// grid (query tiles, B*H); qkv [B, T, H*3*ch], out [B, T, H*ch].
template <typename T, int CHP>
__global__ void __launch_bounds__(kThreads)
attention_generic_kernel(const T* __restrict__ qkv, T* __restrict__ out, int Tn, int H, int ch,
                         float qk_scale) {
  using L = Layout<CHP>;
  constexpr int NC = L::NC;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem + L::Q;
  float* kt = smem + L::K;
  float* vs = smem + L::V;
  float* pt = smem + L::P;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kRows;
  const long long width = (long long)H * 3 * ch;
  const T* base = qkv + (long long)b * Tn * width + (long long)h * 3 * ch;
  const int tid = threadIdx.x;
  const int tr = tid / kLanes, tc = tid % kLanes;

  // Q^T, scaled by ch^-1/4 in fp32; zero past T and past ch.
  for (int i = tid; i < kRows * CHP; i += kThreads) {
    const int r = i / CHP, c = i % CHP;
    float v = 0.f;
    if (q0 + r < Tn && c < ch) v = to_float(base[(long long)(q0 + r) * width + c]) * qk_scale;
    qt[c * kTS + r] = v;
  }

  float o[kRT][NC];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) o[i][n] = 0.f;
  float m[kRT], l[kRT];  // running row max, and this lane's share of the row sum
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }

  const int ntiles = (Tn + kKeys - 1) / kKeys;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kKeys;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < kKeys * L::CHV; i += kThreads) {
      const int r = i / L::CHV, c = i % L::CHV;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < Tn && c < ch) {
        const T* p = base + (long long)(k0 + r) * width + c;
        kv = to_float(p[ch]) * qk_scale;
        vv = to_float(p[2 * ch]);
      }
      if (c < CHP) kt[c * kTS + r] = kv;
      vs[r * L::VS + c] = vv;
    }
    __syncthreads();

    // S for rows 4tr.., keys 4tc.. of the tile.
    float s[kRT][kKT];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < kKT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < CHP; ++c) {
      const float4 q = ld4(qt + c * kTS + kRT * tr);
      const float4 k = ld4(kt + c * kTS + kKT * tc);
      const float qv[kRT] = {q.x, q.y, q.z, q.w};
      const float kv[kKT] = {k.x, k.y, k.z, k.w};
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int j = 0; j < kKT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Online softmax, row by row; P^T [key][row] for the product.
    float p[kKT][kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        if (k0 + kKT * tc + j >= Tn) s[i][j] = -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - mn);  // 0 on the first tile (m = -inf)
      m[i] = mn;
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < NC; ++n) o[i][n] *= corr;
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        const float e = expf(s[i][j] - mn);
        l[i] += e;
        p[j][i] = weight_in(e, qkv);
      }
    }
#pragma unroll
    for (int j = 0; j < kKT; ++j)
      *reinterpret_cast<float4*>(pt + (kKT * tc + j) * kTS + kRT * tr) =
          make_float4(p[j][0], p[j][1], p[j][2], p[j][3]);
    __syncwarp();  // a row group's P is written and read by its own half-warp

    // O += P V over the tile.
#pragma unroll 4
    for (int k = 0; k < kKeys; ++k) {
      const float4 pk = ld4(pt + k * kTS + kRT * tr);
      const float pv[kRT] = {pk.x, pk.y, pk.z, pk.w};
      float v[NC];
      ld_nc<NC>(vs + k * L::VS + NC * tc, v);
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) o[i][n] = fmaf(pv[i], v[n], o[i][n]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const float inv = 1.f / group_sum(l[i]);
    const int r = q0 + kRT * tr + i;
    if (r >= Tn) continue;
    T* orow = out + ((long long)b * Tn + r) * H * ch + (long long)h * ch;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = NC * tc + n;
      if (c < ch) from_float(orow + c, o[i][n] * inv);
    }
  }
}

template <typename T, int CHP>
int launch(const void* qkv, void* out, int B, int Tn, int H, int ch, cudaStream_t stream) {
  constexpr int smem = Layout<CHP>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_generic_kernel<T, CHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Tn + kRows - 1) / kRows, B * H);
  const float qk_scale = (float)pow((double)ch, -0.25);  // ch^-1/4 rounded once, applied to q and k
  attention_generic_kernel<T, CHP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), Tn, H, ch, qk_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* qkv, void* out, int B, int Tn, int H, int ch, int chp, cudaStream_t st) {
  switch (chp) {
    case 8: return launch<T, 8>(qkv, out, B, Tn, H, ch, st);
    case 16: return launch<T, 16>(qkv, out, B, Tn, H, ch, st);
    case 32: return launch<T, 32>(qkv, out, B, Tn, H, ch, st);
    case 64: return launch<T, 64>(qkv, out, B, Tn, H, ch, st);
    case 128: return launch<T, 128>(qkv, out, B, Tn, H, ch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv: [B, T, H*3*ch] contiguous, dtype 0 = float32, 1 = bfloat16; out:
// [B, T, H*ch] of the same dtype. chp: the head dim padded to a power of two
// from 8 to 128 (ops/hopper_kernels.py attention_generic_geometry), ch <= chp.
// Returns cudaGetLastError() after the launch.
extern "C" int ishape_attention_generic(const void* qkv, void* out, int dtype, int B, int T,
                                        int H, int ch, int chp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || B < 1 || H < 1 || ch < 1 || ch > chp || (chp > 8 && 2 * ch <= chp))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(qkv, out, B, T, H, ch, chp, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(qkv, out, B, T, H, ch, chp, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a launch at padded head dim chp, in bytes (0 for
// a chp the kernel does not take).
extern "C" int ishape_attention_generic_smem(int chp) {
  switch (chp) {
    case 8: return Layout<8>::BYTES;
    case 16: return Layout<16>::BYTES;
    case 32: return Layout<32>::BYTES;
    case 64: return Layout<64>::BYTES;
    case 128: return Layout<128>::BYTES;
    default: return 0;
  }
}
