// Decode attention with the current token appended virtually (kernel K2),
// for Hopper, sm_90a.
//
// Replaces the TPU kernel dynamic_llava_tpu/ops/decode_attention.py:
// _decode_kernel (wrapper flash_decode_attention), ported to the contract
// the decode layer loop actually calls: ops/attention.py
// decode_attend_appended. One query token per sample attends over the
// persisted cache rows [0, bound) plus the current token's K/V, which is
// NOT in the cache and enters as one extra, always-visible column. The
// cache is only read; the wrapper's caller writes the new K/V afterwards.
// Layouts: q/out [B, 1, H, D], cache [B, max_len, Hkv, D] (one layer's
// view of the [L, B, max_len, Hkv, D] buffer), k_cur/v_cur [B, 1, Hkv, D]
// in q's type, bound [B] int32 (the persisted length, or the ring
// policy's min(length, budget)).
//
// The cache's storage type is separate from q's: bf16, fp32, fp8 (e4m3,
// converted exactly to fp32 in registers) or int8 with one bf16 scale per
// stored head vector, k_scale / v_scale [B, max_len, Hkv]. The int8 scales
// are folded, never applied to the cache: the score is (q . k_int) * s_k[j]
// in fp32 and p_j * s_v[j] multiplies the V row. With a window (> 0) column
// j is visible iff q_pos[b] - j < window (dense cache, slot = position), so
// rows below q_pos - window + 1 are not read at all.
//
// What bounds it on the H100: bytes of live cache read. Each step reads
// 2 * bound * Hkv * D * (bytes per element) per sample and layer and does
// only 4 * bound * H * D flops, about one flop per byte, far below the
// card's ~295 flop/byte balance point. The design therefore reads each live
// cache row exactly once and nothing past `bound` (the capacity-proportional
// read of the masked plain version is what it removes): one block per (kv
// head, sample) serves all n_rep query heads of that kv head from the same
// rows; its 8 warps take rows round-robin, 4 rows per warp per step with
// all loads started before the math, each lane holding D/32 contiguous
// elements of a row (8 bytes in bf16, 4 in a one-byte type: a warp reads a
// row as one contiguous segment). Dot products reduce with warp shuffles,
// each warp keeps an online softmax (base 2, fp32), and the 8 partial
// states merge through shared memory at the end. Splitting the length
// across blocks (flash-decoding), 16-byte loads of the one-byte types and
// the M-query form (extend_attend_appended) are left to later versions.

#include <cuda_fp8.h>

#include "common.cuh"

namespace dllava {
namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerStep = 4;
constexpr int kMaxRep = 8;  // query heads per kv head

struct Fp8 {  // one e4m3 byte
  unsigned char x;
};

// one stored byte -> float, exactly
template <typename S>
__device__ __forceinline__ float byte_to_float(unsigned char b);
template <>
__device__ __forceinline__ float byte_to_float<signed char>(unsigned char b) {
  return static_cast<float>(static_cast<signed char>(b));
}
template <>
__device__ __forceinline__ float byte_to_float<Fp8>(unsigned char b) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
}

// E consecutive stored elements -> floats, one load of E * sizeof(S) bytes
template <typename S, int E>
__device__ __forceinline__ void load_stored(const S* p, float* out) {
  if constexpr (sizeof(S) > 1) {
    load_vec<S, E>(p, out);
  } else {
    unsigned int u;
    if constexpr (E == 4)
      u = *reinterpret_cast<const unsigned int*>(p);
    else
      u = *reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      out[e] = byte_to_float<S>((u >> (8 * e)) & 0xFFu);
    }
  }
}

// T: type of q, k_cur, v_cur and out; S: storage type of the cache
template <typename T, typename S, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const S* __restrict__ k_cache,
              const S* __restrict__ v_cache, const T* __restrict__ k_cur,
              const T* __restrict__ v_cur, const int* __restrict__ length,
              const __nv_bfloat16* __restrict__ k_scale,
              const __nv_bfloat16* __restrict__ v_scale,
              const int* __restrict__ q_pos, T* __restrict__ out, int max_len,
              int H, int Hkv, float scale_log2, int window) {
  constexpr int E = D / 32;  // elements per lane
  __shared__ float sm_m[kWarps][kMaxRep];
  __shared__ float sm_l[kWarps][kMaxRep];
  __shared__ float sm_acc[kWarps][kMaxRep][D];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int n_rep = H / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = max(0, min(length[b], max_len));
  // first visible row: with a window, column j needs q_pos - j < window
  const int first = window > 0 ? min(len, max(0, q_pos[b] - window + 1)) : 0;
  const bool scaled = k_scale != nullptr;  // int8 storage

  float qv[kMaxRep][E], acc[kMaxRep][E], m[kMaxRep], l[kMaxRep];
#pragma unroll
  for (int rr = 0; rr < kMaxRep; ++rr) {
    m[rr] = kNegBig;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[rr][e] = qv[rr][e] = 0.f;
    if (rr < n_rep) {
      const int h = hk * n_rep + rr;
      load_vec<T, E>(q + (size_t(b) * H + h) * D + lane * E, qv[rr]);
#pragma unroll
      for (int e = 0; e < E; ++e) qv[rr][e] *= scale_log2;
    }
  }

  const size_t row_stride = size_t(Hkv) * D;
  const S* kc = k_cache + size_t(b) * max_len * row_stride + size_t(hk) * D;
  const S* vc = v_cache + size_t(b) * max_len * row_stride + size_t(hk) * D;
  const T* kn = k_cur + (size_t(b) * Hkv + hk) * D;
  const T* vn = v_cur + (size_t(b) * Hkv + hk) * D;
  const size_t scale_at = size_t(b) * max_len * Hkv + hk;  // + row * Hkv

  // rows [first, len] -- row `len` is the current token
  for (int base = first + warp * kRowsPerStep; base <= len;
       base += kWarps * kRowsPerStep) {
    float kf[kRowsPerStep][E], vf[kRowsPerStep][E];
    float ks[kRowsPerStep], vs[kRowsPerStep];
#pragma unroll
    for (int t = 0; t < kRowsPerStep; ++t) {
      const int row = base + t;
      ks[t] = vs[t] = 1.f;
      if (row < len) {
        load_stored<S, E>(kc + row * row_stride + lane * E, kf[t]);
        load_stored<S, E>(vc + row * row_stride + lane * E, vf[t]);
        if (scaled) {
          ks[t] = __bfloat162float(k_scale[scale_at + size_t(row) * Hkv]);
          vs[t] = __bfloat162float(v_scale[scale_at + size_t(row) * Hkv]);
        }
      } else if (row == len) {
        load_vec<T, E>(kn + lane * E, kf[t]);
        load_vec<T, E>(vn + lane * E, vf[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kRowsPerStep; ++t) {
      if (base + t > len) break;  // uniform across the warp
#pragma unroll
      for (int rr = 0; rr < kMaxRep; ++rr) {
        if (rr >= n_rep) break;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(qv[rr][e], kf[t][e], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        s *= ks[t];
        const float m_new = fmaxf(m[rr], s);
        const float alpha = exp2f(m[rr] - m_new);
        const float p = exp2f(s - m_new);
        m[rr] = m_new;
        l[rr] = l[rr] * alpha + p;
        const float pv = p * vs[t];
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[rr][e] = fmaf(pv, vf[t][e], acc[rr][e] * alpha);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kMaxRep; ++rr) {
    if (rr >= n_rep) break;
    if (lane == 0) {
      sm_m[warp][rr] = m[rr];
      sm_l[warp][rr] = l[rr];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][rr][lane * E + e] = acc[rr][e];
  }
  __syncthreads();

  // merge the warps' partial softmax states; every warp that saw no row
  // has m == kNegBig and l == 0, so its weight exp2(m - M) is 0
  for (int idx = threadIdx.x; idx < n_rep * D; idx += kWarps * 32) {
    const int rr = idx / D;
    const int e = idx % D;
    float M = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][rr]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(sm_m[w][rr] - M);
      L += sm_l[w][rr] * wt;
      O += sm_acc[w][rr][e] * wt;
    }
    const int h = hk * n_rep + rr;
    out[(size_t(b) * H + h) * D + e] = from_float<T>(O / L);  // L >= 1
  }
}

template <typename T, typename S, int D>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const void* k_cur, const void* v_cur, const int* length,
                   const void* k_scale, const void* v_scale, const int* q_pos,
                   void* out, int B, int max_len, int H, int Hkv, float scale,
                   int window, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  decode_kernel<T, S, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const S*>(k_cache),
      static_cast<const S*>(v_cache), static_cast<const T*>(k_cur),
      static_cast<const T*>(v_cur), length,
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), q_pos, static_cast<T*>(out),
      max_len, H, Hkv, scale * kLog2e, window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_stored(int storage, const void* q, const void* k_cache,
                          const void* v_cache, const void* k_cur,
                          const void* v_cur, const int* length,
                          const void* k_scale, const void* v_scale,
                          const int* q_pos, void* out, int B, int max_len, int H,
                          int Hkv, float scale, int window, cudaStream_t stream) {
#define DLLAVA_K2(S)                                                          \
  return launch<T, S, D>(q, k_cache, v_cache, k_cur, v_cur, length, k_scale,  \
                         v_scale, q_pos, out, B, max_len, H, Hkv, scale,      \
                         window, stream)
  switch (storage) {
    case kFloat32: DLLAVA_K2(float);
    case kBFloat16: DLLAVA_K2(__nv_bfloat16);
    case kInt8: DLLAVA_K2(signed char);
    case kFloat8E4M3: DLLAVA_K2(Fp8);
  }
#undef DLLAVA_K2
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dllava

// C entry point. `dtype` is the type of q, k_cur, v_cur and out, `storage`
// the cache's (DType codes); k_scale / v_scale go with int8 storage and are
// null otherwise; window <= 0 means no window (q_pos may then be null).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape or type combination the kernel does not take.
extern "C" int decode_attention_appended(
    const void* q, const void* k_cache, const void* v_cache, const void* k_cur,
    const void* v_cur, const int* length, const void* k_scale,
    const void* v_scale, const int* q_pos, void* out, int B, int max_len, int H,
    int Hkv, int D, float scale, int window, int dtype, int storage,
    void* stream) {
  using namespace dllava;
  if (B <= 0 || max_len < 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kMaxRep || (storage == kInt8) != (k_scale != nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (window > 0 && q_pos == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DLLAVA_K2(T, D)                                                        \
  return launch_stored<T, D>(storage, q, k_cache, v_cache, k_cur, v_cur,       \
                             length, k_scale, v_scale, q_pos, out, B, max_len, \
                             H, Hkv, scale, window, s)
  if (dtype == kBFloat16 && D == 128) DLLAVA_K2(__nv_bfloat16, 128);
  if (dtype == kBFloat16 && D == 64) DLLAVA_K2(__nv_bfloat16, 64);
  if (dtype == kFloat32 && D == 128) DLLAVA_K2(float, 128);
  if (dtype == kFloat32 && D == 64) DLLAVA_K2(float, 64);
#undef DLLAVA_K2
  return cudaErrorInvalidValue;
}
