// Decode attention with the current token appended virtually (kernel K2),
// for Hopper, sm_90a.
//
// Replaces the TPU kernel dynamic_llava_tpu/ops/decode_attention.py:
// _decode_kernel (wrapper flash_decode_attention), ported to the contract
// the decode layer loop actually calls: ops/attention.py
// decode_attend_appended. One query token per sample attends over the
// persisted cache rows [0, length) plus the current token's K/V, which is
// NOT in the cache and enters as one extra, always-visible column. The
// cache is only read; the wrapper's caller writes the new K/V afterwards.
// Layouts: q/out [B, 1, H, D], cache [B, max_len, Hkv, D] (one layer's
// view of the [L, B, max_len, Hkv, D] buffer), k_cur/v_cur [B, 1, Hkv, D],
// length [B] int32.
//
// What bounds it on the H100: bytes of live cache read. Each step reads
// 2 * length * Hkv * D * 2 bytes per sample and layer and does only
// 4 * length * H * D flops, about one flop per byte, far below the card's
// ~295 flop/byte balance point. The design therefore reads each live cache
// row exactly once and nothing past `length` (the capacity-proportional
// read of the masked plain version is what it removes), with wide loads:
// one block per (kv head, sample) serves all n_rep query heads of that kv
// head from the same rows; its 8 warps take rows round-robin, 4 rows per
// warp per step with all loads issued before the math, each lane holding
// D/32 contiguous elements of a row (one 8-byte load per row in bf16).
// Dot products reduce with warp shuffles, each warp keeps an online
// softmax (base 2, fp32), and the 8 partial states merge through shared
// memory at the end. Splitting the length across blocks (flash-decoding)
// is left to a later version.

#include "common.cuh"

namespace dllava {
namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerStep = 4;
constexpr int kMaxRep = 8;  // query heads per kv head

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
              const T* __restrict__ v_cache, const T* __restrict__ k_cur,
              const T* __restrict__ v_cur, const int* __restrict__ length,
              T* __restrict__ out, int max_len, int H, int Hkv,
              float scale_log2) {
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
  const T* kc = k_cache + size_t(b) * max_len * row_stride + size_t(hk) * D;
  const T* vc = v_cache + size_t(b) * max_len * row_stride + size_t(hk) * D;
  const T* kn = k_cur + (size_t(b) * Hkv + hk) * D;
  const T* vn = v_cur + (size_t(b) * Hkv + hk) * D;

  // rows [0, len] -- row `len` is the current token
  for (int base = warp * kRowsPerStep; base <= len;
       base += kWarps * kRowsPerStep) {
    float kf[kRowsPerStep][E], vf[kRowsPerStep][E];
#pragma unroll
    for (int t = 0; t < kRowsPerStep; ++t) {
      const int row = base + t;
      if (row < len) {
        load_vec<T, E>(kc + row * row_stride + lane * E, kf[t]);
        load_vec<T, E>(vc + row * row_stride + lane * E, vf[t]);
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
        const float m_new = fmaxf(m[rr], s);
        const float alpha = exp2f(m[rr] - m_new);
        const float p = exp2f(s - m_new);
        m[rr] = m_new;
        l[rr] = l[rr] * alpha + p;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[rr][e] = fmaf(p, vf[t][e], acc[rr][e] * alpha);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const void* k_cur, const void* v_cur, const int* length,
                   void* out, int B, int max_len, int H, int Hkv, float scale,
                   cudaStream_t stream) {
  dim3 grid(Hkv, B);
  decode_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const T*>(k_cur),
      static_cast<const T*>(v_cur), length, static_cast<T*>(out), max_len, H,
      Hkv, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dllava

// C entry point. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape or dtype the kernel does not take.
extern "C" int decode_attention_appended(const void* q, const void* k_cache,
                                         const void* v_cache, const void* k_cur,
                                         const void* v_cur, const int* length,
                                         void* out, int B, int max_len, int H,
                                         int Hkv, int D, float scale, int dtype,
                                         void* stream) {
  using namespace dllava;
  if (B <= 0 || max_len < 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kMaxRep)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k_cache, v_cache, k_cur, v_cur,
                                      length, out, B, max_len, H, Hkv, scale, s);
  if (dtype == kBFloat16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k_cache, v_cache, k_cur, v_cur, length,
                                     out, B, max_len, H, Hkv, scale, s);
  if (dtype == kFloat32 && D == 128)
    return launch<float, 128>(q, k_cache, v_cache, k_cur, v_cur, length, out,
                              B, max_len, H, Hkv, scale, s);
  if (dtype == kFloat32 && D == 64)
    return launch<float, 64>(q, k_cache, v_cache, k_cur, v_cur, length, out, B,
                             max_len, H, Hkv, scale, s);
  return cudaErrorInvalidValue;
}
