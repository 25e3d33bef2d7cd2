// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dllava {

// dtype codes of the C entry points (kernels/__init__.py DTYPE_CODES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// Finite "minus infinity" for running maxima, as in the TPU kernels: a row
// that has seen no valid column keeps m == kNegBig, so exp2(m_old - m_new)
// stays 1 and never becomes inf - inf.
constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a JAX astype
}

// N consecutive elements -> N floats with one vector load (N*sizeof(T) is
// 4, 8 or 16 bytes; the caller guarantees the matching alignment).
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out);

template <>
__device__ __forceinline__ void load_vec<float, 2>(const float* p, float* out) {
  float2 v = *reinterpret_cast<const float2*>(p);
  out[0] = v.x; out[1] = v.y;
}
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p, float* out) {
  float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 2>(
    const __nv_bfloat16* p, float* out) {
  float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  out[0] = v.x; out[1] = v.y;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(
    const __nv_bfloat16* p, float* out) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// Rows [0, ROWS) of a [rows, D] slice with row stride `row_stride` into
// shared-memory rows of `stride` floats, times `mul`; rows >= n_valid are 0.
// Called by all THREADS threads of a block.
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src,
                                          size_t row_stride, int n_valid,
                                          float mul) {
  constexpr int kVecPerRow = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * kVecPerRow; idx += THREADS) {
    const int row = idx / kVecPerRow;
    const int col = (idx % kVecPerRow) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < n_valid) load_vec<T, 4>(src + row * row_stride + col, f);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[row * stride + col + e] = f[e] * mul;
  }
}

}  // namespace dllava
