// Flash-attention forward (kernel K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel dynamic_llava_tpu/ops/flash_attention.py:
// _flash_kernel (wrapper flash_attention). Same contract: FA2-style online
// softmax over kv tiles with fp32 accumulators; causal masking with a static
// q_offset (q row i sees kv columns <= i + q_offset); a per-sample kv_length
// (columns >= kv_length are invalid); GQA by h / n_rep; rows that see no
// valid column write 0; an optional per-row logsumexp [B, H, Sq] (fp32).
// Layouts are the JAX ones: q/out [B, Sq, H, D], k/v [B, Sk, Hkv, D].
//
// What bounds it on the H100: at prefill shapes (decoder S=640, H=32,
// D=128; CLIP N=577, H=16, D=64) attention is compute-bound (about
// 4*S*S*D flops per (b, h) against 4*S*D*2 bytes read). This first version
// runs the two products on the CUDA cores with fp32 FMAs, not on the tensor
// cores, so it is far from the card's bf16 peak: the design aims at being
// right and at keeping the S x S scores out of device memory.
//
// Design: one block of 256 threads per (q tile of 64 rows, head, sample).
// The block keeps its (pre-scaled) q tile in shared memory and walks kv
// tiles of 64 columns up to min(kv_length, causal diagonal) -- tiles past
// either bound are never loaded, which halves causal prefill work. Each
// thread owns a 4 x 4 patch of the 64 x 64 score tile (rows r*4+i, columns
// c+16*j) and 4 rows x D/16 columns of the output accumulator; the 16
// threads of a row group are 16 lanes of one warp, so row maxima and sums
// reduce with shuffles. Shared-memory rows of q and k are padded to D+1
// floats so that the column reads of the score product hit 16 different
// banks. Softmax runs in base 2 (q pre-scaled by scale*log2(e)).

#include "common.cuh"

namespace dllava {
namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // kv columns per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kPS = kBK + 1;   // padded row stride of the probability tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBQ) * (D + 1) + size_t(kBK) * (D + 1) + size_t(kBK) * D +
          size_t(kBQ) * kPS);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_length,
                 T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk,
                 int H, int Hkv, int causal, int q_offset, float scale_log2) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // [kBQ][DP]
  float* Ks = Qs + kBQ * DP;   // [kBK][DP]
  float* Vs = Ks + kBK * DP;   // [kBK][D]
  float* Ps = Vs + kBK * D;    // [kBQ][kPS]

  const int tid = threadIdx.x;
  const int r = tid >> 4;  // row group: rows r*4 .. r*4+3 of the tile
  const int c = tid & 15;  // column lane: columns c + 16*j
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);

  int kv_len = kv_length ? kv_length[b] : Sk;
  kv_len = max(0, min(kv_len, Sk));
  int n_kv = kv_len;  // columns this block may touch
  if (causal) n_kv = min(n_kv, min(q0 + kBQ, Sq) + q_offset);

  const size_t q_stride = size_t(H) * D;
  const size_t kv_stride = size_t(Hkv) * D;
  const T* qb = q + (size_t(b) * Sq + q0) * q_stride + size_t(h) * D;
  const T* kb = k + size_t(b) * Sk * kv_stride + size_t(hk) * D;
  const T* vb = v + size_t(b) * Sk * kv_stride + size_t(hk) * D;

  load_tile<T, D, kBQ, kThreads>(Qs, DP, qb, q_stride, Sq - q0, scale_log2);

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;
  }

  for (int k0 = 0; k0 < n_kv; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    load_tile<T, D, kBK, kThreads>(Ks, DP, kb + size_t(k0) * kv_stride, kv_stride,
                         n_kv - k0, 1.f);
    load_tile<T, D, kBK, kThreads>(Vs, D, vb + size_t(k0) * kv_stride, kv_stride,
                         n_kv - k0, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(r * 4 + i) * DP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(c + 16 * j) * DP + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r * 4 + i;
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + c + 16 * j;
        const bool ok = col < kv_len && (!causal || col <= row + q_offset);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);  // masked: exp2(-inf) = 0
        psum += p;
        Ps[(r * 4 + i) * kPS + c + 16 * j] = p;
      }
      l[i] = l[i] * alpha + psum;  // per-lane partial, reduced at the end
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[DC];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) vv[jj] = Vs[kk * D + c + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(r * 4 + i) * kPS + kk];
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lsum = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    const int row = q0 + r * 4 + i;
    if (row >= Sq) continue;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;  // no valid column -> 0
    T* orow = out + (size_t(b) * Sq + row) * q_stride + size_t(h) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      orow[c + 16 * jj] = from_float<T>(acc[i][jj] * inv);
    if (lse != nullptr && c == 0)
      lse[(size_t(b) * H + h) * Sq + row] =
          lsum > 0.f ? (m[i] + log2f(lsum)) * kLn2 : kNegBig;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_length, void* out, float* lse, int B, int Sq,
                   int Sk, int H, int Hkv, int causal, int q_offset,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_length, static_cast<T*>(out), lse, Sq, Sk,
      H, Hkv, causal, q_offset, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dllava

// C entry point. kv_length may be null (every column valid), lse may be
// null (not written). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape or dtype the kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const int* kv_length, void* out, float* lse,
                                   int B, int Sq, int Sk, int H, int Hkv, int D,
                                   int causal, int q_offset, float scale,
                                   int dtype, void* stream) {
  using namespace dllava;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, kv_length, out, lse, B, Sq, Sk,
                                      H, Hkv, causal, q_offset, scale, s);
  if (dtype == kBFloat16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, kv_length, out, lse, B, Sq, Sk,
                                     H, Hkv, causal, q_offset, scale, s);
  if (dtype == kFloat32 && D == 128)
    return launch<float, 128>(q, k, v, kv_length, out, lse, B, Sq, Sk, H, Hkv,
                              causal, q_offset, scale, s);
  if (dtype == kFloat32 && D == 64)
    return launch<float, 64>(q, k, v, kv_length, out, lse, B, Sq, Sk, H, Hkv,
                             causal, q_offset, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
