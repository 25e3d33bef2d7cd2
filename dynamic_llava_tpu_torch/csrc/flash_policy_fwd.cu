// Fused policy attention, forward (kernel K4) for Hopper, sm_90a.
//
// Replaces the TPU kernel dynamic_llava_tpu/ops/flash_policy.py:
// _policy_kernel (wrapper flash_policy_attention): the training path's
// causal masked softmax with a soft keep policy over the kv tokens,
//
//   w_ij  = (exp(s_ij - m_i) * p'_ij + eps/N) / (sum_j exp(s_ij - m_i) * p'_ij + eps)
//   out_i = sum_j w_ij v_j
//
// with its quirks kept: p' is the kv policy with the diagonal forced to 1
// (every token attends itself; the escape applies to the policy, not to
// the mask); m_i is the maximum of the causally masked scores, policy or
// not; everything is fp32; N in eps/N is the true sequence length, and the
// eps/N term covers EVERY column j < N, also those the causal mask hides,
// so (eps/N) * sum_j v_j rides along. Layouts are the JAX ones: q/out
// [B, S, H, D], k/v [B, S, Hkv, D], policy [B, S] fp32.
//
// What bounds it on the H100: operations, like the forward kernel K1 (two
// products per tile pair). This first version runs them on the CUDA cores
// with fp32 FMAs; the S x S score matrix never reaches device memory.
//
// Design: blocks run in no order and share nothing, so the column sum
// sum_j v_j, which the TPU kernel gathers in a tail loop of every program,
// is a small kernel of its own here (one block per (kv head, sample),
// written to a [B, Hkv, D] fp32 scratch the wrapper allocates), launched
// on the same stream before the main kernel. The main kernel is K1's
// design: one block of 256 threads per (q tile of 64 rows, head, sample)
// walks kv tiles of 64 columns up to the causal diagonal with an online
// renormalization; thread (r, c) owns the 4 x 4 score patch (rows r*4+i,
// columns c+16*j) and 4 rows x D/16 columns of the accumulator. The tile's
// policy values sit in shared memory beside K and V.

#include "common.cuh"

namespace dllava {
namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPS = kBK + 1;

template <int D>
constexpr size_t policy_smem_bytes() {
  return sizeof(float) *
         (size_t(kBQ) * (D + 1) + size_t(kBK) * (D + 1) + size_t(kBK) * D +
          size_t(kBQ) * kPS + size_t(kBK));
}

// vsum[b, hk, :] = sum over all S rows of v[b, :, hk, :]; one thread per
// column, in a fixed order.
template <typename T, int D>
__global__ void __launch_bounds__(D)
policy_vsum_kernel(const T* __restrict__ v, float* __restrict__ vsum, int S,
                   int Hkv) {
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const size_t stride = size_t(Hkv) * D;
  const T* vb = v + size_t(b) * S * stride + size_t(hk) * D + threadIdx.x;
  float acc = 0.f;
#pragma unroll 8
  for (int j = 0; j < S; ++j) acc += to_float(vb[size_t(j) * stride]);
  vsum[(size_t(b) * Hkv + hk) * D + threadIdx.x] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_policy_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ policy,
                        const float* __restrict__ vsum, T* __restrict__ out,
                        int S, int H, int Hkv, float scale_log2, float eps) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBQ][DP]
  float* Ks = Qs + kBQ * DP;     // [kBK][DP]
  float* Vs = Ks + kBK * DP;     // [kBK][D]
  float* Ps = Vs + kBK * D;      // [kBQ][kPS]
  float* pol_s = Ps + kBQ * kPS; // [kBK]

  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int n_kv = min(q0 + kBQ, S);  // causal: columns up to the diagonal

  const size_t q_stride = size_t(H) * D;
  const size_t kv_stride = size_t(Hkv) * D;
  const T* qb = q + (size_t(b) * S + q0) * q_stride + size_t(h) * D;
  const T* kb = k + size_t(b) * S * kv_stride + size_t(hk) * D;
  const T* vb = v + size_t(b) * S * kv_stride + size_t(hk) * D;
  const float* pb = policy + size_t(b) * S;

  load_tile<T, D, kBQ, kThreads>(Qs, DP, qb, q_stride, S - q0, scale_log2);

  float acc[4][DC];
  float m[4], den[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    den[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;
  }

  for (int k0 = 0; k0 < n_kv; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps/pol_s reads are done
    load_tile<T, D, kBK, kThreads>(Ks, DP, kb + size_t(k0) * kv_stride,
                                   kv_stride, n_kv - k0, 1.f);
    load_tile<T, D, kBK, kThreads>(Vs, D, vb + size_t(k0) * kv_stride,
                                   kv_stride, n_kv - k0, 1.f);
    if (tid < kBK) pol_s[tid] = k0 + tid < S ? pb[k0 + tid] : 0.f;
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
        s[i][j] = (col <= row && col < S) ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float esum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + c + 16 * j;
        const float pol = col == row ? 1.f : pol_s[c + 16 * j];
        const float e = exp2f(s[i][j] - m_new) * pol;  // masked: exp2(-inf) = 0
        esum += e;
        Ps[(r * 4 + i) * kPS + c + 16 * j] = e;
      }
      den[i] = den[i] * alpha + esum;  // per-lane partial, reduced at the end
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
        const float e = Ps[(r * 4 + i) * kPS + kk];
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) acc[i][jj] = fmaf(e, vv[jj], acc[i][jj]);
      }
    }
  }

  const float eps_n = eps / float(S);
  const float* vs = vsum + (size_t(b) * Hkv + hk) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float dsum = den[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    const int row = q0 + r * 4 + i;
    if (row >= S) continue;
    const float inv = 1.f / (dsum + eps);
    T* orow = out + (size_t(b) * S + row) * q_stride + size_t(h) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      orow[c + 16 * jj] =
          from_float<T>((acc[i][jj] + eps_n * vs[c + 16 * jj]) * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* policy, float* vsum, void* out, int B, int S,
                   int H, int Hkv, float scale, float eps,
                   cudaStream_t stream) {
  const size_t smem = policy_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_policy_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  policy_vsum_kernel<T, D><<<dim3(Hkv, B), D, 0, stream>>>(
      static_cast<const T*>(v), vsum, S, Hkv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_policy_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), policy, vsum, static_cast<T*>(out), S, H, Hkv,
      scale * kLog2e, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dllava

// C entry point. `vsum` is a [B, Hkv, D] fp32 scratch buffer. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape or dtype the kernel does not take.
extern "C" int flash_policy_attention_fwd(const void* q, const void* k,
                                          const void* v, const float* policy,
                                          float* vsum, void* out, int B, int S,
                                          int H, int Hkv, int D, float scale,
                                          float eps, int dtype, void* stream) {
  using namespace dllava;
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, policy, vsum, out, B, S, H, Hkv,
                                      scale, eps, s);
  if (dtype == kBFloat16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, policy, vsum, out, B, S, H, Hkv,
                                     scale, eps, s);
  if (dtype == kFloat32 && D == 128)
    return launch<float, 128>(q, k, v, policy, vsum, out, B, S, H, Hkv, scale,
                              eps, s);
  if (dtype == kFloat32 && D == 64)
    return launch<float, 64>(q, k, v, policy, vsum, out, B, S, H, Hkv, scale,
                             eps, s);
  return cudaErrorInvalidValue;
}
