// Flash-attention backward (kernel K3, two kernels) for Hopper, sm_90a.
//
// Replaces the TPU kernels dynamic_llava_tpu/ops/flash_attention.py:
// _flash_bwd_dkv_kernel and _flash_bwd_dq_kernel (wrapper
// flash_attention_bwd). Same contract, FlashAttention-2 style: from the
// forward's per-row logsumexp `lse` and `delta = rowsum(dO * O)`,
//   p  = exp(s * scale - lse)   under the causal and kv_length masks,
//   dv = p^T dO,   ds = p * (dO v^T - delta) * scale,
//   dk = ds^T q,   dq = ds k,
// and the S x S matrices p and ds never reach device memory. The mask is
// applied BEFORE the exponential: a fully masked row has lse = -1e30, and
// exp(s - lse) would overflow. Layouts are the JAX ones: q/dO/dq
// [B, Sq, H, D], k/v [B, Sk, Hkv, D], lse/delta [B, H, Sq] fp32. dk and dv
// are written per QUERY head in fp32, [B, Sk, H, D]; the wrapper sums each
// GQA group and casts, as the JAX wrapper does.
//
// What bounds it on the H100: operations. The dq kernel does three products
// per (q tile, kv tile) pair and the dkv kernel four, against 2 in the
// forward, on about the same bytes. This first version runs them on the
// CUDA cores with fp32 FMAs, so it is far from the card's bf16 peak; the
// design aims at being right, deterministic and free of S x S traffic.
//
// Design: no atomics, so that a layer re-run under activation
// checkpointing gives the same bits. The dkv kernel gives one block a kv
// tile of 64 columns and walks the q tiles that can see it (from the
// diagonal on when causal); the dq kernel gives one block a q tile of 64
// rows and walks kv tiles up to min(kv_length, diagonal). A block has 256
// threads; thread (r, c) owns the 4 x 4 patch (rows r*4+i, columns c+16*j)
// of the 64 x 64 tiles s and dO v^T, writes p and ds to shared memory, and
// then owns 4 rows x D/16 columns of the accumulators, as in the forward
// kernel. Rows of the q/k/v/dO tiles are padded to D+1 floats.

#include "common.cuh"

namespace dllava {
namespace {

constexpr int kBQ = 64;        // q rows per tile
constexpr int kBK = 64;        // kv columns per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kPS = kBK + 1;   // padded row stride of the p / ds tiles

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t(4) * 64 * (D + 1) + size_t(kBQ) * kPS);
}
template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t(4) * 64 * (D + 1) + size_t(2) * kBQ * kPS);
}

// s = Q K^T and dp = dO V^T for this thread's 4 x 4 patch.
template <int D>
__device__ __forceinline__ void score_patches(const float* Qs, const float* dOs,
                                              const float* Ks, const float* Vs,
                                              int r, int c, float (&s)[4][4],
                                              float (&dp)[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int kk = 0; kk < D; ++kk) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(r * 4 + i) * DP + kk];
      gv[i] = dOs[(r * 4 + i) * DP + kk];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(c + 16 * j) * DP + kk];
      vv[j] = Vs[(c + 16 * j) * DP + kk];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_length, T* __restrict__ dq,
                    int Sq, int Sk, int H, int Hkv, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // [kBQ][DP]
  float* dOs = Qs + kBQ * DP;   // [kBQ][DP]
  float* Ks = dOs + kBQ * DP;   // [kBK][DP]
  float* Vs = Ks + kBK * DP;    // [kBK][DP]
  float* dSs = Vs + kBK * DP;   // [kBQ][kPS]

  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);

  int kv_len = kv_length ? kv_length[b] : Sk;
  kv_len = max(0, min(kv_len, Sk));
  int n_kv = kv_len;  // columns this block may touch
  if (causal) n_kv = min(n_kv, min(q0 + kBQ, Sq));

  const size_t q_stride = size_t(H) * D;
  const size_t kv_stride = size_t(Hkv) * D;
  const size_t q_off = (size_t(b) * Sq + q0) * q_stride + size_t(h) * D;
  const T* kb = k + size_t(b) * Sk * kv_stride + size_t(hk) * D;
  const T* vb = v + size_t(b) * Sk * kv_stride + size_t(hk) * D;

  load_tile<T, D, kBQ, kThreads>(Qs, DP, q + q_off, q_stride, Sq - q0, 1.f);
  load_tile<T, D, kBQ, kThreads>(dOs, DP, dout + q_off, q_stride, Sq - q0, 1.f);

  const float scale_log2 = scale * kLog2e;
  float lse2[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    const bool ok = row < Sq;
    lse2[i] = ok ? lse[(size_t(b) * H + h) * Sq + row] * kLog2e : 0.f;
    dl[i] = ok ? delta[(size_t(b) * H + h) * Sq + row] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;

  for (int k0 = 0; k0 < n_kv; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks/Vs/dSs reads are done
    load_tile<T, D, kBK, kThreads>(Ks, DP, kb + size_t(k0) * kv_stride,
                                   kv_stride, n_kv - k0, 1.f);
    load_tile<T, D, kBK, kThreads>(Vs, DP, vb + size_t(k0) * kv_stride,
                                   kv_stride, n_kv - k0, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_patches<D>(Qs, dOs, Ks, Vs, r, c, s, dp);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + c + 16 * j;
        const bool ok = row < Sq && col < kv_len && (!causal || col <= row);
        const float p = ok ? exp2f(s[i][j] * scale_log2 - lse2[i]) : 0.f;
        dSs[(r * 4 + i) * kPS + c + 16 * j] = p * (dp[i][j] - dl[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float kv[DC];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) kv[jj] = Ks[kk * DP + c + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(r * 4 + i) * kPS + kk];
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) acc[i][jj] = fmaf(ds, kv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    if (row >= Sq) continue;
    T* drow = dq + (size_t(b) * Sq + row) * q_stride + size_t(h) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) drow[c + 16 * jj] = from_float<T>(acc[i][jj]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ kv_length, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                     int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;             // [kBK][DP]
  float* Vs = Ks + kBK * DP;    // [kBK][DP]
  float* Qs = Vs + kBK * DP;    // [kBQ][DP]
  float* dOs = Qs + kBQ * DP;   // [kBQ][DP]
  float* Ps = dOs + kBQ * DP;   // [kBQ][kPS]
  float* dSs = Ps + kBQ * kPS;  // [kBQ][kPS]

  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;
  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);

  int kv_len = kv_length ? kv_length[b] : Sk;
  kv_len = max(0, min(kv_len, Sk));

  const size_t q_stride = size_t(H) * D;
  const size_t kv_stride = size_t(Hkv) * D;
  const float scale_log2 = scale * kLog2e;
  const float* lse_b = lse + (size_t(b) * H + h) * Sq;
  const float* delta_b = delta + (size_t(b) * H + h) * Sq;

  // this thread's 4 kv rows (k0 + r*4 + i) x DC columns (c + 16*jj)
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      dk_acc[i][jj] = 0.f;
      dv_acc[i][jj] = 0.f;
    }

  if (k0 < kv_len) {  // the same for the whole block
    const size_t kv_off = (size_t(b) * Sk + k0) * kv_stride + size_t(hk) * D;
    load_tile<T, D, kBK, kThreads>(Ks, DP, k + kv_off, kv_stride, kv_len - k0, 1.f);
    load_tile<T, D, kBK, kThreads>(Vs, DP, v + kv_off, kv_stride, kv_len - k0, 1.f);

    // causal: this kv tile only receives gradients from q rows >= k0
    for (int q0 = causal ? k0 : 0; q0 < Sq; q0 += kBQ) {
      __syncthreads();  // the previous tile's Qs/dOs/Ps/dSs reads are done
      const size_t q_off = (size_t(b) * Sq + q0) * q_stride + size_t(h) * D;
      load_tile<T, D, kBQ, kThreads>(Qs, DP, q + q_off, q_stride, Sq - q0, 1.f);
      load_tile<T, D, kBQ, kThreads>(dOs, DP, dout + q_off, q_stride, Sq - q0, 1.f);
      __syncthreads();

      float s[4][4], dp[4][4];
      score_patches<D>(Qs, dOs, Ks, Vs, r, c, s, dp);

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + r * 4 + i;
        const bool row_ok = row < Sq;
        const float lse2 = row_ok ? lse_b[row] * kLog2e : 0.f;
        const float dl = row_ok ? delta_b[row] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + c + 16 * j;
          const bool ok = row_ok && col < kv_len && (!causal || col <= row);
          const float p = ok ? exp2f(s[i][j] * scale_log2 - lse2) : 0.f;
          Ps[(r * 4 + i) * kPS + c + 16 * j] = p;
          dSs[(r * 4 + i) * kPS + c + 16 * j] = p * (dp[i][j] - dl) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < kBQ; ++kk) {  // over the q rows of the tile
        float gv[DC], qv[DC];
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) {
          gv[jj] = dOs[kk * DP + c + 16 * jj];
          qv[jj] = Qs[kk * DP + c + 16 * jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[kk * kPS + r * 4 + i];
          const float ds = dSs[kk * kPS + r * 4 + i];
#pragma unroll
          for (int jj = 0; jj < DC; ++jj) {
            dv_acc[i][jj] = fmaf(p, gv[jj], dv_acc[i][jj]);
            dk_acc[i][jj] = fmaf(ds, qv[jj], dk_acc[i][jj]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + r * 4 + i;
    if (col >= Sk) continue;
    const size_t o = (size_t(b) * Sk + col) * q_stride + size_t(h) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      dk[o + c + 16 * jj] = dk_acc[i][jj];
      dv[o + c + 16 * jj] = dv_acc[i][jj];
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* kv_length, void* dq, int B, int Sq, int Sk,
                      int H, int Hkv, int causal, float scale,
                      cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      kv_length, static_cast<T*>(dq), Sq, Sk, H, Hkv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const int* kv_length, float* dk, float* dv, int B,
                       int Sq, int Sk, int H, int Hkv, int causal, float scale,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + kBK - 1) / kBK, H, B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      kv_length, dk, dv, Sq, Sk, H, Hkv, causal, scale);
  return cudaGetLastError();
}

bool shapes_ok(int B, int Sq, int Sk, int H, int Hkv, int causal) {
  // the causal bounds assume q row i is kv column i (no q_offset)
  return B > 0 && Sq > 0 && Sk > 0 && Hkv > 0 && H % Hkv == 0 &&
         (!causal || Sq == Sk);
}

}  // namespace
}  // namespace dllava

// C entry points. kv_length may be null (every column valid). Each returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for a shape
// or dtype the kernel does not take.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      const int* kv_length, void* dq, int B,
                                      int Sq, int Sk, int H, int Hkv, int D,
                                      int causal, float scale, int dtype,
                                      void* stream) {
  using namespace dllava;
  if (!shapes_ok(B, Sq, Sk, H, Hkv, causal)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && D == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, kv_length,
                                         dq, B, Sq, Sk, H, Hkv, causal, scale, s);
  if (dtype == kBFloat16 && D == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, kv_length,
                                        dq, B, Sq, Sk, H, Hkv, causal, scale, s);
  if (dtype == kFloat32 && D == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, delta, kv_length, dq, B,
                                 Sq, Sk, H, Hkv, causal, scale, s);
  if (dtype == kFloat32 && D == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, delta, kv_length, dq, B,
                                Sq, Sk, H, Hkv, causal, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       const int* kv_length, float* dk,
                                       float* dv, int B, int Sq, int Sk, int H,
                                       int Hkv, int D, int causal, float scale,
                                       int dtype, void* stream) {
  using namespace dllava;
  if (!shapes_ok(B, Sq, Sk, H, Hkv, causal)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && D == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, kv_length,
                                          dk, dv, B, Sq, Sk, H, Hkv, causal,
                                          scale, s);
  if (dtype == kBFloat16 && D == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, kv_length,
                                         dk, dv, B, Sq, Sk, H, Hkv, causal,
                                         scale, s);
  if (dtype == kFloat32 && D == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, kv_length, dk, dv,
                                  B, Sq, Sk, H, Hkv, causal, scale, s);
  if (dtype == kFloat32 && D == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, kv_length, dk, dv,
                                 B, Sq, Sk, H, Hkv, causal, scale, s);
  return cudaErrorInvalidValue;
}
