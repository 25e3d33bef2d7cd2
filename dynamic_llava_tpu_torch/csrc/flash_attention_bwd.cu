// Flash-attention backward (kernel K3) for Hopper, sm_90a.
//
// Replaces the TPU kernels dynamic_llava_tpu/ops/flash_attention.py:
// _flash_bwd_dkv_kernel and _flash_bwd_dq_kernel (wrapper
// flash_attention_bwd, which also computes delta). Same contract,
// FlashAttention-2 style: from the forward's per-row logsumexp `lse` and
// `delta = rowsum(dO * O)`,
//   p  = exp(s * scale - lse)   under the causal and kv_length masks,
//   dv = p^T dO,   ds = p * (dO v^T - delta) * scale,
//   dk = ds^T q,   dq = ds k,
// and the S x S matrices p and ds never reach device memory. The mask is
// applied BEFORE the exponential: a fully masked row has lse = -1e30, and
// exp(s - lse) would overflow. Layouts are the JAX ones: q/dO/dq
// [B, Sq, H, D], k/v/dk/dv [B, Sk, Hkv, D], lse/delta [B, H, Sq] fp32. dk
// and dv are summed over each GQA group in fp32 and cast once, as the JAX
// wrapper does.
//
// What bounds it on the H100: operations. The dq kernel does three products
// per (q tile, kv tile) pair and the dkv kernel four, against 2 in the
// forward, on about the same bytes; the delta kernel is bound by its bytes
// (out and dO read once).
//
// No atomics anywhere, so that a layer re-run under activation checkpointing
// gives the same bits: the dq kernels give one block a q tile of 64 rows and
// walk kv tiles up to min(kv_length, diagonal); the dkv kernels give one
// block a kv tile of 64 columns of one KV head and walk, for each query head
// of the group in order, the q tiles that can see it (from the diagonal on
// when causal), accumulating dk and dv in registers and writing them once.
// The C entry points choose by the tensors' type:
//
// bf16 (flash_bwd_dq_mma_kernel, flash_bwd_dkv_mma_kernel): every product
// runs on the tensor cores (mma.sync m16n8k16, bf16 x bf16 -> fp32), 4 warps
// a block, 16 tile rows a warp. Tiles stay bf16 in shared memory with rows of
// D + 8 elements (conflict-free ldmatrix; 103 KB at D=128, two blocks an SM);
// the streamed operand (K/V in dq, Q/dO with their lse/delta in dkv) goes
// through a two-stage ring of cp.async copies, zero-filled past the valid
// rows, the next tile in flight while this one is multiplied. In dq the fp32
// accumulator fragments of S and dP become, once dS is packed to bf16, the A
// fragment of dS K, with K through ldmatrix.trans. The dkv kernel computes
// the TRANSPOSED tiles S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T
// are the A fragments of dV = P^T dO and dK = dS^T Q (dO and Q through
// ldmatrix.trans); lse and delta are then per accumulator column and come
// from a small shared-memory vector. At D=128 it does so 32 q rows at a
// time: the two 16 x D accumulators take 128 registers a thread, and
// half-width S^T / dP^T fragments keep the kernel clear of spills (255
// registers, no spill; at D=64 one full-width pass, 64 rows). P and dS never
// touch shared memory; one __syncthreads per tile. Masks are evaluated only
// on tiles that straddle a bound. Heavy tiles start first: the q tile
// (dq, highest first) or kv tile (dkv, lowest first) is the slowest grid
// dimension.
//
// fp32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): full fp32 arithmetic on
// the CUDA cores, 256 threads a block, fp32 tiles with rows padded to D+1;
// thread (r, c) owns the 4 x 4 patch (rows r*4+i, columns c+16*j) of the
// 64 x 64 tiles s and dO v^T, writes p and ds to shared memory, and then
// owns 4 rows x D/16 columns of the accumulators. They serve the fp32
// checks, where a bf16 product would not do.
//
// flash_bwd_delta_kernel (both types): D / (16 bytes) lanes a row read out
// and dO once with 16-byte loads, multiply in fp32, reduce with shuffles and
// write [B, H, Sq].

#include "common.cuh"

namespace dllava {
namespace {

constexpr int kBQ = 64;        // q rows per tile
constexpr int kBK = 64;        // kv columns per tile
// ---------------------------------------------------------------------------
// fp32: CUDA cores

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
                     const int* __restrict__ kv_length, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
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
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kBK;
  const int n_rep = H / Hkv;

  int kv_len = kv_length ? kv_length[b] : Sk;
  kv_len = max(0, min(kv_len, Sk));

  const size_t q_stride = size_t(H) * D;
  const size_t kv_stride = size_t(Hkv) * D;
  const float scale_log2 = scale * kLog2e;

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

    // the query heads of this KV head, in order, into the same accumulators
    for (int h = hk * n_rep; h < (hk + 1) * n_rep; ++h) {
      const float* lse_b = lse + (size_t(b) * H + h) * Sq;
      const float* delta_b = delta + (size_t(b) * H + h) * Sq;
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
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + r * 4 + i;
    if (col >= Sk) continue;
    const size_t o = (size_t(b) * Sk + col) * kv_stride + size_t(hk) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      dk[o + c + 16 * jj] = from_float<T>(dk_acc[i][jj]);
      dv[o + c + 16 * jj] = from_float<T>(dv_acc[i][jj]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores

constexpr int kMmaThreads = 128;  // 4 warps x 16 tile rows
using bf16 = __nv_bfloat16;

// q, dO and two stages each of k and v (dq); k, v and two stages each of q
// and dO with their lse and delta (dkv)
template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * size_t(6) * 64 * (D + kTilePad) + sizeof(float) * 4 * kBQ;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ kv_length, bf16* __restrict__ dq,
                        int Sq, int Sk, int H, int Hkv, int causal, float scale) {
  constexpr int DS = D + kTilePad;  // tile row stride
  constexpr int kTile = 64 * DS;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_mma);  // [kBQ][DS]
  bf16* dOs = Qs + kTile;                        // [kBQ][DS]
  bf16* Ks = dOs + kTile;                        // [2][kBK][DS]
  bf16* Vs = Ks + 2 * kTile;                     // [2][kBK][DS]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // accumulator rows g and g + 8
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1 of each 8-block
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heavy tiles first
  const int hk = h / (H / Hkv);

  int kv_len = kv_length ? kv_length[b] : Sk;
  kv_len = max(0, min(kv_len, Sk));
  int n_kv = kv_len;  // columns this block may touch
  if (causal) n_kv = min(n_kv, min(q0 + kBQ, Sq));
  const int n_tiles = (n_kv + kBK - 1) / kBK;

  const size_t q_stride = size_t(H) * D;
  const size_t kv_stride = size_t(Hkv) * D;
  const size_t q_off = (size_t(b) * Sq + q0) * q_stride + size_t(h) * D;
  const bf16* kb = k + size_t(b) * Sk * kv_stride + size_t(hk) * D;
  const bf16* vb = v + size_t(b) * Sk * kv_stride + size_t(hk) * D;

  auto load_kv = [&](int tile) {
    const int k0 = tile * kBK;
    const size_t off = size_t(k0) * kv_stride;
    cp_async_tile<D, kBK, kMmaThreads>(Ks + (tile & 1) * kTile, kb + off, kv_stride,
                                       kv_len - k0);
    cp_async_tile<D, kBK, kMmaThreads>(Vs + (tile & 1) * kTile, vb + off, kv_stride,
                                       kv_len - k0);
  };

  cp_async_tile<D, kBQ, kMmaThreads>(Qs, q + q_off, q_stride, Sq - q0);
  cp_async_tile<D, kBQ, kMmaThreads>(dOs, dout + q_off, q_stride, Sq - q0);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    const bool ok = row < Sq;
    lse2[r] = ok ? lse[(size_t(b) * H + h) * Sq + row] * kLog2e : 0.f;
    dl[r] = ok ? delta[(size_t(b) * H + h) * Sq + row] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<0>();
    __syncthreads();  // tile `tile` has landed; the other stage is free
    if (tile + 1 < n_tiles) {
      load_kv(tile + 1);
      cp_async_commit();
    }
    const bf16* Kt = Ks + (tile & 1) * kTile;
    const bf16* Vt = Vs + (tile & 1) * kTile;
    const int k0 = tile * kBK;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 columns a warp
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = 0.f;
        dp[i][c] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ag[4];
      ldmatrix_x4(aq, frag_ptr(Qs, DS, warp * 16, kk * 16, lane));
      ldmatrix_x4(ag, frag_ptr(dOs, DS, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, frag_ptr_nk(Kt, DS, np * 16, kk * 16, lane));
        ldmatrix_x4(bv, frag_ptr_nk(Vt, DS, np * 16, kk * 16, lane));
        mma_bf16(s[2 * np], aq, bk);
        mma_bf16(s[2 * np + 1], aq, bk + 2);
        mma_bf16(dp[2 * np], ag, bv);
        mma_bf16(dp[2 * np + 1], ag, bv + 2);
      }
    }

    // dS = p * (dP - delta) * scale, the mask before the exponential and
    // only where the tile straddles a bound; s becomes dS
    const bool straddle =
        k0 + kBK > kv_len || q0 + kBQ > Sq || (causal && k0 + kBK - 1 > q0);
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        bool ok = true;
        if (straddle) {
          const int row = q0 + warp * 16 + g + r * 8;
          const int col = k0 + i * 8 + 2 * t + (c & 1);
          ok = row < Sq && col < kv_len && (!causal || col <= row);
        }
        const float p = ok ? exp2f(s[i][c] * scale_log2 - lse2[r]) : 0.f;
        s[i][c] = p * (dp[i][c] - dl[r]) * scale;
      }

    // dq += dS K: dS from registers, K through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t a[4];
      frag_from_acc(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, frag_ptr(Kt, DS, j * 16, np * 16, lane));
        mma_bf16(acc[2 * np], a, bk);
        mma_bf16(acc[2 * np + 1], a, bk + 2);
      }
    }
  }
  cp_async_wait<0>();  // a block without kv tiles still has its tiles in flight

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    bf16* drow = dq + (size_t(b) * Sq + row) * q_stride + size_t(h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(drow + j * 8 + 2 * t) =
          pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ kv_length, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                         int causal, float scale) {
  constexpr int DS = D + kTilePad;  // tile row stride
  constexpr int kTile = 64 * DS;
  // q rows of one pass over S^T and dP^T: half a tile at D=128, where the
  // accumulators already take 128 registers
  constexpr int kHalf = D > 64 ? 32 : 64;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_mma);       // [kBK][DS]
  bf16* Vs = Ks + kTile;                              // [kBK][DS]
  bf16* Qs = Vs + kTile;                              // [2][kBQ][DS]
  bf16* dOs = Qs + 2 * kTile;                         // [2][kBQ][DS]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kTile);  // [2][kBQ] lse
  float* Dls = Ls + 2 * kBQ;                              // [2][kBQ] delta

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // accumulator rows g and g + 8 (kv rows here)
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1 (q rows here)
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kBK;  // under a causal mask the heavy tiles first
  const int n_rep = H / Hkv;

  int kv_len = kv_length ? kv_length[b] : Sk;
  kv_len = max(0, min(kv_len, Sk));

  const size_t q_stride = size_t(H) * D;
  const size_t kv_stride = size_t(Hkv) * D;
  const float scale_log2 = scale * kLog2e;

  // this warp's 16 kv rows x D columns of dk and dv, summed over the group
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dk_acc[j][c] = 0.f;
      dv_acc[j][c] = 0.f;
    }

  if (k0 < kv_len) {  // the same for the whole block
    // causal: this kv tile only receives gradients from q rows >= k0
    const int first_qt = causal ? k0 / kBQ : 0;
    const int per_head = (Sq + kBQ - 1) / kBQ - first_qt;
    const int n_steps = n_rep * per_head;  // (query head, q tile), head-major

    auto load_q = [&](int step) {
      const int h = hk * n_rep + step / per_head;
      const int q0 = (first_qt + step % per_head) * kBQ;
      const int stage = step & 1;
      const size_t q_off = (size_t(b) * Sq + q0) * q_stride + size_t(h) * D;
      cp_async_tile<D, kBQ, kMmaThreads>(Qs + stage * kTile, q + q_off, q_stride,
                                         Sq - q0);
      cp_async_tile<D, kBQ, kMmaThreads>(dOs + stage * kTile, dout + q_off,
                                         q_stride, Sq - q0);
      if (threadIdx.x < kBQ) {
        const int row = q0 + threadIdx.x;
        const bool ok = row < Sq;
        const size_t off = (size_t(b) * H + h) * Sq + (ok ? row : q0);
        cp_async4_zfill(Ls + stage * kBQ + threadIdx.x, lse + off, ok);
        cp_async4_zfill(Dls + stage * kBQ + threadIdx.x, delta + off, ok);
      }
    };

    const size_t kv_off = (size_t(b) * Sk + k0) * kv_stride + size_t(hk) * D;
    cp_async_tile<D, kBK, kMmaThreads>(Ks, k + kv_off, kv_stride, kv_len - k0);
    cp_async_tile<D, kBK, kMmaThreads>(Vs, v + kv_off, kv_stride, kv_len - k0);
    if (n_steps > 0) load_q(0);
    cp_async_commit();

    for (int step = 0; step < n_steps; ++step) {
      cp_async_wait<0>();
      __syncthreads();  // step `step` has landed; the other stage is free
      if (step + 1 < n_steps) {
        load_q(step + 1);
        cp_async_commit();
      }
      const int stage = step & 1;
      const bf16* Qt = Qs + stage * kTile;
      const bf16* dOt = dOs + stage * kTile;
      const int q0 = (first_qt + step % per_head) * kBQ;
      const bool straddle =
          k0 + kBK > kv_len || q0 + kBQ > Sq || (causal && q0 < k0 + kBK - 1);

#pragma unroll
      for (int half = 0; half < kBQ / kHalf; ++half) {
        const int qh = half * kHalf;  // first q row of this pass, in the tile
        // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 32 q columns a warp
        float st[kHalf / 8][4], dpt[kHalf / 8][4];
#pragma unroll
        for (int i = 0; i < kHalf / 8; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            st[i][c] = 0.f;
            dpt[i][c] = 0.f;
          }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ak[4], av[4];
          ldmatrix_x4(ak, frag_ptr(Ks, DS, warp * 16, kk * 16, lane));
          ldmatrix_x4(av, frag_ptr(Vs, DS, warp * 16, kk * 16, lane));
#pragma unroll
          for (int np = 0; np < kHalf / 16; ++np) {
            uint32_t bq[4], bg[4];
            ldmatrix_x4(bq, frag_ptr_nk(Qt, DS, qh + np * 16, kk * 16, lane));
            ldmatrix_x4(bg, frag_ptr_nk(dOt, DS, qh + np * 16, kk * 16, lane));
            mma_bf16(st[2 * np], ak, bq);
            mma_bf16(st[2 * np + 1], ak, bq + 2);
            mma_bf16(dpt[2 * np], av, bg);
            mma_bf16(dpt[2 * np + 1], av, bg + 2);
          }
        }

        // st becomes P^T, dpt becomes dS^T; lse and delta per column
#pragma unroll
        for (int i = 0; i < kHalf / 8; ++i) {
          const int qc = qh + i * 8 + 2 * t;  // this lane's two q rows
          const float2 l2 = *reinterpret_cast<const float2*>(Ls + stage * kBQ + qc);
          const float2 d2 = *reinterpret_cast<const float2*>(Dls + stage * kBQ + qc);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            bool ok = true;
            if (straddle) {
              const int col = k0 + warp * 16 + g + (c >> 1) * 8;  // kv column
              const int row = q0 + qc + (c & 1);                  // q row
              ok = row < Sq && col < kv_len && (!causal || col <= row);
            }
            const float lse2 = ((c & 1) ? l2.y : l2.x) * kLog2e;
            const float dl = (c & 1) ? d2.y : d2.x;
            const float p = ok ? exp2f(st[i][c] * scale_log2 - lse2) : 0.f;
            st[i][c] = p;
            dpt[i][c] = p * (dpt[i][c] - dl) * scale;
          }
        }

        // dv += P^T dO and dk += dS^T Q: A from registers, dO and Q through
        // ldmatrix.trans
#pragma unroll
        for (int j = 0; j < kHalf / 16; ++j) {
          uint32_t ap[4], ads[4];
          frag_from_acc(ap, st[2 * j], st[2 * j + 1]);
          frag_from_acc(ads, dpt[2 * j], dpt[2 * j + 1]);
#pragma unroll
          for (int np = 0; np < D / 16; ++np) {
            uint32_t bg[4], bq[4];
            ldmatrix_x4_trans(bg, frag_ptr(dOt, DS, qh + j * 16, np * 16, lane));
            ldmatrix_x4_trans(bq, frag_ptr(Qt, DS, qh + j * 16, np * 16, lane));
            mma_bf16(dv_acc[2 * np], ap, bg);
            mma_bf16(dv_acc[2 * np + 1], ap, bg + 2);
            mma_bf16(dk_acc[2 * np], ads, bq);
            mma_bf16(dk_acc[2 * np + 1], ads, bq + 2);
          }
        }
      }
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int col = k0 + warp * 16 + g + r * 8;
    if (col >= Sk) continue;
    const size_t o = (size_t(b) * Sk + col) * kv_stride + size_t(hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + o + j * 8 + 2 * t) =
          pack_bf16(dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + o + j * 8 + 2 * t) =
          pack_bf16(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O), both types

constexpr int kDeltaThreads = 256;

// the dot product of 16 bytes of a and 16 bytes of b, in fp32
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}
__device__ __forceinline__ float dot16(const bf16* a, const bf16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 fy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    sum += fx.x * fy.x + fx.y * fy.y;
  }
  return sum;
}

// out, dout: [B, Sq, H, D] (n_rows = B * Sq * H rows of D); delta: [B, H, Sq]
template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int n_rows, int Sq, int H) {
  constexpr int kVec = 16 / sizeof(T);  // elements of one 16-byte load
  constexpr int kLanes = D / kVec;      // lanes a row: 8, 16 or 32
  const size_t idx = size_t(blockIdx.x) * kDeltaThreads + threadIdx.x;
  const size_t row = idx / kLanes;
  const int part = int(idx % kLanes);
  float sum = 0.f;
  if (row < size_t(n_rows)) {
    const size_t off = row * D + size_t(part) * kVec;
    sum = dot16(out + off, dout + off);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < size_t(n_rows) && part == 0) {
    const int h = int(row % H);
    const int s = int((row / H) % Sq);
    const size_t b = row / (size_t(H) * Sq);
    delta[(b * H + h) * Sq + s] = sum;
  }
}

template <typename T, int D>
cudaError_t launch_delta(const void* out, const void* dout, float* delta, int B,
                         int Sq, int H, cudaStream_t stream) {
  constexpr int kLanes = D / (16 / int(sizeof(T)));
  const long long n_rows = (long long)B * Sq * H;
  if (n_rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long blocks = (n_rows * kLanes + kDeltaThreads - 1) / kDeltaThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T, D><<<(unsigned)blocks, kDeltaThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, int(n_rows),
      Sq, H);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launches

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* delta,
                          const int* kv_length, void* dq, int B, int Sq, int Sk,
                          int H, int Hkv, int causal, float scale,
                          cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_bwd_dq_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      kv_length, static_cast<bf16*>(dq), Sq, Sk, H, Hkv, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse, const float* delta,
                           const int* kv_length, void* dk, void* dv, int B, int Sq,
                           int Sk, int H, int Hkv, int causal, float scale,
                           cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B, (Sk + kBK - 1) / kBK);
  flash_bwd_dkv_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      kv_length, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H, Hkv,
      causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* kv_length, void* dq, int B, int Sq, int Sk,
                      int H, int Hkv, int causal, float scale,
                      cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      kv_length, static_cast<float*>(dq), Sq, Sk, H, Hkv, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const int* kv_length, void* dk, void* dv, int B, int Sq,
                       int Sk, int H, int Hkv, int causal, float scale,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B, (Sk + kBK - 1) / kBK);
  flash_bwd_dkv_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      kv_length, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H, Hkv,
      causal, scale);
  return cudaGetLastError();
}

bool shapes_ok(int B, int Sq, int Sk, int H, int Hkv, int causal) {
  // the causal bounds assume q row i is kv column i (no q_offset); B and the
  // tile counts are grid dimensions y and z
  return B > 0 && Sq > 0 && Sk > 0 && Hkv > 0 && H % Hkv == 0 &&
         (!causal || Sq == Sk) && B <= 65535 && (Sq + kBQ - 1) / kBQ <= 65535 &&
         (Sk + kBK - 1) / kBK <= 65535;
}

}  // namespace
}  // namespace dllava

// C entry points. kv_length may be null (every column valid). Each returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for a shape
// or dtype the kernel does not take. bf16 tensors run the tensor-core
// kernels, fp32 tensors the fp32 ones.
extern "C" int flash_attention_bwd_delta(const void* out, const void* dout,
                                         float* delta, int B, int Sq, int H,
                                         int D, int dtype, void* stream) {
  using namespace dllava;
  if (B <= 0 || Sq <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && D == 128)
    return launch_delta<bf16, 128>(out, dout, delta, B, Sq, H, s);
  if (dtype == kBFloat16 && D == 64)
    return launch_delta<bf16, 64>(out, dout, delta, B, Sq, H, s);
  if (dtype == kFloat32 && D == 128)
    return launch_delta<float, 128>(out, dout, delta, B, Sq, H, s);
  if (dtype == kFloat32 && D == 64)
    return launch_delta<float, 64>(out, dout, delta, B, Sq, H, s);
  return cudaErrorInvalidValue;
}

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
    return launch_dq_mma<128>(q, k, v, dout, lse, delta, kv_length, dq, B, Sq,
                              Sk, H, Hkv, causal, scale, s);
  if (dtype == kBFloat16 && D == 64)
    return launch_dq_mma<64>(q, k, v, dout, lse, delta, kv_length, dq, B, Sq, Sk,
                             H, Hkv, causal, scale, s);
  if (dtype == kFloat32 && D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, kv_length, dq, B, Sq, Sk, H,
                          Hkv, causal, scale, s);
  if (dtype == kFloat32 && D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, kv_length, dq, B, Sq, Sk, H,
                         Hkv, causal, scale, s);
  return cudaErrorInvalidValue;
}

// dk and dv are [B, Sk, Hkv, D] in the inputs' type
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       const int* kv_length, void* dk, void* dv,
                                       int B, int Sq, int Sk, int H, int Hkv,
                                       int D, int causal, float scale, int dtype,
                                       void* stream) {
  using namespace dllava;
  if (!shapes_ok(B, Sq, Sk, H, Hkv, causal)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && D == 128)
    return launch_dkv_mma<128>(q, k, v, dout, lse, delta, kv_length, dk, dv, B,
                               Sq, Sk, H, Hkv, causal, scale, s);
  if (dtype == kBFloat16 && D == 64)
    return launch_dkv_mma<64>(q, k, v, dout, lse, delta, kv_length, dk, dv, B, Sq,
                              Sk, H, Hkv, causal, scale, s);
  if (dtype == kFloat32 && D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, kv_length, dk, dv, B, Sq,
                           Sk, H, Hkv, causal, scale, s);
  if (dtype == kFloat32 && D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, kv_length, dk, dv, B, Sq, Sk,
                          H, Hkv, causal, scale, s);
  return cudaErrorInvalidValue;
}
