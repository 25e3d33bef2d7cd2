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
// not; the sums are fp32; N in eps/N is the true sequence length, and the
// eps/N term covers EVERY column j < N, also those the causal mask hides,
// so (eps/N) * sum_j v_j rides along. Layouts are the JAX ones: q/out
// [B, S, H, D], k/v [B, S, Hkv, D], policy [B, S] fp32.
//
// What bounds it on the H100: operations, like the forward kernel K1 (two
// products per tile pair, of which the training shape needs ~90 GFLOP);
// the S x S score matrix never reaches device memory.
//
// Blocks run in no order and share nothing, so the column sum sum_j v_j,
// which the TPU kernel gathers in a tail loop of every program, is a small
// kernel of its own here (policy_vsum_kernel: one block per (kv head,
// sample), written to a [B, Hkv, D] fp32 scratch the wrapper allocates),
// launched on the same stream before the main kernel. Two main kernels,
// chosen by the tensors' type in the C entry point:
//
// bf16 (flash_policy_fwd_mma_kernel): K1's tensor-core design. One block of
// 4 warps per (64-row q tile, head, sample), heavy tiles first; a warp owns
// 16 q rows. K and V tiles of 64 columns and the tile's 64 policy values
// stream through a two-stage cp.async ring (zero-filled past S); tiles past
// the diagonal are never loaded, and the masks and the diagonal escape are
// applied only on the tile that straddles the diagonal or S. S = Q K^T runs
// on mma.sync from the unscaled bf16 Q (a bf16 tile must not round a scaled
// Q); the scale and log2(e) are applied to the fp32 scores. The row maximum,
// e = exp(s - m) * p' and its row sum stay in fp32 registers. The TPU kernel
// multiplies the fp32 e by V in fp32, where K1 would round P to bf16: here
// each fragment of e is split into hi = bf16(e) and lo = bf16(e - hi), and
// both meet the same V fragment (ldmatrix.trans) in two mma.sync, which
// keeps e to ~16 bits, the error of the output's own bf16 rounding. Neither
// e nor its split touches shared memory: one __syncthreads a tile.
//
// fp32 (flash_policy_fwd_kernel): FP32 FMAs on the CUDA cores, one block of
// 256 threads per (q tile, head, sample) walking kv tiles up to the
// diagonal with an online renormalization; thread (r, c) owns the 4 x 4
// score patch (rows r*4+i, columns c+16*j) and 4 rows x D/16 columns of the
// accumulator. It serves the fp32 checks, where a bf16 product would not do.

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

// vsum[b, hk, :] = sum over all S rows of v[b, :, hk, :]. One block of
// kVsumThreads per (kv head, sample): thread (r, c) sums 8 columns (one or two
// 16-byte loads a row) over rows r, r + R, ... in order, with R = 8 kVsumThreads
// / D row lanes and several rows' loads in flight; the R partial sums of a
// column meet in shared memory in lane order, so the sum is the same bits on
// every call.
constexpr int kVsumThreads = 512;

template <typename T, int D>
__global__ void __launch_bounds__(kVsumThreads)
policy_vsum_kernel(const T* __restrict__ v, float* __restrict__ vsum, int S,
                   int Hkv) {
  constexpr int kGroups = D / 8;                   // 8-column groups of a row
  constexpr int kLanes = kVsumThreads / kGroups;   // row lanes
  __shared__ float part[kLanes][D];
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int c = threadIdx.x % kGroups * 8, r = threadIdx.x / kGroups;
  const size_t stride = size_t(Hkv) * D;
  const T* vb = v + size_t(b) * S * stride + size_t(hk) * D + c;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int j = r; j < S; j += kLanes) {
    float f[8];
    load_vec<T, 4>(vb + size_t(j) * stride, f);
    load_vec<T, 4>(vb + size_t(j) * stride + 4, f + 4);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += f[e];
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) part[r][c + e] = acc[e];
  __syncthreads();
  if (threadIdx.x < D) {
    float sum = 0.f;
#pragma unroll 8
    for (int l = 0; l < kLanes; ++l) sum += part[l][threadIdx.x];
    vsum[(size_t(b) * Hkv + hk) * D + threadIdx.x] = sum;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores

constexpr int kMmaThreads = 128;  // 4 warps x 16 q rows

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * size_t(kBQ + 4 * kBK) * (D + kTilePad) +
         sizeof(float) * 2 * kBK;
}

// Two neighbouring fp32 accumulator blocks of e (columns 0-7 and 8-15 of a
// 16-row strip) as the A fragments of hi = bf16(e) and lo = bf16(e - hi);
// e - hi is exact in fp32.
__device__ __forceinline__ void split_frag(uint32_t* hi, uint32_t* lo, const float* a,
                                           const float* b) {
  const float v[8] = {a[0], a[1], a[2], a[3], b[0], b[1], b[2], b[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(v[2 * i] - __low2float(h), v[2 * i + 1] - __high2float(h));
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_policy_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ policy,
                            const float* __restrict__ vsum,
                            __nv_bfloat16* __restrict__ out, int S, int H, int Hkv,
                            float scale_log2, float eps) {
  constexpr int DS = D + kTilePad;  // tile row stride
  constexpr int kTile = kBK * DS;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [kBQ][DS]
  __nv_bfloat16* Ks = Qs + kBQ * DS;                               // [2][kBK][DS]
  __nv_bfloat16* Vs = Ks + 2 * kTile;                              // [2][kBK][DS]
  float* Ps = reinterpret_cast<float*>(Vs + 2 * kTile);            // [2][kBK] policy

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // accumulator rows g and g + 8
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1 of each 8-block
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heavy tiles first
  const int hk = h / (H / Hkv);
  const int n_kv = min(q0 + kBQ, S);  // causal: columns up to the diagonal
  const int n_tiles = (n_kv + kBK - 1) / kBK;

  const size_t q_stride = size_t(H) * D;
  const size_t kv_stride = size_t(Hkv) * D;
  const __nv_bfloat16* qb = q + (size_t(b) * S + q0) * q_stride + size_t(h) * D;
  const __nv_bfloat16* kb = k + size_t(b) * S * kv_stride + size_t(hk) * D;
  const __nv_bfloat16* vb = v + size_t(b) * S * kv_stride + size_t(hk) * D;
  const float* pb = policy + size_t(b) * S;

  auto load_kv = [&](int tile) {
    const int k0 = tile * kBK;
    const size_t off = size_t(k0) * kv_stride;
    cp_async_tile<D, kBK, kMmaThreads>(Ks + (tile & 1) * kTile, kb + off, kv_stride, S - k0);
    cp_async_tile<D, kBK, kMmaThreads>(Vs + (tile & 1) * kTile, vb + off, kv_stride, S - k0);
    if (threadIdx.x < kBK) {
      const bool ok = k0 + int(threadIdx.x) < S;
      cp_async4_zfill(Ps + (tile & 1) * kBK + threadIdx.x, pb + (ok ? k0 + threadIdx.x : 0), ok);
    }
  };

  cp_async_tile<D, kBQ, kMmaThreads>(Qs, qb, q_stride, S - q0);
  load_kv(0);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  float m[2] = {kNegBig, kNegBig};
  float l[2] = {0.f, 0.f};  // per-lane partial sums, reduced at the end

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<0>();
    __syncthreads();  // tile `tile` has landed; the other stage is free
    if (tile + 1 < n_tiles) {
      load_kv(tile + 1);
      cp_async_commit();
    }
    const __nv_bfloat16* Kt = Ks + (tile & 1) * kTile;
    const __nv_bfloat16* Vt = Vs + (tile & 1) * kTile;
    const float* Pt = Ps + (tile & 1) * kBK;
    const int k0 = tile * kBK;

    // S = Q K^T: 16 rows x 64 columns a warp
    float s[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, frag_ptr(Qs, DS, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, frag_ptr_nk(Kt, DS, np * 16, kk * 16, lane));
        mma_bf16(s[2 * np], a, bk);
        mma_bf16(s[2 * np + 1], a, bk + 2);
      }
    }

    // the causal mask and the diagonal escape only where the tile straddles
    // the diagonal (tiles are aligned: the one at q0) or S
    const bool straddle = k0 + kBK > S || k0 >= q0;
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] *= scale_log2;
        if (straddle) {
          const int row = q0 + warp * 16 + g + (c >> 1) * 8;
          const int col = k0 + i * 8 + 2 * t + (c & 1);
          if (col > row || col >= S) s[i][c] = -INFINITY;
        }
      }

    // online softmax in base 2, the maximum over the masked scores whatever
    // the policy; s becomes e = exp(s - m) * p'
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + r * 8;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i)
        mx = fmaxf(mx, fmaxf(s[i][2 * r], s[i][2 * r + 1]));
      mx = quad_max(mx);
      const float m_new = fmaxf(m[r], mx);  // finite: m starts at kNegBig
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float esum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int cl = i * 8 + 2 * t + c;
          const float pol = straddle && k0 + cl == row ? 1.f : Pt[cl];
          const float e = exp2f(s[i][2 * r + c] - m_new) * pol;  // masked: exp2(-inf) = 0
          s[i][2 * r + c] = e;
          esum += e;
        }
      l[r] = l[r] * alpha + esum;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

    // O += e V: e split into hi + lo, both from registers, V through
    // ldmatrix.trans
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t hi[4], lo[4];
      split_frag(hi, lo, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, frag_ptr(Vt, DS, j * 16, np * 16, lane));
        mma_bf16(o[2 * np], hi, bv);
        mma_bf16(o[2 * np + 1], hi, bv + 2);
        mma_bf16(o[2 * np], lo, bv);
        mma_bf16(o[2 * np + 1], lo, bv + 2);
      }
    }
  }

  const float eps_n = eps / float(S);
  const float* vs = vsum + (size_t(b) * Hkv + hk) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / (quad_sum(l[r]) + eps);
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= S) continue;
    __nv_bfloat16* orow = out + (size_t(b) * S + row) * q_stride + size_t(h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(orow + col) =
          pack_bf16((o[j][2 * r] + eps_n * vs[col]) * inv,
                    (o[j][2 * r + 1] + eps_n * vs[col + 1]) * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_policy_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ policy,
                        const float* __restrict__ vsum, float* __restrict__ out,
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
  const float* qb = q + (size_t(b) * S + q0) * q_stride + size_t(h) * D;
  const float* kb = k + size_t(b) * S * kv_stride + size_t(hk) * D;
  const float* vb = v + size_t(b) * S * kv_stride + size_t(hk) * D;
  const float* pb = policy + size_t(b) * S;

  load_tile<float, D, kBQ, kThreads>(Qs, DP, qb, q_stride, S - q0, scale_log2);

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
    load_tile<float, D, kBK, kThreads>(Ks, DP, kb + size_t(k0) * kv_stride,
                                   kv_stride, n_kv - k0, 1.f);
    load_tile<float, D, kBK, kThreads>(Vs, D, vb + size_t(k0) * kv_stride,
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
    float* orow = out + (size_t(b) * S + row) * q_stride + size_t(h) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      orow[c + 16 * jj] =
          (acc[i][jj] + eps_n * vs[c + 16 * jj]) * inv;
  }
}

// the column sum of v, then the main kernel, on `stream`
template <typename T, int D, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, int threads, const void* q,
                   const void* k, const void* v, const float* policy, float* vsum, void* out,
                   int B, int S, int H, int Hkv, float scale, float eps, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  policy_vsum_kernel<T, D><<<dim3(Hkv, B), kVsumThreads, 0, stream>>>(
      static_cast<const T*>(v), vsum, S, Hkv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), policy, vsum,
                                          static_cast<T*>(out), S, H, Hkv, scale * kLog2e, eps);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* policy,
                       float* vsum, void* out, int B, int S, int H, int Hkv, float scale,
                       float eps, cudaStream_t stream) {
  // the q tile index is the slowest grid dimension, highest first
  return launch<__nv_bfloat16, D>(flash_policy_fwd_mma_kernel<D>, mma_smem_bytes<D>(),
                                  dim3(H, B, (S + kBQ - 1) / kBQ), kMmaThreads, q, k, v,
                                  policy, vsum, out, B, S, H, Hkv, scale, eps, stream);
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, const float* policy,
                       float* vsum, void* out, int B, int S, int H, int Hkv, float scale,
                       float eps, cudaStream_t stream) {
  return launch<float, D>(flash_policy_fwd_kernel<D>, policy_smem_bytes<D>(),
                          dim3((S + kBQ - 1) / kBQ, H, B), kThreads, q, k, v, policy, vsum,
                          out, B, S, H, Hkv, scale, eps, stream);
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
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || (S + 63) / 64 > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && D == 128)
    return launch_mma<128>(q, k, v, policy, vsum, out, B, S, H, Hkv, scale, eps, s);
  if (dtype == kBFloat16 && D == 64)
    return launch_mma<64>(q, k, v, policy, vsum, out, B, S, H, Hkv, scale, eps, s);
  if (dtype == kFloat32 && D == 128)
    return launch_fma<128>(q, k, v, policy, vsum, out, B, S, H, Hkv, scale, eps, s);
  if (dtype == kFloat32 && D == 64)
    return launch_fma<64>(q, k, v, policy, vsum, out, B, S, H, Hkv, scale, eps, s);
  return cudaErrorInvalidValue;
}
