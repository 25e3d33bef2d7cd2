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
// D=128; CLIP N=577, H=16, D=64) the card could finish in the time it takes
// to move q, k, v and out once (about 4*S*S*D flops per (b, h) against
// 4*S*D*2 bytes); what a kernel pays for in practice is the rate of its two
// products and the shared-memory traffic that feeds them.
//
// Two kernels, chosen by the tensors' type in the C entry point:
//
// bf16 (flash_fwd_mma_kernel): both products run on the tensor cores
// (mma.sync m16n8k16, bf16 x bf16 -> fp32). One block of 4 warps per
// (64-row q tile, head, sample); a warp owns 16 q rows. Tiles stay bf16 in
// shared memory with rows of D + 8 elements (conflict-free ldmatrix, 85 KB
// at D=128, so two blocks share an SM). K and V tiles of 64 columns stream
// through a two-stage ring of 16-byte cp.async copies, the next tile in
// flight while this one is multiplied; rows at or past kv_length are
// zero-filled, never read. S = Q K^T takes K as the [n][k] operand straight
// from its row-major tile; the fp32 accumulator fragment of S, after the
// online softmax in registers, IS the A fragment of P V once packed to bf16,
// and V comes through ldmatrix.trans: P never touches shared memory and one
// __syncthreads per tile is enough. Masks are applied only on the tiles that
// straddle the diagonal or kv_length, and tiles past either bound are never
// loaded. The q tile index is the slowest grid dimension, highest first:
// under a causal mask the heavy tiles start first.
//
// fp32 (flash_fwd_kernel): full fp32 arithmetic on the CUDA cores, one block
// of 256 threads per tile with fp32 tiles in shared memory (rows padded to
// D+1); thread (r, c) owns a 4 x 4 patch of the 64 x 64 score tile and 4
// rows x D/16 columns of the output. It serves the fp32 checks, where a
// bf16 product would not do.

#include "common.cuh"

namespace dllava {
namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // kv columns per tile

// ---------------------------------------------------------------------------
// bf16: tensor cores

constexpr int kMmaThreads = 128;  // 4 warps x 16 q rows

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * size_t(kBQ + 4 * kBK) * (D + kTilePad);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ kv_length,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int Sq, int Sk, int H, int Hkv, int causal, int q_offset,
                     float scale_log2) {
  constexpr int DS = D + kTilePad;  // tile row stride
  constexpr int kTile = kBK * DS;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [kBQ][DS]
  __nv_bfloat16* Ks = Qs + kBQ * DS;                               // [2][kBK][DS]
  __nv_bfloat16* Vs = Ks + 2 * kTile;                              // [2][kBK][DS]

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
  if (causal) n_kv = min(n_kv, min(q0 + kBQ, Sq) + q_offset);
  const int n_tiles = (n_kv + kBK - 1) / kBK;

  const size_t q_stride = size_t(H) * D;
  const size_t kv_stride = size_t(Hkv) * D;
  const __nv_bfloat16* qb = q + (size_t(b) * Sq + q0) * q_stride + size_t(h) * D;
  const __nv_bfloat16* kb = k + size_t(b) * Sk * kv_stride + size_t(hk) * D;
  const __nv_bfloat16* vb = v + size_t(b) * Sk * kv_stride + size_t(hk) * D;

  auto load_kv = [&](int tile) {
    const int k0 = tile * kBK;
    const size_t off = size_t(k0) * kv_stride;
    cp_async_tile<D, kBK, kMmaThreads>(Ks + (tile & 1) * kTile, kb + off, kv_stride,
                                       kv_len - k0);
    cp_async_tile<D, kBK, kMmaThreads>(Vs + (tile & 1) * kTile, vb + off, kv_stride,
                                       kv_len - k0);
  };

  cp_async_tile<D, kBQ, kMmaThreads>(Qs, qb, q_stride, Sq - q0);
  if (n_tiles > 0) load_kv(0);
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

    // masks only where the tile straddles kv_length or the diagonal
    const bool straddle =
        k0 + kBK > kv_len || (causal && k0 + kBK - 1 > q0 + q_offset);
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] *= scale_log2;
        if (straddle) {
          const int row = q0 + warp * 16 + g + (c >> 1) * 8;
          const int col = k0 + i * 8 + 2 * t + (c & 1);
          const bool ok = col < kv_len && (!causal || col <= row + q_offset);
          if (!ok) s[i][c] = -INFINITY;
        }
      }

    // online softmax in base 2; s becomes p
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i)
        mx = fmaxf(mx, fmaxf(s[i][2 * r], s[i][2 * r + 1]));
      mx = quad_max(mx);
      const float m_new = fmaxf(m[r], mx);  // finite: m starts at kNegBig
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i) {
        const float p0 = exp2f(s[i][2 * r] - m_new);  // masked: exp2(-inf) = 0
        const float p1 = exp2f(s[i][2 * r + 1] - m_new);
        s[i][2 * r] = p0;
        s[i][2 * r + 1] = p1;
        psum += p0 + p1;
      }
      l[r] = l[r] * alpha + psum;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V: P from registers, V through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t a[4];
      frag_from_acc(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, frag_ptr(Vt, DS, j * 16, np * 16, lane));
        mma_bf16(o[2 * np], a, bv);
        mma_bf16(o[2 * np + 1], a, bv + 2);
      }
    }
  }
  cp_async_wait<0>();  // a block without kv tiles still has its q tile in flight

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;  // no valid column -> 0
    __nv_bfloat16* orow = out + (size_t(b) * Sq + row) * q_stride + size_t(h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[(size_t(b) * H + h) * Sq + row] =
          lsum > 0.f ? (m[r] + log2f(lsum)) * kLn2 : kNegBig;
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* kv_length, void* out, float* lse, int B, int Sq,
                       int Sk, int H, int Hkv, int causal, int q_offset,
                       float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  using bf16 = __nv_bfloat16;
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kv_length, static_cast<bf16*>(out), lse, Sq,
      Sk, H, Hkv, causal, q_offset, scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores

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
  if (B > 65535 || (Sq + 63) / 64 > 65535) return cudaErrorInvalidValue;
  if (dtype == kBFloat16 && D == 128)
    return launch_mma<128>(q, k, v, kv_length, out, lse, B, Sq, Sk, H, Hkv,
                           causal, q_offset, scale, s);
  if (dtype == kBFloat16 && D == 64)
    return launch_mma<64>(q, k, v, kv_length, out, lse, B, Sq, Sk, H, Hkv,
                          causal, q_offset, scale, s);
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
