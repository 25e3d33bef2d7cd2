// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dllava {

// dtype codes of the C entry points (kernels/__init__.py DTYPE_CODES); the
// one-byte codes name KV-cache storage only (ops/decode_attention.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2, kFloat8E4M3 = 3 };

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

// ----------------------------------------------------------------------------
// Pieces of the weight-only GEMVs (quant_gemv.cu) and the fused int4 MLP
// (quant_mlp.cu): the 64-column weight tile of the fp32-x kernel and its
// padded shared-memory row, cp.async copies that complete an mbarrier, the
// exact integer -> float and integer -> bf16 pair conversions, and the bf16
// tensor-core step.

constexpr int kTileCols = 64;  // output columns of one weight tile

// bytes of one tile row of the weight, and its padded stride in shared
// memory (the 16 bytes of padding spread the rows over the banks)
template <bool INT4>
constexpr int kTileBytes = INT4 ? kTileCols / 2 : kTileCols;
template <bool INT4>
constexpr int kRowStride = kTileBytes<INT4> + 16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

// waits until the barrier's phase of the given parity has completed (a
// barrier used once is waited for with parity 0; one that is reused
// alternates 0, 1, 0, ...)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity = 0) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}

// arrives on `bar` once every cp.async this thread started so far has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
}

// Byte i of `biased` (an unsigned value v < 256) as the float 2^23 + v.
__device__ __forceinline__ float magic_float(uint32_t biased, int i) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | i));
}
// int8 byte i of u, exactly: b xor 0x80 is b + 128
__device__ __forceinline__ float s8_at(uint32_t u, int i) {
  return magic_float(u ^ 0x80808080u, i) - 8388736.f;  // 2^23 + 128
}
// int4 low / high nibble of byte i of u, exactly: n xor 8 is n + 8
__device__ __forceinline__ float lo4_at(uint32_t u, int i) {
  return magic_float((u & 0x0F0F0F0Fu) ^ 0x08080808u, i) - 8388616.f;  // 2^23 + 8
}
__device__ __forceinline__ float hi4_at(uint32_t u, int i) {
  return magic_float(((u >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, i) - 8388616.f;
}

// element idx of a bf16 or fp32 array (DType code) as a float
__device__ __forceinline__ float load_float(const void* p, size_t idx, int dtype) {
  return dtype == kBFloat16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[idx])
             : static_cast<const float*>(p)[idx];
}
// Two weights straight to a bf16x2 register (the B operand of mma_bf16 holds
// K rows 2t and 2t + 1 of a column side by side), exactly and without a trip
// through fp32: a bf16 with the bits 0x4300 | m is 128 + m for m < 128, and
// the difference of two such numbers is exact.
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}
// byte i (0 or 1) of w's low half into bits 0-7 and byte i of its high half
// into bits 16-23 (bits 8-15 and 24-31 repeat them and are masked off by the
// callers)
__device__ __forceinline__ uint32_t pair_bytes(uint32_t w, int i) {
  return __byte_perm(w, w, i | (i << 4) | ((2 + i) << 8) | ((2 + i) << 12));
}
// int8 bytes of a pair: b = (128 + b[6:0]) - (128 + 128 b[7])
__device__ __forceinline__ uint32_t s8_pair(uint32_t pair) {
  return bf16x2_sub((pair & 0x007F007Fu) | 0x43004300u, (pair & 0x00800080u) | 0x43004300u);
}
// int4 low / high nibbles of a pair: n = (128 + (n xor 8)) - 136
__device__ __forceinline__ uint32_t lo4_pair(uint32_t pair) {
  return bf16x2_sub((pair & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
}
__device__ __forceinline__ uint32_t hi4_pair(uint32_t pair) {
  return bf16x2_sub(((pair >> 4) & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
}

__device__ __forceinline__ float load_scale(const void* s, int col, int dtype) {
  return load_float(s, col, dtype);
}

__device__ __forceinline__ void store_out(void* y, size_t idx, float v, int dtype) {
  if (dtype == kBFloat16)
    static_cast<__nv_bfloat16*>(y)[idx] = __float2bfloat16(v);
  else
    static_cast<float*>(y)[idx] = v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // exact for |v| <= 256
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ----------------------------------------------------------------------------
// Pieces shared by the tensor-core attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): bf16 shared-memory tiles filled by zero-filling
// cp.async, ldmatrix fragment loads, and reductions over the four lanes that
// share a row of an mma accumulator.
//
// Fragments of mma.m16n8k16 (lane = 4 * g + t): A holds rows g / g + 8 and k
// columns 2t, 2t + 1 / + 8; B holds k rows 2t, 2t + 1 / + 8 of column g; the
// accumulator holds rows g / g + 8 and columns 2t, 2t + 1. Two neighbouring
// accumulator blocks [16 x 8] packed to bf16 are therefore one A fragment
// [16 x 16] of the next product (frag_from_acc).

// Padding of a bf16 tile row, in elements: rows of D + 8 elements are 16-byte
// aligned and the 8 rows of one ldmatrix matrix fall into 8 different groups
// of four banks (the row stride is 4 words mod 32), so ldmatrix is
// conflict-free.
constexpr int kTilePad = 8;

// 16-byte (4-byte) async copy; when !valid nothing is read and zeros land
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// waits until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [0, ROWS) of a [rows, D] bf16 slice with row stride `row_stride`
// (elements) into shared-memory rows of D + kTilePad elements, 16 bytes a
// copy; rows >= n_valid (n_valid >= 1) are zero-filled and never read.
// Called by all THREADS threads of a block; the caller commits and waits.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void cp_async_tile(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src,
                                              size_t row_stride, int n_valid) {
  constexpr int kVecPerRow = D / 8;
  static_assert((ROWS * kVecPerRow) % THREADS == 0, "tile / threads");
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * kVecPerRow; idx += THREADS) {
    const int row = idx / kVecPerRow;
    const int col = (idx % kVecPerRow) * 8;
    const bool ok = row < n_valid;
    cp_async16_zfill(dst + row * (D + kTilePad) + col,
                     src + (ok ? row * row_stride + col : 0), ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// two 8 x 8 b16 matrices, transposed: lanes 0-7 hand in the rows of the first,
// lanes 8-15 those of the second
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The address a lane hands to ldmatrix.x4 for the 16 x 16 block at
// (row0, col0) of a row-major tile, matrices ordered (rows 0-7, cols 0-7),
// (rows 8-15, cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols 8-15).
// Plain, on an [m][k] tile: the A fragment a0..a3 of rows row0.. and k
// columns col0... With .trans, on a [k][n] tile: r[0], r[1] are the B
// fragment of k rows row0.. and columns col0..col0+7, r[2], r[3] that of
// columns col0+8..col0+15.
__device__ __forceinline__ const __nv_bfloat16* frag_ptr(const __nv_bfloat16* tile,
                                                         int stride, int row0,
                                                         int col0, int lane) {
  return tile + (row0 + (lane & 15)) * stride + col0 + (lane >> 4) * 8;
}
// The same for a B operand held as an [n][k] tile (plain ldmatrix.x4),
// matrices ordered (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
// (n 8-15, k 8-15): r[0], r[1] are the B fragment of columns n0..n0+7 and k
// rows k0.., r[2], r[3] that of columns n0+8..n0+15.
__device__ __forceinline__ const __nv_bfloat16* frag_ptr_nk(const __nv_bfloat16* tile,
                                                            int stride, int n0,
                                                            int k0, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * stride + k0 +
         ((lane >> 3) & 1) * 8;
}

// Two neighbouring fp32 accumulator blocks (columns 0-7 and 8-15 of a 16-row
// strip) as the bf16 A fragment of the next product.
__device__ __forceinline__ void frag_from_acc(uint32_t* a, const float* lo,
                                              const float* hi) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// over the four lanes (t = 0..3) that hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Blocks that each wrote a partial result to global memory meet here: called
// by every thread of a block after its writes, it is true in the last of the
// n blocks to arrive on *ticket (which starts at 0), and there every other
// block's writes are visible (read them with __ldcg). That block puts
// *ticket back to 0 once it is done.
__device__ __forceinline__ bool last_block_to_arrive(int* ticket, int n) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == n - 1;
  __syncthreads();
  const bool is_last = last != 0;
  if (is_last) __threadfence();
  return is_last;
}

// The merge of partial softmax states (m, l, acc), in the order given: the
// first call sets the state, a state with l == 0 has seen no column.
struct Merged {
  float m = kNegBig, l = 0.f, o = 0.f;
  __device__ __forceinline__ void add(float m2, float l2, float o2) {
    if (l2 == 0.f) return;
    const float mx = fmaxf(m, m2);
    const float w1 = exp2f(m - mx), w2 = exp2f(m2 - mx);
    l = l * w1 + l2 * w2;
    o = o * w1 + o2 * w2;
    m = mx;
  }
};

inline int sm_count() {
  static int count = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return count;
}

// ----------------------------------------------------------------------------
// The work list of the persistent weight-streaming kernels (gemv_tc_kernel in
// quant_gemv.cu, both phases of q4_mlp_kernel in quant_mlp.cu): a cell is a
// column tile times a slice of K, `chunks` units of K rows (a unit is 32 KB of
// weights); cell c = slice * tiles + tile, and block b takes cells b, b +
// grid, ... Mirrored by ops/quant_matmul.py (gemv_plan, mlp_plan).

constexpr int kMaxSlices = 16;

struct TcPlan {
  int tiles;   // column tiles of all weights
  int slices;  // K slices of a tile: blocks that share one tile's sum
  int chunks;  // units of a slice (the last slice may have fewer)
  int grid;    // persistent blocks
};

// The slices that cost the fewest half unit times: waves of cells over the SMs
// times two for each unit of a cell, plus `sliced_cost` for a cell's partial
// tile and its share of the sum when the tiles are sliced at all; ties go to
// fewer slices.
inline TcPlan tc_plan(int tiles, int K, int unit_rows, int sliced_cost = 1) {
  const int nkc = (K + unit_rows - 1) / unit_rows, sms = sm_count();
  TcPlan best{};
  long best_cost = -1;
  for (int want = 1; want <= kMaxSlices && want <= nkc; ++want) {
    const int chunks = (nkc + want - 1) / want;
    const int slices = (nkc + chunks - 1) / chunks;
    const long cells = long(tiles) * slices;
    const long cost = (cells + sms - 1) / sms * (2 * chunks + (slices > 1 ? sliced_cost : 0));
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = TcPlan{tiles, slices, chunks, static_cast<int>(cells < sms ? cells : sms)};
    }
  }
  return best;
}

}  // namespace dllava
