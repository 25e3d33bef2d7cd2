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
// card's ~295 flop/byte balance point. So every live row is read once and
// nothing past `bound`, and the design is about keeping enough bytes in
// flight on every SM:
// - the live length is split over blocks (flash-decoding): grid (Hkv, B,
//   n_split), the split chosen on the host from the shapes alone (the
//   lengths live on the device), so that a call has at least about one block
//   an SM (measured: past that, more splits buy nothing at these shapes).
//   Block z owns cache rows [z * chunk, (z + 1) * chunk) below the bound and
//   above the window's first row; a block with no such row leaves a neutral
//   state. The current token's column belongs to split 0;
// - a block streams its rows as tiles of 4-16 KB of K and as much of V
//   through a ring of kStages shared-memory stages filled by 16-byte
//   cp.async copies (rows past the bound are zero-filled, not read), so the
//   next tiles are in flight while this one is multiplied. 16 bytes a lane
//   whatever the storage type: a row of D elements is D * size / 16 lanes
//   (16 for bf16 at D = 128, 8 for a one-byte type), a warp instruction
//   covers 2-8 rows, and a dot product reduces over that many lanes only;
// - a group of lanes that shares a row runs its own online softmax (base 2,
//   fp32, scale * log2(e) folded into q) over the 4 rows it owns in a tile:
//   4 independent dot products, one maximum and one rescale of the
//   accumulator a tile. Groups, then warps, merge once at the end of the
//   block;
// - the kernel is written over "query rows per KV head" (nq: the GQA group
//   today, group x M chunk queries for the M-query form later). A warp
//   holds one query row in registers when nq is 1 and two otherwise; the
//   warps divide the query rows first and the tile's rows second;
// - with n_split > 1 a block writes (m, l, acc) to an fp32 workspace; the
//   last block of a (kv head, sample) to arrive (a ticket from an atomicAdd
//   after __threadfence) merges the splits in index order, writes `out` and
//   resets the ticket. The order of every sum is fixed by the shapes, so two
//   calls give the same bits. Still one launch a call.
// Left for later: the M-query form itself (extend_attend_appended), and
// tensor cores for it.

#include <cuda_fp8.h>

#include "common.cuh"

namespace dllava {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;        // tiles in the shared-memory ring
constexpr int kRowsPerGroup = 4;  // rows of a tile a lane group owns
constexpr int kMaxQ = 8;          // query rows per kv head
constexpr int kMaxSplit = 32;
// a tile is at most kRowsPerGroup rows for each of the block's lane groups:
// 4 * 256 lanes * 16 bytes of K, as much of V, and a scale per row
constexpr int kTileBytes = kRowsPerGroup * kThreads * 16;
constexpr int kMaxTileRows = kRowsPerGroup * kThreads / 4;  // 4 lanes a row at least
constexpr int kStageBytes = 2 * kTileBytes + 2 * 4 * kMaxTileRows;
constexpr int kSmemBytes = kStages * kStageBytes;

struct Fp8 {  // one e4m3 byte
  unsigned char x;
};

// 16 stored bytes -> 16 / sizeof(S) floats, exactly
template <typename S>
__device__ __forceinline__ void convert16(const uint4& raw, float* f);
template <>
__device__ __forceinline__ void convert16<float>(const uint4& raw, float* f) {
  f[0] = __uint_as_float(raw.x); f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z); f[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void convert16<__nv_bfloat16>(const uint4& raw, float* f) {
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its float
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}
template <>
__device__ __forceinline__ void convert16<signed char>(const uint4& raw, float* f) {
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t) f[4 * i + t] = s8_at(u[i], t);
}
template <>
__device__ __forceinline__ void convert16<Fp8>(const uint4& raw, float* f) {
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>((u[i] >> (16 * t)) & 0xFFFFu), __NV_E4M3);
      const float2 v = __half22float2(__half2(h));
      f[4 * i + 2 * t] = v.x;
      f[4 * i + 2 * t + 1] = v.y;
    }
}

// N (4, 8 or 16) consecutive elements of a bf16 or fp32 array (DType code),
// from element `at` (a multiple of N), with 8- or 16-byte loads
template <int N>
__device__ __forceinline__ void load_row(const void* p, size_t at, int dtype, float* out) {
  if (dtype == kBFloat16) {
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(p) + at;
    if constexpr (N == 4) {
      load_vec<__nv_bfloat16, 4>(src, out);
    } else {
#pragma unroll
      for (int i = 0; i < N; i += 8)
        convert16<__nv_bfloat16>(*reinterpret_cast<const uint4*>(src + i), out + i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      load_vec<float, 4>(static_cast<const float*>(p) + at + i, out + i);
  }
}

struct DecodeArgs {
  const void* q;        // [B, 1, H, D], q_dtype
  const void* k_cache;  // [B, max_len, Hkv, D], the storage type
  const void* v_cache;
  const void* k_cur;    // [B, 1, Hkv, D], q_dtype
  const void* v_cur;
  const int* length;    // [B] attend bound
  const __nv_bfloat16* k_scale;  // [B, max_len, Hkv] with int8 storage, else null
  const __nv_bfloat16* v_scale;
  const int* q_pos;     // [B] with a window
  void* out;            // [B, 1, H, D], q_dtype
  float* ws;            // n_split > 1: [B, Hkv, n_split, nq, D + 2] partial states
  int* tickets;         // n_split > 1: [B, Hkv], zero between launches
  int max_len, H, Hkv, n_split, chunk, window, q_dtype;
  float scale_log2;
};

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

// S: storage type of the cache; q, k_cur, v_cur and out are a.q_dtype. QW:
// query rows a warp holds in registers (1 when nq == 1, else 2).
template <typename S, int D, int QW>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const DecodeArgs a) {
  constexpr int ES = sizeof(S);
  constexpr int EPL = 16 / ES;   // elements a lane holds of a row
  constexpr int LPR = D / EPL;   // lanes that share a row
  constexpr int GPW = 32 / LPR;  // lane groups (rows a pass) of a warp
  constexpr int RB = D * ES;     // bytes of a row
  constexpr int U = kRowsPerGroup;
  static_assert(LPR >= 4 && LPR <= 32, "row lanes");
  extern __shared__ __align__(16) unsigned char smem[];

  const int hk = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int nq = a.H / a.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warps divide the query rows first (QW each), the tile's rows second
  const int wr_n = (nq + QW - 1) / QW;  // 1..4
  const int wk_n = kWarps / wr_n;                     // 8, 4, 2, 2
  const int wr = warp % wr_n, wk = warp / wr_n;
  const bool idle = wk >= wk_n;  // warps left over with three query-row groups
  const int q0 = wr * QW;
  const int g = lane / LPR, j = lane % LPR;
  const int pass_rows = GPW * wk_n;       // rows the block covers with one pass
  const int tile_rows = U * pass_rows;    // <= kMaxTileRows
  const bool scaled = a.k_scale != nullptr;  // int8 storage

  const int len = max(0, min(a.length[b], a.max_len));
  // first visible row: with a window, column j needs q_pos - j < window
  const int first = a.window > 0 ? min(len, max(0, a.q_pos[b] - a.window + 1)) : 0;
  const int c0 = z * a.chunk;
  const int c1 = min(len, c0 + a.chunk);
  const int lo = max(c0, first);  // the block's rows are [lo, c1)
  int t0 = 0, nt = 0;             // its tiles: t0 .. t0 + nt - 1, tile t at c0 + t * tile_rows
  if (lo < c1) {
    t0 = (lo - c0) / tile_rows;
    nt = (c1 - c0 + tile_rows - 1) / tile_rows - t0;
  }

  // this lane's EPL columns of the warp's query rows, times scale * log2(e)
  float qv[QW][EPL], acc[QW][EPL], m[QW], l[QW];
#pragma unroll
  for (int rr = 0; rr < QW; ++rr) {
    m[rr] = kNegBig;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[rr][e] = qv[rr][e] = 0.f;
    if (q0 + rr < nq) {
      load_row<EPL>(a.q, (size_t(b) * a.H + hk * nq + q0 + rr) * D + j * EPL, a.q_dtype,
                    qv[rr]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[rr][e] *= a.scale_log2;
    }
  }

  const size_t row_stride = size_t(a.Hkv) * RB;  // bytes
  const size_t head_at = (size_t(b) * a.max_len * a.Hkv + hk) * RB;
  const unsigned char* kc = static_cast<const unsigned char*>(a.k_cache) + head_at;
  const unsigned char* vc = static_cast<const unsigned char*>(a.v_cache) + head_at;
  const size_t scale_at = size_t(b) * a.max_len * a.Hkv + hk;  // + row * Hkv

  auto stage_k = [&](int s) { return smem + s * kStageBytes; };
  auto stage_scales = [&](int s) {
    return reinterpret_cast<float*>(smem + s * kStageBytes + 2 * kTileBytes);
  };
  // cp.async copies of tile t into stage s; rows outside [lo, c1) are
  // zero-filled and not read
  auto issue = [&](int t, int s) {
    unsigned char* kd = stage_k(s);
    const int base = c0 + t * tile_rows;
    for (int c = tid; c < tile_rows * LPR; c += kThreads) {
      const int row = c / LPR, part = c % LPR;
      const int gr = base + row;
      const bool ok = gr >= lo && gr < c1;
      const size_t src = ok ? gr * row_stride + part * 16 : 0;
      cp_async16_zfill(kd + row * RB + part * 16, kc + src, ok);
      cp_async16_zfill(kd + kTileBytes + row * RB + part * 16, vc + src, ok);
    }
  };
  // the int8 scales of row `tid` of tile t (threads below tile_rows)
  auto load_scales = [&](int t, float& ks, float& vs) {
    const int gr = c0 + t * tile_rows + tid;
    ks = vs = 0.f;
    if (tid < tile_rows && gr >= lo && gr < c1) {
      ks = __bfloat162float(a.k_scale[scale_at + size_t(gr) * a.Hkv]);
      vs = __bfloat162float(a.v_scale[scale_at + size_t(gr) * a.Hkv]);
    }
  };
  auto store_scales = [&](int s, float ks, float vs) {
    if (tid < tile_rows) {
      stage_scales(s)[tid] = ks;
      stage_scales(s)[kMaxTileRows + tid] = vs;
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) {
      issue(t0 + s, s);
      if (scaled) {
        float ks, vs;
        load_scales(t0 + s, ks, vs);
        store_scales(s, ks, vs);
      }
    }
    cp_async_commit();
  }

  // split 0 owns the current token's column: its score for every query row
  // and this thread's column of its V, loaded while the first tiles fly
  __shared__ float sm_cur[kMaxQ];
  const size_t cur_at = (size_t(b) * a.Hkv + hk) * D;
  float v_cur = 0.f;
  if (z == 0) {
    for (int qi = warp; qi < nq; qi += kWarps) {
      const size_t q_at = (size_t(b) * a.H + hk * nq + qi) * D;
      float d = 0.f;
      for (int e = lane; e < D; e += 32)
        d = fmaf(load_float(a.q, q_at + e, a.q_dtype) * a.scale_log2,
                 load_float(a.k_cur, cur_at + e, a.q_dtype), d);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      if (lane == 0) sm_cur[qi] = d;
    }
    v_cur = load_float(a.v_cur, cur_at + tid % D, a.q_dtype);
  }

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i have landed
    __syncthreads();               // everyone's have, and tile i - 1 is consumed
    const int nx = i + kStages - 1, nxs = nx % kStages;
    float ks_nx = 0.f, vs_nx = 0.f;
    if (nx < nt) {
      issue(t0 + nx, nxs);
      if (scaled) load_scales(t0 + nx, ks_nx, vs_nx);  // lands during the math below
    }
    cp_async_commit();

    if (!idle) {
      const unsigned char* kt = stage_k(i % kStages);
      const float* sc = stage_scales(i % kStages);
      const int base = c0 + (t0 + i) * tile_rows;
      // the lane's rows: row0 + u * pass_rows of the tile; visible iff the
      // cache row lies in [lo, c1)
      const int row0 = wk * GPW + g;
      const unsigned span = c1 - lo;
      auto visible = [&](int u) {
        return unsigned(base + row0 + u * pass_rows - lo) < span;
      };
      float s[QW][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = row0 + u * pass_rows;
        float kf[EPL];
        convert16<S>(*reinterpret_cast<const uint4*>(kt + row * RB + j * 16), kf);
#pragma unroll
        for (int rr = 0; rr < QW; ++rr) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) d = fmaf(qv[rr][e], kf[e], d);
          s[rr][u] = d;
        }
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int rr = 0; rr < QW; ++rr)
#pragma unroll
          for (int u = 0; u < U; ++u)
            s[rr][u] += __shfl_xor_sync(0xffffffffu, s[rr][u], off);
      float p[QW][U];
#pragma unroll
      for (int rr = 0; rr < QW; ++rr) {
        float mx = m[rr];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (scaled) s[rr][u] *= sc[row0 + u * pass_rows];
          if (visible(u)) mx = fmaxf(mx, s[rr][u]);
        }
        const float alpha = exp2f(m[rr] - mx);
        m[rr] = mx;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[rr][u] = visible(u) ? exp2f(s[rr][u] - mx) : 0.f;
          sum += p[rr][u];
        }
        l[rr] = l[rr] * alpha + sum;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[rr][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = row0 + u * pass_rows;
        float vf[EPL];
        convert16<S>(*reinterpret_cast<const uint4*>(kt + kTileBytes + row * RB + j * 16),
                     vf);
        const float vs = scaled ? sc[kMaxTileRows + row] : 1.f;
#pragma unroll
        for (int rr = 0; rr < QW; ++rr) {
          const float pv = p[rr][u] * vs;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[rr][e] = fmaf(pv, vf[e], acc[rr][e]);
        }
      }
    }
    if (scaled && nx < nt) store_scales(nxs, ks_nx, vs_nx);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the merge buffers below reuse it

  // the lane groups of a warp merge by shuffles (a group that saw no row has
  // m == kNegBig and l == 0, so its weight is 0 or meets zeros)
#pragma unroll
  for (int rr = 0; rr < QW; ++rr) {
    float mx = m[rr];
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float w = exp2f(m[rr] - mx);
    m[rr] = mx;
    l[rr] *= w;
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], off);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[rr][e] *= w;
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        acc[rr][e] += __shfl_xor_sync(0xffffffffu, acc[rr][e], off);
    }
  }
  float* sm_m = reinterpret_cast<float*>(smem);  // [kWarps][QW]
  float* sm_l = sm_m + kWarps * QW;
  float* sm_acc = sm_l + kWarps * QW;            // [kWarps][QW][D]
  if (g == 0) {
#pragma unroll
    for (int rr = 0; rr < QW; ++rr) {
      if (j == 0) {
        sm_m[warp * QW + rr] = m[rr];
        sm_l[warp * QW + rr] = l[rr];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        sm_acc[(warp * QW + rr) * D + j * EPL + e] = acc[rr][e];
    }
  }
  __syncthreads();

  // the block's state for every (query row, column): warps in row order,
  // then the current token
  const size_t pair = size_t(b) * a.Hkv + hk;
  float* ws_acc = a.ws + (pair * a.n_split + z) * nq * (D + 2);
  float* ws_ml = ws_acc + nq * D;  // [nq][2]
  for (int idx = tid; idx < nq * D; idx += kThreads) {
    const int qi = idx / D, e = idx % D;
    Merged st;
    for (int w = 0; w < wk_n; ++w) {
      const int slot = (w * wr_n + qi / QW) * QW + qi % QW;
      st.add(sm_m[slot], sm_l[slot], sm_acc[slot * D + e]);
    }
    if (z == 0) st.add(sm_cur[qi], 1.f, v_cur);  // e == tid % D
    if (a.n_split == 1) {
      store_out(a.out, (size_t(b) * a.H + hk * nq + qi) * D + e, st.o / st.l, a.q_dtype);
    } else {
      ws_acc[idx] = st.o;
      if (e == 0) {
        ws_ml[2 * qi] = st.m;
        ws_ml[2 * qi + 1] = st.l;
      }
    }
  }
  if (a.n_split == 1) return;

  // the last block of this (kv head, sample) to arrive merges the splits
  if (!last_block_to_arrive(&a.tickets[pair], a.n_split)) return;
  const float* part = a.ws + pair * a.n_split * nq * (D + 2);
  for (int idx = tid; idx < nq * D; idx += kThreads) {
    const int qi = idx / D, e = idx % D;
    Merged st;
    for (int s = 0; s < a.n_split; ++s) {
      const float* ps = part + size_t(s) * nq * (D + 2);
      st.add(__ldcg(ps + nq * D + 2 * qi), __ldcg(ps + nq * D + 2 * qi + 1),
             __ldcg(ps + idx));
    }
    // split 0 holds the current token, so st.l >= 1 up to rounding
    store_out(a.out, (size_t(b) * a.H + hk * nq + qi) * D + e, st.o / st.l, a.q_dtype);
  }
  if (tid == 0) a.tickets[pair] = 0;  // for the next launch (a graph replay too)
}

template <typename S, int D, int QW>
cudaError_t launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<S, D, QW>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.Hkv, B, a.n_split);
  decode_kernel<S, D, QW><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

template <int D, int QW>
cudaError_t launch_stored(int storage, const DecodeArgs& a, int B, cudaStream_t stream) {
  switch (storage) {
    case kFloat32: return launch<float, D, QW>(a, B, stream);
    case kBFloat16: return launch<__nv_bfloat16, D, QW>(a, B, stream);
    case kInt8: return launch<signed char, D, QW>(a, B, stream);
    case kFloat8E4M3: return launch<Fp8, D, QW>(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dllava

// Bytes of fp32 workspace a call with these shapes needs (0 when n_split is 1).
extern "C" long long decode_attention_workspace_bytes(int B, int H, int Hkv, int D,
                                                      int n_split) {
  if (n_split <= 1) return 0;
  return 4LL * B * Hkv * n_split * (H / Hkv) * (D + 2);
}

// C entry point. `dtype` is the type of q, k_cur, v_cur and out, `storage`
// the cache's (DType codes); k_scale / v_scale go with int8 storage and are
// null otherwise; window <= 0 means no window (q_pos may then be null).
// n_split blocks share the rows of a (kv head, sample); above 1 they need
// `workspace` (decode_attention_workspace_bytes, 16-byte aligned, free again
// once the launch has run) and `tickets`, [B, Hkv] int32 that are zero before
// the launch and zero again after it. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape or type combination the
// kernel does not take.
extern "C" int decode_attention_appended(
    const void* q, const void* k_cache, const void* v_cache, const void* k_cur,
    const void* v_cur, const int* length, const void* k_scale,
    const void* v_scale, const int* q_pos, void* out, void* workspace,
    long long workspace_bytes, int* tickets, int n_split, int B, int max_len,
    int H, int Hkv, int D, float scale, int window, int dtype, int storage,
    void* stream) {
  using namespace dllava;
  if (B <= 0 || B > 65535 || max_len < 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kMaxQ || (storage == kInt8) != (k_scale != nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (window > 0 && q_pos == nullptr) || n_split < 1 || n_split > kMaxSplit ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return cudaErrorInvalidValue;
  if (n_split > 1 &&
      (workspace == nullptr || tickets == nullptr ||
       workspace_bytes < decode_attention_workspace_bytes(B, H, Hkv, D, n_split)))
    return cudaErrorInvalidValue;
  const void* aligned[] = {k_cache, v_cache, workspace};
  for (const void* ptr : aligned)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorInvalidValue;
  DecodeArgs a{};
  a.q = q;
  a.k_cache = k_cache;
  a.v_cache = v_cache;
  a.k_cur = k_cur;
  a.v_cur = v_cur;
  a.length = length;
  a.k_scale = static_cast<const __nv_bfloat16*>(k_scale);
  a.v_scale = static_cast<const __nv_bfloat16*>(v_scale);
  a.q_pos = q_pos;
  a.out = out;
  a.ws = static_cast<float*>(workspace);
  a.tickets = tickets;
  a.max_len = max_len;
  a.H = H;
  a.Hkv = Hkv;
  a.n_split = n_split;
  a.chunk = (max_len + n_split - 1) / n_split;
  a.window = window;
  a.q_dtype = dtype;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one = H == Hkv;  // one query row a kv head: a warp holds it alone
  if (D == 128) return one ? launch_stored<128, 1>(storage, a, B, s)
                           : launch_stored<128, 2>(storage, a, B, s);
  if (D == 64) return one ? launch_stored<64, 1>(storage, a, B, s)
                          : launch_stored<64, 2>(storage, a, B, s);
  return cudaErrorInvalidValue;
}
