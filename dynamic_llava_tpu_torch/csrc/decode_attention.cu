// Attention of new tokens over the persisted KV cache plus their own K/V,
// for Hopper, sm_90a: kernel K2 (one query token a sample, decode) and its
// M-query form (a chunk of M tokens a sample, multi-round chat and every
// later caller of the continuation prefill).
//
// Replaces, for one token, the TPU kernel dynamic_llava_tpu/ops/
// decode_attention.py: _decode_kernel (wrapper flash_decode_attention),
// ported to the contract the decode layer loop actually calls:
// ops/attention.py decode_attend_appended. For M tokens it replaces the XLA
// function ops/attention.py extend_attend_appended (called from
// run_layers_extend), which has no Pallas kernel. Each query row attends over
// the persisted cache rows [0, bound) plus the chunk's own M fresh K/V, which
// are NOT in the cache and enter as M extra columns: chunk column i is
// visible to the row of chunk token m iff i <= m, and, with an `attend` mask,
// iff i == m or attend[b, i]. Decode is the case M = 1: the current token is
// the one chunk column. The cache is only read; the caller writes the new K/V
// afterwards. Layouts: q/out [B, M, H, D], cache [B, max_len, Hkv, D] (one
// layer's view of the [L, B, max_len, Hkv, D] buffer), k_chunk/v_chunk
// [B, M, Hkv, D] in q's type, bound [B] int32 (the persisted length, or the
// ring policy's min(length, budget)), q_pos [B, M] (with a window), attend
// [B, M] bool (or null: every earlier chunk column is visible).
//
// The cache's storage type is separate from q's: bf16, fp32, fp8 (e4m3,
// converted exactly to fp32 in registers) or int8 with one bf16 scale per
// stored head vector, k_scale / v_scale [B, max_len, Hkv]. The int8 scales
// are folded, never applied to the cache: the score is (q . k_int) * s_k[j]
// in fp32 and p_j * s_v[j] multiplies the V row. With a window (> 0) cache
// column j is visible to a row iff q_pos[b, m] - j < window (dense cache,
// slot = position) and chunk column i iff q_pos[b, m] - q_pos[b, i] < window;
// cache rows below the block's smallest q_pos - window + 1 are not read.
//
// What bounds it on the H100: bytes of live cache read. Decode reads
// 2 * bound * Hkv * D * (bytes per element) per sample and layer and does
// only 4 * bound * H * D flops, about one flop per byte, far below the
// card's ~295 flop/byte balance point; M chunk queries do M times the flops
// on the same bytes, still below it up to M of a few hundred. So every live
// row is read once by a block and nothing past `bound`, and the design is
// about keeping enough bytes in flight on every SM:
// - a bf16 query over a bf16, int8 or fp8 cache with M chunk tokens takes
//   the tensor-core form, extend_mma_kernel (extend_attention.cu): a block
//   reads each cache tile once for a tile of up to 64 query rows of a kv
//   head and multiplies with mma.sync, the one-byte tiles widened to bf16 in
//   shared memory. Everything below is the CUDA-core code of decode_kernel
//   (M = 1) and of extend_kernel, the M-query form for an fp32 query or an
//   fp32 cache, where a bf16 product would not meet the fp32 checks;
// - the query rows of a kv head ((chunk token m, head j of its group), M x
//   n_rep of them) are cut into groups of at most kMaxQ = 8, one group a
//   block; grid (Hkv x groups, B, n_split). In extend_kernel a group
//   re-reads the cache rows that every other group of its (kv head, sample)
//   reads: ceil(M n_rep / 8) reads of the cache a call;
// - the live length is split over blocks (flash-decoding), the split chosen
//   on the host from the shapes alone (the lengths live on the device), so
//   that a call has at least about one block an SM. Block z owns cache rows
//   [z * chunk, (z + 1) * chunk) below the bound and above the window's
//   first row; a block with no such row leaves a neutral state. The chunk's
//   own columns belong to split 0;
// - a block streams its rows ("segment": the cache rows, then in split 0 the
//   chunk's rows, both with the code below) as tiles of 4-16 KB of K and as
//   much of V through a ring of kStages shared-memory stages filled by
//   16-byte cp.async copies (rows past the bound are zero-filled, not read),
//   so the next tiles are in flight while this one is multiplied. 16 bytes a
//   lane whatever the storage type: a row of D elements is D * size / 16
//   lanes (16 for bf16 at D = 128, 8 for a one-byte type), a warp instruction
//   covers 2-8 rows, and a dot product reduces over that many lanes only;
// - a group of lanes that shares a row runs its own online softmax (base 2,
//   fp32, scale * log2(e) folded into q) over the 4 rows it owns in a tile:
//   4 independent dot products, one maximum and one rescale of the
//   accumulator a tile. Groups, then warps, then the two segments merge once
//   at the end of the block. A warp holds one query row in registers when
//   the block has one, two otherwise; the warps divide the query rows first
//   and the tile's rows second;
// - with n_split > 1 a block writes (m, l, acc) to an fp32 workspace; the
//   last block of a (kv head, sample, row group) to arrive (a ticket from an
//   atomicAdd after __threadfence) merges the splits in index order, writes
//   `out` and resets the ticket. The order of every sum is fixed by the
//   shapes, so two calls give the same bits. Still one launch a call.

#include <cuda_fp8.h>

#include <climits>

#include "common.cuh"

namespace dllava {

// extend_attention.cu: the tensor-core M-query form and its workspace
cudaError_t extend_mma(const void* q, const void* k_cache, const void* v_cache,
                       const void* k_chunk, const void* v_chunk, const int* length,
                       const void* k_scale, const void* v_scale, const int* q_pos,
                       const unsigned char* attend, void* out, void* workspace,
                       long long ws_bytes, int* tickets, int n_split, int B, int M,
                       int max_len, int H, int Hkv, int D, float scale, int window,
                       int storage, cudaStream_t stream);
long long extend_mma_workspace_bytes(int B, int M, int H, int Hkv, int D, int n_split);

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;        // tiles in the shared-memory ring
constexpr int kRowsPerGroup = 4;  // rows of a tile a lane group owns
constexpr int kMaxQ = 8;          // query rows of a block
constexpr int kMaxSplit = 32;
// a tile is at most kRowsPerGroup rows for each of the block's lane groups:
// 4 * 256 lanes * 16 bytes of K, as much of V, and a scale per row
constexpr int kTileBytes = kRowsPerGroup * kThreads * 16;
constexpr int kMaxTileRows = kRowsPerGroup * kThreads / 4;  // 4 lanes a row at least
constexpr int kStageBytes = 2 * kTileBytes + 2 * 4 * kMaxTileRows;
constexpr int kRingBytes = kStages * kStageBytes;
// a segment's merged state: m and l of [kWarps][2] query rows, then acc
// [kWarps][2][D <= 128]
constexpr int kStateFloats = kWarps * 2 * (128 + 2);
// the ring, then the cache segment's state (the chunk segment's reuses the
// ring once its tiles are consumed); two blocks an SM
constexpr int kSmemBytes = kRingBytes + 4 * kStateFloats;

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

struct AttendArgs {
  const void* q;        // [B, M, H, D], q_dtype
  const void* k_cache;  // [B, max_len, Hkv, D], the storage type
  const void* v_cache;
  const void* k_chunk;  // [B, M, Hkv, D], q_dtype
  const void* v_chunk;
  const int* length;    // [B] attend bound of the cache
  const __nv_bfloat16* k_scale;  // [B, max_len, Hkv] with int8 storage, else null
  const __nv_bfloat16* v_scale;
  const int* q_pos;     // [B, M] with a window
  const unsigned char* attend;  // [B, M] bool, or null: every earlier chunk column
  void* out;            // [B, M, H, D], q_dtype
  float* ws;            // n_split > 1: [B, Hkv, n_groups, n_split, nqg, D + 2] partial states
  int* tickets;         // n_split > 1: [B, Hkv, n_groups], zero between launches
  int M, max_len, H, Hkv, n_rep, n_groups, nqg, n_split, chunk, window, q_dtype;
  float scale_log2;
};

// How the warps of a block share its nq query rows: warp-row groups of QW
// rows first (wr_n of them), the tile's rows second (wk_n warps a group).
struct Layout {
  int nq, wr_n, wk_n, wr, wk, q0;
  bool idle;  // warps left over with three query-row groups
  __device__ __forceinline__ Layout(int nq_, int QW) : nq(nq_) {
    const int warp = threadIdx.x >> 5;
    wr_n = (nq + QW - 1) / QW;  // 1..4
    wk_n = kWarps / wr_n;       // 8, 4, 2, 2
    wr = warp % wr_n;
    wk = warp / wr_n;
    idle = wk >= wk_n;
    q0 = wr * QW;
  }
  // the state slot of query row qi as seen by warp-row w of its group
  __device__ __forceinline__ int slot(int w, int qi, int QW) const {
    return (w * wr_n + qi / QW) * QW + qi % QW;
  }
};

// The query rows a warp holds: their element offsets in q (kNoRow: none) and
// what their visibility needs (a window's first cache column; a chunk
// token's index and position).
constexpr size_t kNoRow = ~size_t(0);
template <int QW>
struct WarpRows {
  size_t q_at[QW];
  int tok[QW];    // the chunk token of row rr
  int first[QW];  // the first cache column row rr sees (INT_MIN without a window)
  int pos[QW];    // row rr's position (with a window)
};

// cache column `col` is visible to row rr iff it is not below its window
template <int QW>
struct CacheVis {
  WarpRows<QW> r;
  __device__ __forceinline__ bool operator()(int rr, int col) const {
    return col >= r.first[rr];
  }
};

// chunk column i is visible to row rr (chunk token t) iff i <= t, and i == t
// or attend[i], and within the window of t's position
template <int QW>
struct ChunkVis {
  WarpRows<QW> r;
  const unsigned char* attend;  // of this sample, or null
  const int* pos;               // of this sample, with a window
  int window;
  __device__ __forceinline__ bool operator()(int rr, int i) const {
    const int t = r.tok[rr];
    return i <= t && (i == t || attend == nullptr || attend[i] != 0) &&
           (window <= 0 || r.pos[rr] - pos[i] < window);
  }
};

// One segment of key/value rows of type T (the cache in its storage type, or
// the chunk in q's type): rows [lo, c1) of the [rows, Hkv, D] array whose
// row 0 of this kv head is at kv / vv (bytes), tiles counted from row c0,
// with int8 scales ks / vs (row r at r * Hkv) or none. vis(rr, row) is the
// per-query-row visibility beyond [lo, c1); vis.r the warp's query rows.
// Leaves the block's state of this segment, merged over lane groups, in
// `state` ([kWarps][QW] m, then l, then acc [kWarps][QW][D]); `state` may lie
// in the ring. Called by every thread.
template <typename T, int D, int QW, typename Vis>
__device__ __forceinline__ void segment(const AttendArgs& a, const Layout& w,
                                        const unsigned char* kv, const unsigned char* vv,
                                        const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                        int c0, int lo, int c1, const Vis vis,
                                        unsigned char* smem, float* state) {
  constexpr int ES = sizeof(T);
  constexpr int EPL = 16 / ES;   // elements a lane holds of a row
  constexpr int LPR = D / EPL;   // lanes that share a row
  constexpr int GPW = 32 / LPR;  // lane groups (rows a pass) of a warp
  constexpr int RB = D * ES;     // bytes of a row
  constexpr int U = kRowsPerGroup;
  static_assert(LPR >= 4 && LPR <= 32, "row lanes");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / LPR, j = lane % LPR;
  const int pass_rows = GPW * w.wk_n;     // rows the block covers with one pass
  const int tile_rows = U * pass_rows;    // <= kMaxTileRows
  const bool scaled = ks != nullptr;      // int8 storage
  const size_t row_stride = size_t(a.Hkv) * RB;  // bytes

  int t0 = 0, nt = 0;  // tiles t0 .. t0 + nt - 1, tile t at c0 + t * tile_rows
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
    if (vis.r.q_at[rr] != kNoRow) {
      load_row<EPL>(a.q, vis.r.q_at[rr] + j * EPL, a.q_dtype, qv[rr]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[rr][e] *= a.scale_log2;
    }
  }

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
      cp_async16_zfill(kd + row * RB + part * 16, kv + src, ok);
      cp_async16_zfill(kd + kTileBytes + row * RB + part * 16, vv + src, ok);
    }
  };
  // the int8 scales of row `tid` of tile t (threads below tile_rows)
  auto load_scales = [&](int t, float& ksc, float& vsc) {
    const int gr = c0 + t * tile_rows + tid;
    ksc = vsc = 0.f;
    if (tid < tile_rows && gr >= lo && gr < c1) {
      ksc = __bfloat162float(ks[size_t(gr) * a.Hkv]);
      vsc = __bfloat162float(vs[size_t(gr) * a.Hkv]);
    }
  };
  auto store_scales = [&](int s, float ksc, float vsc) {
    if (tid < tile_rows) {
      stage_scales(s)[tid] = ksc;
      stage_scales(s)[kMaxTileRows + tid] = vsc;
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) {
      issue(t0 + s, s);
      if (scaled) {
        float ksc, vsc;
        load_scales(t0 + s, ksc, vsc);
        store_scales(s, ksc, vsc);
      }
    }
    cp_async_commit();
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

    if (!w.idle) {
      const unsigned char* kt = stage_k(i % kStages);
      const float* sc = stage_scales(i % kStages);
      const int base = c0 + (t0 + i) * tile_rows;
      // the lane's rows: row0 + u * pass_rows of the tile; visible to query
      // row rr iff the row lies in [lo, c1) and vis(rr, row)
      const int row0 = w.wk * GPW + g;
      const unsigned span = c1 - lo;
      auto visible = [&](int rr, int u) {
        const int gr = base + row0 + u * pass_rows;
        return unsigned(gr - lo) < span && vis(rr, gr);
      };
      float s[QW][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = row0 + u * pass_rows;
        float kf[EPL];
        convert16<T>(*reinterpret_cast<const uint4*>(kt + row * RB + j * 16), kf);
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
        bool vis_u[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          vis_u[u] = visible(rr, u);
          if (scaled) s[rr][u] *= sc[row0 + u * pass_rows];
          if (vis_u[u]) mx = fmaxf(mx, s[rr][u]);
        }
        const float alpha = exp2f(m[rr] - mx);
        m[rr] = mx;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[rr][u] = vis_u[u] ? exp2f(s[rr][u] - mx) : 0.f;
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
        convert16<T>(*reinterpret_cast<const uint4*>(kt + kTileBytes + row * RB + j * 16),
                     vf);
        const float vsc = scaled ? sc[kMaxTileRows + row] : 1.f;
#pragma unroll
        for (int rr = 0; rr < QW; ++rr) {
          const float pv = p[rr][u] * vsc;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[rr][e] = fmaf(pv, vf[e], acc[rr][e]);
        }
      }
    }
    if (scaled && nx < nt) store_scales(nxs, ks_nx, vs_nx);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: `state` may reuse it

  // the lane groups of a warp merge by shuffles (a group that saw no row has
  // m == kNegBig and l == 0, so its weight is 0 or meets zeros)
#pragma unroll
  for (int rr = 0; rr < QW; ++rr) {
    float mx = m[rr];
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float wgt = exp2f(m[rr] - mx);
    m[rr] = mx;
    l[rr] *= wgt;
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], off);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[rr][e] *= wgt;
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        acc[rr][e] += __shfl_xor_sync(0xffffffffu, acc[rr][e], off);
    }
  }
  float* st_m = state;                 // [kWarps][QW]
  float* st_l = st_m + kWarps * QW;
  float* st_acc = st_l + kWarps * QW;  // [kWarps][QW][D]
  if (g == 0) {
#pragma unroll
    for (int rr = 0; rr < QW; ++rr) {
      if (j == 0) {
        st_m[warp * QW + rr] = m[rr];
        st_l[warp * QW + rr] = l[rr];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        st_acc[(warp * QW + rr) * D + j * EPL + e] = acc[rr][e];
    }
  }
}

// The block of (kv head, row group) blockIdx.x, sample blockIdx.y and split
// blockIdx.z. S: storage type of the cache; q, the chunk and out are
// a.q_dtype. QW: query rows a warp holds in registers (1 when a block has
// one query row, else 2).
template <typename S, int D, int QW>
__device__ __forceinline__ void attend_block(const AttendArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hk = blockIdx.x % a.Hkv, grp = blockIdx.x / a.Hkv;
  const int b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x;
  const int r0 = grp * kMaxQ;  // the group's first query row of this kv head
  const Layout w(min(kMaxQ, a.M * a.n_rep - r0), QW);
  const int nq = w.nq;
  // query row qi of the block: chunk token m, head hk * n_rep + (r % n_rep)
  auto token_of = [&](int qi) { return (r0 + qi) / a.n_rep; };
  auto row_at = [&](int qi) {
    const int r = r0 + qi;
    return ((size_t(b) * a.M + r / a.n_rep) * a.H + hk * a.n_rep + r % a.n_rep) * D;
  };
  const int* pos = a.window > 0 ? a.q_pos + size_t(b) * a.M : nullptr;

  // the cache rows: below the bound, above every query row's window start
  const int len = max(0, min(a.length[b], a.max_len));
  WarpRows<QW> rows;
#pragma unroll
  for (int rr = 0; rr < QW; ++rr) {
    const int qi = w.q0 + rr;
    rows.q_at[rr] = qi < nq ? row_at(qi) : kNoRow;
    rows.tok[rr] = qi < nq ? token_of(qi) : 0;
    rows.pos[rr] = a.window > 0 ? pos[rows.tok[rr]] : 0;
    rows.first[rr] = a.window > 0 ? rows.pos[rr] - a.window + 1 : INT_MIN;
  }
  int first = 0;
  if (a.window > 0) {
    int pmin = pos[token_of(0)];
    for (int qi = 1; qi < nq; ++qi) pmin = min(pmin, pos[token_of(qi)]);
    first = min(len, max(0, pmin - a.window + 1));
  }
  const int c0 = z * a.chunk;
  const int c1 = min(len, c0 + a.chunk);
  constexpr int RB = D * sizeof(S);
  const size_t head_at = (size_t(b) * a.max_len * a.Hkv + hk) * RB;
  const size_t scale_at = size_t(b) * a.max_len * a.Hkv + hk;
  const bool scaled = a.k_scale != nullptr;
  float* cache_state = reinterpret_cast<float*>(smem + kRingBytes);
  segment<S, D, QW>(a, w, static_cast<const unsigned char*>(a.k_cache) + head_at,
                    static_cast<const unsigned char*>(a.v_cache) + head_at,
                    scaled ? a.k_scale + scale_at : nullptr,
                    scaled ? a.v_scale + scale_at : nullptr, c0, max(c0, first), c1,
                    CacheVis<QW>{rows}, smem, cache_state);

  // split 0 owns the chunk's own columns: rows [0, last token of the group]
  float* chunk_state = reinterpret_cast<float*>(smem);
  if (z == 0) {
    const ChunkVis<QW> vis{rows, a.attend == nullptr ? nullptr : a.attend + size_t(b) * a.M,
                           pos, a.window};
    const int n_rows = token_of(nq - 1) + 1;
    if (a.q_dtype == kBFloat16) {
      constexpr int RQ = D * sizeof(__nv_bfloat16);
      const size_t at = (size_t(b) * a.M * a.Hkv + hk) * RQ;
      segment<__nv_bfloat16, D, QW>(a, w, static_cast<const unsigned char*>(a.k_chunk) + at,
                                    static_cast<const unsigned char*>(a.v_chunk) + at, nullptr,
                                    nullptr, 0, 0, n_rows, vis, smem, chunk_state);
    } else {
      constexpr int RQ = D * sizeof(float);
      const size_t at = (size_t(b) * a.M * a.Hkv + hk) * RQ;
      segment<float, D, QW>(a, w, static_cast<const unsigned char*>(a.k_chunk) + at,
                            static_cast<const unsigned char*>(a.v_chunk) + at, nullptr, nullptr,
                            0, 0, n_rows, vis, smem, chunk_state);
    }
  }
  __syncthreads();

  // the block's state for every (query row, column): the cache segment's
  // warps in row order, then the chunk segment's
  const size_t pair = (size_t(b) * a.Hkv + hk) * a.n_groups + grp;
  float* ws_acc = a.ws + (pair * a.n_split + z) * a.nqg * (D + 2);
  float* ws_ml = ws_acc + a.nqg * D;  // [nqg][2]
  for (int idx = tid; idx < nq * D; idx += kThreads) {
    const int qi = idx / D, e = idx % D;
    Merged st;
    for (int k = 0; k < w.wk_n; ++k) {
      const int sl = w.slot(k, qi, QW);
      st.add(cache_state[sl], cache_state[kWarps * QW + sl],
             cache_state[2 * kWarps * QW + sl * D + e]);
    }
    if (z == 0)
      for (int k = 0; k < w.wk_n; ++k) {
        const int sl = w.slot(k, qi, QW);
        st.add(chunk_state[sl], chunk_state[kWarps * QW + sl],
               chunk_state[2 * kWarps * QW + sl * D + e]);
      }
    if (a.n_split == 1) {
      store_out(a.out, row_at(qi) + e, st.o / st.l, a.q_dtype);
    } else {
      ws_acc[idx] = st.o;
      if (e == 0) {
        ws_ml[2 * qi] = st.m;
        ws_ml[2 * qi + 1] = st.l;
      }
    }
  }
  if (a.n_split == 1) return;

  // the last block of this (kv head, sample, row group) to arrive merges the
  // splits
  if (!last_block_to_arrive(&a.tickets[pair], a.n_split)) return;
  const float* part = a.ws + pair * a.n_split * a.nqg * (D + 2);
  for (int idx = tid; idx < nq * D; idx += kThreads) {
    const int qi = idx / D, e = idx % D;
    Merged st;
    for (int s = 0; s < a.n_split; ++s) {
      const float* ps = part + size_t(s) * a.nqg * (D + 2);
      st.add(__ldcg(ps + a.nqg * D + 2 * qi), __ldcg(ps + a.nqg * D + 2 * qi + 1),
             __ldcg(ps + idx));
    }
    // split 0 holds the row's own chunk column, so st.l >= 1 up to rounding
    store_out(a.out, row_at(qi) + e, st.o / st.l, a.q_dtype);
  }
  if (tid == 0) a.tickets[pair] = 0;  // for the next launch (a graph replay too)
}

// one query token a sample (M = 1): kernel K2
template <typename S, int D, int QW>
__global__ void __launch_bounds__(kThreads) decode_kernel(const AttendArgs a) {
  attend_block<S, D, QW>(a);
}

// M chunk tokens a sample: the M-query form
template <typename S, int D>
__global__ void __launch_bounds__(kThreads) extend_kernel(const AttendArgs a) {
  attend_block<S, D, 2>(a);
}

template <typename S, int D, int QW>
cudaError_t launch(const AttendArgs& a, int B, bool extend, cudaStream_t stream) {
  dim3 grid(a.Hkv * a.n_groups, B, a.n_split);
  if (extend) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        extend_kernel<S, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (attr != cudaSuccess) return attr;
    extend_kernel<S, D><<<grid, kThreads, kSmemBytes, stream>>>(a);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        decode_kernel<S, D, QW>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (attr != cudaSuccess) return attr;
    decode_kernel<S, D, QW><<<grid, kThreads, kSmemBytes, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int D, int QW>
cudaError_t launch_stored(int storage, const AttendArgs& a, int B, bool extend,
                          cudaStream_t stream) {
  switch (storage) {
    case kFloat32: return launch<float, D, QW>(a, B, extend, stream);
    case kBFloat16: return launch<__nv_bfloat16, D, QW>(a, B, extend, stream);
    case kInt8: return launch<signed char, D, QW>(a, B, extend, stream);
    case kFloat8E4M3: return launch<Fp8, D, QW>(a, B, extend, stream);
  }
  return cudaErrorInvalidValue;
}

// the M-query form on a bf16 query over a bf16, int8 or fp8 cache runs on
// the tensor cores (extend_attention.cu); everything else here
bool tensor_cores(bool extend, int dtype, int storage) {
  return extend && dtype == kBFloat16 && storage != kFloat32;
}

long long workspace_bytes(int B, int M, int H, int Hkv, int D, int n_split) {
  if (n_split <= 1 || Hkv <= 0) return 0;
  const int rows = M * (H / Hkv);
  const int groups = (rows + kMaxQ - 1) / kMaxQ;
  return 4LL * B * Hkv * groups * n_split * (rows < kMaxQ ? rows : kMaxQ) * (D + 2);
}

// Checks the arguments and launches decode_kernel (extend false: M == 1,
// attend null), extend_mma_kernel (tensor_cores) or extend_kernel.
int attend(const void* q, const void* k_cache, const void* v_cache, const void* k_chunk,
           const void* v_chunk, const int* length, const void* k_scale, const void* v_scale,
           const int* q_pos, const unsigned char* attend_mask, void* out, void* workspace,
           long long ws_bytes, int* tickets, int n_split, int B, int M, int max_len, int H,
           int Hkv, int D, float scale, int window, int dtype, int storage, bool extend,
           void* stream) {
  if (B <= 0 || B > 65535 || M <= 0 || max_len < 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kMaxQ || (storage == kInt8) != (k_scale != nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (window > 0 && q_pos == nullptr) || n_split < 1 || n_split > kMaxSplit ||
      (dtype != kFloat32 && dtype != kBFloat16) || (!extend && (M != 1 || attend_mask)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores(extend, dtype, storage))
    return extend_mma(q, k_cache, v_cache, k_chunk, v_chunk, length, k_scale, v_scale, q_pos,
                      attend_mask, out, workspace, ws_bytes, tickets, n_split, B, M, max_len, H,
                      Hkv, D, scale, window, storage, s);
  if (n_split > 1 &&
      (workspace == nullptr || tickets == nullptr ||
       ws_bytes < workspace_bytes(B, M, H, Hkv, D, n_split)))
    return cudaErrorInvalidValue;
  const void* aligned[] = {k_cache, v_cache, workspace};
  for (const void* ptr : aligned)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorInvalidValue;
  AttendArgs a{};
  a.q = q;
  a.k_cache = k_cache;
  a.v_cache = v_cache;
  a.k_chunk = k_chunk;
  a.v_chunk = v_chunk;
  a.length = length;
  a.k_scale = static_cast<const __nv_bfloat16*>(k_scale);
  a.v_scale = static_cast<const __nv_bfloat16*>(v_scale);
  a.q_pos = q_pos;
  a.attend = attend_mask;
  a.out = out;
  a.ws = static_cast<float*>(workspace);
  a.tickets = tickets;
  a.M = M;
  a.max_len = max_len;
  a.H = H;
  a.Hkv = Hkv;
  a.n_rep = H / Hkv;
  const int rows = M * a.n_rep;
  a.n_groups = (rows + kMaxQ - 1) / kMaxQ;
  a.nqg = rows < kMaxQ ? rows : kMaxQ;
  a.n_split = n_split;
  a.chunk = (max_len + n_split - 1) / n_split;
  a.window = window;
  a.q_dtype = dtype;
  a.scale_log2 = scale * kLog2e;
  if (size_t(Hkv) * a.n_groups > 0x7FFFFFFFu) return cudaErrorInvalidValue;
  // one query row a block: a warp holds it alone (decode without GQA)
  const bool one = !extend && rows == 1;
  if (D == 128) return one ? launch_stored<128, 1>(storage, a, B, extend, s)
                           : launch_stored<128, 2>(storage, a, B, extend, s);
  if (D == 64) return one ? launch_stored<64, 1>(storage, a, B, extend, s)
                          : launch_stored<64, 2>(storage, a, B, extend, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dllava

// Bytes of fp32 workspace a call with these shapes needs (0 when n_split is
// 1): M query tokens a sample (1 for decode_attention_appended).
extern "C" long long decode_attention_workspace_bytes(int B, int M, int H, int Hkv, int D,
                                                      int n_split) {
  return dllava::workspace_bytes(B, M, H, Hkv, D, n_split);
}

// The same for the M-query form, whose kernel depends on q's dtype and the
// cache's storage code.
extern "C" long long extend_attention_workspace_bytes(int B, int M, int H, int Hkv, int D,
                                                      int n_split, int dtype, int storage) {
  return dllava::tensor_cores(true, dtype, storage)
             ? dllava::extend_mma_workspace_bytes(B, M, H, Hkv, D, n_split)
             : dllava::workspace_bytes(B, M, H, Hkv, D, n_split);
}

// C entry point of K2. `dtype` is the type of q, k_cur, v_cur and out,
// `storage` the cache's (DType codes); k_scale / v_scale go with int8 storage
// and are null otherwise; window <= 0 means no window (q_pos may then be
// null). n_split blocks share the rows of a (kv head, sample); above 1 they
// need `workspace` (decode_attention_workspace_bytes, 16-byte aligned, free
// again once the launch has run) and `tickets`, [B, Hkv] int32 that are zero
// before the launch and zero again after it. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape or type combination
// the kernel does not take.
extern "C" int decode_attention_appended(
    const void* q, const void* k_cache, const void* v_cache, const void* k_cur,
    const void* v_cur, const int* length, const void* k_scale,
    const void* v_scale, const int* q_pos, void* out, void* workspace,
    long long workspace_bytes, int* tickets, int n_split, int B, int max_len,
    int H, int Hkv, int D, float scale, int window, int dtype, int storage,
    void* stream) {
  return dllava::attend(q, k_cache, v_cache, k_cur, v_cur, length, k_scale, v_scale, q_pos,
                        nullptr, out, workspace, workspace_bytes, tickets, n_split, B, 1,
                        max_len, H, Hkv, D, scale, window, dtype, storage, false, stream);
}

// C entry point of the M-query form: q / out [B, M, H, D], k_chunk / v_chunk
// [B, M, Hkv, D] in q's type, q_pos [B, M] (with a window), attend [B, M]
// bool or null. A bf16 q over a bf16, int8 or fp8 cache launches
// extend_mma_kernel, anything else extend_kernel. With n_split > 1 the
// workspace is extend_attention_workspace_bytes and the tickets are
// [B, Hkv, ceil(M * H / Hkv / R)] int32, R the query rows of a block (64 on
// the tensor cores, 8 otherwise); everything else as
// decode_attention_appended.
extern "C" int extend_attention_appended(
    const void* q, const void* k_cache, const void* v_cache, const void* k_chunk,
    const void* v_chunk, const int* length, const void* k_scale, const void* v_scale,
    const int* q_pos, const unsigned char* attend, void* out, void* workspace,
    long long workspace_bytes, int* tickets, int n_split, int B, int M, int max_len, int H,
    int Hkv, int D, float scale, int window, int dtype, int storage, void* stream) {
  return dllava::attend(q, k_cache, v_cache, k_chunk, v_chunk, length, k_scale, v_scale,
                        q_pos, attend, out, workspace, workspace_bytes, tickets, n_split, B, M,
                        max_len, H, Hkv, D, scale, window, dtype, storage, true, stream);
}
