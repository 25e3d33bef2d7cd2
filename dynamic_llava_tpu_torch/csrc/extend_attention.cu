// The M-query form of kernel K2 (K2-M) on the H100's tensor cores, sm_90a:
// extend_mma_kernel, for a bf16 query over a bf16, scaled-int8 or fp8 (e4m3)
// cache. decode_attention.cu's C entry extend_attention_appended dispatches
// here by dtype; an fp32 query or an fp32 cache keeps that file's CUDA-core
// extend_kernel, whose fp32 arithmetic the fp32 checks need.
//
// Replaces the XLA function dynamic_llava_tpu/ops/attention.py
// extend_attend_appended (called from run_layers_extend), which has no
// Pallas kernel; the contract is decode_attention.cu's: each of the M chunk
// tokens of a sample attends over the persisted cache rows [0, bound) plus
// the chunk's own M K/V rows (not in the cache), chunk column i visible to
// the row of token m iff i <= m and (i == m or attend[b, i]); with a window,
// cache column j iff q_pos[b, m] - j < window and chunk column i iff
// q_pos[b, m] - q_pos[b, i] < window. int8 scales are folded, never applied
// to the cache: column j of S = Q K^T is multiplied by s_k[j] in fp32 after
// the product, and column j of P by s_v[j] in fp32 before P is rounded to
// bf16 for P V (the softmax sum takes P unscaled).
//
// What bounds it on the H100: the bytes of live cache, once. A (kv head,
// sample) has M * n_rep query rows; every one of them reads the same cache
// rows, so the design reads each cache tile once for up to 64 of them and
// does the products on the tensor cores (K1's mma.sync skeleton over two
// segments):
// - the query rows of a kv head, row r = (chunk token r / n_rep, head
//   r % n_rep of the group), are cut into tiles of 64; a block of 4 warps
//   takes one tile of one (kv head, sample) and one split of the cache
//   length; grid (Hkv x row tiles, B, n_split). A warp owns a strip of 16
//   rows (WK = 1), or, when a call has at most 16 rows a kv head (the
//   speculative verify rounds, M = k + 1), the four warps share the one
//   strip and each takes 16 of a tile's 64 columns (WK = 4); the warps'
//   states merge in shared memory in warp order. Spare rows of a tile are
//   computed on a clamped row and never written;
// - 64-row tiles of the cache, in their storage type, and then (split 0
//   only) of the chunk's own rows, in bf16, stream through a ring of
//   16-byte cp.async copies (3 stages for a bf16 cache, 2 for a one-byte
//   cache, whose tiles are widened to a bf16 tile in shared memory before
//   the products: int8 and e4m3 values are exact in bf16). Rows outside
//   [bound's split range, above the tile's first window row) are zero-filled
//   and not read, and masked; a row tile reads the chunk's rows only up to
//   its last token. The next tiles are in flight while one is multiplied;
// - S = Q K^T with Q's fragments in registers and K as the [n][k] operand
//   through ldmatrix; online softmax in base 2 (fp32, scale * log2(e) after
//   the product); the S accumulator packed to bf16 is P's A fragment, and V
//   comes through ldmatrix.trans. P never touches shared memory;
// - the length split and its in-launch merge are K2's: the split is chosen
//   on the host from the shapes alone (ops/decode_attention.py extend_plan),
//   about one block an SM; with n_split > 1 a block writes (m, l, acc) of
//   its rows to an fp32 workspace [B, Hkv, row tiles, n_split, rows x
//   (D + 4)], and the last block of a (kv head, sample, row tile) to take a
//   ticket merges the splits in index order, writes `out` and resets the
//   ticket. That merge is a chain of round trips to the L2 in one SM, so it
//   takes its data with cp.async in bulk: every split's (m, l) at once, then
//   the acc of the splits that saw a column, as many at a time as the shared
//   memory holds, and writes `out` 16 bytes a thread. Every sum runs in an
//   order fixed by the shapes, so two calls give the same bits; nothing but
//   the ticket is atomic.

#include <cuda_fp8.h>

#include <climits>

#include "common.cuh"

namespace dllava {
namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBR = 64;        // query rows of a tile
constexpr int kBC = 64;        // key / value rows of a tile
constexpr int kMaxSplit = 32;  // as decode_attention.cu

struct Fp8 {  // one e4m3 byte
  unsigned char x;
};

template <typename S>
struct Storage {  // one-byte storage: int8 with scales, fp8
  static constexpr bool kWiden = true;
  static constexpr int kStages = 2;
};
template <>
struct Storage<__nv_bfloat16> {
  static constexpr bool kWiden = false;
  static constexpr int kStages = 3;
};

// bytes of a bf16 tile of kBC rows of D + kTilePad elements
template <int D>
constexpr int kTileBytes = kBC * (D + kTilePad) * 2;
// a ring stage: the K tile, the V tile, then two words a row (int8 scales
// of the cache's rows; attend and position of the chunk's)
template <int D>
constexpr int kStageBytes = 2 * kTileBytes<D> + 2 * kBC * 4;

// the ring, then (one-byte storage) the widened K and V tiles; the ring also
// holds the q tile at the start and the warps' states at the end
template <typename S, int D>
constexpr int kSmemBytes =
    Storage<S>::kStages * kStageBytes<D> + (Storage<S>::kWiden ? 2 * kTileBytes<D> : 0);

struct MmaArgs {
  const __nv_bfloat16* q;        // [B, M, H, D]
  const unsigned char* k_cache;  // [B, max_len, Hkv, D], the storage type
  const unsigned char* v_cache;
  const __nv_bfloat16* k_chunk;  // [B, M, Hkv, D]
  const __nv_bfloat16* v_chunk;
  const int* length;             // [B] attend bound of the cache
  const __nv_bfloat16* k_scale;  // [B, max_len, Hkv] with int8 storage, else null
  const __nv_bfloat16* v_scale;
  const int* q_pos;              // [B, M] with a window
  const unsigned char* attend;   // [B, M] bool, or null
  __nv_bfloat16* out;            // [B, M, H, D]
  float* ws;                     // n_split > 1: [B, Hkv, n_tiles, n_split, nqt x (D + 4)]
  int* tickets;                  // n_split > 1: [B, Hkv, n_tiles], zero between launches
  int M, max_len, H, Hkv, n_rep, rows, n_tiles, nqt, n_split, chunk, window;
  float scale_log2;
};

// 16 stored bytes -> 16 bf16 values (two 16-byte words), exactly
template <typename S>
__device__ __forceinline__ void widen16(const uint4& raw, uint4& lo, uint4& hi);
template <>
__device__ __forceinline__ void widen16<signed char>(const uint4& raw, uint4& lo, uint4& hi) {
  // bytes 0, 1 (2, 3) of a word to bits 0-7 and 16-23 of a pair
  auto pair = [](uint32_t u, int half) {
    return s8_pair(__byte_perm(u, 0, half ? 0x0302 : 0x0100));
  };
  lo = make_uint4(pair(raw.x, 0), pair(raw.x, 1), pair(raw.y, 0), pair(raw.y, 1));
  hi = make_uint4(pair(raw.z, 0), pair(raw.z, 1), pair(raw.w, 0), pair(raw.w, 1));
}
template <>
__device__ __forceinline__ void widen16<Fp8>(const uint4& raw, uint4& lo, uint4& hi) {
  auto pair = [](uint32_t u, int half) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>((u >> (16 * half)) & 0xFFFFu), __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    return pack_bf16(f.x, f.y);  // e4m3 values are exact in bf16
  };
  lo = make_uint4(pair(raw.x, 0), pair(raw.x, 1), pair(raw.y, 0), pair(raw.y, 1));
  hi = make_uint4(pair(raw.z, 0), pair(raw.z, 1), pair(raw.w, 0), pair(raw.w, 1));
}

// Rows [0, kBC) of a raw one-byte tile (rows of RP bytes) into a bf16 tile
// (rows of D + kTilePad elements). Called by every thread.
template <typename S, int D, int RP>
__device__ __forceinline__ void widen_tile(__nv_bfloat16* dst, const unsigned char* src) {
  constexpr int kParts = D / 16;  // 16-byte words of a raw row
#pragma unroll
  for (int c = threadIdx.x; c < kBC * kParts; c += kThreads) {
    const int row = c / kParts, part = c % kParts;
    uint4 lo, hi;
    widen16<S>(*reinterpret_cast<const uint4*>(src + row * RP + part * 16), lo, hi);
    uint4* d = reinterpret_cast<uint4*>(dst + row * (D + kTilePad) + part * 16);
    d[0] = lo;
    d[1] = hi;
  }
}

// Rows [0, kBC) of a bf16 [rows, D] slice from row `base` (row stride
// `stride` elements) into a bf16 tile; rows outside [lo, hi) are
// zero-filled and not read. Called by every thread.
template <int D>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int base, int lo, int hi) {
  constexpr int kParts = D / 8;
#pragma unroll
  for (int c = threadIdx.x; c < kBC * kParts; c += kThreads) {
    const int row = c / kParts, part = c % kParts, gr = base + row;
    const bool ok = gr >= lo && gr < hi;
    cp_async16_zfill(dst + row * (D + kTilePad) + part * 8,
                     src + (ok ? gr * stride + part * 8 : 0), ok);
  }
}

// The block of (kv head, row tile) blockIdx.x, sample blockIdx.y and split
// blockIdx.z. S: storage type of the cache; WK: warps that share a strip of
// 16 query rows, each taking 64 / WK columns of a tile.
template <typename S, int D, int WK>
__global__ void __launch_bounds__(kThreads) extend_mma_kernel(const MmaArgs a) {
  constexpr bool kWiden = Storage<S>::kWiden;
  constexpr int kStages = Storage<S>::kStages;
  constexpr int DS = D + kTilePad;     // bf16 tile row pitch, elements
  constexpr int RP = D + 16;           // raw one-byte tile row pitch, bytes
  constexpr int NCW = kBC / WK;        // columns of a tile a warp takes
  constexpr int OP = D + 8;            // fp32 row pitch of the WK warps' states
  static_assert(RP * kBC <= kTileBytes<D>, "a raw tile fits a stage's tile");
  static_assert((WK * 16 * OP + 2 * WK * 16) * 4 <= kStages * kStageBytes<D>,
                "the warps' states fit the ring");
  static_assert(kSmemBytes<S, D> / 4 >=
                    kBR * (kMaxSplit + (4 * kMaxSplit > 2 * D ? 4 * kMaxSplit : 2 * D)),
                "the merge's weights, then (m, l) or two tiles' acc fit the shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  auto stage = [&](int s) { return smem + s * kStageBytes<D>; };
  auto stage_aux = [&](int s) {
    return reinterpret_cast<uint32_t*>(stage(s) + 2 * kTileBytes<D>);  // [2][kBC]
  };
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(smem + kStages * kStageBytes<D>);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / WK, wk = warp % WK;  // the warp's strip and column share
  const int hk = blockIdx.x % a.Hkv, rt = blockIdx.x / a.Hkv;
  const int b = blockIdx.y, z = blockIdx.z;
  const int r0 = rt * kBR;               // the tile's first query row of this kv head
  const int nq = min(kBR, a.rows - r0);  // its query rows
  // query row qi of the tile: chunk token r / n_rep, head hk * n_rep + r % n_rep
  auto row_at = [&](int qi) {
    const int r = r0 + qi;
    return ((size_t(b) * a.M + r / a.n_rep) * a.H + hk * a.n_rep + r % a.n_rep) * D;
  };

  // the q tile, into the last stage (the prologue fills the others)
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(stage(kStages - 1));
#pragma unroll
  for (int c = tid; c < kBR * (D / 8); c += kThreads) {
    const int qi = c / (D / 8), part = c % (D / 8);
    const bool ok = qi < nq;
    cp_async16_zfill(qs + qi * DS + part * 8, a.q + row_at(ok ? qi : 0) + part * 8, ok);
  }
  cp_async_commit();

  // the rows a lane holds (g and g + 8 of its strip; a spare row stands in
  // for the tile's last) and what their visibility needs
  const int* pos = a.window > 0 ? a.q_pos + size_t(b) * a.M : nullptr;
  int tok[2], qpos[2], first[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tok[h] = (r0 + min(wr * 16 + g + 8 * h, nq - 1)) / a.n_rep;
    qpos[h] = pos ? pos[tok[h]] : 0;
    first[h] = pos ? qpos[h] - a.window + 1 : INT_MIN;
  }
  const bool strip_live = wr * 16 < nq;
  const int t_last = (r0 + nq - 1) / a.n_rep;  // the tile's last chunk token

  // the cache rows of this split: below the bound, not below the first
  // window row of every query row; columns below hi_first are masked for
  // some row
  const int len = max(0, min(a.length[b], a.max_len));
  const int c0 = z * a.chunk, c1 = min(len, c0 + a.chunk);
  int lo = c0, hi_first = c0;
  if (pos) {
    __shared__ int red[2][4];
    const int t_first = r0 / a.n_rep;
    const int p = pos[min(t_first + tid, t_last)];  // <= 64 tokens a tile
    int pmin = p, pmax = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      pmin = min(pmin, __shfl_xor_sync(0xffffffffu, pmin, off));
      pmax = max(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
    }
    if (lane == 0) {
      red[0][warp] = pmin;
      red[1][warp] = pmax;
    }
    __syncthreads();
    pmin = min(min(red[0][0], red[0][1]), min(red[0][2], red[0][3]));
    pmax = max(max(red[1][0], red[1][1]), max(red[1][2], red[1][3]));
    lo = max(c0, pmin - a.window + 1);
    hi_first = max(lo, pmax - a.window + 1);
  }
  int t0 = 0, ntc = 0;  // cache tiles t0 .. t0 + ntc - 1, tile t at c0 + t * kBC
  if (lo < c1) {
    t0 = (lo - c0) / kBC;
    ntc = (c1 - c0 + kBC - 1) / kBC - t0;
  }
  // split 0 owns the chunk's columns [0, n_chunk): up to the tile's last token
  const int n_chunk = z == 0 ? t_last + 1 : 0;
  const int nt = ntc + (n_chunk + kBC - 1) / kBC;  // cache tiles, then chunk tiles

  constexpr int ES = sizeof(S);
  const size_t cache_at = (size_t(b) * a.max_len * a.Hkv + hk) * D * ES;  // bytes
  const size_t chunk_at = (size_t(b) * a.M * a.Hkv + hk) * D;             // elements
  const size_t stride = size_t(a.Hkv) * D;  // elements between rows, both segments
  const bool scaled = a.k_scale != nullptr;
  const size_t scale_at = size_t(b) * a.max_len * a.Hkv + hk;

  // cp.async copies of tile v into stage s
  auto issue = [&](int v, int s) {
    unsigned char* kd = stage(s);
    unsigned char* vd = kd + kTileBytes<D>;
    if (v < ntc) {
      const int base = c0 + (t0 + v) * kBC;
      if constexpr (kWiden) {
        constexpr int kParts = D / 16;
#pragma unroll
        for (int c = tid; c < kBC * kParts; c += kThreads) {
          const int row = c / kParts, part = c % kParts, gr = base + row;
          const bool ok = gr >= lo && gr < c1;
          const size_t src = cache_at + (ok ? gr * stride + part * 16 : 0);
          cp_async16_zfill(kd + row * RP + part * 16, a.k_cache + src, ok);
          cp_async16_zfill(vd + row * RP + part * 16, a.v_cache + src, ok);
        }
      } else {
        const auto* kc = reinterpret_cast<const __nv_bfloat16*>(a.k_cache + cache_at);
        const auto* vc = reinterpret_cast<const __nv_bfloat16*>(a.v_cache + cache_at);
        copy_rows<D>(reinterpret_cast<__nv_bfloat16*>(kd), kc, stride, base, lo, c1);
        copy_rows<D>(reinterpret_cast<__nv_bfloat16*>(vd), vc, stride, base, lo, c1);
      }
    } else {
      const int base = (v - ntc) * kBC;
      copy_rows<D>(reinterpret_cast<__nv_bfloat16*>(kd), a.k_chunk + chunk_at, stride, base,
                   0, n_chunk);
      copy_rows<D>(reinterpret_cast<__nv_bfloat16*>(vd), a.v_chunk + chunk_at, stride, base,
                   0, n_chunk);
    }
  };
  // the two words of row `tid` of tile v (threads below kBC): a cache row's
  // k / v scales (int8 storage), a chunk row's attend flag and position
  auto aux_load = [&](int v, uint32_t& x0, uint32_t& x1) {
    x0 = x1 = 0;
    if (tid >= kBC) return;
    if (v < ntc) {
      const int gr = c0 + (t0 + v) * kBC + tid;
      if (scaled && gr >= lo && gr < c1) {
        x0 = __float_as_uint(__bfloat162float(a.k_scale[scale_at + size_t(gr) * a.Hkv]));
        x1 = __float_as_uint(__bfloat162float(a.v_scale[scale_at + size_t(gr) * a.Hkv]));
      }
    } else {
      const int i = (v - ntc) * kBC + tid;
      if (i < n_chunk) {
        x0 = a.attend == nullptr || a.attend[size_t(b) * a.M + i] != 0;
        x1 = pos ? pos[i] : 0;
      }
    }
  };
  auto aux_store = [&](int s, uint32_t x0, uint32_t x1) {
    if (tid < kBC) {
      stage_aux(s)[tid] = x0;
      stage_aux(s)[kBC + tid] = x1;
    }
  };

  uint32_t x0, x1;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) {
      issue(s, s);
      aux_load(s, x0, x1);
      aux_store(s, x0, x1);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // the q tile has landed
  __syncthreads();
  uint32_t qf[D / 16][4];  // the strip's A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], frag_ptr(qs, DS, wr * 16, kk * 16, lane));

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  float m[2] = {kNegBig, kNegBig};
  float l[2] = {0.f, 0.f};  // per-lane partial sums, reduced at the end
  const int cb = wk * NCW;  // the warp's first column of a tile

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i have landed
    __syncthreads();               // everyone's have, and tile i - 1 is consumed
    const int nx = i + kStages - 1;
    if (nx < nt) {
      issue(nx, nx % kStages);
      aux_load(nx, x0, x1);  // lands during the products below
    }
    cp_async_commit();
    const int s = i % kStages;
    const bool cache = i < ntc;
    const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(stage(s));
    const __nv_bfloat16* vt = kt + kTileBytes<D> / 2;
    if constexpr (kWiden) {
      if (cache) {
        widen_tile<S, D, RP>(wide, stage(s));
        widen_tile<S, D, RP>(wide + kTileBytes<D> / 2, stage(s) + kTileBytes<D>);
        __syncthreads();
        kt = wide;
        vt = wide + kTileBytes<D> / 2;
      }
    }
    if (strip_live) {
      const uint32_t* aux = stage_aux(s);
      // S = Q K^T: the strip's 16 rows x the warp's NCW columns
      float sc[NCW / 8][4];
#pragma unroll
      for (int j = 0; j < NCW / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int np = 0; np < NCW / 16; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, frag_ptr_nk(kt, DS, cb + np * 16, kk * 16, lane));
          mma_bf16(sc[2 * np], qf[kk], bk);
          mma_bf16(sc[2 * np + 1], qf[kk], bk + 2);
        }

      // scale (and the int8 k scale); masks where the tile needs them
      if (cache) {
        const int base = c0 + (t0 + i) * kBC;
        const bool edge = base < hi_first || base + kBC > c1;
#pragma unroll
        for (int j = 0; j < NCW / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = cb + j * 8 + 2 * t + (c & 1);
            float v = sc[j][c] * a.scale_log2;
            if (scaled) v *= __uint_as_float(aux[col]);
            if (edge) {
              const int gc = base + col;
              if (gc < lo || gc >= c1 || gc < first[c >> 1]) v = -INFINITY;
            }
            sc[j][c] = v;
          }
      } else {
        const int base = (i - ntc) * kBC;
#pragma unroll
        for (int j = 0; j < NCW / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = cb + j * 8 + 2 * t + (c & 1), ci = base + col, tk = tok[c >> 1];
            const bool ok = ci <= tk && (ci == tk || aux[col] != 0) &&
                            (!pos || qpos[c >> 1] - int(aux[kBC + col]) < a.window);
            sc[j][c] = ok ? sc[j][c] * a.scale_log2 : -INFINITY;
          }
      }

      // online softmax in base 2; sc becomes p
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NCW / 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * h], sc[j][2 * h + 1]));
        mx = quad_max(mx);
        const float m_new = fmaxf(m[h], mx);  // finite: m starts at kNegBig
        const float alpha = exp2f(m[h] - m_new);
        m[h] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < NCW / 8; ++j) {
          const float p0 = exp2f(sc[j][2 * h] - m_new);  // masked: exp2(-inf) = 0
          const float p1 = exp2f(sc[j][2 * h + 1] - m_new);
          sc[j][2 * h] = p0;
          sc[j][2 * h + 1] = p1;
          psum += p0 + p1;
        }
        l[h] = l[h] * alpha + psum;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[j][2 * h] *= alpha;
          o[j][2 * h + 1] *= alpha;
        }
      }

      // O += P V: P (times the int8 v scale) from registers, V through
      // ldmatrix.trans
#pragma unroll
      for (int jj = 0; jj < NCW / 16; ++jj) {
        float p[2][4];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = cb + (2 * jj + e) * 8 + 2 * t + (c & 1);
            p[e][c] = sc[2 * jj + e][c] * (cache && scaled ? __uint_as_float(aux[kBC + col]) : 1.f);
          }
        uint32_t af[4];
        frag_from_acc(af, p[0], p[1]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, frag_ptr(vt, DS, cb + jj * 16, np * 16, lane));
          mma_bf16(o[2 * np], af, bv);
          mma_bf16(o[2 * np + 1], af, bv + 2);
        }
      }
    }
    if (nx < nt) aux_store(nx % kStages, x0, x1);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the states may reuse it

  // the block's state of each of its rows: `out` at n_split 1, else this
  // split's region of the workspace, acc [nqt][D] then (m, l, -, -) [nqt][4]
  const size_t pair = (size_t(b) * a.Hkv + hk) * a.n_tiles + rt;
  const size_t region = size_t(a.nqt) * (D + 4);
  float* ws_acc = a.ws + (pair * a.n_split + z) * region;
  float* ws_ml = ws_acc + size_t(a.nqt) * D;
  auto store_out = [&](int qi, int e, float4 v, float inv) {
    *reinterpret_cast<uint2*>(a.out + row_at(qi) + e) =
        make_uint2(pack_bf16(v.x * inv, v.y * inv), pack_bf16(v.z * inv, v.w * inv));
  };
  float lsum[2] = {quad_sum(l[0]), quad_sum(l[1])};
  if constexpr (WK == 1) {
    // a warp owns its rows: straight from the accumulator fragments
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = wr * 16 + g + 8 * h;
      if (qi >= nq) continue;
      if (a.n_split == 1) {
        const float inv = 1.f / lsum[h];  // the row's own column: l > 0
        __nv_bfloat16* orow = a.out + row_at(qi);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
              pack_bf16(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
      } else {
        if (nt > 0)  // a split without tiles leaves its acc unwritten (l = 0)
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<float2*>(ws_acc + size_t(qi) * D + j * 8 + 2 * t) =
                make_float2(o[j][2 * h], o[j][2 * h + 1]);
        if (t == 0) {
          ws_ml[4 * qi] = m[h];
          ws_ml[4 * qi + 1] = lsum[h];
        }
      }
    }
  } else {
    // the four warps of the strip merge in warp order through shared memory
    float* st_o = reinterpret_cast<float*>(smem);  // [WK][16][OP]
    float* st_m = st_o + WK * 16 * OP;             // [WK][16]
    float* st_l = st_m + WK * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = wk * 16 + g + 8 * h;
      if (t == 0) {
        st_m[slot] = m[h];
        st_l[slot] = lsum[h];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(st_o + slot * OP + j * 8 + 2 * t) =
            make_float2(o[j][2 * h], o[j][2 * h + 1]);
    }
    __syncthreads();
    for (int idx = tid; idx < nq * (D / 4); idx += kThreads) {
      const int qi = idx / (D / 4), e = idx % (D / 4) * 4;
      float mx = kNegBig, ls = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < WK; ++k) mx = fmaxf(mx, st_m[k * 16 + qi]);
#pragma unroll
      for (int k = 0; k < WK; ++k) {
        const int slot = k * 16 + qi;
        const float w = exp2f(st_m[slot] - mx);  // a warp that saw no column: 0
        const float4 v = *reinterpret_cast<const float4*>(st_o + slot * OP + e);
        ls += w * st_l[slot];
        acc = make_float4(acc.x + w * v.x, acc.y + w * v.y, acc.z + w * v.z, acc.w + w * v.w);
      }
      if (a.n_split == 1) {
        store_out(qi, e, acc, 1.f / ls);
      } else {
        if (nt > 0) *reinterpret_cast<float4*>(ws_acc + size_t(qi) * D + e) = acc;
        if (e == 0) {
          ws_ml[4 * qi] = mx;
          ws_ml[4 * qi + 1] = ls;
        }
      }
    }
  }
  if (a.n_split == 1) return;

  // The last block of this (kv head, sample, row tile) to arrive merges the
  // splits in index order. It runs once a launch and its code is cold, so its
  // loops stay rolled; its data comes in bulk through cp.async: every split's
  // (m, l) of every row at once, then the acc of the splits that saw a
  // column (a split past the bound saw none and wrote none), as many at a
  // time as the shared memory holds.
  if (!last_block_to_arrive(&a.tickets[pair], a.n_split)) return;
  const float* part = a.ws + pair * a.n_split * region;
  float* wts = reinterpret_cast<float*>(smem);  // [n_split][nq] weights
  float* ml = wts + kMaxSplit * kBR;            // [n_split][nq][4]: m, l, -, -
  __shared__ int live[kMaxSplit + 1];  // flags, then the live splits in order, and their count
#pragma unroll 1
  for (int p = tid; p < a.n_split * nq; p += kThreads)
    cp_async16(ml + 4 * p, part + p / nq * region + size_t(a.nqt) * D + 4 * (p % nq));
  cp_async_commit();
  if (tid < kMaxSplit) live[tid] = 0;
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll 1
  for (int p = tid; p < a.n_split * nq; p += kThreads)
    if (ml[4 * p + 1] > 0.f) live[p / nq] = 1;
  __syncthreads();
  if (tid == 0) {
    int n = 0;
#pragma unroll 1
    for (int s = 0; s < a.n_split; ++s)
      if (live[s]) live[n++] = s;
    live[kMaxSplit] = n;  // >= 1: split 0 holds every row's own column
  }
#pragma unroll 1
  for (int qi = tid; qi < nq; qi += kThreads) {
    float mx = kNegBig, ls = 0.f;
#pragma unroll 1
    for (int s = 0; s < a.n_split; ++s) mx = fmaxf(mx, ml[4 * (s * nq + qi)]);
#pragma unroll 1
    for (int s = 0; s < a.n_split; ++s) {
      const float* e = ml + 4 * (s * nq + qi);
      wts[s * nq + qi] = exp2f(e[0] - mx);
      ls += wts[s * nq + qi] * e[1];
    }
    // split 0 holds the row's own chunk column, so ls >= 1 up to rounding
#pragma unroll 1
    for (int s = 0; s < a.n_split; ++s) wts[s * nq + qi] /= ls;
  }
  __syncthreads();  // the weights are in place and `ml` is free
  // acc [nq][D] summed so far (with more than one batch), then a batch of
  // splits' acc
  const int n4 = nq * D / 4;  // four-column groups of the tile's rows
  float4* acc = reinterpret_cast<float4*>(ml);
  float4* staged = acc + n4;
  const int batch = (kSmemBytes<S, D> / 4 - kMaxSplit * kBR - nq * D) / (nq * D);
  const int n_live = live[kMaxSplit];
#pragma unroll 1
  for (int s0 = 0; s0 < n_live; s0 += batch) {
    const int ns = min(batch, n_live - s0);
#pragma unroll 1
    for (int c = tid; c < ns * n4; c += kThreads)
      cp_async16(staged + c, part + live[s0 + c / n4] * region + 4 * (c % n4));
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // the batch has landed
    // eight columns a thread: one 16-byte store of `out` (the SM's
    // outstanding requests, not its bytes, pace these stores)
#pragma unroll 1
    for (int idx = tid; idx < n4 / 2; idx += kThreads) {
      const int qi = idx / (D / 8);
      float4 v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[h] = s0 == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : acc[2 * idx + h];
#pragma unroll 1
      for (int s = 0; s < ns; ++s) {
        const float w = wts[live[s0 + s] * nq + qi];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 x = staged[s * n4 + 2 * idx + h];
          v[h] = make_float4(fmaf(w, x.x, v[h].x), fmaf(w, x.y, v[h].y),
                             fmaf(w, x.z, v[h].z), fmaf(w, x.w, v[h].w));
        }
      }
      if (s0 + ns < n_live) {
        acc[2 * idx] = v[0];
        acc[2 * idx + 1] = v[1];
      } else {
        *reinterpret_cast<uint4*>(a.out + row_at(qi) + idx % (D / 8) * 8) =
            make_uint4(pack_bf16(v[0].x, v[0].y), pack_bf16(v[0].z, v[0].w),
                       pack_bf16(v[1].x, v[1].y), pack_bf16(v[1].z, v[1].w));
      }
    }
    __syncthreads();  // the batch is consumed
  }
  if (tid == 0) a.tickets[pair] = 0;  // for the next launch (a graph replay too)
}

template <typename S, int D, int WK>
cudaError_t launch(const MmaArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = kSmemBytes<S, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      extend_mma_kernel<S, D, WK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(a.Hkv * a.n_tiles, B, a.n_split);
  extend_mma_kernel<S, D, WK><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename S, int D>
cudaError_t launch_shared(const MmaArgs& a, int B, cudaStream_t stream) {
  // at most 16 rows a kv head: the four warps share one strip's columns
  return a.nqt <= 16 ? launch<S, D, 4>(a, B, stream) : launch<S, D, 1>(a, B, stream);
}

}  // namespace

long long extend_mma_workspace_bytes(int B, int M, int H, int Hkv, int D, int n_split) {
  if (n_split <= 1 || Hkv <= 0) return 0;
  const int rows = M * (H / Hkv);
  const int tiles = (rows + kBR - 1) / kBR;
  return 4LL * B * Hkv * tiles * n_split * (rows < kBR ? rows : kBR) * (D + 4);
}

cudaError_t extend_mma(const void* q, const void* k_cache, const void* v_cache,
                       const void* k_chunk, const void* v_chunk, const int* length,
                       const void* k_scale, const void* v_scale, const int* q_pos,
                       const unsigned char* attend, void* out, void* workspace,
                       long long ws_bytes, int* tickets, int n_split, int B, int M,
                       int max_len, int H, int Hkv, int D, float scale, int window,
                       int storage, cudaStream_t stream) {
  if (n_split > 1 &&
      (workspace == nullptr || tickets == nullptr ||
       ws_bytes < extend_mma_workspace_bytes(B, M, H, Hkv, D, n_split)))
    return cudaErrorInvalidValue;
  const void* aligned[] = {q, k_cache, v_cache, k_chunk, v_chunk, out, workspace};
  for (const void* ptr : aligned)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorInvalidValue;
  MmaArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_cache = static_cast<const unsigned char*>(k_cache);
  a.v_cache = static_cast<const unsigned char*>(v_cache);
  a.k_chunk = static_cast<const __nv_bfloat16*>(k_chunk);
  a.v_chunk = static_cast<const __nv_bfloat16*>(v_chunk);
  a.length = length;
  a.k_scale = static_cast<const __nv_bfloat16*>(k_scale);
  a.v_scale = static_cast<const __nv_bfloat16*>(v_scale);
  a.q_pos = q_pos;
  a.attend = attend;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ws = static_cast<float*>(workspace);
  a.tickets = tickets;
  a.M = M;
  a.max_len = max_len;
  a.H = H;
  a.Hkv = Hkv;
  a.n_rep = H / Hkv;
  a.rows = M * a.n_rep;
  a.n_tiles = (a.rows + kBR - 1) / kBR;
  a.nqt = a.rows < kBR ? a.rows : kBR;
  a.n_split = n_split;
  a.chunk = (max_len + n_split - 1) / n_split;
  a.window = window;
  a.scale_log2 = scale * kLog2e;
  if (size_t(Hkv) * a.n_tiles > 0x7FFFFFFFu) return cudaErrorInvalidValue;
  switch (storage) {
    case kBFloat16:
      return D == 128 ? launch_shared<__nv_bfloat16, 128>(a, B, stream)
           : D == 64  ? launch_shared<__nv_bfloat16, 64>(a, B, stream)
                      : cudaErrorInvalidValue;
    case kInt8:
      return D == 128 ? launch_shared<signed char, 128>(a, B, stream)
           : D == 64  ? launch_shared<signed char, 64>(a, B, stream)
                      : cudaErrorInvalidValue;
    case kFloat8E4M3:
      return D == 128 ? launch_shared<Fp8, 128>(a, B, stream)
           : D == 64  ? launch_shared<Fp8, 64>(a, B, stream)
                      : cudaErrorInvalidValue;
  }
  return cudaErrorInvalidValue;
}

}  // namespace dllava
