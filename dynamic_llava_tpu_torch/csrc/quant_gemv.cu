// Weight-only int8 / int4 GEMVs (kernels K5-K8), for Hopper, sm_90a.
//
// Replaces the TPU kernels of dynamic_llava_tpu/ops/quant_matmul.py:
//   K5 _q8_gemv_kernel        (matmul_q8_pallas)        -> q8_gemv
//   K6 _q8_gemv_multi_kernel  (matmul_q8_multi_pallas)  -> q8_gemv_group
//   K7 _q4_gemv_kernel        (matmul_q4_pallas)        -> q4_gemv
//   K8 _q4_gemv_multi_kernel  (matmul_q4_multi_pallas)  -> q4_gemv_group
// The four entry points share the kernels below. They compute
// y = (x @ q) * s for x [rows <= 64, K] (bf16 or fp32), an int8 weight
// q [K, N] or a split-half packed int4 weight [K, N/2] (byte j: column j in
// the low nibble, column N/2 + j in the high nibble), per-output-column
// scales s [N] (bf16 or fp32) and y [rows, N] (bf16 or fp32), K a multiple
// of 8 up to 16384 and N of 64. Sums are fp32 and the scale is applied
// once, after the whole K loop. A group launch takes 1-3 weights that share
// x (q/k/v, gate/up): the grid spans their concatenated column tiles.
//
// What bounds it on the H100: bytes of weight read per call. At decode row
// counts a GEMV does `rows` multiply-adds per weight element, far below the
// card's ~295 flop/byte balance point, so the weight stream from HBM is the
// cost (int8: K*N bytes, int4: K*N/2). The design reads every weight byte
// from HBM exactly once, whatever the row count, keeps a whole block's share
// of it in flight at once, and spends as few instructions per weight as it
// can:
// - a cluster of 1-8 blocks owns a 64-column tile; each block takes a
//   slice of at most 2048 K rows, and the blocks' partial tiles are summed
//   in rank order through distributed shared memory (no global workspace,
//   no atomics). The split is the larger of what fills the SMs (N = 4096
//   alone has only 64 tiles) and what fits the slice;
// - at entry every thread issues its 16-byte cp.async copies of the whole
//   slice into shared memory (up to 160 KB with the row padding that
//   spreads banks), in groups of 256 rows, each group completing an
//   mbarrier; the math on a group starts as soon as it has landed, while
//   the later groups are still in flight;
// - int8 and int4 values become floats by a byte permute into the
//   mantissa of 2^23 and one subtraction (exact, and cheaper than I2F);
//   int4 nibbles sign-extend through `xor 8`;
// - bf16 x (the serving path): tensor cores, mma.sync m16n8k16 with bf16
//   inputs and fp32 sums. A warp converts a 16 x 32-byte block of the
//   slice to bf16 B fragments (4 ld.shared of 4 bytes a thread, the 4
//   bytes being 4 n8 tiles, so the physical columns are interleaved) and
//   multiplies it with every 16-row tile of x; the cost per weight is the
//   conversion, not the row count. int8 blocks split the tile in two column
//   groups of 32 (4 warps each along K), int4 blocks take the 32 packed
//   bytes = 64 columns in one group (8 warps along K);
// - fp32 x: FP32 FMAs on CUDA cores (tensor cores would round x). Each
//   weight element is read by one thread and applied to every row of x:
//   64 fp32 accumulators a thread (128 at 64 rows), MT rows (x's rows
//   rounded up to 8, 16, 32 or 64) times 64/MT columns.
// Left for later: wgmma and TMA tensor copies of the slice, and a larger
// share of HBM bandwidth (PERF.md).

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace dllava {
namespace {

namespace cg = cooperative_groups;

// kTileCols = 64 output columns per cluster (common.cuh)
constexpr int kSlabRows = 2048;  // K rows of weights a block holds
constexpr int kGroupRows = 256;  // K rows per mbarrier, and the unit of the K split
constexpr int kMaxGroups = kSlabRows / kGroupRows;
constexpr int kMaxGroup = 3;
constexpr int kMaxSplit = 8;  // blocks per cluster (the portable maximum)

struct Group {
  const int8_t* w[kMaxGroup];
  const void* s[kMaxGroup];
  void* y[kMaxGroup];
  int n[kMaxGroup];  // output columns of each weight
  int nw;
};

// ----------------------------------------------------------------------------
// Shared by both kernels: where the block's tile and K slice are, the copy of
// the slice into shared memory, and the sum of the partial tiles.

struct Slice {
  int tile;  // column tile within weight j
  int j;     // weight of the group
  int kb;    // first K row of the block's slice
  int nrows; // K rows in the slice (0 for a block past K)
};

__device__ __forceinline__ Slice locate(const Group& g, int split, int rank, int K) {
  Slice s;
  s.tile = blockIdx.x / split;
  s.j = 0;
  for (; s.j < g.nw - 1; ++s.j) {
    const int t = g.n[s.j] / kTileCols;
    if (s.tile < t) break;
    s.tile -= t;
  }
  // whole groups of rows, at most kSlabRows (the launcher picks split >=
  // K / kSlabRows)
  const int per = (K + split * kGroupRows - 1) / (split * kGroupRows) * kGroupRows;
  s.kb = rank * per;
  s.nrows = max(0, min(K, s.kb + per) - s.kb);
  return s;
}

// Issues the cp.async copies of the slice (group gi: rows [256 gi, 256 gi +
// 256) to slab rows of kRowStride bytes); every thread arrives on each
// group's mbarrier once its copies have landed. Returns the number of groups.
template <bool INT4, int Threads>
__device__ __forceinline__ int copy_slice(unsigned char* slab, uint64_t* bars,
                                          const Group& g, const Slice& s) {
  constexpr int kPerRow = kTileBytes<INT4> / 16;
  const int ngroups = (s.nrows + kGroupRows - 1) / kGroupRows;
  if (threadIdx.x == 0)
    for (int gi = 0; gi < ngroups; ++gi) mbar_init(&bars[gi], Threads);
  __syncthreads();
  const size_t ldw = INT4 ? g.n[s.j] / 2 : g.n[s.j];
  const int8_t* src = g.w[s.j] + size_t(s.tile) * kTileBytes<INT4> + size_t(s.kb) * ldw;
  for (int gi = 0; gi < ngroups; ++gi) {
    const int end = min(kGroupRows, s.nrows - gi * kGroupRows) * kPerRow;
    for (int c = threadIdx.x; c < end; c += Threads) {
      const int row = gi * kGroupRows + c / kPerRow, part = c % kPerRow;
      cp_async16(slab + row * kRowStride<INT4> + part * 16,
                 src + size_t(row) * ldw + part * 16);
    }
    cp_async_arrive(&bars[gi]);
  }
  return ngroups;
}

// part[p][MT][kTileCols], p < nparts, holds the block's partial tiles (all
// written before the call returns to a barrier): sums them, then sums the
// cluster's tiles in rank order (through distributed shared memory), each
// block scaling and storing a share of the outputs.
template <int MT, bool INT4, int Threads>
__device__ __forceinline__ void finish(float* part, int nparts, const Group& g,
                                       const Slice& s, int rows, int s_dtype,
                                       int y_dtype, cg::cluster_group& cluster) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < MT * kTileCols; idx += Threads) {
    float v = 0.f;
    for (int p = 0; p < nparts; ++p) v += part[p * MT * kTileCols + idx];
    part[idx] = v;  // only this thread reads or writes element idx of part[0]
  }
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  const int N = g.n[s.j];
  for (int idx = rank * Threads + threadIdx.x; idx < rows * kTileCols;
       idx += split * Threads) {
    float v = 0.f;
    for (int q = 0; q < split; ++q) v += cluster.map_shared_rank(part, q)[idx];
    const int r = idx / kTileCols, cl = idx % kTileCols;
    int col;  // tile column -> output column; int4: [0, 32) low, [32, 64) high
    if constexpr (INT4)
      col = cl < kTileCols / 2 ? s.tile * (kTileCols / 2) + cl
                               : N / 2 + s.tile * (kTileCols / 2) + cl - kTileCols / 2;
    else
      col = s.tile * kTileCols + cl;
    store_out(g.y[s.j], size_t(r) * N + col, v * load_scale(g.s[s.j], col, s_dtype),
              y_dtype);
  }
  cluster.sync();  // no block leaves while another reads its partial tile
}

// ----------------------------------------------------------------------------
// bf16 x: tensor cores.

template <int MT, bool INT4>
struct TcShape {
  static constexpr int Threads = 256;
  static constexpr int Warps = Threads / 32;
  static constexpr int CG = INT4 ? 1 : 2;   // 32-byte column groups of a tile row
  static constexpr int KLW = Warps / CG;    // warps along K
  static constexpr int NT = INT4 ? 8 : 4;   // n8 tiles of a warp
  static constexpr int MTILES = MT / 16;
  static constexpr int TK = 16384 / MT;     // K rows of x per staged chunk (32 KB)
  static constexpr int SX = TK + 8;         // x row stride in elements (bank spread)
  static_assert(TK % kGroupRows == 0, "chunks of whole groups");
  // shared memory: [x chunk][weight slice, later the partial tiles][mbarriers]
  static constexpr int kXBytes = 2 * MT * SX;
  static constexpr int kSlabBytes = kSlabRows * kRowStride<INT4>;
  static constexpr int kPartBytes = 4 * KLW * MT * kTileCols;
  static constexpr int kMidBytes = kSlabBytes > kPartBytes ? kSlabBytes : kPartBytes;
  static constexpr int kSmemBytes = kXBytes + kMidBytes + 8 * kMaxGroups;
};

template <int MT, bool INT4>
__global__ void __launch_bounds__(TcShape<MT, INT4>::Threads, 1)
gemv_tc_kernel(const __nv_bfloat16* __restrict__ x, Group g, int rows, int K,
               int s_dtype, int y_dtype) {
  using S = TcShape<MT, INT4>;
  constexpr int RS = kRowStride<INT4>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* slab = smem + S::kXBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kXBytes + S::kMidBytes);
  cg::cluster_group cluster = cg::this_cluster();
  const Slice sl = locate(g, static_cast<int>(cluster.num_blocks()),
                          static_cast<int>(cluster.block_rank()), K);
  const int ngroups = copy_slice<INT4, S::Threads>(slab, bars, g, sl);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cgi = warp % S::CG, kl = warp / S::CG;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  float acc[S::MTILES][S::NT][4];
#pragma unroll
  for (int m = 0; m < S::MTILES; ++m)
#pragma unroll
    for (int n = 0; n < S::NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  int landed = 0;  // groups this thread has waited for
  for (int c0 = 0; c0 < sl.nrows; c0 += S::TK) {  // slice rows of the x chunk
    __syncthreads();  // every warp is done with the previous chunk
    // x rows [0, rows) x K rows [kb + c0, + TK) -> xs[MT][SX], zero-padded,
    // 16 bytes (8 elements of one row) a load
    const int kc = min(S::TK, sl.nrows - c0);
    for (int idx = threadIdx.x; idx < MT * S::TK / 8; idx += S::Threads) {
      const int r = idx / (S::TK / 8), k8 = idx % (S::TK / 8) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows && k8 < kc)
        v = *reinterpret_cast<const uint4*>(x + size_t(r) * K + sl.kb + c0 + k8);
      *reinterpret_cast<uint4*>(xs + r * S::SX + k8) = v;
    }
    __syncthreads();
    for (int st = kl; st * 16 < kc; st += S::KLW) {  // k16 steps of this warp
      const int r0 = c0 + st * 16;  // slice row of the step
      const int need = min(ngroups, (r0 + 16 + kGroupRows - 1) / kGroupRows);
      while (landed < need) mbar_wait(&bars[landed++]);
      // B fragments: rows r0 + 2tq, +1, +8, +9 of the slice, 4 bytes at
      // column 4 gq of the warp's 32-byte group: byte t is n8 tile t (int4:
      // its low nibble tile t, its high nibble tile 4 + t), fragment
      // column gq. Rows past the slice hold stale bytes and meet zeros of x.
      const unsigned char* wb = slab + (r0 + 2 * tq) * RS + cgi * 32 + 4 * gq;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wb);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wb + RS);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(wb + 8 * RS);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(wb + 9 * RS);
      uint32_t b[S::NT][2];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if constexpr (INT4) {
          b[t][0] = pack_bf16(lo4_at(w0, t), lo4_at(w1, t));
          b[t][1] = pack_bf16(lo4_at(w8, t), lo4_at(w9, t));
          b[4 + t][0] = pack_bf16(hi4_at(w0, t), hi4_at(w1, t));
          b[4 + t][1] = pack_bf16(hi4_at(w8, t), hi4_at(w9, t));
        } else {
          b[t][0] = pack_bf16(s8_at(w0, t), s8_at(w1, t));
          b[t][1] = pack_bf16(s8_at(w8, t), s8_at(w9, t));
        }
      }
#pragma unroll
      for (int m = 0; m < S::MTILES; ++m) {
        const __nv_bfloat16* xa = xs + (16 * m + gq) * S::SX + st * 16 + 2 * tq;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(xa);
        a[1] = *reinterpret_cast<const uint32_t*>(xa + 8 * S::SX);
        a[2] = *reinterpret_cast<const uint32_t*>(xa + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(xa + 8 * S::SX + 8);
#pragma unroll
        for (int n = 0; n < S::NT; ++n) mma_bf16(acc[m][n], a, b[n]);
      }
    }
  }
  while (landed < ngroups) mbar_wait(&bars[landed++]);  // the slab is reused below

  // each K-lane warp writes its partial tile part[kl][MT][kTileCols] over the
  // consumed slice: accumulator (m, n, e) is row 16 m + gq (+8 for e >= 2),
  // fragment column 2 tq + e % 2, i.e. tile column 4 (2 tq + e % 2) + n in
  // the warp's group (int4: n < 4 low half, n >= 4 high half)
  __syncthreads();
  float* part = reinterpret_cast<float*>(slab);
  float* mine = part + kl * MT * kTileCols;
#pragma unroll
  for (int m = 0; m < S::MTILES; ++m)
#pragma unroll
    for (int n = 0; n < S::NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * m + gq + (e >= 2 ? 8 : 0);
        const int fc = 4 * (2 * tq + (e & 1));
        const int col = INT4 ? (n < 4 ? fc + n : kTileCols / 2 + fc + n - 4)
                             : cgi * 32 + fc + n;
        mine[row * kTileCols + col] = acc[m][n][e];
      }
  finish<MT, INT4, S::Threads>(part, S::KLW, g, sl, rows, s_dtype, y_dtype, cluster);
}

// ----------------------------------------------------------------------------
// fp32 x: FP32 FMAs on CUDA cores.

template <int MT, bool INT4>
struct FmaShape {
  // 16 warps of 64 fp32 accumulators a thread (~110 registers), but 8 warps
  // of 128 at 64 rows, where an int4 thread needs at least 2 columns
  static constexpr int Threads = MT == 64 ? 256 : 512;
  static constexpr int Warps = Threads / 32;
  static constexpr int Accs = MT == 64 ? 128 : 64;
  static constexpr int C = Accs / MT;           // output columns per thread
  static constexpr int CB = INT4 ? C / 2 : C;   // weight bytes per thread and K row
  static constexpr int LC = kTileCols / C;      // lanes along the columns
  static constexpr int KL = 32 / LC;            // lanes along K in a warp
  static constexpr int NK = Warps * KL;         // K rows per round of the block
  static constexpr int TK = 16384 / MT;         // K rows of x per staged chunk (64 KB)
  static_assert(LC * CB == kTileBytes<INT4>, "tile width");
  static_assert(kGroupRows % NK == 0 && TK % kGroupRows == 0, "whole rounds");
  // shared memory: [x chunk][weight slice, later one partial tile per warp][mbarriers]
  static constexpr int kXBytes = 4 * MT * TK;
  static constexpr int kSlabBytes = kSlabRows * kRowStride<INT4>;
  static constexpr int kPartBytes = 4 * Warps * MT * kTileCols;
  static constexpr int kMidBytes = kSlabBytes > kPartBytes ? kSlabBytes : kPartBytes;
  static constexpr int kSmemBytes = kXBytes + kMidBytes + 8 * kMaxGroups;
};

template <int CB>
struct Raw {
  uint32_t u[(CB + 3) / 4];
};

template <int CB>
__device__ __forceinline__ Raw<CB> load_raw(const unsigned char* p) {
  Raw<CB> r;
  if constexpr (CB == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    r.u[0] = v.x; r.u[1] = v.y; r.u[2] = v.z; r.u[3] = v.w;
  } else if constexpr (CB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    r.u[0] = v.x; r.u[1] = v.y;
  } else if constexpr (CB == 4) {
    r.u[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (CB == 2) {
    r.u[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    r.u[0] = *p;
  }
  return r;
}

// CB weight bytes -> C floats: int8 values in order; int4 low nibbles
// (columns j) then high nibbles (columns N/2 + j).
template <int CB, bool INT4>
__device__ __forceinline__ void unpack(const Raw<CB>& r, float* w) {
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    if constexpr (INT4) {
      w[b] = lo4_at(r.u[b / 4], b % 4);
      w[CB + b] = hi4_at(r.u[b / 4], b % 4);
    } else {
      w[b] = s8_at(r.u[b / 4], b % 4);
    }
  }
}

template <int MT, bool INT4>
__global__ void __launch_bounds__(FmaShape<MT, INT4>::Threads, 1)
gemv_fma_kernel(const float* __restrict__ x, Group g, int rows, int K,
                int s_dtype, int y_dtype) {
  using S = FmaShape<MT, INT4>;
  constexpr int RS = kRowStride<INT4>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  unsigned char* slab = smem + S::kXBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kXBytes + S::kMidBytes);
  cg::cluster_group cluster = cg::this_cluster();
  const Slice sl = locate(g, static_cast<int>(cluster.num_blocks()),
                          static_cast<int>(cluster.block_rank()), K);
  const int ngroups = copy_slice<INT4, S::Threads>(slab, bars, g, sl);

  const int lane = threadIdx.x & 31;
  const int lc = lane % S::LC;
  const int kid = (threadIdx.x >> 5) * S::KL + lane / S::LC;  // K lane, < NK
  float acc[MT][S::C];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < S::C; ++c) acc[r][c] = 0.f;

  for (int c0 = 0; c0 < sl.nrows; c0 += S::TK) {  // slice rows of the x chunk
    __syncthreads();  // every warp is done with the previous chunk
    // x rows [0, rows) x K rows [kb + c0, + TK) -> xs[k][MT], zero-padded,
    // 16 bytes (4 elements of one row) a load
    const int kc = min(S::TK, sl.nrows - c0);
#pragma unroll 4
    for (int it = 0; it < MT * S::TK / 4 / S::Threads; ++it) {
      const int idx = it * S::Threads + threadIdx.x;
      const int r = idx % MT, kk = idx / MT * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && kk < kc)
        v = *reinterpret_cast<const float4*>(x + size_t(r) * K + sl.kb + c0 + kk);
      xs[kk * MT + r] = v.x;
      xs[(kk + 1) * MT + r] = v.y;
      xs[(kk + 2) * MT + r] = v.z;
      xs[(kk + 3) * MT + r] = v.w;
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < S::TK / S::NK; ++i) {
      const int base = c0 + i * S::NK;  // first slice row of this round
      if (base >= sl.nrows) break;
      if (base % kGroupRows == 0) mbar_wait(&bars[base / kGroupRows]);
      if (base + kid < sl.nrows) {
        float w[S::C];
        unpack<S::CB, INT4>(load_raw<S::CB>(slab + (base + kid) * RS + lc * S::CB), w);
        const float* xr = xs + (i * S::NK + kid) * MT;
#pragma unroll
        for (int r = 0; r < MT; r += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + r);
#pragma unroll
          for (int c = 0; c < S::C; ++c) {
            acc[r][c] = fmaf(xv.x, w[c], acc[r][c]);
            acc[r + 1][c] = fmaf(xv.y, w[c], acc[r + 1][c]);
            acc[r + 2][c] = fmaf(xv.z, w[c], acc[r + 2][c]);
            acc[r + 3][c] = fmaf(xv.w, w[c], acc[r + 3][c]);
          }
        }
      }
    }
  }
  (void)ngroups;  // every group was waited for in the loop above

  // the K lanes of a warp meet by shuffles; each warp writes its partial
  // tile part[warp][MT][kTileCols] over the consumed slice
  __syncthreads();
  float* part = reinterpret_cast<float*>(slab);
  float* mine = part + (threadIdx.x >> 5) * MT * kTileCols;
#pragma unroll
  for (int c = 0; c < S::C; ++c) {
    int col;  // column within the tile; int4: [0, 32) low, [32, 64) high
    if constexpr (INT4)
      col = c < S::CB ? lc * S::CB + c : kTileCols / 2 + lc * S::CB + (c - S::CB);
    else
      col = lc * S::C + c;
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      float v = acc[r][c];
#pragma unroll
      for (int off = S::LC; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane < S::LC) mine[r * kTileCols + col] = v;
    }
  }
  finish<MT, INT4, S::Threads>(part, S::Warps, g, sl, rows, s_dtype, y_dtype, cluster);
}

// ----------------------------------------------------------------------------
// Launch.

// Blocks per tile: at least K / kSlabRows, and the smallest power of two
// that fills at least 85% of the last wave of one block per SM.
int pick_split(int tiles, int K) {
  const int sms = sm_count();
  int s = 1;
  for (; s < kMaxSplit; s *= 2) {
    const int blocks = tiles * s, waves = (blocks + sms - 1) / sms;
    if (blocks >= 0.85 * waves * sms) break;
  }
  const int need = (K + kSlabRows - 1) / kSlabRows;
  return s > need ? s : need;
}

template <typename X>
cudaError_t launch(void (*kernel)(const X*, Group, int, int, int, int),
                   int threads, int smem_bytes, const void* x, const Group& g,
                   int rows, int K, int s_dtype, int y_dtype, cudaStream_t stream) {
  int tiles = 0;
  for (int j = 0; j < g.nw; ++j) tiles += g.n[j] / kTileCols;
  const int split = pick_split(tiles, K);
  if (split > kMaxSplit) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const X* xp = static_cast<const X*>(x);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, xp, g, rows, K, s_dtype, y_dtype);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int MT, bool INT4>
cudaError_t launch_tc(const void* x, const Group& g, int rows, int K, int s_dtype,
                      int y_dtype, cudaStream_t stream) {
  using S = TcShape<MT, INT4>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemv_tc_kernel<MT, INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  return launch<__nv_bfloat16>(gemv_tc_kernel<MT, INT4>, S::Threads, S::kSmemBytes,
                               x, g, rows, K, s_dtype, y_dtype, stream);
}

template <int MT, bool INT4>
cudaError_t launch_fma(const void* x, const Group& g, int rows, int K, int s_dtype,
                       int y_dtype, cudaStream_t stream) {
  using S = FmaShape<MT, INT4>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemv_fma_kernel<MT, INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  return launch<float>(gemv_fma_kernel<MT, INT4>, S::Threads, S::kSmemBytes, x, g,
                       rows, K, s_dtype, y_dtype, stream);
}

template <bool INT4>
cudaError_t launch_rows(const void* x, bool bf16, const Group& g, int rows, int K,
                        int s_dtype, int y_dtype, cudaStream_t stream) {
  if (bf16) {
    if (rows <= 16) return launch_tc<16, INT4>(x, g, rows, K, s_dtype, y_dtype, stream);
    if (rows <= 32) return launch_tc<32, INT4>(x, g, rows, K, s_dtype, y_dtype, stream);
    return launch_tc<64, INT4>(x, g, rows, K, s_dtype, y_dtype, stream);
  }
  if (rows <= 8) return launch_fma<8, INT4>(x, g, rows, K, s_dtype, y_dtype, stream);
  if (rows <= 16) return launch_fma<16, INT4>(x, g, rows, K, s_dtype, y_dtype, stream);
  if (rows <= 32) return launch_fma<32, INT4>(x, g, rows, K, s_dtype, y_dtype, stream);
  return launch_fma<64, INT4>(x, g, rows, K, s_dtype, y_dtype, stream);
}

int dispatch(const void* x, const Group& g, int rows, int K, bool int4,
             int x_dtype, int s_dtype, int y_dtype, void* stream) {
  // the one statement of the shape contract (the Python wrappers check only
  // devices, dtypes, shapes and contiguity, which these pointers cannot show)
  if (rows < 1 || rows > 64 || K < 8 || K % 8 != 0 || K > kMaxSplit * kSlabRows ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || g.nw < 1 || g.nw > kMaxGroup)
    return cudaErrorInvalidValue;
  for (int j = 0; j < g.nw; ++j)
    if (g.n[j] <= 0 || g.n[j] % kTileCols != 0 ||
        reinterpret_cast<uintptr_t>(g.w[j]) % 16 != 0)
      return cudaErrorInvalidValue;
  const int dtypes[] = {x_dtype, s_dtype, y_dtype};
  for (int dt : dtypes)
    if (dt != kFloat32 && dt != kBFloat16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = x_dtype == kBFloat16;
  return int4 ? launch_rows<true>(x, bf16, g, rows, K, s_dtype, y_dtype, s)
              : launch_rows<false>(x, bf16, g, rows, K, s_dtype, y_dtype, s);
}

Group one(const void* w, const void* s, void* y, int n) {
  Group g{};
  g.w[0] = static_cast<const int8_t*>(w);
  g.s[0] = s;
  g.y[0] = y;
  g.n[0] = n;
  g.nw = 1;
  return g;
}

Group many(const void* w0, const void* w1, const void* w2, const void* s0,
           const void* s1, const void* s2, void* y0, void* y1, void* y2, int n0,
           int n1, int n2, int nw) {
  Group g{};
  const void* w[] = {w0, w1, w2};
  const void* s[] = {s0, s1, s2};
  void* y[] = {y0, y1, y2};
  const int n[] = {n0, n1, n2};
  for (int j = 0; j < kMaxGroup; ++j) {
    g.w[j] = static_cast<const int8_t*>(w[j]);
    g.s[j] = s[j];
    g.y[j] = y[j];
    g.n[j] = n[j];
  }
  g.nw = nw;
  return g;
}

}  // namespace
}  // namespace dllava

// C entry points. N is the number of OUTPUT columns (for int4 the packed
// weight has N/2 bytes per row). Each returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int q8_gemv(const void* x, const void* w, const void* s, void* y,
                       int N, int rows, int K, int x_dtype, int s_dtype,
                       int y_dtype, void* stream) {
  using namespace dllava;
  return dispatch(x, one(w, s, y, N), rows, K, false, x_dtype, s_dtype, y_dtype,
                  stream);
}

extern "C" int q4_gemv(const void* x, const void* w, const void* s, void* y,
                       int N, int rows, int K, int x_dtype, int s_dtype,
                       int y_dtype, void* stream) {
  using namespace dllava;
  return dispatch(x, one(w, s, y, N), rows, K, true, x_dtype, s_dtype, y_dtype,
                  stream);
}

extern "C" int q8_gemv_group(const void* x, const void* w0, const void* w1,
                             const void* w2, const void* s0, const void* s1,
                             const void* s2, void* y0, void* y1, void* y2,
                             int n0, int n1, int n2, int nw, int rows, int K,
                             int x_dtype, int s_dtype, int y_dtype,
                             void* stream) {
  using namespace dllava;
  return dispatch(x, many(w0, w1, w2, s0, s1, s2, y0, y1, y2, n0, n1, n2, nw),
                  rows, K, false, x_dtype, s_dtype, y_dtype, stream);
}

extern "C" int q4_gemv_group(const void* x, const void* w0, const void* w1,
                             const void* w2, const void* s0, const void* s1,
                             const void* s2, void* y0, void* y1, void* y2,
                             int n0, int n1, int n2, int nw, int rows, int K,
                             int x_dtype, int s_dtype, int y_dtype,
                             void* stream) {
  using namespace dllava;
  return dispatch(x, many(w0, w1, w2, s0, s1, s2, y0, y1, y2, n0, n1, n2, nw),
                  rows, K, true, x_dtype, s_dtype, y_dtype, stream);
}
