// Weight-only int8 / int4 GEMVs (kernels K5-K8), for Hopper, sm_90a.
//
// Replaces the TPU kernels of dynamic_llava_tpu/ops/quant_matmul.py:
//   K5 _q8_gemv_kernel        (matmul_q8_pallas)        -> q8_gemv
//   K6 _q8_gemv_multi_kernel  (matmul_q8_multi_pallas)  -> q8_gemv_group
//   K7 _q4_gemv_kernel        (matmul_q4_pallas)        -> q4_gemv
//   K8 _q4_gemv_multi_kernel  (matmul_q4_multi_pallas)  -> q4_gemv_group
// The four entry points share the two kernels below. They compute
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
// cost (int8: K*N bytes, int4: K*N/2). Both kernels read every weight byte
// from HBM exactly once, whatever the row count, and turn int8 and int4
// values into floats by a byte permute into the mantissa of 2^23 and one
// subtraction (exact, and cheaper than I2F; int4 nibbles sign-extend through
// `xor 8`).
//
// bf16 x (the serving path), gemv_tc_kernel: what it must do is keep HBM
// busy from the first cycle of a launch to the last, on every SM, in pieces
// that DRAM serves well.
// - persistent blocks, one an SM, each walking a fixed list of cells: a
//   256-column tile (rows of 256 or 128 contiguous bytes) times a slice of K,
//   in units of 128 or 256 K rows (32 KB of weights). The list is a pure
//   function of the shapes and the SM count. Cells are ordered slice by
//   slice and handed out round-robin, so the blocks that run side by side
//   read neighbouring tiles of the same K rows at the same pace and DRAM sees
//   whole rows; the number of slices is the one that fills the SMs' waves
//   best (the o projection's 16 int8 tiles are cut in 8, gate/up's 86 in 3);
// - a ring of 4-5 shared-memory stages across units: the cp.async copies of
//   the next units (weights and the matching columns of x, one commit group
//   a unit) are in flight while this one is multiplied, from one tile into
//   the next, at the price of one block barrier a unit (an mbarrier that
//   every thread arrives on costs more than the products of a unit);
// - tensor cores: mma.sync m16n8k16 with bf16 inputs and fp32 sums. A warp
//   owns 32 columns of the tile (32 bytes of every int8 row; 16 bytes of an
//   int4 row, 16 low and 16 high columns), so the 8 warps never share a sum.
//   One ldmatrix.trans brings a k16 step of them, 2 bytes a lane and row
//   pair, laid out as the B operand wants them; the cost per weight is the
//   conversion, not the row count;
// - an unsliced tile is scaled and stored from registers. A sliced one: each
//   cell writes its partial tile to an fp32 scratch, and the last of the
//   tile's blocks to arrive (a ticket, common.cuh) sums the partial tiles in
//   slice order, so no atomics touch a value and every call gives the same
//   bits;
// - the weights go from bytes to bf16 pairs without a trip through fp32
//   (common.cuh, s8_pair).
// fp32 x, gemv_fma_kernel: FP32 FMAs on CUDA cores (tensor cores would round
// x), as first written for this card:
// - a cluster of 1-8 blocks owns a 64-column tile; each block takes a
//   slice of at most 2048 K rows, copied whole at entry (cp.async in groups of
//   256 rows, each completing an mbarrier), and the blocks' partial tiles are
//   summed in rank order through distributed shared memory;
// - each weight element is read by one thread and applied to every row of x:
//   64 fp32 accumulators a thread (128 at 64 rows), MT rows (x's rows
//   rounded up to 8, 16, 32 or 64) times 64/MT columns.
// Left for later: wgmma, and TMA copies of the units (PERF.md).

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
// bf16 x: tensor cores, persistent blocks.
//
// The work is a list of cells, a pure function of the shapes and the SM
// count: a cell is a column tile (256 output columns: 256 contiguous bytes of
// an int8 row, 128 of an int4 row, whose low nibbles are 128 columns of the
// low half and whose high nibbles the matching 128 of the high half) times a
// slice of K, `chunks` units of KR rows (a unit is 32 KB of weights). Cell
// c = slice * tiles + tile, over the tiles of the group's weights in order;
// block b of the grid (one an SM) takes cells b, b + grid, ...: blocks that run
// side by side read neighbouring tiles of the same K rows at the same pace,
// so DRAM sees whole rows, not 256-byte pieces a row stride apart.

constexpr int kItemCols = 256;  // output columns of a column tile

template <int MT, bool INT4>
struct TcShape {
  static constexpr int TB = INT4 ? kItemCols / 2 : kItemCols;  // weight bytes of a tile row
  static constexpr int Warps = 8;
  static constexpr int Threads = 32 * Warps;
  static constexpr int WB = TB / Warps;  // bytes of a row a warp owns: 2 or 1 ldmatrix rows
  static constexpr int KR = 32768 / TB;  // K rows of a unit: 128 or 256
  static constexpr int RS = TB + 16;     // padded row stride: ldmatrix without bank conflicts
  static constexpr int NT = 4;           // n8 tiles of a warp
  static constexpr int MTILES = MT / 16;
  static constexpr int kAccFloats = MTILES * NT * 4;  // accumulators a thread
  static constexpr int SX = KR + 8;      // x row stride in elements (bank spread)
  // a stage of the ring: [x chunk MT x SX bf16][weights KR x RS bytes]
  static constexpr int kXBytes = 2 * MT * SX;
  static constexpr int kStageBytes = kXBytes + KR * RS;
  static constexpr int kBudget = 220 * 1024;
  static constexpr int Stages = kBudget / kStageBytes < 6 ? kBudget / kStageBytes : 6;
  static constexpr int kSmemBytes = Stages * kStageBytes;
  // a cell's partial tile in the scratch: the 4 floats of an mma tile a
  // thread, MT rows times 256 columns in all
  static constexpr int kPartFloats = kAccFloats * Threads;
  static_assert(kPartFloats == MT * kItemCols && Stages >= 3, "partial tile; ring depth");
  static_assert(WB == (INT4 ? 16 : 32), "ldmatrix rows a warp");
};

// column tiles of all weights of a group
inline int group_tiles(const Group& g) {
  int tiles = 0;
  for (int j = 0; j < g.nw; ++j) tiles += (g.n[j] + kItemCols - 1) / kItemCols;
  return tiles;
}

template <int MT, bool INT4>
__global__ void __launch_bounds__(TcShape<MT, INT4>::Threads, 1)
gemv_tc_kernel(const __nv_bfloat16* __restrict__ x, Group g, int rows, int K,
               int s_dtype, int y_dtype, TcPlan plan, float* __restrict__ scratch,
               int* __restrict__ tickets) {
  using S = TcShape<MT, INT4>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  const int G = gridDim.x;

  // x rows past `rows` are never copied: they stay zero
  for (int s = 0; s < S::Stages; ++s)
    for (int i = tid; i < S::kXBytes / 16; i += S::Threads)
      reinterpret_cast<uint4*>(smem + s * S::kStageBytes)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int nkc = (K + S::KR - 1) / S::KR;  // units of a tile
  const int cells = plan.tiles * plan.slices;

  // A position in the block's list of units: unit j of cell c, which is K
  // rows [k0, k0 + KR) of column tile `tile` of weight `w`. The producer
  // (copies) and the consumer (products) each walk the list.
  struct Walk {
    int c, j, chunks;     // cell, unit in it, units of the cell
    int w, tile, gtile;   // weight, tile in it, tile over all weights
    int k0;
  };
  auto enter = [&](Walk& p, int c) {  // at unit 0 of cell c (if there is one)
    p.c = c;
    p.j = 0;
    if (c >= cells) return;
    const int slice = c / plan.tiles;
    p.gtile = c - slice * plan.tiles;
    p.chunks = min(plan.chunks, nkc - slice * plan.chunks);
    p.k0 = slice * plan.chunks * S::KR;
    p.tile = p.gtile;
    p.w = 0;
    for (; p.w < g.nw - 1; ++p.w) {
      const int t = (g.n[p.w] + kItemCols - 1) / kItemCols;
      if (p.tile < t) break;
      p.tile -= t;
    }
  };
  auto advance = [&](Walk& p) {
    if (++p.j == p.chunks)
      enter(p, p.c + G);
    else
      p.k0 += S::KR;
  };
  auto stage_of = [&](uint32_t n) { return smem + (n % S::Stages) * S::kStageBytes; };
  // this thread's cp.async copies of the unit at `p` into the stage of the
  // block's n-th unit (the caller commits them as one group)
  auto send = [&](uint32_t n, const Walk& p) {
    const int nrows = min(S::KR, K - p.k0);
    const int ldw = INT4 ? g.n[p.w] / 2 : g.n[p.w];  // bytes of a weight row
    const int valid = min(S::TB, ldw - p.tile * S::TB) / 16;  // 16-byte pieces of a tile row
    unsigned char* xd = stage_of(n);
    unsigned char* wd = xd + S::kXBytes;
    const int8_t* src = g.w[p.w] + size_t(p.k0) * ldw + size_t(p.tile) * S::TB;
    constexpr int kPieces = S::TB / 16;  // of a whole tile row
    const int piece = tid % kPieces;
    if (piece < valid)
      for (int row = tid / kPieces; row < nrows; row += S::Threads / kPieces)
        cp_async16(wd + row * S::RS + piece * 16, src + size_t(row) * ldw + piece * 16);
    // whole k16 steps of x: a last half step is zero-filled, so the weight
    // rows past the unit (stale bytes, always finite) meet zeros
    constexpr int kXPieces = S::KR / 8;  // 16-byte pieces of a whole x row
    const int xvalid = (nrows + 15) / 16 * 2;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(xd);
    for (int c = tid; c < rows * kXPieces; c += S::Threads) {
      const int r = c / kXPieces, k8 = c % kXPieces * 8;
      if (k8 >= xvalid * 8) continue;
      const bool ok = k8 < nrows;
      cp_async16_zfill(xs + r * S::SX + k8, x + (ok ? size_t(r) * K + p.k0 + k8 : 0), ok);
    }
  };

  float acc[S::MTILES][S::NT][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int m = 0; m < S::MTILES; ++m)
#pragma unroll
      for (int n = 0; n < S::NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  };
  // adds the products of the block's n-th unit (landed) to acc: every warp
  // walks all k16 steps on its own 16 bytes of the tile's rows
  auto compute = [&](uint32_t n, int nrows) {
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(stage_of(n));
    // the row this lane hands to ldmatrix: k row lane % 16 of a step (int8:
    // lanes 16-31 the warp's second 16 bytes of it)
    const unsigned char* slab = stage_of(n) + S::kXBytes + (lane & 15) * S::RS +
                                warp * S::WB + (INT4 ? 0 : (lane >> 4) * 16);
#pragma unroll(S::MTILES >= 4 ? 1 : 2)  // two steps in flight where registers allow
    for (int st = 0; st * 16 < nrows; ++st) {
      // 16 k rows x 16 bytes, transposed by ldmatrix as if they were b16:
      // w[h] holds bytes 2 gq and 2 gq + 1 of k rows 8 h + 2 tq (low half)
      // and 8 h + 2 tq + 1 (high half); int8: w[2 + h] the same of the second
      // 16 bytes. Byte t of both rows, side by side, is the B fragment of an
      // n8 tile, fragment column gq: int8 tile 2 c + t for 16-byte group c,
      // int4 tile t (low nibbles) and tile 2 + t (high nibbles).
      uint32_t w[S::WB / 8];
      if constexpr (INT4)
        ldmatrix_x2_trans(w, slab + st * 16 * S::RS);
      else
        ldmatrix_x4_trans(w, slab + st * 16 * S::RS);
      uint32_t b[S::NT][2];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (INT4) {
            const uint32_t pair = pair_bytes(w[h], t);
            b[t][h] = lo4_pair(pair);
            b[2 + t][h] = hi4_pair(pair);
          } else {
            b[t][h] = s8_pair(pair_bytes(w[h], t));
            b[2 + t][h] = s8_pair(pair_bytes(w[2 + h], t));
          }
        }
#pragma unroll
      for (int m = 0; m < S::MTILES; ++m) {
        uint32_t af[4];
        ldmatrix_x4(af, frag_ptr(xs, S::SX, 16 * m, st * 16, lane));
#pragma unroll
        for (int n = 0; n < S::NT; ++n) mma_bf16(acc[m][n], af, b[n]);
      }
    }
  };
  // the output column of accumulator column (n, e) of the tile at `p`, or -1
  // past a narrower last tile: fragment column 2 tq + e of n8 tile n (int4:
  // tiles 2, 3 are the high half; int8: the warp's second 16 bytes)
  auto col_of = [&](const Walk& p, int n, int e) {
    const int N = g.n[p.w], ldw = INT4 ? N / 2 : N;
    const int byte = p.tile * S::TB + warp * S::WB + (INT4 ? 0 : (n >> 1) * 16) +
                     2 * (2 * tq + e) + (n & 1);
    if (byte >= ldw) return -1;
    return INT4 && n >= 2 ? N / 2 + byte : byte;
  };
  // the scales of this thread's columns, fetched when a cell begins so that
  // the store at its end does not wait for them
  float scale[S::NT][2];
  auto fetch_scales = [&](const Walk& p) {
#pragma unroll
    for (int n = 0; n < S::NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col_of(p, n, e);
        scale[n][e] = col < 0 ? 0.f : load_scale(g.s[p.w], col, s_dtype);
      }
  };
  // scales and stores the tile held in acc: accumulator (m, n, e) is x row
  // 16 m + gq (+ 8 for e >= 2) and column (n, e % 2)
  auto store_tile = [&](const Walk& p) {
    const int N = g.n[p.w];
#pragma unroll
    for (int n = 0; n < S::NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col_of(p, n, e);
        if (col < 0) continue;
#pragma unroll
        for (int m = 0; m < S::MTILES; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = 16 * m + gq + 8 * half;
            if (row < rows)
              store_out(g.y[p.w], size_t(row) * N + col,
                        acc[m][n][2 * half + e] * scale[n][e], y_dtype);
          }
      }
  };
  auto part_of = [&](int cell) {
    return reinterpret_cast<float4*>(scratch + size_t(cell) * S::kPartFloats) + tid;
  };

  // One cp.async group a unit, Stages - 1 of them in flight (empty groups
  // past the block's last unit keep the count). Per unit one barrier: past
  // it this unit's copies of every thread have landed, and every warp is
  // done with the unit before, whose stage the next copies then take.
  uint32_t sent = 0, done = 0;
  Walk producer, cur;
  enter(producer, blockIdx.x);
  enter(cur, blockIdx.x);
  auto send_next = [&]() {
    if (producer.c < cells) {
      send(sent, producer);
      advance(producer);
    }
    ++sent;
    cp_async_commit();
  };
  for (int i = 0; i < S::Stages - 1; ++i) send_next();
  for (; cur.c < cells; advance(cur)) {
    cp_async_wait<S::Stages - 2>();
    __syncthreads();
    send_next();
    if (cur.j == 0) {
      zero_acc();
      fetch_scales(cur);
    }
    compute(done++, min(S::KR, K - cur.k0));
    if (cur.j == cur.chunks - 1) {  // the cell is summed
      if (plan.slices == 1) {
        store_tile(cur);
      } else {
        // the tile is shared by `slices` cells: the partial tile goes to the
        // scratch (16 bytes a thread and mma tile, for the m tiles that hold
        // rows of x), and the last of the tile's blocks to arrive sums the
        // partial tiles in slice order
        float4* part = part_of(cur.c);
#pragma unroll
        for (int m = 0; m < S::MTILES; ++m)
          if (16 * m + gq < rows)
#pragma unroll
            for (int n = 0; n < S::NT; ++n)
              part[(m * S::NT + n) * S::Threads] =
                  make_float4(acc[m][n][0], acc[m][n][1], acc[m][n][2], acc[m][n][3]);
        if (last_block_to_arrive(&tickets[cur.gtile], plan.slices)) {
          // kDepth slices' loads in flight at a time (as registers allow): the
          // sum waits for one L2 round trip a batch, not one a slice
          constexpr int kDepth = S::kAccFloats >= 64 ? 2 : S::MTILES == 1 ? 8 : 4;
          zero_acc();
#pragma unroll
          for (int m = 0; m < S::MTILES; ++m) {
            if (16 * m + gq >= rows) continue;
            for (int s0 = 0; s0 < plan.slices; s0 += kDepth) {
              float4 buf[kDepth][S::NT];
#pragma unroll
              for (int d = 0; d < kDepth; ++d)
                if (s0 + d < plan.slices) {
                  const float4* ps = part_of((s0 + d) * plan.tiles + cur.gtile);
#pragma unroll
                  for (int n = 0; n < S::NT; ++n)
                    buf[d][n] = __ldcg(ps + (m * S::NT + n) * S::Threads);
                }
#pragma unroll
              for (int d = 0; d < kDepth; ++d)
                if (s0 + d < plan.slices)
#pragma unroll
                  for (int n = 0; n < S::NT; ++n) {
                    acc[m][n][0] += buf[d][n].x;
                    acc[m][n][1] += buf[d][n].y;
                    acc[m][n][2] += buf[d][n].z;
                    acc[m][n][3] += buf[d][n].w;
                  }
            }
          }
          store_tile(cur);
          if (tid == 0) tickets[cur.gtile] = 0;  // for the next launch (a graph replay too)
        }
      }
    }
  }
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

// the cluster launch of the fp32-x kernel
cudaError_t launch(void (*kernel)(const float*, Group, int, int, int, int),
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
  const float* xp = static_cast<const float*>(x);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, xp, g, rows, K, s_dtype, y_dtype);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// fp32 scratch of the tensor-core kernel: a partial tile a cell
struct Scratch {
  float* p;
  long long bytes;
  int* tickets;  // one per column tile, zero between launches
};

template <int MT, bool INT4>
long long tc_scratch_bytes(const TcPlan& p) {
  return p.slices == 1 ? 0 : 4LL * p.tiles * p.slices * TcShape<MT, INT4>::kPartFloats;
}

template <int MT, bool INT4>
cudaError_t launch_tc(const void* x, const Group& g, int rows, int K, int s_dtype,
                      int y_dtype, const Scratch& sc, cudaStream_t stream) {
  using S = TcShape<MT, INT4>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemv_tc_kernel<MT, INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const TcPlan plan = tc_plan(group_tiles(g), K, S::KR);
  if (plan.slices > 1 &&
      (sc.p == nullptr || sc.tickets == nullptr ||
       reinterpret_cast<uintptr_t>(sc.p) % 16 != 0 ||
       sc.bytes < tc_scratch_bytes<MT, INT4>(plan)))
    return cudaErrorInvalidValue;
  gemv_tc_kernel<MT, INT4><<<plan.grid, S::Threads, S::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), g, rows, K, s_dtype, y_dtype, plan, sc.p,
      sc.tickets);
  return cudaGetLastError();
}

template <int MT, bool INT4>
cudaError_t launch_fma(const void* x, const Group& g, int rows, int K, int s_dtype,
                       int y_dtype, cudaStream_t stream) {
  using S = FmaShape<MT, INT4>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemv_fma_kernel<MT, INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  return launch(gemv_fma_kernel<MT, INT4>, S::Threads, S::kSmemBytes, x, g,
                       rows, K, s_dtype, y_dtype, stream);
}

template <bool INT4>
cudaError_t launch_rows(const void* x, bool bf16, const Group& g, int rows, int K,
                        int s_dtype, int y_dtype, const Scratch& sc,
                        cudaStream_t stream) {
  if (bf16) {
    if (rows <= 16) return launch_tc<16, INT4>(x, g, rows, K, s_dtype, y_dtype, sc, stream);
    if (rows <= 32) return launch_tc<32, INT4>(x, g, rows, K, s_dtype, y_dtype, sc, stream);
    return launch_tc<64, INT4>(x, g, rows, K, s_dtype, y_dtype, sc, stream);
  }
  if (rows <= 8) return launch_fma<8, INT4>(x, g, rows, K, s_dtype, y_dtype, stream);
  if (rows <= 16) return launch_fma<16, INT4>(x, g, rows, K, s_dtype, y_dtype, stream);
  if (rows <= 32) return launch_fma<32, INT4>(x, g, rows, K, s_dtype, y_dtype, stream);
  return launch_fma<64, INT4>(x, g, rows, K, s_dtype, y_dtype, stream);
}

bool shapes_ok(const Group& g, int rows, int K) {
  if (rows < 1 || rows > 64 || K < 8 || K % 8 != 0 || K > kMaxSplit * kSlabRows ||
      g.nw < 1 || g.nw > kMaxGroup)
    return false;
  for (int j = 0; j < g.nw; ++j)
    if (g.n[j] <= 0 || g.n[j] % kTileCols != 0) return false;
  return true;
}

int dispatch(const void* x, const Group& g, int rows, int K, bool int4,
             int x_dtype, int s_dtype, int y_dtype, const Scratch& sc, void* stream) {
  // the one statement of the shape contract (the Python wrappers check only
  // devices, dtypes, shapes and contiguity, which these pointers cannot show)
  if (!shapes_ok(g, rows, K) || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  for (int j = 0; j < g.nw; ++j)
    if (reinterpret_cast<uintptr_t>(g.w[j]) % 16 != 0) return cudaErrorInvalidValue;
  const int dtypes[] = {x_dtype, s_dtype, y_dtype};
  for (int dt : dtypes)
    if (dt != kFloat32 && dt != kBFloat16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = x_dtype == kBFloat16;
  return int4 ? launch_rows<true>(x, bf16, g, rows, K, s_dtype, y_dtype, sc, s)
              : launch_rows<false>(x, bf16, g, rows, K, s_dtype, y_dtype, sc, s);
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
// weight has N/2 bytes per row). With bf16 x a launch needs `scratch`
// (quant_gemv_scratch_bytes, 16-byte aligned, free again once the launch has
// run) and `tickets`, at least one int32 per 256 output columns of each
// weight, zero before the launch and zero again after it; with fp32 x both
// may be null. Each returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" long long quant_gemv_scratch_bytes(int n0, int n1, int n2, int nw, int rows,
                                              int K, int int4) {
  using namespace dllava;
  const Group g = many(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                       nullptr, nullptr, n0, n1, n2, nw);
  if (!shapes_ok(g, rows, K)) return -1;
  const TcPlan p = tc_plan(group_tiles(g), K, int4 ? TcShape<16, true>::KR : TcShape<16, false>::KR);
  if (int4)
    return rows <= 16   ? tc_scratch_bytes<16, true>(p)
           : rows <= 32 ? tc_scratch_bytes<32, true>(p)
                        : tc_scratch_bytes<64, true>(p);
  return rows <= 16   ? tc_scratch_bytes<16, false>(p)
         : rows <= 32 ? tc_scratch_bytes<32, false>(p)
                      : tc_scratch_bytes<64, false>(p);
}

extern "C" int q8_gemv(const void* x, const void* w, const void* s, void* y,
                       void* scratch, long long scratch_bytes, int* tickets, int N,
                       int rows, int K, int x_dtype, int s_dtype, int y_dtype,
                       void* stream) {
  using namespace dllava;
  return dispatch(x, one(w, s, y, N), rows, K, false, x_dtype, s_dtype, y_dtype,
                  Scratch{static_cast<float*>(scratch), scratch_bytes, tickets}, stream);
}

extern "C" int q4_gemv(const void* x, const void* w, const void* s, void* y,
                       void* scratch, long long scratch_bytes, int* tickets, int N,
                       int rows, int K, int x_dtype, int s_dtype, int y_dtype,
                       void* stream) {
  using namespace dllava;
  return dispatch(x, one(w, s, y, N), rows, K, true, x_dtype, s_dtype, y_dtype,
                  Scratch{static_cast<float*>(scratch), scratch_bytes, tickets}, stream);
}

extern "C" int q8_gemv_group(const void* x, const void* w0, const void* w1,
                             const void* w2, const void* s0, const void* s1,
                             const void* s2, void* y0, void* y1, void* y2,
                             void* scratch, long long scratch_bytes, int* tickets,
                             int n0, int n1, int n2, int nw, int rows, int K,
                             int x_dtype, int s_dtype, int y_dtype,
                             void* stream) {
  using namespace dllava;
  return dispatch(x, many(w0, w1, w2, s0, s1, s2, y0, y1, y2, n0, n1, n2, nw),
                  rows, K, false, x_dtype, s_dtype, y_dtype,
                  Scratch{static_cast<float*>(scratch), scratch_bytes, tickets}, stream);
}

extern "C" int q4_gemv_group(const void* x, const void* w0, const void* w1,
                             const void* w2, const void* s0, const void* s1,
                             const void* s2, void* y0, void* y1, void* y2,
                             void* scratch, long long scratch_bytes, int* tickets,
                             int n0, int n1, int n2, int nw, int rows, int K,
                             int x_dtype, int s_dtype, int y_dtype,
                             void* stream) {
  using namespace dllava;
  return dispatch(x, many(w0, w1, w2, s0, s1, s2, y0, y1, y2, n0, n1, n2, nw),
                  rows, K, true, x_dtype, s_dtype, y_dtype,
                  Scratch{static_cast<float*>(scratch), scratch_bytes, tickets}, stream);
}
