// The fused int4 SwiGLU MLP (kernel K9), for Hopper, sm_90a.
//
// Replaces the TPU kernel dynamic_llava_tpu/ops/quant_matmul.py:
// _q4_mlp_kernel (wrapper matmul_q4_mlp_pallas). One launch computes
//   y = (bf16(silu(g) * u) @ D) * s_d,  g = (x @ G) * s_g,  u = (x @ U) * s_u
// for x [rows <= 64, K] (bf16, or fp32 rounded to bf16 first), the split-half
// packed int4 weights G, U [K, F/2] and D [F, Dout/2] (byte j of a row: column
// j in the low nibble, column N/2 + j in the high nibble), per-column scales
// (bf16 or fp32) and y [rows, Dout] (bf16 or fp32). g, u and y are summed and
// scaled in fp32; h = silu(g) * u is formed from the fp32 g and u and rounded
// to bf16 once. [lo | hi] is the original column order, so h meets D's rows
// in ffn order. K is a multiple of 16, F and Dout of 64.
//
// What bounds it on the H100: bytes of weight read, 3 * K * F / 2 per call
// (67.6 MB for a 7B layer, 106.2 MB for 13B) against rows * 6 * K * F flops,
// far below the card's balance point at decode rows. The TPU kernel is one
// sequential program that streams gate and up and then down past a resident
// h. Here every SM must stream at once, and every block of the down phase
// needs h from every block of the gate/up phase: a device-wide dependency
// inside one launch. The design is gemv_tc_kernel's (quant_gemv.cu), twice:
// - one persistent block per SM, launched cooperatively (every block is
//   resident), with ONE grid barrier: the phase boundary. No atomics touch a
//   value, so every call gives the same bits;
// - each phase walks a fixed list of cells (common.cuh, tc_plan): a
//   256-column tile (128 bytes of every packed row) times a slice of K, in
//   units of 32 KB of weights, ordered slice by slice and handed out
//   round-robin, so the blocks that run side by side read neighbouring tiles
//   of the same K rows and DRAM sees whole rows; the slices are chosen
//   against the waves with the end of a sliced cell charged at its measured
//   cost (kSlicedCost), so the 13B MLP's gate/up phase takes 2 slices in one
//   wave, not 7 in three;
// - phase A (gate and up): a cell holds BOTH weights' bytes of the same 256
//   columns (units of 128 K rows), so g and u of a column meet in the same
//   thread's accumulators. An unsliced cell forms h from registers; a sliced
//   one writes its partial tiles to an fp32 scratch, and the last of the
//   tile's blocks to arrive (a ticket, common.cuh) sums g's partial tiles in
//   slice order, then u's, scales both and forms h. h ([rows, F] bf16) goes
//   to a global scratch that stays in the L2;
// - before the grid barrier each block has the weights of its first down
//   units in flight (the counterpart of the TPU kernel's prefetch of down's
//   first window during the gate/up phase); their columns of h follow once
//   every block has written its share;
// - phase B (down, K = F rows, N = Dout) is q4_gemv's list: units of 256 F
//   rows; a sliced tile is summed in slice order by the last block to arrive,
//   which scales and stores y;
// - inside a phase: a cp.async ring of 3-5 stages across units, one commit
//   group and one block barrier a unit; mma.sync m16n8k16 with bf16 inputs
//   and fp32 sums; each of the 8 warps owns 16 bytes of every tile row (32
//   columns a weight), so no warp shares a sum; ldmatrix.trans brings a k16
//   step of the nibbles laid out as the B operand wants them, and lo4_pair /
//   hi4_pair make exact bf16 pairs of them without a trip through fp32;
// - an fp32 x is rounded to bf16 as each unit's columns are staged into
//   shared memory (no extra pass, no extra barrier).

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace dllava {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItemCols = 256;          // output columns of a tile, per weight
constexpr int kTB = kItemCols / 2;      // packed bytes of a tile row
constexpr int kWB = kTB / kWarps;       // bytes of a tile row a warp owns
constexpr int kRS = kTB + 16;           // padded row stride: ldmatrix without bank conflicts
constexpr int kUnitBytes = 32768;       // weight bytes of a unit
constexpr int kBudget = 220 * 1024;     // shared memory of the ring
// what a sliced cell's end costs in half unit times (tc_plan): its partial
// tiles, the fence and ticket, and the last block's sum. Measured on the
// H100 at the 13B MLP, an extra cell end a block cost ~7 us, ~2.8 units
// (PERF.md), where the GEMVs' plan counts half a unit.
constexpr int kSlicedCost = 6;

// A phase's geometry: NW weights a cell (2: gate and up; 1: down), MT rows of
// x (rows rounded up to 16, 32 or 64).
template <int MT, int NW>
struct Geo {
  static constexpr int KR = kUnitBytes / (NW * kTB);  // K rows of a unit: 128 or 256
  static constexpr int SX = KR + 8;                   // x row stride in elements
  static constexpr int kXBytes = 2 * MT * SX;
  static constexpr int kWBytes = KR * kRS;            // one weight's rows of a stage
  // a stage: [x chunk MT x SX bf16][NW x weights KR x kRS bytes]
  static constexpr int kStageBytes = kXBytes + NW * kWBytes;
  static constexpr int Stages = kBudget / kStageBytes < 6 ? kBudget / kStageBytes : 6;
  static constexpr int MTILES = MT / 16;
  static constexpr int NT = 4 * NW;                   // n8 tiles a warp
  static constexpr int kAcc = MTILES * NT * 4;        // accumulators a thread
  // a cell's partial tiles in the scratch: the 4 floats of an mma tile a
  // thread, MT rows times 256 columns for each weight
  static constexpr int kPartFloats = kAcc * kThreads;
  // slices whose partial tiles are loaded at once in the sliced sum (as
  // registers allow): the sum waits for one L2 round trip a batch
  static constexpr int kDepth = kAcc >= 128 ? 1 : kAcc >= 64 || NW == 2 ? 2 : kAcc >= 32 ? 4 : 8;
  static_assert(kPartFloats == NW * MT * kItemCols && Stages >= 3, "partial tile; ring depth");
};

template <int MT>
constexpr int kSmemBytes =
    Geo<MT, 2>::Stages * Geo<MT, 2>::kStageBytes > Geo<MT, 1>::Stages * Geo<MT, 1>::kStageBytes
        ? Geo<MT, 2>::Stages * Geo<MT, 2>::kStageBytes
        : Geo<MT, 1>::Stages * Geo<MT, 1>::kStageBytes;

struct MlpArgs {
  const __nv_bfloat16* x;  // [rows, K] bf16 (null when x is fp32)
  const float* x32;        // [rows, K] fp32 (null when x is bf16)
  const int8_t* gate;      // [K, F/2]
  const int8_t* up;        // [K, F/2]
  const int8_t* down;      // [F, D/2]
  const void* gate_s;      // [F]
  const void* up_s;        // [F]
  const void* down_s;      // [D]
  __nv_bfloat16* h;        // scratch [rows, F]
  float* part_a;           // scratch: phase A's partial tiles (sliced only)
  float* part_b;           // scratch: phase B's partial tiles (sliced only)
  int* tickets;            // pa.tiles + pb.tiles, zero before and after
  void* y;                 // [rows, D]
  int rows, K, F, D;
  TcPlan pa, pb;           // the cells of phase A (gate/up) and B (down)
  int s_dtype, y_dtype;
};

// One phase: phase A (NW = 2) streams gate and up against x and leaves h;
// phase B (NW = 1) streams down against h and leaves y. Phase B starts with
// the grid barrier.
template <int MT, int NW>
__device__ __forceinline__ void run_phase(unsigned char* smem, const MlpArgs& a) {
  using G = Geo<MT, NW>;
  constexpr bool kA = NW == 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  const int nblocks = gridDim.x;
  const int K = kA ? a.K : a.F;  // the contraction: K rows of the weights
  const int N = kA ? a.F : a.D;  // output columns of each weight
  const int ldw = N / 2;         // bytes of a weight row
  const __nv_bfloat16* xb = kA ? a.x : a.h;
  const float* x32 = kA ? a.x32 : nullptr;
  const TcPlan plan = kA ? a.pa : a.pb;
  int* tickets = kA ? a.tickets : a.tickets + a.pa.tiles;
  float* part = kA ? a.part_a : a.part_b;
  const int nkc = (K + G::KR - 1) / G::KR;  // units of a tile
  const int cells = plan.tiles * plan.slices;

  // A position in the block's list of units: unit j of cell c, K rows
  // [k0, k0 + KR) of tile `tile`. The producer (copies) and the consumer
  // (products) each walk the list.
  struct Walk {
    int c, j, chunks, tile, k0;
  };
  auto enter = [&](Walk& p, int c) {  // at unit 0 of cell c (if there is one)
    p.c = c;
    p.j = 0;
    if (c >= cells) return;
    const int slice = c / plan.tiles;
    p.tile = c - slice * plan.tiles;
    p.chunks = min(plan.chunks, nkc - slice * plan.chunks);
    p.k0 = slice * plan.chunks * G::KR;
  };
  auto advance = [&](Walk& p) {
    if (++p.j == p.chunks)
      enter(p, p.c + nblocks);
    else
      p.k0 += G::KR;
  };
  auto stage_of = [&](uint32_t n) { return smem + (n % G::Stages) * G::kStageBytes; };
  // this thread's cp.async copies of the weights of the unit at `p` into the
  // stage of the phase's n-th unit
  auto send_w = [&](uint32_t n, const Walk& p) {
    const int nrows = min(G::KR, K - p.k0);
    const int valid = min(kTB, ldw - p.tile * kTB) / 16;  // 16-byte pieces of a tile row
    constexpr int kPieces = kTB / 16;
    const int piece = tid % kPieces;
    if (piece >= valid) return;
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      const int8_t* w = kA ? (wi == 0 ? a.gate : a.up) : a.down;
      unsigned char* wd = stage_of(n) + G::kXBytes + wi * G::kWBytes;
      const int8_t* src = w + size_t(p.k0) * ldw + size_t(p.tile) * kTB;
      for (int row = tid / kPieces; row < nrows; row += kThreads / kPieces)
        cp_async16(wd + row * kRS + piece * 16, src + size_t(row) * ldw + piece * 16);
    }
  };
  // ... and of the matching columns of the activations (x or h), whole k16
  // steps: a last half step and the rows past `rows` are zero-filled, so the
  // weight rows past the unit (stale bytes, always finite) meet zeros. An
  // fp32 x is rounded to bf16 on the way.
  auto send_x = [&](uint32_t n, const Walk& p) {
    const int nrows = min(G::KR, K - p.k0);
    constexpr int kXPieces = G::KR / 8;  // 16-byte pieces of a whole x row
    const int xvalid = (nrows + 15) / 16 * 16;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage_of(n));
    for (int c = tid; c < MT * kXPieces; c += kThreads) {
      const int r = c / kXPieces, k8 = c % kXPieces * 8;
      if (k8 >= xvalid) continue;
      const bool ok = r < a.rows && k8 < nrows;
      const size_t src = ok ? size_t(r) * K + p.k0 + k8 : 0;
      if (x32 != nullptr) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (ok) {
          const float4 lo = *reinterpret_cast<const float4*>(x32 + src);
          const float4 hi = *reinterpret_cast<const float4*>(x32 + src + 4);
          v = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                         pack_bf16(hi.z, hi.w));
        }
        *reinterpret_cast<uint4*>(xs + r * G::SX + k8) = v;
      } else {
        cp_async16_zfill(xs + r * G::SX + k8, xb + src, ok);
      }
    }
  };

  float acc[G::MTILES][G::NT][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int m = 0; m < G::MTILES; ++m)
#pragma unroll
      for (int n = 0; n < G::NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  };
  // adds the products of the phase's n-th unit (landed) to acc: every warp
  // walks all k16 steps on its own 16 bytes of the tile's rows
  auto compute = [&](uint32_t n, int nrows) {
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(stage_of(n));
    // the row this lane hands to ldmatrix: k row lane % 16 of a step; with
    // two weights lanes 16-31 hand in the up weight's rows
    const unsigned char* slab = stage_of(n) + G::kXBytes +
                                (kA ? (lane >> 4) * G::kWBytes : 0) + (lane & 15) * kRS +
                                warp * kWB;
#pragma unroll(G::MTILES >= 4 ? 1 : 2)  // two steps in flight where registers allow
    for (int st = 0; st * 16 < nrows; ++st) {
      // 16 k rows x 16 bytes, transposed by ldmatrix as if they were b16:
      // w[2 wi + h] holds bytes 2 gq and 2 gq + 1 of weight wi's k rows
      // 8 h + 2 tq (low half) and 8 h + 2 tq + 1 (high half). Byte t of both
      // rows, side by side, is the B fragment of an n8 tile, fragment column
      // gq: tile 4 wi + t (low nibbles) and 4 wi + 2 + t (high nibbles).
      uint32_t w[2 * NW];
      if constexpr (kA)
        ldmatrix_x4_trans(w, slab + st * 16 * kRS);
      else
        ldmatrix_x2_trans(w, slab + st * 16 * kRS);
      uint32_t b[G::NT][2];
#pragma unroll
      for (int wi = 0; wi < NW; ++wi)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t pair = pair_bytes(w[2 * wi + h], t);
            b[4 * wi + t][h] = lo4_pair(pair);
            b[4 * wi + 2 + t][h] = hi4_pair(pair);
          }
#pragma unroll
      for (int m = 0; m < G::MTILES; ++m) {
        uint32_t af[4];
        ldmatrix_x4(af, frag_ptr(xs, G::SX, 16 * m, st * 16, lane));
#pragma unroll
        for (int nn = 0; nn < G::NT; ++nn) mma_bf16(acc[m][nn], af, b[nn]);
      }
    }
  };
  // the output column of accumulator column (n, e) of tile `tile` (n8 tile n
  // of weight n / 4; n % 4 >= 2 the high half), or -1 past a narrower last
  // tile
  auto col_of = [&](int tile, int n, int e) {
    const int byte = tile * kTB + warp * kWB + 2 * (2 * tq + e) + (n & 1);
    if (byte >= ldw) return -1;
    return (n & 3) >= 2 ? ldw + byte : byte;
  };
  // the scales of this thread's columns, fetched when a cell begins so that
  // the epilogue at its end does not wait for them
  float scale[G::NT][2];
  auto fetch_scales = [&](int tile) {
#pragma unroll
    for (int n = 0; n < G::NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col_of(tile, n, e);
        const void* s = kA ? (n < 4 ? a.gate_s : a.up_s) : a.down_s;
        scale[n][e] = col < 0 ? 0.f : load_scale(s, col, a.s_dtype);
      }
  };
  // the tile in acc, whole: phase A forms h = silu(g) * u of it, phase B
  // scales and stores y. Accumulator (m, n, e) is row 16 m + gq (+ 8 for
  // e >= 2) and column (n, e % 2).
  auto emit = [&](int tile) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col_of(tile, n, e);
        if (col < 0) continue;
#pragma unroll
        for (int m = 0; m < G::MTILES; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = 16 * m + gq + 8 * half;
            if (row >= a.rows) continue;
            if constexpr (kA) {
              const float g = acc[m][n][2 * half + e] * scale[n][e];
              const float u = acc[m][4 + n][2 * half + e] * scale[4 + n][e];
              a.h[size_t(row) * a.F + col] = __float2bfloat16(g / (1.f + expf(-g)) * u);
            } else {
              store_out(a.y, size_t(row) * a.D + col, acc[m][n][2 * half + e] * scale[n][e],
                        a.y_dtype);
            }
          }
      }
  };
  auto part_of = [&](int cell) {
    return reinterpret_cast<float4*>(part + size_t(cell) * G::kPartFloats) + tid;
  };

  // One cp.async group a unit, Stages - 1 of them in flight (empty groups
  // past the block's last unit keep the count). Per unit one barrier: past
  // it this unit's copies of every thread have landed, and every warp is
  // done with the unit before, whose stage the next copies then take.
  uint32_t sent = 0, done = 0;
  Walk producer, cur;
  enter(producer, blockIdx.x);
  enter(cur, blockIdx.x);
  auto send_next = [&](bool weights) {
    if (producer.c < cells) {
      if (weights) send_w(sent, producer);
      send_x(sent, producer);
      advance(producer);
    }
    ++sent;
    cp_async_commit();
  };
  if constexpr (kA) {
    for (int i = 0; i < G::Stages - 1; ++i) send_next(true);
  } else {
    // the weights of the first units leave before the barrier (uncommitted:
    // they join the first group); their columns of h follow once every block
    // has written its share of it
    Walk ahead = producer;
    for (int i = 0; i < G::Stages - 1 && ahead.c < cells; ++i, advance(ahead))
      send_w(i, ahead);
    cg::this_grid().sync();
    for (int i = 0; i < G::Stages - 1; ++i) send_next(false);
  }
  for (; cur.c < cells; advance(cur)) {
    cp_async_wait<G::Stages - 2>();
    __syncthreads();
    send_next(true);
    if (cur.j == 0) {
      zero_acc();
      fetch_scales(cur.tile);
    }
    compute(done++, min(G::KR, K - cur.k0));
    if (cur.j != cur.chunks - 1) continue;  // the cell is not summed yet
    if (plan.slices == 1) {
      emit(cur.tile);
      continue;
    }
    // the tile is shared by `slices` cells: the partial tiles go to the
    // scratch (16 bytes a thread and mma tile, for the m tiles that hold rows
    // of x), and the last of the tile's blocks to arrive sums them in slice
    // order
    float4* mine = part_of(cur.c);
#pragma unroll
    for (int m = 0; m < G::MTILES; ++m)
      if (16 * m + gq < a.rows)
#pragma unroll
        for (int n = 0; n < G::NT; ++n)
          mine[(m * G::NT + n) * kThreads] =
              make_float4(acc[m][n][0], acc[m][n][1], acc[m][n][2], acc[m][n][3]);
    if (!last_block_to_arrive(&tickets[cur.tile], plan.slices)) continue;
    zero_acc();
#pragma unroll
    for (int m = 0; m < G::MTILES; ++m) {
      if (16 * m + gq >= a.rows) continue;
      for (int s0 = 0; s0 < plan.slices; s0 += G::kDepth) {
        float4 buf[G::kDepth][G::NT];
#pragma unroll
        for (int d = 0; d < G::kDepth; ++d)
          if (s0 + d < plan.slices) {
            const float4* ps = part_of((s0 + d) * plan.tiles + cur.tile);
#pragma unroll
            for (int n = 0; n < G::NT; ++n) buf[d][n] = __ldcg(ps + (m * G::NT + n) * kThreads);
          }
#pragma unroll
        for (int d = 0; d < G::kDepth; ++d)
          if (s0 + d < plan.slices)
#pragma unroll
            for (int n = 0; n < G::NT; ++n) {
              acc[m][n][0] += buf[d][n].x;
              acc[m][n][1] += buf[d][n].y;
              acc[m][n][2] += buf[d][n].z;
              acc[m][n][3] += buf[d][n].w;
            }
      }
    }
    emit(cur.tile);
    if (tid == 0) tickets[cur.tile] = 0;  // for the next launch (a graph replay too)
  }
  // every copy has landed (the groups left are empty) and every warp is done
  // with the ring: the next phase may take its stages
  cp_async_wait<0>();
  __syncthreads();
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1) q4_mlp_kernel(MlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  run_phase<MT, 2>(smem, a);  // gate and up -> h
  run_phase<MT, 1>(smem, a);  // (grid barrier) down -> y
}

// ----------------------------------------------------------------------------
// Launch.

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

struct Plan {
  int mt;
  TcPlan pa, pb;
  size_t part_a_off, part_b_off, bytes;  // the scratch buffer's layout (h at 0)
};

// The one statement of the shape contract (the Python wrapper checks only
// devices, dtypes, shapes and contiguity). False: not a shape for this kernel.
bool make_plan(int rows, int K, int F, int D, Plan* p) {
  if (rows < 1 || rows > 64 || K < 16 || K % 16 != 0 || K > (1 << 16) || F < 64 ||
      F % 64 != 0 || F > (1 << 17) || D < 64 || D % 64 != 0 || D > (1 << 16))
    return false;
  p->mt = rows <= 16 ? 16 : rows <= 32 ? 32 : 64;
  p->pa = tc_plan((F + kItemCols - 1) / kItemCols, K, kUnitBytes / (2 * kTB), kSlicedCost);
  p->pb = tc_plan((D + kItemCols - 1) / kItemCols, F, kUnitBytes / kTB, kSlicedCost);
  const size_t tile = size_t(4) * p->mt * kItemCols;  // bytes of one weight's partial tile
  p->part_a_off = align256(size_t(rows) * F * 2);
  p->part_b_off =
      p->part_a_off + (p->pa.slices > 1 ? align256(2 * tile * p->pa.tiles * p->pa.slices) : 0);
  p->bytes = p->part_b_off + (p->pb.slices > 1 ? align256(tile * p->pb.tiles * p->pb.slices) : 0);
  return true;
}

template <int MT>
cudaError_t launch(MlpArgs& args, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      q4_mlp_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<MT>);
  if (attr != cudaSuccess) return attr;
  // a cooperative launch needs every block resident: one per SM
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, q4_mlp_kernel<MT>, kThreads,
                                                  kSmemBytes<MT>);
    return n;
  }();
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  void* params[] = {&args};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(q4_mlp_kernel<MT>), dim3(sm_count()), dim3(kThreads), params,
      kSmemBytes<MT>, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace dllava

// Bytes of scratch q4_mlp needs for these shapes (h, then the partial tiles
// of the sliced phases), or -1 for shapes it does not take. Its tickets: one
// int32 per 256 columns of F and of D.
extern "C" long long q4_mlp_scratch_bytes(int rows, int K, int F, int D) {
  dllava::Plan p;
  return dllava::make_plan(rows, K, F, D, &p) ? static_cast<long long>(p.bytes) : -1;
}

// C entry point: gate, up [K, F/2] and down [F, D/2] packed int4, scales of
// F, F and D elements in s_dtype, y [rows, D]; `scratch` holds at least
// q4_mlp_scratch_bytes(...) bytes, 16-byte aligned, and is free again once
// the launch has run; `tickets` holds at least F/256 + D/256 (rounded up)
// int32, zero before the launch and zero again after it. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int q4_mlp(const void* x, const void* gate, const void* up,
                      const void* down, const void* gate_s, const void* up_s,
                      const void* down_s, void* y, void* scratch,
                      long long scratch_bytes, int* tickets, int rows, int K, int F,
                      int D, int x_dtype, int s_dtype, int y_dtype, void* stream) {
  using namespace dllava;
  Plan p;
  if (!make_plan(rows, K, F, D, &p) || scratch_bytes < static_cast<long long>(p.bytes) ||
      tickets == nullptr)
    return cudaErrorInvalidValue;
  const int dtypes[] = {x_dtype, s_dtype, y_dtype};
  for (int dt : dtypes)
    if (dt != kFloat32 && dt != kBFloat16) return cudaErrorInvalidValue;
  const void* aligned[] = {x, gate, up, down, scratch};
  for (const void* ptr : aligned)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  MlpArgs a{};
  const bool bf16 = x_dtype == kBFloat16;
  a.x = bf16 ? static_cast<const __nv_bfloat16*>(x) : nullptr;
  a.x32 = bf16 ? nullptr : static_cast<const float*>(x);
  a.gate = static_cast<const int8_t*>(gate);
  a.up = static_cast<const int8_t*>(up);
  a.down = static_cast<const int8_t*>(down);
  a.gate_s = gate_s;
  a.up_s = up_s;
  a.down_s = down_s;
  a.h = reinterpret_cast<__nv_bfloat16*>(base);
  a.part_a = reinterpret_cast<float*>(base + p.part_a_off);
  a.part_b = reinterpret_cast<float*>(base + p.part_b_off);
  a.tickets = tickets;
  a.y = y;
  a.rows = rows;
  a.K = K;
  a.F = F;
  a.D = D;
  a.pa = p.pa;
  a.pb = p.pb;
  a.s_dtype = s_dtype;
  a.y_dtype = y_dtype;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.mt == 16) return launch<16>(a, s);
  if (p.mt == 32) return launch<32>(a, s);
  return launch<64>(a, s);
}
