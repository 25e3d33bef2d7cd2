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
// in ffn order.
//
// What bounds it on the H100: bytes of weight read, 3 * K * F / 2 per call
// (67.6 MB for a 7B layer, 106.2 MB for 13B) against rows * 6 * K * F flops,
// far below the card's balance point at decode rows. The TPU kernel is one
// sequential program that streams gate and up and then down past a resident
// h. Here every SM must stream at once, and every block of the down phase
// needs h from every block of the gate/up phase: a device-wide dependency
// inside one launch. The design:
// - one persistent block per SM, launched cooperatively (every block is
//   resident, so grid-wide barriers cannot deadlock); no clusters and no
//   atomics, so the result is the same bits on every call;
// - phase A: a block owns 64-column tiles of F (32 packed bytes a row: 32
//   low and the matching 32 high columns) over the WHOLE of K, the gate tile
//   and then the up tile, so g and u of a column meet in one block: g waits
//   scaled in shared memory, and h leaves for a global scratch ([rows, F]
//   bf16, a few hundred KB that stay in the L2);
// - one grid barrier; before it each block already has the first slabs of
//   its down tiles in flight (the counterpart of the TPU kernel's prefetch
//   of down's first window during the gate/up phase);
// - phase B: 64-column tiles of Dout times slices of F, the split chosen so
//   that the units fill the SMs' waves; partial tiles go to a global fp32
//   scratch, and after a second grid barrier all blocks sum them in slice
//   order, scale and store y;
// - inside a block the work is a stream of slabs (16384 / MT K rows of one
//   tile's weights plus the matching columns of the activations, MT = rows
//   rounded up to 16, 32 or 64), copied with cp.async into a ring of 2-3
//   stages that each complete an mbarrier, so the next slabs are in flight
//   while the 8 warps (each along K) run the math of this one: mma.sync
//   m16n8k16 on nibbles converted exactly to bf16, as in quant_gemv.cu, whose
//   pieces (common.cuh) this file shares;
// - an fp32 x is rounded to a bf16 copy by all blocks first (one more grid
//   barrier, on that path only): one mma path serves both types.
// The two grid barriers cost a few microseconds each, of the order of the
// launch the fusion saves; PERF.md has the times beside K8 + K7.

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace dllava {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // all along K
constexpr int kRS = kRowStride<true>;  // bytes of a slab row: 32 packed + 16 pad
constexpr int kTB = kTileBytes<true>;  // 32 packed bytes = 64 columns
constexpr int kNT = 8;                 // n8 tiles of a warp: 4 low, 4 high

template <int MT>
struct Shape {
  static constexpr int MTILES = MT / 16;
  static constexpr int SR = 16384 / MT;  // K rows of a slab: 1024, 512, 256
  static constexpr int SX = SR + 8;      // activation row stride (bank spread)
  static constexpr int STAGES = MT == 16 ? 2 : 3;
  // a stage: [activations MT x SX bf16][weights SR x kRS bytes]
  static constexpr int kXBytes = 2 * MT * SX;
  static constexpr int kStageBytes = kXBytes + SR * kRS;
  // after the ring: one 16-row partial tile per warp, the scaled gate tile,
  // the stages' mbarriers
  static constexpr int kPartBytes = 4 * kWarps * 16 * kTileCols;
  static constexpr int kGateBytes = 4 * MT * kTileCols;
  static constexpr int kSmemBytes =
      STAGES * kStageBytes + kPartBytes + kGateBytes + 8 * STAGES;
};

struct MlpArgs {
  const __nv_bfloat16* x;  // [rows, K] bf16 (null when x is fp32)
  const float* x32;        // [rows, K] fp32 (null when x is bf16)
  __nv_bfloat16* xb;       // scratch [rows, K]: the bf16 copy of an fp32 x
  const int8_t* gate;      // [K, F/2]
  const int8_t* up;        // [K, F/2]
  const int8_t* down;      // [F, D/2]
  const void* gate_s;      // [F]
  const void* up_s;        // [F]
  const void* down_s;      // [D]
  __nv_bfloat16* h;        // scratch [rows, F]
  float* part;             // scratch [nslices, rows, D]
  void* y;                 // [rows, D]
  int rows, K, F, D;
  int spu;      // slabs of F per down unit
  int nslices;  // down units per tile
  int s_dtype, y_dtype;
};

// One slab of the block's stream: rows [k0, k0 + nrows) of tile `tile` of a
// packed weight with `ldw` bytes a row, against the same columns of `act`.
struct Slab {
  const int8_t* w;
  const __nv_bfloat16* act;
  int ldw, ld, tile, k0, nrows;
};

// tile column (0-63: 32 low, then 32 high) -> column of an N-wide output
__device__ __forceinline__ int out_col(int tile, int cl, int N) {
  return cl < kTB ? tile * kTB + cl : N / 2 + tile * kTB + cl - kTB;
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1) q4_mlp_kernel(MlpArgs a) {
  using S = Shape<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem + S::STAGES * S::kStageBytes);
  float* gate_tile = part + kWarps * 16 * kTileCols;
  uint64_t* bars = reinterpret_cast<uint64_t*>(gate_tile + MT * kTileCols);
  cg::grid_group grid = cg::this_grid();
  const int nblocks = gridDim.x, bid = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment coordinates

  if (threadIdx.x == 0)
    for (int s = 0; s < S::STAGES; ++s) mbar_init(&bars[s], kThreads);
  // activation rows past `rows` are never copied: they stay zero
  for (int s = 0; s < S::STAGES; ++s)
    for (int i = threadIdx.x; i < S::kXBytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem + s * S::kStageBytes)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const __nv_bfloat16* x = a.x;
  if (a.x32 != nullptr) {  // round an fp32 x to bf16 once, for every block
    for (int i = bid * kThreads + threadIdx.x; i < a.rows * a.K; i += nblocks * kThreads)
      a.xb[i] = __float2bfloat16(a.x32[i]);
    grid.sync();
    x = a.xb;
  }

  uint32_t sent = 0, waited = 0;  // slabs so far: stage = n % STAGES
  float acc[S::MTILES][kNT][4];

  auto stage_of = [&](uint32_t n) { return smem + (n % S::STAGES) * S::kStageBytes; };
  auto copy_w = [&](uint32_t n, const Slab& sl) {
    unsigned char* dst = stage_of(n) + S::kXBytes;
    const int8_t* src = sl.w + size_t(sl.k0) * sl.ldw + sl.tile * kTB;
    for (int c = threadIdx.x; c < sl.nrows * (kTB / 16); c += kThreads) {
      const int row = c / (kTB / 16), p = c % (kTB / 16);
      cp_async16(dst + row * kRS + p * 16, src + size_t(row) * sl.ldw + p * 16);
    }
  };
  auto copy_x = [&](uint32_t n, const Slab& sl) {
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(stage_of(n));
    const int per = sl.nrows / 8;  // 16-byte pieces of a row
    for (int c = threadIdx.x; c < a.rows * per; c += kThreads) {
      const int r = c / per, k8 = c % per * 8;
      cp_async16(dst + r * S::SX + k8, sl.act + size_t(r) * sl.ld + sl.k0 + k8);
    }
  };
  auto arrive = [&](uint32_t n) { cp_async_arrive(&bars[n % S::STAGES]); };
  auto zero_acc = [&]() {
#pragma unroll
    for (int m = 0; m < S::MTILES; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  };
  // waits for slab n and adds its products to acc; warp w takes the k16
  // steps w, w + 8, ...
  auto compute = [&](uint32_t n, int nrows) {
    mbar_wait(&bars[n % S::STAGES], (n / S::STAGES) & 1);
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(stage_of(n));
    const unsigned char* slab = stage_of(n) + S::kXBytes;
    for (int st = warp; st * 16 < nrows; st += kWarps) {
      // B fragments as in quant_gemv.cu: rows r0 + 2 tq, +1, +8, +9, the 4
      // bytes at column 4 gq; byte t is n8 tile t (low nibble) and 4 + t
      // (high nibble), fragment column gq
      const unsigned char* wb = slab + (st * 16 + 2 * tq) * kRS + 4 * gq;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wb);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wb + kRS);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(wb + 8 * kRS);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(wb + 9 * kRS);
      uint32_t b[kNT][2];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        b[t][0] = pack_bf16(lo4_at(w0, t), lo4_at(w1, t));
        b[t][1] = pack_bf16(lo4_at(w8, t), lo4_at(w9, t));
        b[4 + t][0] = pack_bf16(hi4_at(w0, t), hi4_at(w1, t));
        b[4 + t][1] = pack_bf16(hi4_at(w8, t), hi4_at(w9, t));
      }
#pragma unroll
      for (int m = 0; m < S::MTILES; ++m) {
        const __nv_bfloat16* xa = xs + (16 * m + gq) * S::SX + st * 16 + 2 * tq;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(xa);
        af[1] = *reinterpret_cast<const uint32_t*>(xa + 8 * S::SX);
        af[2] = *reinterpret_cast<const uint32_t*>(xa + 8);
        af[3] = *reinterpret_cast<const uint32_t*>(xa + 8 * S::SX + 8);
#pragma unroll
        for (int n = 0; n < kNT; ++n) mma_bf16(acc[m][n], af, b[n]);
      }
    }
  };
  // sums the 8 warps' accumulators, 16 rows at a time through `part`, and
  // hands every element of the [MT, 64] tile to emit(row, tile column, sum)
  auto reduce = [&](auto emit) {
#pragma unroll
    for (int m = 0; m < S::MTILES; ++m) {
      float* mine = part + warp * 16 * kTileCols;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // accumulator (n, e): row gq (+8 for e >= 2), fragment column
          // 2 tq + e % 2, i.e. packed byte 4 (2 tq + e % 2) + n % 4
          const int fc = 4 * (2 * tq + (e & 1));
          const int cl = n < 4 ? fc + n : kTB + fc + n - 4;
          mine[(gq + (e >= 2 ? 8 : 0)) * kTileCols + cl] = acc[m][n][e];
        }
      __syncthreads();
      for (int idx = threadIdx.x; idx < 16 * kTileCols; idx += kThreads) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += part[w * 16 * kTileCols + idx];
        emit(16 * m + idx / kTileCols, idx % kTileCols, v);
      }
      __syncthreads();
    }
  };

  // ---- phase A: h = silu((x @ G) s_g) * ((x @ U) s_u), tile by tile ---------
  const int nsA = (a.K + S::SR - 1) / S::SR;  // slabs of K
  const int tilesF = a.F / kTileCols;
  const int mine_A = bid < tilesF ? (tilesF - bid + nblocks - 1) / nblocks : 0;
  const int total_A = mine_A * 2 * nsA;
  auto slab_A = [&](int i) {  // the block's i-th slab: tile, gate then up, K order
    const int rem = i % (2 * nsA), k0 = rem % nsA * S::SR;
    Slab sl;
    sl.w = rem < nsA ? a.gate : a.up;
    sl.act = x;
    sl.ldw = a.F / 2;
    sl.ld = a.K;
    sl.tile = bid + i / (2 * nsA) * nblocks;
    sl.k0 = k0;
    sl.nrows = min(S::SR, a.K - k0);
    return sl;
  };
  auto send_A = [&](int i) {
    const Slab sl = slab_A(i);
    copy_w(sent, sl);
    copy_x(sent, sl);
    arrive(sent++);
  };
  for (int i = 0; i < min(S::STAGES - 1, total_A); ++i) send_A(i);
  for (int i = 0; i < total_A; ++i) {
    // the stage of slab i - 1 is free since the barrier that ended its turn
    if (i + S::STAGES - 1 < total_A) send_A(i + S::STAGES - 1);
    const Slab sl = slab_A(i);
    const int rem = i % (2 * nsA);
    if (rem % nsA == 0) zero_acc();
    compute(waited++, sl.nrows);
    if (rem == nsA - 1) {  // the gate tile is whole: keep it, scaled
      reduce([&](int row, int cl, float v) {
        gate_tile[row * kTileCols + cl] =
            v * load_scale(a.gate_s, out_col(sl.tile, cl, a.F), a.s_dtype);
      });
    } else if (rem == 2 * nsA - 1) {  // the up tile is whole: h leaves
      reduce([&](int row, int cl, float v) {
        if (row >= a.rows) return;
        const int col = out_col(sl.tile, cl, a.F);
        const float g = gate_tile[row * kTileCols + cl];
        const float u = v * load_scale(a.up_s, col, a.s_dtype);
        a.h[size_t(row) * a.F + col] = __float2bfloat16(g / (1.f + __expf(-g)) * u);
      });
    }
    __syncthreads();  // every warp is done with the stage
  }

  // ---- phase B: partial tiles of (h @ D) over slices of F ------------------
  const int nsB = (a.F + S::SR - 1) / S::SR;  // slabs of F
  const int tilesD = a.D / kTileCols;
  const int units = tilesD * a.nslices;  // unit u: slice u / tilesD, tile u % tilesD
  const int mine_B = bid < units ? (units - bid + nblocks - 1) / nblocks : 0;
  struct Cursor {
    int j, s;  // the block's j-th unit, its s-th slab
  };
  auto unit_slabs = [&](int j) {
    const int slice = (bid + j * nblocks) / tilesD;
    return min(a.spu, nsB - slice * a.spu);
  };
  auto slab_B = [&](const Cursor& c) {
    const int u = bid + c.j * nblocks, k0 = (u / tilesD * a.spu + c.s) * S::SR;
    Slab sl;
    sl.w = a.down;
    sl.act = a.h;
    sl.ldw = a.D / 2;
    sl.ld = a.F;
    sl.tile = u % tilesD;
    sl.k0 = k0;
    sl.nrows = min(S::SR, a.F - k0);
    return sl;
  };
  auto advance = [&](Cursor& c) {
    if (++c.s == unit_slabs(c.j)) {
      ++c.j;
      c.s = 0;
    }
  };
  // the first slabs of the down weights leave before the barrier; their
  // columns of h follow once every block has written its share of it
  Cursor producer{0, 0}, ahead{0, 0};
  int primed = 0;
  for (; primed < S::STAGES - 1 && ahead.j < mine_B; ++primed, advance(ahead))
    copy_w(sent + primed, slab_B(ahead));
  grid.sync();
  for (int p = 0; p < primed; ++p, advance(producer)) {
    copy_x(sent, slab_B(producer));
    arrive(sent++);
  }
  for (Cursor c{0, 0}; c.j < mine_B; advance(c)) {
    if (producer.j < mine_B) {
      const Slab nx = slab_B(producer);
      copy_w(sent, nx);
      copy_x(sent, nx);
      arrive(sent++);
      advance(producer);
    }
    const Slab sl = slab_B(c);
    if (c.s == 0) zero_acc();
    compute(waited++, sl.nrows);
    if (c.s == unit_slabs(c.j) - 1) {
      const int slice = (bid + c.j * nblocks) / tilesD;
      reduce([&](int row, int cl, float v) {
        if (row < a.rows)
          a.part[(size_t(slice) * a.rows + row) * a.D + out_col(sl.tile, cl, a.D)] = v;
      });
    }
    __syncthreads();
  }

  // ---- y = (sum of the slices' partial tiles, in slice order) * s_d ---------
  grid.sync();
  const int total = a.rows * a.D;
  for (int i = bid * kThreads + threadIdx.x; i < total; i += nblocks * kThreads) {
    float v = 0.f;
    for (int s = 0; s < a.nslices; ++s) v += a.part[size_t(s) * total + i];
    store_out(a.y, i, v * load_scale(a.down_s, i % a.D, a.s_dtype), a.y_dtype);
  }
}

// ----------------------------------------------------------------------------
// Launch.

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

struct Plan {
  int mt, spu, nslices;
  size_t h_off, part_off, xb_off, bytes;  // the scratch buffer's layout
};

// The one statement of the shape contract (the Python wrapper checks only
// devices, dtypes, shapes and contiguity). False: not a shape for this kernel.
bool make_plan(int rows, int K, int F, int D, int x_dtype, Plan* p) {
  if (rows < 1 || rows > 64 || K < 16 || K % 16 != 0 || K > (1 << 16) ||
      F < kTileCols || F % kTileCols != 0 || F > (1 << 17) || D < kTileCols ||
      D % kTileCols != 0 || D > (1 << 16) ||
      (x_dtype != kFloat32 && x_dtype != kBFloat16))
    return false;
  p->mt = rows <= 16 ? 16 : rows <= 32 ? 32 : 64;
  // the split of F: the slabs per unit that cost the fewest slab times,
  // waves of units over the SMs times slabs per unit (ties: fewer slices)
  const int sr = 16384 / p->mt, ns = (F + sr - 1) / sr, tiles = D / kTileCols;
  const int sms = sm_count();
  long best = -1;
  for (int spu = ns; spu >= 1; --spu) {
    const int nslices = (ns + spu - 1) / spu;
    const long waves = (long(tiles) * nslices + sms - 1) / sms;
    if (best < 0 || waves * spu < best) {
      best = waves * spu;
      p->spu = spu;
      p->nslices = nslices;
    }
  }
  p->h_off = 0;
  p->part_off = align256(size_t(rows) * F * 2);
  p->xb_off = p->part_off + align256(size_t(p->nslices) * rows * D * 4);
  p->bytes = p->xb_off + (x_dtype == kFloat32 ? align256(size_t(rows) * K * 2) : 0);
  return true;
}

template <int MT>
cudaError_t launch(MlpArgs& args, cudaStream_t stream) {
  using S = Shape<MT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      q4_mlp_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  // a cooperative launch needs every block resident: one per SM
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, q4_mlp_kernel<MT>, kThreads,
                                                  S::kSmemBytes);
    return n;
  }();
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  void* params[] = {&args};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(q4_mlp_kernel<MT>), dim3(sm_count()), dim3(kThreads),
      params, S::kSmemBytes, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace dllava

// Bytes of scratch q4_mlp needs for these shapes, or -1 for shapes it does
// not take.
extern "C" long long q4_mlp_scratch_bytes(int rows, int K, int F, int D,
                                          int x_dtype) {
  dllava::Plan p;
  return dllava::make_plan(rows, K, F, D, x_dtype, &p)
             ? static_cast<long long>(p.bytes) : -1;
}

// C entry point: gate, up [K, F/2] and down [F, D/2] packed int4, scales of
// F, F and D elements in s_dtype, y [rows, D]; `scratch` holds at least
// q4_mlp_scratch_bytes(...) bytes, 16-byte aligned, and is free again once
// the launch has run. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int q4_mlp(const void* x, const void* gate, const void* up,
                      const void* down, const void* gate_s, const void* up_s,
                      const void* down_s, void* y, void* scratch,
                      long long scratch_bytes, int rows, int K, int F, int D,
                      int x_dtype, int s_dtype, int y_dtype, void* stream) {
  using namespace dllava;
  Plan p;
  if (!make_plan(rows, K, F, D, x_dtype, &p) ||
      scratch_bytes < static_cast<long long>(p.bytes))
    return cudaErrorInvalidValue;
  const int dtypes[] = {s_dtype, y_dtype};
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
  a.xb = reinterpret_cast<__nv_bfloat16*>(base + p.xb_off);
  a.gate = static_cast<const int8_t*>(gate);
  a.up = static_cast<const int8_t*>(up);
  a.down = static_cast<const int8_t*>(down);
  a.gate_s = gate_s;
  a.up_s = up_s;
  a.down_s = down_s;
  a.h = reinterpret_cast<__nv_bfloat16*>(base + p.h_off);
  a.part = reinterpret_cast<float*>(base + p.part_off);
  a.y = y;
  a.rows = rows;
  a.K = K;
  a.F = F;
  a.D = D;
  a.spu = p.spu;
  a.nslices = p.nslices;
  a.s_dtype = s_dtype;
  a.y_dtype = y_dtype;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.mt == 16) return launch<16>(a, s);
  if (p.mt == 32) return launch<32>(a, s);
  return launch<64>(a, s);
}
