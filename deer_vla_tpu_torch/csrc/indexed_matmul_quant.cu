// Layer-indexed matmuls with quantized weights for Hopper, idx read from
// device memory inside the kernel:
//   K3  y = (x @ Wq[idx]) * s[idx]          Wq (L, K, N) int8
//   K4  y = (x @ unpack(Wq4[idx])) * s[idx] Wq4 (L, K/2, N) int8, two int4
//                                           codes a byte (halves split: the
//                                           low nibble of packed row k is
//                                           row k, the high one row K/2 + k)
// with s (L, N) fp32 per-output-column scales.
//
// Replaces the TPU kernels deer_vla_tpu/ops/pallas/indexed_matmul.py
// indexed_matmul_q8 (_run_q8 -> _kernel_q8) and indexed_matmul_q4 (_run_q4
// -> _kernel_q4).  As there, only the quantized bytes of layer idx ever
// cross from device memory; the codes are widened to bf16 on the SM (int8
// and int4 values are exact in bf16), the tensor cores accumulate in fp32,
// and the scale multiplies the fp32 sum once, before the one rounding to
// x's dtype.  An index outside [0, L) is clamped, as in K2.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): one deer_3b decoder
// layer's four products read 2048*6144 + 2048*2048 + 2048*8192 + 8192*2048
// = 50.3 M weights.  At one stream (M = 32) K3 moves 50.3 MB of codes ->
// 15.0 us (15.7 us with x, y and the scales), K4 25.2 MB -> 7.5 us (8.2
// us), against 3.2 GFLOP -> 3.3 us; at eight streams (M = 256) 25.8 GFLOP
// -> 26 us bound both.
//
// Design: K2's pipeline (csrc/indexed_matmul.cu) with a widen stage.
//   - A block owns a column strip (64 or 128 columns: a warp copies whole
//     128-byte lines of codes) and all M rows up to 256 (256-row chunks
//     beyond), so at B <= 8 each code leaves device memory once.  A K-tile
//     is 64 rows of the product: 64 int8 rows of Wq (K3) or 32 packed rows
//     (K4), whose low nibbles pair with x columns [k, k + 32) and high
//     nibbles with [K/2 + k, K/2 + k + 32), so x's tile is those 64 columns
//     and the tensor-core loop is the same for both.  The x tile and the
//     code tile stream through a 4-stage cp.async ring; x rows past M
//     are zero-filled by the copy and never stored (no padding launch).
//   - Widen: after a tile lands, 16 codes at a time become 16 bf16 in the
//     layout the tensor-core path reads, in one of two widened tiles.  No
//     conversion instruction: int8 byte b goes, as b ^ 0x80 = b + 128,
//     into the mantissa of 2^23 (one PRMT), one FADD of -(2^23 + 128)
//     leaves b in fp32, and the bf16 of a small integer is the upper half
//     of its fp32 bits (one PRMT packs two); an int4 nibble n goes, as
//     n ^ 8 = n + 8, into the mantissa of bf16 128 (PRMT + LOP3), and one
//     packed bf16 subtraction of 136 leaves two codes.
//     tests/test_torch_quant_designs.py checks these bit operations over
//     every code; chip_smoke.py counts the conversions in the SASS.
//   - M <= 32 (one stream), or N % 128 != 0: warp-specialised mma.sync
//     blocks.  Four consumer warps run mma.sync.m16n8k16 (A by ldmatrix
//     from the padded x tile, B by ldmatrix.trans from the padded
//     row-major widened tile) while eight producer warps copy and widen
//     the next tiles, handing them over through named barriers, so the
//     widen runs beside the multiply.  M > 32: one warpgroup per 64 rows
//     runs wgmma.m64n128k16 from 128-byte-swizzled tiles (x K-major, the
//     widened tile N-major); every thread copies and widens, and the
//     double-buffered widened tile lets widening tile t + 1 overlap the
//     asynchronous wgmma of tile t.
//   - K is split over a thread-block cluster of up to 8 blocks, summed in
//     rank order through distributed shared memory, scaled and rounded
//     once (deer::reduce_partials): bit-identical, one launch, no atomics,
//     capturable in a CUDA graph whose index changes.
// Shared memory (dynamic; the fp32 partial tile reuses the ring):
//   mma.sync 32 x 64: a stage is 4.5 KB of x + 4 KB (K3) / 2 KB (K4) of
//     codes, two widened tiles 18 KB: 4 stages 52 / 44 KB.
//   wgmma 256 x 128: a stage is 32 KB of x + 8 KB (K3) / 4 KB (K4) of codes,
//     two widened tiles 32 KB: 4 stages 193 / 177 KB of the 227 KB (a
//     K4 tile of 64 packed rows would need two 32 KB x tiles a stage, and
//     four such stages do not fit; K4 takes 32 packed rows instead).
// The tiling and split come from indexed_matmul_quant_plan in
// ops/kernels/indexed_matmul.py; each config is the fastest measured at
// some row count, and the planned one is within 4% of the fastest at 32-256
// rows (chip_smoke.py phase k3_k4_configs).
//
// What holds it back now (chip_smoke.py, scripts/torch_indexed_sweep.py,
// scripts/torch_widen_cost.py; an H100 SXM at 700 W; PERF.md section 6).
// At M = 32 a layer's four products take 51 us (K3) and 47 us (K4), 3.2x
// and 5.8x their bounds, about cuBLAS's time on the bf16 stack: x is
// re-read for every 64-column strip, as many bytes as K3's codes, and each
// short block pays its pipeline fill and cluster reduction; the widen,
// now beside the multiply, costs about 4% (torch_widen_cost.py).  At
// M = 256 they take 111 / 115 us, 4.3x the operations bound and 1.3x K2:
// a stage's x tile (32 KB) is four times its codes, out_proj and mlp_down
// fill 64 of the 132 SMs, and the widen with its barrier costs about a
// fifth of the layer, between two wgmma groups.  Tried and slower:
// 8-stage rings, 128-column blocks, 8 consumer warps, a 7-stage 128-row
// ring, 256-column wgmma blocks, and producer warps beside the wgmma
// warpgroups.  Next: bulk (TMA) copies and an x tile multicast to
// neighbouring strips.
//
// An fp32 path (CUDA cores, one column per thread) serves fp32 compute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "hopper_mma.cuh"

namespace {

using deer::bf16;

constexpr int BK = 64;  // product rows a K-tile (bf16 rows of the widened tile)

// The two code formats: RB code rows a K-tile.
struct Int8Codes {
  static constexpr bool Q4 = false;
  static constexpr int RB = BK;
};
struct Int4Codes {
  static constexpr bool Q4 = true;
  static constexpr int RB = BK / 2;
};

// x column of 8-column chunk c (0-7) of the K-tile whose first code row is
// k0 (rows: code rows a layer, K or K/2)
template <class Codes>
__device__ __forceinline__ int x_col(int k0, int c, int rows) {
  if constexpr (Codes::Q4) return c < 4 ? k0 + c * 8 : rows + k0 + (c - 4) * 8;
  return k0 + c * 8;
}

// bf16 pair of two fp32 values that are exact in bf16: their upper halves
__device__ __forceinline__ uint32_t upper_halves(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

__device__ __forceinline__ uint32_t minus136(uint32_t v) {
  __nv_bfloat162 h, c;
  const uint32_t k = 0x43084308u;  // (136, 136) in bf16
  memcpy(&h, &v, 4);
  memcpy(&c, &k, 4);
  h = __hsub2(h, c);
  memcpy(&v, &h, 4);
  return v;
}

// 16 codes of one row (16 bytes) -> bf16: int8, the 16 values in lo;
// int4, the 16 low nibbles in lo and the 16 high nibbles in hi.  Each
// uint4 holds 8 neighbouring columns.
template <class Codes>
__device__ __forceinline__ void widen16(const uint4 v, uint4 (&lo)[2], uint4 (&hi)[2]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t a[8], b[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (Codes::Q4) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // bytes 2j, 2j + 1 of w to bytes 0 and 2: one bf16 pair per nibble
        const uint32_t t = __byte_perm(w[q], 0u, j ? 0x4342 : 0x4140);
        a[2 * q + j] = minus136((t & 0x000F000Fu) ^ 0x43084308u);
        b[2 * q + j] = minus136(((t >> 4) & 0x000F000Fu) ^ 0x43084308u);
      }
    } else {
      const uint32_t u = w[q] ^ 0x80808080u;  // b + 128
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)  // 2^23 + b + 128, minus 2^23 + 128
        f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | j)) - 8388736.f;
      a[2 * q] = upper_halves(f[0], f[1]);
      a[2 * q + 1] = upper_halves(f[2], f[3]);
    }
  }
  lo[0] = make_uint4(a[0], a[1], a[2], a[3]);
  lo[1] = make_uint4(a[4], a[5], a[6], a[7]);
  if constexpr (Codes::Q4) {
    hi[0] = make_uint4(b[0], b[1], b[2], b[3]);
    hi[1] = make_uint4(b[4], b[5], b[6], b[7]);
  }
}

// Widen the code tile cs (RB rows x BN bytes, row-major) of one stage,
// thread t of THREADS taking the 16-byte chunks it copied in load_stage:
// store(row, col, 8 bf16) puts 8 neighbouring columns of widened row `row`
// (0-63) where the tensor-core path reads them.
template <class Codes, int BN, int THREADS, class Store>
__device__ __forceinline__ void widen_tile(int t, const uint8_t* cs, Store store) {
  constexpr int ITEMS = Codes::RB * BN / 16;
#pragma unroll
  for (int it = 0; it < (ITEMS + THREADS - 1) / THREADS; ++it) {
    const int i = t + it * THREADS;
    if (ITEMS % THREADS == 0 || i < ITEMS) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      uint4 lo[2], hi[2];
      widen16<Codes>(*reinterpret_cast<const uint4*>(cs + r * BN + c), lo, hi);
      store(r, c, lo[0]);
      store(r, c + 8, lo[1]);
      if constexpr (Codes::Q4) {
        store(Codes::RB + r, c, hi[0]);
        store(Codes::RB + r, c + 8, hi[1]);
      }
    }
  }
}

// cp.async of one stage by thread t of THREADS: x's 64 columns of the
// K-tile (BM rows, rows past M zero-filled) and the RB x BN code tile.
// XOFF(r, c) is the byte offset of x chunk c of row r in the stage.
template <class Codes, int BM, int BN, int THREADS, class XOff>
__device__ __forceinline__ void load_stage(int t, uint8_t* xs, uint8_t* cs,
                                           const bf16* __restrict__ x,
                                           const int8_t* __restrict__ wl, int m0, int M,
                                           int K, int N, int rows, int k0, int kt,
                                           XOff xoff) {
  constexpr int XITEMS = BM * 8, CITEMS = Codes::RB * BN / 16;
#pragma unroll
  for (int it = 0; it < (XITEMS + THREADS - 1) / THREADS; ++it) {
    const int i = t + it * THREADS;
    if (XITEMS % THREADS == 0 || i < XITEMS) {
      const int r = i >> 3, c = i & 7;
      const bool ok = m0 + r < M;
      deer::cp_async16(xs + xoff(r, c),
                       ok ? x + (size_t)(m0 + r) * K + x_col<Codes>(k0, c, rows) : x, ok);
    }
  }
#pragma unroll
  for (int it = 0; it < (CITEMS + THREADS - 1) / THREADS; ++it) {
    const int i = t + it * THREADS;
    if (CITEMS % THREADS == 0 || i < CITEMS) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      deer::cp_async16(cs + r * BN + c, wl + (size_t)(kt * Codes::RB + r) * N + c, true);
    }
  }
}

// ---------------------------------------------------------------------------
// mma.sync path, warp-specialised.  The consumer warps (0 .. WM * WN - 1)
// run mma.sync.m16n8k16 on padded row-major tiles: A by ldmatrix from the x
// tile, B by ldmatrix.trans from the widened tile.  The producer warps copy
// the stages and widen the codes, each thread the chunks it copied itself,
// and hand the tiles over through named barriers: FULL + b (producers
// arrive, consumers wait) says widened tile b and its x tile are in shared
// memory, EMPTY + b (consumers arrive, producers wait) that the consumers
// are done with them, so a stage and a widened tile are refilled two tiles
// after their use, and the widen of the next tiles runs beside the
// multiply.
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int PRODUCER_WARPS>
struct MmaCfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int CONSUMERS = WM * WN * 32;
  static constexpr int PRODUCERS = PRODUCER_WARPS * 32;
  static constexpr int THREADS = CONSUMERS + PRODUCERS;
  static constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;   // mma tiles a warp
  static constexpr int XLD = BK + 8;                  // padded row strides
  static constexpr int WLD = BN + 8;
  static constexpr int PLD = BN + 8;                  // fp32 partial tile
  static constexpr int X_BYTES = BM * XLD * 2;
  static constexpr int W_BYTES = BK * WLD * 2;        // one widened tile
  template <class Codes>  // host side, for the launch
  static constexpr size_t smem() {
    const size_t ring = 2 * W_BYTES + (size_t)STAGES * (X_BYTES + Codes::RB * BN);
    const size_t part = (size_t)BM * PLD * 4;
    return ring > part ? ring : part;
  }
  static_assert(NT % 2 == 0, "B fragments are loaded in pairs of n-tiles");
  static_assert(STAGES >= 3, "two tiles in use beside the one in flight");
};

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <class Codes, class C>
__global__ void __launch_bounds__(C::THREADS)
indexed_matmul_quant_mma(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
                         const float* __restrict__ s, const int* __restrict__ idx,
                         bf16* __restrict__ y, int M, int K, int N, int L) {
  constexpr int STAGE = C::X_BYTES + Codes::RB * C::BN;  // bytes a ring stage
  constexpr int FULL = 1, EMPTY = 3;  // named barriers 1-2 and 3-4
  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_raw);
  uint8_t* ring = smem + 2 * C::W_BYTES;  // after the two widened tiles
  const int nsplit = gridDim.x;
  const int split = blockIdx.x;
  const int m0 = blockIdx.y * C::BM;
  const int n0 = blockIdx.z * C::BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int layer = min(max(*idx, 0), L - 1);
  const int rows = Codes::Q4 ? K / 2 : K;
  const int rslice = rows / nsplit;
  const int nk = rslice / Codes::RB;
  const int r0 = split * rslice;

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  if (tid >= C::CONSUMERS) {  // producers
    const int pt = tid - C::CONSUMERS;
    const int8_t* wl = wq + ((size_t)layer * rows + r0) * N + n0;
    auto load = [&](int stage, int kt) {
      uint8_t* xs = ring + stage * STAGE;
      load_stage<Codes, C::BM, C::BN, C::PRODUCERS>(
          pt, xs, xs + C::X_BYTES, x, wl, m0, M, K, N, rows, r0 + kt * Codes::RB, kt,
          [](int r, int c) { return r * C::XLD * 2 + c * 16; });
    };
#pragma unroll
    for (int st = 0; st < C::STAGES - 2; ++st) {
      if (st < nk) load(st, st);
      deer::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      // tile kt - 2's stage and widened tile are free
      if (kt >= 2) named_sync(EMPTY + (kt & 1), C::THREADS);
      const int next = kt + C::STAGES - 2;
      if (next < nk) load(next % C::STAGES, next);
      deer::cp_async_commit();
      deer::cp_async_wait<C::STAGES - 2>();  // this thread's copies of tile kt
      bf16* ws = reinterpret_cast<bf16*>(smem + (kt & 1) * C::W_BYTES);
      widen_tile<Codes, C::BN, C::PRODUCERS>(
          pt, ring + (kt % C::STAGES) * STAGE + C::X_BYTES,
          [&](int r, int c, uint4 v) { *reinterpret_cast<uint4*>(ws + r * C::WLD + c) = v; });
      named_arrive(FULL + (kt & 1), C::THREADS);
    }
  } else {  // consumers
    const int wm = warp / C::WN, wn = warp % C::WN;
    for (int kt = 0; kt < nk; ++kt) {
      named_sync(FULL + (kt & 1), C::THREADS);
      const bf16* xs = reinterpret_cast<const bf16*>(ring + (kt % C::STAGES) * STAGE);
      const bf16* ws = reinterpret_cast<const bf16*>(smem + (kt & 1) * C::W_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[C::MT][4];
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
          deer::ldmatrix_x4(af[mt], xs + (wm * C::WTM + mt * 16 + (lane & 15)) * C::XLD
                                        + kk * 16 + ((lane >> 4) << 3));
#pragma unroll
        for (int np = 0; np < C::NT / 2; ++np) {
          uint32_t bfr[4];
          deer::ldmatrix_x4_trans(bfr, ws + (kk * 16 + (lane & 15)) * C::WLD
                                           + wn * C::WTN + np * 16 + ((lane >> 4) << 3));
#pragma unroll
          for (int mt = 0; mt < C::MT; ++mt) {
            deer::mma_bf16(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
            deer::mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
          }
        }
      }
      if (kt + 2 < nk) named_arrive(EMPTY + (kt & 1), C::THREADS);
    }
  }
  deer::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the fp32 partial tile

  float* part = reinterpret_cast<float*>(smem_raw);
  if (tid < C::CONSUMERS) {
    const int wm = warp / C::WN, wn = warp % C::WN;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int r = wm * C::WTM + mt * 16 + g, c = wn * C::WTN + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(part + r * C::PLD + c) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(part + (r + 8) * C::PLD + c) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
  }
  deer::reduce_partials<C::BM, C::BN, C::PLD, C::THREADS>(part, y, m0, n0, M, N,
                                                          s + (size_t)layer * N + n0);
}

// ---------------------------------------------------------------------------
// wgmma path: a warpgroup per 64 rows, wgmma.m64n128k16 from shared memory.
// Both tiles in the 128-byte swizzle (16-byte chunk c of row r stored at
// chunk c ^ (r % 8)): x K-major, one 128-byte row of 64 K-values per x row;
// the widened tile N-major, 64-column atoms of 64 K-rows x 128 bytes, atoms
// 8 KB apart (LBO), 8-row groups 1024 bytes apart (SBO), as K2's weights.
// ---------------------------------------------------------------------------

template <int BM_, int STAGES_>
struct WgCfg {
  static constexpr int BM = BM_, BN = 128, STAGES = STAGES_;
  static constexpr int THREADS = BM / 64 * 128;  // a warpgroup per 64 rows
  static constexpr int X_BYTES = BM * BK * 2;
  static constexpr int W_BYTES = BK * BN * 2;    // one widened tile, 16 KB
  static constexpr int PLD = BN + 8;
  // host side, for the launch; + 1 KB to align the tiles to the swizzle's
  // 1024-byte atoms
  template <class Codes>
  static constexpr size_t smem() {
    const size_t ring = 2 * W_BYTES + (size_t)STAGES * (X_BYTES + Codes::RB * BN);
    const size_t part = (size_t)BM * PLD * 4;
    return (ring > part ? ring : part) + 1024;
  }
  static_assert(STAGES >= 4, "two tiles in flight beside the two in the tensor cores");
};

template <class Codes, class C>
__global__ void __launch_bounds__(C::THREADS)
indexed_matmul_quant_wgmma(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
                           const float* __restrict__ s, const int* __restrict__ idx,
                           bf16* __restrict__ y, int M, int K, int N, int L) {
  constexpr int STAGE = C::X_BYTES + Codes::RB * C::BN;  // bytes a ring stage
  static_assert(STAGE % 1024 == 0, "stages start on swizzle atoms");
  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_raw);
  smem += (1024 - (deer::smem_addr(smem) & 1023)) & 1023;
  uint8_t* ring = smem + 2 * C::W_BYTES;  // after the two widened tiles
  const int nsplit = gridDim.x;
  const int split = blockIdx.x;
  const int m0 = blockIdx.y * C::BM;
  const int n0 = blockIdx.z * C::BN;
  const int tid = threadIdx.x, wg = tid >> 7;

  const int layer = min(max(*idx, 0), L - 1);
  const int rows = Codes::Q4 ? K / 2 : K;
  const int rslice = rows / nsplit;
  const int nk = rslice / Codes::RB;
  const int r0 = split * rslice;
  const int8_t* wl = wq + ((size_t)layer * rows + r0) * N + n0;

  auto load = [&](int stage, int kt) {
    uint8_t* xs = ring + stage * STAGE;
    load_stage<Codes, C::BM, C::BN, C::THREADS>(
        tid, xs, xs + C::X_BYTES, x, wl, m0, M, K, N, rows, r0 + kt * Codes::RB, kt,
        [](int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); });
  };

  float d[C::BN / 2];
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) d[i] = 0.f;

  // Two tiles ahead are in flight while the tensor cores work on tile kt
  // and may still be finishing tile kt - 1.  A stage and a widened tile
  // are rewritten two iterations after their wgmma group was issued, when
  // every warpgroup has waited for that group (wait_group 1 below, before
  // the next barrier).
#pragma unroll
  for (int st = 0; st < C::STAGES - 2; ++st) {
    if (st < nk) load(st, st);
    deer::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    deer::cp_async_wait<C::STAGES - 3>();  // this thread's copies of tile kt
    __syncthreads();  // every thread's copies landed; tile kt - 2 retired
    const int next = kt + C::STAGES - 2;
    if (next < nk) load(next % C::STAGES, next);
    deer::cp_async_commit();

    const uint8_t* stage = ring + (kt % C::STAGES) * STAGE;
    uint8_t* ws = smem + (kt & 1) * C::W_BYTES;
    widen_tile<Codes, C::BN, C::THREADS>(tid, stage + C::X_BYTES, [&](int r, int c, uint4 v) {
      const int ch = (c & 63) >> 3;
      *reinterpret_cast<uint4*>(ws + (c >> 6) * 8192 + r * 128 + ((ch ^ (r & 7)) << 4)) = v;
    });
    deer::fence_proxy_async();  // the copies and the widened tile, visible to wgmma
    __syncthreads();

    const uint8_t* xs = stage + wg * 64 * 128;
    deer::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = deer::wgmma_desc_sw128(xs + kk * 32, 16, 1024);
      const uint64_t db = deer::wgmma_desc_sw128(ws + kk * 2048, 8192, 1024);
      deer::wgmma_m64n128k16(d, da, db, 1);
    }
    deer::wgmma_commit();
    deer::wgmma_wait<1>();  // tile kt - 1's group is done
    deer::fence_regs(d);
  }
  deer::wgmma_wait<0>();
  deer::fence_regs(d);
  deer::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the fp32 partial tile

  float* part = reinterpret_cast<float*>(smem_raw);
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r = wg * 64 + ((tid >> 5) & 3) * 16 + g;
#pragma unroll
  for (int j = 0; j < C::BN / 8; ++j) {
    *reinterpret_cast<float2*>(part + r * C::PLD + j * 8 + 2 * t) = make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(part + (r + 8) * C::PLD + j * 8 + 2 * t) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
  deer::reduce_partials<C::BM, C::BN, C::PLD, C::THREADS>(part, y, m0, n0, M, N,
                                                          s + (size_t)layer * N + n0);
}

// the block configs, in the order of indexed_matmul_quant_plan's QUANT_CONFIGS
using Mma = MmaCfg<32, 64, 1, 4, 4, 8>; // 0: M <= 32, or N % 128 != 0
using Wg128 = WgCfg<128, 4>;            // 1: 32 < M <= 128
using Wg256 = WgCfg<256, 4>;            // 2: larger M, in chunks of 256 rows

template <class Codes, class C, class Kernel>
int launch_cluster(Kernel kern, const bf16* x, const int8_t* w, const float* s, const int* idx,
                   bf16* y, int M, int K, int N, int L, int splits, cudaStream_t stream) {
  const int rows = Codes::Q4 ? K / 2 : K;
  if (splits < 1 || splits > 8 || rows % (splits * Codes::RB) || N % C::BN || C::BM % splits)
    return (int)cudaErrorInvalidValue;
  constexpr size_t SMEM = C::template smem<Codes>();
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (M + C::BM - 1) / C::BM, N / C::BN);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, x, w, s, idx, y, M, K, N, L);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <class Codes>
int launch_bf16(const bf16* x, const int8_t* w, const float* s, const int* idx, bf16* y,
                int M, int K, int N, int L, int config, int splits, cudaStream_t st) {
  switch (config) {
#define MMA(C) launch_cluster<Codes, C>(indexed_matmul_quant_mma<Codes, C>, x, w, s, idx, y, \
                                        M, K, N, L, splits, st)
#define WG(C) launch_cluster<Codes, C>(indexed_matmul_quant_wgmma<Codes, C>, x, w, s, idx, y, \
                                       M, K, N, L, splits, st)
    case 0: return MMA(Mma);
    case 1: return WG(Wg128);
    case 2: return WG(Wg256);
#undef MMA
#undef WG
    default: return (int)cudaErrorInvalidValue;
  }
}

constexpr int F32_ROWS = 8;     // rows per thread
constexpr int F32_COLS = 128;   // columns per block (one per thread)

template <bool Q4>
__global__ void __launch_bounds__(F32_COLS)
indexed_matmul_quant_f32(const float* __restrict__ x,
                         const int8_t* __restrict__ wq,
                         const float* __restrict__ s,
                         const int* __restrict__ idx, float* __restrict__ y,
                         int M, int K, int N, int L) {
  const int m0 = blockIdx.x * F32_ROWS;
  const int n = blockIdx.y * F32_COLS + threadIdx.x;
  if (n >= N) return;
  const int layer = min(max(*idx, 0), L - 1);
  const int rows = Q4 ? K / 2 : K;
  const int8_t* wl = wq + (size_t)layer * rows * N;
  float acc[F32_ROWS];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) acc[r] = 0.f;
  for (int k = 0; k < rows; ++k) {
    const int b = wl[(size_t)k * N + n];
    if (Q4) {
      const float lo = (float)(((b & 0xF) ^ 8) - 8);
      const float hi = (float)(b >> 4);
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) {
        if (m0 + r < M) {
          const float* xr = x + (size_t)(m0 + r) * K;
          acc[r] = fmaf(xr[k], lo, acc[r]);
          acc[r] = fmaf(xr[rows + k], hi, acc[r]);
        }
      }
    } else {
      const float wv = (float)b;
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) {
        if (m0 + r < M) acc[r] = fmaf(x[(size_t)(m0 + r) * K + k], wv, acc[r]);
      }
    }
  }
  const float sc = s[(size_t)layer * N + n];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    if (m0 + r < M) y[(size_t)(m0 + r) * N + n] = acc[r] * sc;
  }
}

template <class Codes>
int launch(const void* x, const void* wq, const void* s, const void* idx, void* y, int M,
           int K, int N, int L, int dtype, int config, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(s);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 1)
    return launch_bf16<Codes>(static_cast<const bf16*>(x), w, sc, ix, static_cast<bf16*>(y), M,
                              K, N, L, config, splits, st);
  const dim3 grid((M + F32_ROWS - 1) / F32_ROWS, (N + F32_COLS - 1) / F32_COLS);
  indexed_matmul_quant_f32<Codes::Q4><<<grid, F32_COLS, 0, st>>>(
      static_cast<const float*>(x), w, sc, ix, static_cast<float*>(y), M, K, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  K is x's (unpacked) width.  For
// bfloat16, `config` (0-2: Mma, Wg128, Wg256 above) and `splits`
// (1-8, the K split and cluster size) come from indexed_matmul_quant_plan;
// the wrapper guarantees K % (64 * splits) == 0, N % 64 == 0 (% 128 for
// configs 1 and 2) and 16-byte aligned x, weights and scales; any M >= 1.
// fp32 ignores config and splits.  s is (L, N) fp32; idx points to one
// int32 in device memory.  Returns the first CUDA error of the launch, 0 if
// none.
extern "C" int deer_indexed_matmul_q8(const void* x, const void* wq, const void* s,
                                      const void* idx, void* y, int M, int K, int N, int L,
                                      int dtype, int config, int splits, void* stream) {
  return launch<Int8Codes>(x, wq, s, idx, y, M, K, N, L, dtype, config, splits, stream);
}

extern "C" int deer_indexed_matmul_q4(const void* x, const void* wq4, const void* s,
                                      const void* idx, void* y, int M, int K, int N, int L,
                                      int dtype, int config, int splits, void* stream) {
  return launch<Int4Codes>(x, wq4, s, idx, y, M, K, N, L, dtype, config, splits, stream);
}
