// Layer-indexed matmul for Hopper: y = x @ W[idx] over stacked (L, K, N)
// weights, with idx read from device memory inside the kernel.
//
// Replaces the TPU kernel deer_vla_tpu/ops/pallas/indexed_matmul.py
// (indexed_matmul -> _run -> _kernel), which streams W[idx] tile by tile
// with the index as a scalar-prefetch argument.  On the card the point is
// the same device-side index: the decoder loop passes a 0-dim int32 tensor,
// so no layer index ever crosses to the host (no .item(), no sync), and the
// kernel allocates nothing, so the four products of a layer can be
// captured in a CUDA graph whose index tensor changes between replays.  An
// index outside [0, L) is clamped, as the TPU engine's dynamic index is.
//
// Bound on an H100 SXM at one stream (M = 32 text rows): one decoder layer's
// four products read 2048*6144 + 2048*2048 + 2048*8192 + 8192*2048 bf16
// weights = 100.7 MB -> 30 us at 3.35 TB/s, against 3.2 GFLOP -> 3.3 us at
// 989 TFLOP/s; the bound is weight bytes up to M ~ 300.
//
// bf16 design: a pipelined weight stream with split-K.  A block owns a
// column strip of BN = 64 or 128 columns (each lane copies 16 bytes, a warp
// 128-256 contiguous bytes of a weight row) and all M rows up to 256
// (larger M in chunks of 256), so at B <= 8 each weight byte leaves device
// memory once and enters shared memory once.  K-tiles of 64 rows of W[idx],
// with the matching 64 columns of x beside them, stream into a 4-stage
// shared-memory ring by cp.async.cg.  Two tensor-core paths, each kept
// because it is the fastest block config at its row count (chip_smoke.py
// times every config side by side; on an H100 SXM at 700 W a layer's four
// products took 61 us in 32 x 64 mma.sync blocks against 66 us in 128-row
// wgmma blocks at M = 32, and 66 us in wgmma against 75 us in 64-row
// mma.sync blocks at M = 64, so the 64-row mma.sync config went):
//   M <= 32 (one stream), or N % 128 != 0: warps run mma.sync.m16n8k16
//     (bf16 in, fp32 accumulate), A fragments by ldmatrix from the x tile,
//     B fragments by ldmatrix.trans from the row-major weight tile; rows
//     padded by 16 bytes so ldmatrix is free of bank conflicts; three tiles
//     in flight while one is consumed.  The blocks are small (56 KB), so
//     split-K puts one or more on every SM and the weight stream spreads
//     over the whole card.
//   M > 32: one warpgroup per 64 rows (128-row blocks up to M = 128,
//     256-row blocks above) runs wgmma.m64n128k16 straight from shared
//     memory, both tiles in the 128-byte swizzle (x K-major, the weight
//     N-major, so neither is transposed); two tiles in flight while the
//     tensor cores work on the third and drain the fourth.  mma.sync issues
//     at about a third of the card's bf16 rate, so its blocks fall behind
//     as rows grow.
// K is split over a thread-block cluster of up to 8 blocks (the split
// count comes from indexed_matmul_plan in ops/kernels/indexed_matmul.py):
// each block leaves its fp32 partial tile in its own shared memory, and
// after a cluster barrier block r sums rows [r*BM/S, (r+1)*BM/S) over the S
// partial tiles, read through distributed shared memory in rank order, and
// rounds once to bf16.  The order is fixed, so the result is bit-identical
// from run to run; no scratch buffer, no atomics, one launch.  x rows past
// M are zero-filled by the copy and never stored, so x needs no padding.
//
// What holds it back now (measured on an H100 SXM at 700 W): at M = 32
// the four products of a layer take 61 us, 2x their bound and 1.3x
// cuBLAS's time; each block runs 4 to 16 K-tiles, so filling the ring and
// the cluster reduction are a visible share of a call that moves 4-34 MB.
// At M = 256 they take 87 us, 1.5x cuBLAS (out_proj 1.9x): the wgmma
// blocks (one an SM, 193 KB of shared memory) cover 64-128 of the 132
// SMs, since a cluster needs its blocks on free SMs of one GPC, and at
// that row count a block's tensor-core work (mlp_down: 134 MFLOP, 18 us at
// an SM's share of the peak) outweighs its bytes; every block re-reads its
// x slice from L2 for each column strip.
//
// An fp32 path (CUDA cores, one column per thread) serves fp32 compute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

using deer::bf16;

constexpr int BK = 64;  // K-tile depth

template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;   // mma tiles a warp
  static constexpr int XLD = BK + 8;                  // padded row strides
  static constexpr int WLD = BN + 8;
  static constexpr int PLD = BN + 8;                  // fp32 partial tile
  static constexpr int X_ELEMS = BM * XLD;
  static constexpr int STAGE_ELEMS = X_ELEMS + BK * WLD;
  static constexpr size_t RING = (size_t)STAGES * STAGE_ELEMS * sizeof(bf16);
  static constexpr size_t PART = (size_t)BM * PLD * sizeof(float);
  static constexpr size_t SMEM = RING > PART ? RING : PART;
  static_assert(NT % 2 == 0, "B fragments are loaded in pairs of n-tiles");
  static_assert(BM * 8 % THREADS == 0 && BK * BN / 8 % THREADS == 0, "copy split");
};

// the mma.sync configuration (indexed_matmul_plan's config 0)
using Cfg0 = Cfg<32, 64, 1, 4, 4>;     // M <= 32 (one stream), or N % 128 != 0

// grid (splits, ceil(M / BM), N / BN), cluster (splits, 1, 1)
template <class C>
__global__ void __launch_bounds__(C::THREADS)
indexed_matmul_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const int* __restrict__ idx, bf16* __restrict__ y,
                    int M, int K, int N, int L) {
  extern __shared__ uint4 smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int nsplit = gridDim.x;
  const int split = blockIdx.x;  // the rank in the (splits, 1, 1) cluster
  const int m0 = blockIdx.y * C::BM;
  const int n0 = blockIdx.z * C::BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / C::WN, wn = warp % C::WN;

  const int layer = min(max(*idx, 0), L - 1);
  const int kslice = K / nsplit;
  const int nk = kslice / BK;
  const bf16* wl = w + (size_t)layer * K * N + (size_t)split * kslice * N + n0;
  const bf16* xl = x + (size_t)split * kslice;

  auto load_stage = [&](int stage, int kt) {
    bf16* xs = ring + stage * C::STAGE_ELEMS;
    bf16* ws = xs + C::X_ELEMS;
#pragma unroll
    for (int it = 0; it < C::BM * 8 / C::THREADS; ++it) {
      const int i = tid + it * C::THREADS;
      const int r = i >> 3, c = (i & 7) * 8;
      const bool ok = m0 + r < M;
      deer::cp_async16(xs + r * C::XLD + c,
                       ok ? xl + (size_t)(m0 + r) * K + kt * BK + c : x, ok);
    }
#pragma unroll
    for (int it = 0; it < BK * C::BN / 8 / C::THREADS; ++it) {
      const int i = tid + it * C::THREADS;
      const int r = i / (C::BN / 8), c = (i % (C::BN / 8)) * 8;
      deer::cp_async16(ws + r * C::WLD + c, wl + (size_t)(kt * BK + r) * N + c, true);
    }
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    deer::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    deer::cp_async_wait<C::STAGES - 2>();  // tile kt has landed
    __syncthreads();  // ... for every thread, and tile kt - 1 is consumed
    const int next = kt + C::STAGES - 1;
    if (next < nk) load_stage(next % C::STAGES, next);
    deer::cp_async_commit();

    const bf16* xs = ring + (kt % C::STAGES) * C::STAGE_ELEMS;
    const bf16* ws = xs + C::X_ELEMS;
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
  }
  deer::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the fp32 partial tile

  float* part = reinterpret_cast<float*>(smem_raw);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int r = wm * C::WTM + mt * 16 + g, c = wn * C::WTN + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(part + r * C::PLD + c) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(part + (r + 8) * C::PLD + c) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  deer::reduce_partials<C::BM, C::BN, C::PLD, C::THREADS>(part, y, m0, n0, M, N, nullptr);
}


// wgmma path (M > 32): one consumer warpgroup per 64 rows, each computing
// its 64 x 128 slab with wgmma.m64n128k16 straight from shared memory.
// Both tiles use the 128-byte swizzle (16-byte chunk c of row r stored at
// chunk c ^ (r % 8)), so the tensor cores read them without bank
// conflicts: the x tile K-major, one 128-byte row of 64 K-values per x row,
// 8-row groups 1024 bytes apart (SBO); the weight tile N-major, 64-column
// atoms of 64 K-rows x 128 bytes, atoms 8 KB apart (LBO), 8-row groups
// 1024 bytes apart (SBO).  Eight neighbouring lanes copy one 128-byte row,
// so the cp.async writes are conflict-free and the reads coalesced.
template <int BM_, int STAGES_>
struct WgCfg {
  static constexpr int BM = BM_, BN = 128, STAGES = STAGES_;
  static constexpr int THREADS = BM / 64 * 128;  // a warpgroup per 64 rows
  static constexpr int X_BYTES = BM * BK * 2;
  static constexpr int STAGE_BYTES = X_BYTES + BK * BN * 2;
  static constexpr int PLD = BN + 8;
  static constexpr size_t RING = (size_t)STAGES * STAGE_BYTES;
  static constexpr size_t PART = (size_t)BM * PLD * sizeof(float);
  // + 1 KB to align the ring to the swizzle's 1024-byte atoms
  static constexpr size_t SMEM = (RING > PART ? RING : PART) + 1024;
  static_assert(STAGES >= 4, "two tiles in flight beside the two in the tensor cores");
};

template <class C>
__global__ void __launch_bounds__(C::THREADS)
indexed_matmul_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const int* __restrict__ idx, bf16* __restrict__ y,
                     int M, int K, int N, int L) {
  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_raw);
  smem += (1024 - (deer::smem_addr(smem) & 1023)) & 1023;
  const int nsplit = gridDim.x;
  const int split = blockIdx.x;
  const int m0 = blockIdx.y * C::BM;
  const int n0 = blockIdx.z * C::BN;
  const int tid = threadIdx.x, wg = tid >> 7;

  const int layer = min(max(*idx, 0), L - 1);
  const int kslice = K / nsplit;
  const int nk = kslice / BK;
  const bf16* wl = w + (size_t)layer * K * N + (size_t)split * kslice * N + n0;
  const bf16* xl = x + (size_t)split * kslice;

  auto load_stage = [&](int stage, int kt) {
    uint8_t* xs = smem + stage * C::STAGE_BYTES;
    uint8_t* ws = xs + C::X_BYTES;
#pragma unroll
    for (int it = 0; it < C::BM * 8 / C::THREADS; ++it) {
      const int i = tid + it * C::THREADS;
      const int r = i >> 3, c = i & 7;
      const bool ok = m0 + r < M;
      deer::cp_async16(xs + r * 128 + ((c ^ (r & 7)) << 4),
                       ok ? xl + (size_t)(m0 + r) * K + kt * BK + c * 8 : x, ok);
    }
#pragma unroll
    for (int it = 0; it < BK * C::BN / 8 / C::THREADS; ++it) {
      const int i = tid + it * C::THREADS;
      const int c = i & 7, k = (i >> 3) & 63, atom = i >> 9;
      deer::cp_async16(ws + atom * 8192 + k * 128 + ((c ^ (k & 7)) << 4),
                       wl + (size_t)(kt * BK + k) * N + atom * 64 + c * 8, true);
    }
  };

  float d[C::BN / 2];
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) d[i] = 0.f;

  // Two tiles ahead are in flight while the tensor cores work on tile kt
  // and may still be finishing tile kt - 1: a stage is refilled two
  // iterations after its wgmma group was issued, when every warpgroup has
  // waited for that group (wait_group 1 below, before the next barrier).
#pragma unroll
  for (int s = 0; s < C::STAGES - 2; ++s) {
    if (s < nk) load_stage(s, s);
    deer::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    deer::cp_async_wait<C::STAGES - 3>();  // this thread's copies of tile kt
    deer::fence_proxy_async();             // ... visible to wgmma
    __syncthreads();  // every thread's copies landed; tile kt - 2 retired
    const int next = kt + C::STAGES - 2;
    if (next < nk) load_stage(next % C::STAGES, next);
    deer::cp_async_commit();

    const uint8_t* xs = smem + (kt % C::STAGES) * C::STAGE_BYTES + wg * 64 * 128;
    const uint8_t* ws = smem + (kt % C::STAGES) * C::STAGE_BYTES + C::X_BYTES;
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
  deer::reduce_partials<C::BM, C::BN, C::PLD, C::THREADS>(part, y, m0, n0, M, N, nullptr);
}

using Wg128 = WgCfg<128, 4>;  // 32 < M <= 128
using Wg256 = WgCfg<256, 4>;  // larger M, in chunks of 256 rows

template <class C, class Kernel>
int launch_cluster(Kernel kern, const bf16* x, const bf16* w, const int* idx, bf16* y, int M,
                int K, int N, int L, int splits, cudaStream_t stream) {
  if (splits < 1 || splits > 8 || K % (splits * BK) || N % C::BN || C::BM % splits)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (M + C::BM - 1) / C::BM, N / C::BN);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, x, w, idx, y, M, K, N, L);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

constexpr int F32_ROWS = 8;     // rows per thread
constexpr int F32_COLS = 128;   // columns per block (one per thread)

__global__ void __launch_bounds__(F32_COLS)
indexed_matmul_f32(const float* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ idx, float* __restrict__ y, int M,
                   int K, int N, int L) {
  const int m0 = blockIdx.x * F32_ROWS;
  const int n = blockIdx.y * F32_COLS + threadIdx.x;
  if (n >= N) return;
  const int layer = min(max(*idx, 0), L - 1);
  const float* wl = w + (size_t)layer * K * N;
  float acc[F32_ROWS];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) acc[r] = 0.f;
  for (int k = 0; k < K; ++k) {
    const float wv = wl[(size_t)k * N + n];
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) {
      if (m0 + r < M) acc[r] = fmaf(x[(size_t)(m0 + r) * K + k], wv, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    if (m0 + r < M) y[(size_t)(m0 + r) * N + n] = acc[r];
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  For bfloat16, `config` (0-2: Cfg0,
// Wg128, Wg256 above) and `splits` (1-8, the K split and cluster
// size) come from indexed_matmul_plan; the wrapper guarantees
// K % (64 * splits) == 0, N % 64 == 0 (% 128 for configs 1 and 2) and
// 16-byte aligned x, w and y.
// Any M >= 1.  fp32 ignores config and splits.  idx points to one int32 in
// device memory.  Returns the first CUDA error of the launch, 0 if none.
extern "C" int deer_indexed_matmul(const void* x, const void* w, const void* idx,
                                   void* y, int M, int K, int N, int L, int dtype,
                                   int config, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    const int* ib = static_cast<const int*>(idx);
    bf16* yb = static_cast<bf16*>(y);
    switch (config) {
#define MMA(C) launch_cluster<C>(indexed_matmul_bf16<C>, xb, wb, ib, yb, M, K, N, L, splits, st)
#define WG(C) launch_cluster<C>(indexed_matmul_wgmma<C>, xb, wb, ib, yb, M, K, N, L, splits, st)
      case 0: return MMA(Cfg0);
      case 1: return WG(Wg128);
      case 2: return WG(Wg256);
#undef MMA
#undef WG
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const dim3 grid((M + F32_ROWS - 1) / F32_ROWS, (N + F32_COLS - 1) / F32_COLS);
  indexed_matmul_f32<<<grid, F32_COLS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int*>(idx), static_cast<float*>(y), M, K, N, L);
  return (int)cudaGetLastError();
}
