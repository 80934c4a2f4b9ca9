// Layer-indexed matmul for Hopper: y = x @ W[idx] over stacked (L, K, N)
// weights, with idx read from device memory inside the kernel.
//
// Replaces the TPU kernel deer_vla_tpu/ops/pallas/indexed_matmul.py
// (indexed_matmul -> _run -> _kernel), which streams W[idx] tile by tile
// with the index as a scalar-prefetch argument.  On the card the point is
// the same device-side index: the decoder loop passes a 0-dim int32 tensor,
// so no layer index ever crosses to the host (no .item(), no sync), which
// lets the exit loop be captured as a CUDA graph later.  An index outside
// [0, L) is clamped, as the TPU engine's dynamic index is.
//
// Bound on an H100 SXM at one stream (M = 32 text rows): one decoder layer's
// four products read 2048*6144 + 2048*2048 + 2048*8192 + 8192*2048 bf16
// weights = 100.7 MB -> 30 us at 3.35 TB/s, against 3.2 GFLOP -> 3.3 us at
// 989 TFLOP/s; the bound is weight bytes up to M ~ 300.  The design streams
// each weight element from device memory once: a block owns a 16-column
// strip of W[idx] and 16 rows of x, its four warps split K four ways and
// run bf16 tensor-core MMAs (wmma 16x16x16, fp32 accumulation), and the
// partial sums meet in shared memory.  At one stream the grid is
// (2 row tiles) x (N / 16 strips): 256 blocks for the 2048-column products,
// up to 1024 for the 8192-column one, so every SM has work.  The row tiles
// are the fastest grid dimension, so the blocks that share a strip run
// together and the second one reads it from L2, not from device memory.
// x is zero-padded to a multiple of 16 rows by the wrapper.  An fp32 path
// (CUDA cores, one column per thread) serves fp32 compute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 16;      // rows per block (one 16-row fragment)
constexpr int BN = 16;      // columns per block (one 16-column fragment)
constexpr int KSPLIT = 4;   // warps per block, each a quarter of K

__global__ void __launch_bounds__(KSPLIT * 32)
indexed_matmul_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const int* __restrict__ idx, bf16* __restrict__ y,
                    int K, int N, int L) {
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int layer = min(max(*idx, 0), L - 1);
  const bf16* wl = w + (size_t)layer * K * N;
  const int warp = threadIdx.x / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  const int kper = K / KSPLIT;
  const int kbeg = warp * kper;
#pragma unroll 4
  for (int kk = kbeg; kk < kbeg + kper; kk += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
    wmma::load_matrix_sync(bfrag, wl + (size_t)kk * N + n0, N);
    wmma::load_matrix_sync(afrag, x + (size_t)m0 * K + kk, K);
    wmma::mma_sync(acc, afrag, bfrag, acc);
  }

  __shared__ float part[KSPLIT][BM][BN];
  wmma::store_matrix_sync(&part[warp][0][0], acc, BN, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int r = i / BN, c = i % BN;
    float s = 0.f;
#pragma unroll
    for (int s_ = 0; s_ < KSPLIT; ++s_) s += part[s_][r][c];
    y[(size_t)(m0 + r) * N + n0 + c] = __float2bfloat16(s);
  }
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

// dtype: 0 = float32, 1 = bfloat16.  For bfloat16 the wrapper guarantees
// M % 16 == 0, K % 64 == 0, N % 16 == 0 and 32-byte aligned x and w.
// idx points to one int32 in device memory.  Returns cudaGetLastError().
extern "C" int deer_indexed_matmul(const void* x, const void* w, const void* idx,
                                   void* y, int M, int K, int N, int L, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid(M / BM, N / BN);
    indexed_matmul_bf16<<<grid, KSPLIT * 32, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const int*>(idx), static_cast<bf16*>(y), K, N, L);
  } else {
    const dim3 grid((M + F32_ROWS - 1) / F32_ROWS, (N + F32_COLS - 1) / F32_COLS);
    indexed_matmul_f32<<<grid, F32_COLS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const int*>(idx), static_cast<float*>(y), M, K, N, L);
  }
  return (int)cudaGetLastError();
}
