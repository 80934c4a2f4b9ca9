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
// cross from device memory: each warp widens its codes to bf16 in shared
// memory (int8 and int4 values are exact in bf16), the tensor cores
// accumulate in fp32, and the scale is applied in fp32 in the epilogue,
// before the one rounding to x's dtype.  K4 unpacks each byte into its two
// rows and accumulates x[:, k] * low + x[:, K/2 + k] * high into the same
// accumulator.  An index outside [0, L) is clamped, as in K2.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at one stream (M = 32
// text rows): one deer_3b decoder layer's four products read 2048*6144 +
// 2048*2048 + 2048*8192 + 8192*2048 = 50.3 M weights.  K3 moves 50.3 MB of
// int8 codes -> 15.0 us (15.7 us with x, y and the scales), K4 25.2 MB of
// packed bytes -> 7.5 us (8.2 us), against 3.2 GFLOP -> 3.3 us: both are
// bound by weight bytes up to M ~ 150 (K3) and M ~ 75 (K4), and by
// operations above.  The design spends its effort on bytes in flight: a
// block owns a 16-column strip of Wq[idx] and 16 (or, from M = 128, 64)
// rows of x; its eight warps split the weight rows eight ways, and each
// lane of a warp loads one 16-byte row segment per step, with the next
// step's segment already in flight while the current one is widened and
// multiplied (wmma 16x16x16 bf16, fp32 accumulation).  The partial sums of
// the eight warps meet in shared memory, reusing the staging buffers.  The
// 64-row tiles at larger M stage each weight tile once for four row
// fragments, so the codes are widened a quarter as often.  An fp32 path
// (CUDA cores, one column per thread) serves fp32 compute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <cstdint>
#include <cstring>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BN = 16;      // columns per block (one 16-column fragment)
constexpr int KSPLIT = 8;   // warps per block, each an eighth of the rows
constexpr int CHUNK = 32;   // weight rows a warp stages per step (one a lane)

__device__ __forceinline__ unsigned pack2(int a, int b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn((float)a, (float)b);
  unsigned r;
  memcpy(&r, &h, sizeof(r));
  return r;
}

// signed byte j of w, and its two sign-extended nibbles
__device__ __forceinline__ int sbyte(unsigned w, int j) {
  return (int)(w << (24 - 8 * j)) >> 24;
}
__device__ __forceinline__ int lo_nib(unsigned w, int j) {
  return (int)(w << (28 - 8 * j)) >> 28;
}
__device__ __forceinline__ int hi_nib(unsigned w, int j) {
  return (int)(w << (24 - 8 * j)) >> 28;
}

// 16 codes (one 16-byte row segment) -> 16 bf16 at lo (K3: the bytes; K4:
// the low nibbles) and, for K4, the high nibbles at hi.
template <bool Q4>
__device__ __forceinline__ void widen(const uint4 v, bf16* lo, bf16* hi) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned a[8], b[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (Q4) {
      a[2 * q] = pack2(lo_nib(w[q], 0), lo_nib(w[q], 1));
      a[2 * q + 1] = pack2(lo_nib(w[q], 2), lo_nib(w[q], 3));
      b[2 * q] = pack2(hi_nib(w[q], 0), hi_nib(w[q], 1));
      b[2 * q + 1] = pack2(hi_nib(w[q], 2), hi_nib(w[q], 3));
    } else {
      a[2 * q] = pack2(sbyte(w[q], 0), sbyte(w[q], 1));
      a[2 * q + 1] = pack2(sbyte(w[q], 2), sbyte(w[q], 3));
    }
  }
  uint4* d = reinterpret_cast<uint4*>(lo);
  d[0] = make_uint4(a[0], a[1], a[2], a[3]);
  d[1] = make_uint4(a[4], a[5], a[6], a[7]);
  if (Q4) {
    uint4* e = reinterpret_cast<uint4*>(hi);
    e[0] = make_uint4(b[0], b[1], b[2], b[3]);
    e[1] = make_uint4(b[4], b[5], b[6], b[7]);
  }
}

// MT: 16-row fragments of x per block (1 or 4).
template <bool Q4, int MT>
__global__ void __launch_bounds__(KSPLIT * 32)
indexed_matmul_quant_bf16(const bf16* __restrict__ x,
                          const int8_t* __restrict__ wq,
                          const float* __restrict__ s,
                          const int* __restrict__ idx, bf16* __restrict__ y,
                          int K, int N, int L) {
  constexpr int NT = Q4 ? 2 : 1;        // staged tiles a step (low, high)
  constexpr int TILE = CHUNK * BN;      // bf16 elements a staged tile
  constexpr int STAGE_BYTES = KSPLIT * NT * TILE * 2;
  constexpr int PART_BYTES = KSPLIT * MT * 16 * BN * 4;
  __shared__ __align__(128) unsigned char
      smem[STAGE_BYTES > PART_BYTES ? STAGE_BYTES : PART_BYTES];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * 16 * MT;
  const int n0 = blockIdx.y * BN;
  const int layer = min(max(*idx, 0), L - 1);
  const int rows = Q4 ? K / 2 : K;      // weight rows of one layer
  const int per = rows / KSPLIT;
  const int beg = warp * per;
  const int end = beg + per;
  bf16* stage = reinterpret_cast<bf16*>(smem) + warp * NT * TILE;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) wmma::fill_fragment(acc[mt], 0.f);

  const int8_t* src = wq + ((size_t)layer * rows + beg + lane) * N + n0;
  uint4 cur = __ldg(reinterpret_cast<const uint4*>(src));
  for (int r = beg; r < end; r += CHUNK) {
    uint4 nxt = cur;
    if (r + CHUNK < end) {
      src += (size_t)CHUNK * N;
      nxt = __ldg(reinterpret_cast<const uint4*>(src));
    }
    widen<Q4>(cur, stage + lane * BN, stage + TILE + lane * BN);
    __syncwarp();
#pragma unroll
    for (int h = 0; h < CHUNK / 16; ++h) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, stage + t * TILE + h * 16 * BN, BN);
        // the high nibbles of packed row k multiply x column K/2 + k
        const int kx = r + h * 16 + t * rows;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
          wmma::load_matrix_sync(af, x + (size_t)(m0 + mt * 16) * K + kx, K);
          wmma::mma_sync(acc[mt], af, bf, acc[mt]);
        }
      }
    }
    __syncwarp();
    cur = nxt;
  }

  __syncthreads();  // the staging buffers become the partial sums
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    wmma::store_matrix_sync(part + (warp * MT + mt) * 16 * BN, acc[mt], BN,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MT * 16 * BN; i += blockDim.x) {
    const int r = i / BN, c = i % BN;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < KSPLIT; ++w) sum += part[(w * MT * 16 + r) * BN + c];
    y[(size_t)(m0 + r) * N + n0 + c] =
        __float2bfloat16(sum * s[(size_t)layer * N + n0 + c]);
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

template <bool Q4>
int launch(const void* x, const void* wq, const void* s, const void* idx,
           void* y, int M, int K, int N, int L, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(s);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 1) {
    const bf16* xb = static_cast<const bf16*>(x);
    bf16* yb = static_cast<bf16*>(y);
    if (M >= 128 && M % 64 == 0) {
      indexed_matmul_quant_bf16<Q4, 4><<<dim3(M / 64, N / BN), KSPLIT * 32, 0,
                                         st>>>(xb, w, sc, ix, yb, K, N, L);
    } else {
      indexed_matmul_quant_bf16<Q4, 1><<<dim3(M / 16, N / BN), KSPLIT * 32, 0,
                                         st>>>(xb, w, sc, ix, yb, K, N, L);
    }
  } else {
    const dim3 grid((M + F32_ROWS - 1) / F32_ROWS,
                    (N + F32_COLS - 1) / F32_COLS);
    indexed_matmul_quant_f32<Q4><<<grid, F32_COLS, 0, st>>>(
        static_cast<const float*>(x), w, sc, ix, static_cast<float*>(y), M, K,
        N, L);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  K is x's (unpacked) width.  For
// bfloat16 the wrapper guarantees M % 16 == 0, weight rows (K, or K/2 for
// K4) % 256 == 0, N % 16 == 0, 32-byte aligned x and 16-byte aligned
// weights.  s is (L, N) fp32; idx points to one int32 in device memory.
// Returns cudaGetLastError().
extern "C" int deer_indexed_matmul_q8(const void* x, const void* wq,
                                      const void* s, const void* idx, void* y,
                                      int M, int K, int N, int L, int dtype,
                                      void* stream) {
  return launch<false>(x, wq, s, idx, y, M, K, N, L, dtype, stream);
}

extern "C" int deer_indexed_matmul_q4(const void* x, const void* wq4,
                                      const void* s, const void* idx, void* y,
                                      int M, int K, int N, int L, int dtype,
                                      void* stream) {
  return launch<true>(x, wq4, s, idx, y, M, K, N, L, dtype, stream);
}
