// Building blocks shared by the bf16 kernels (K1, its backward, K2, K3,
// K4): cp.async copies into shared memory, ldmatrix fragment loads, the
// bf16 tensor-core products mma.sync.m16n8k16 and wgmma with fp32
// accumulation, and the split-K reduction over a thread-block cluster.
//
// Fragment layout of m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..),
//                           a2 = (g, 2t+8..),   a3 = (g+8, 2t+8..)
//   B (16 x 8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C (16 x 8, fp32):       c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..)
// so the C fragments of two neighbouring 8-column tiles, rounded to bf16
// in pairs, are the A fragment of the next product (FlashAttention-2's
// register reuse of P).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace deer {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from device to shared memory that bypasses L1; with
// valid == false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(n));
}

// the same for 4 bytes (through L1: cp.async.cg takes 16 bytes only), for
// fp32 rows that need not be 16-byte aligned
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of each matrix, (row l / 4, cols 2(l % 4)..+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, transposed: lane l receives (rows 2(l % 4)..+1, col l / 4).
// On a row-major (k, n) tile this yields B fragments directly.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b on the tensor cores (bf16 in, fp32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// wgmma (sm_90a only): a warpgroup (4 warps) multiplies from shared memory.
// Operands are described by 64-bit descriptors of tiles in the 128-byte
// swizzle: rows of 128 bytes, 16-byte chunk c of row r stored at chunk
// c ^ (r % 8), groups of 8 rows 1024 bytes apart (SBO).  A is K-major (x
// rows, 64 K-values a row); B is N-major (weight rows, 64 N-values a row),
// hence trans-b = 1, with 64-column atoms LBO bytes apart.  The
// accumulator of m64nNk16 lays out as mma.sync's C fragments: warp w of
// the warpgroup holds rows 16w..16w+15, d[4j..4j+3] the 8-column tile j.
// ---------------------------------------------------------------------------

// The tile must start on a 1024-byte boundary; a start address moved by a
// multiple of 16 bytes within the swizzle atom addresses the next K slice.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p, uint32_t lbo_bytes,
                                                     uint32_t sbo_bytes) {
  uint64_t d = (smem_addr(p) & 0x3FFFF) >> 4;
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  return d | (1ull << 62);  // base offset 0, layout type 1 (128-byte swizzle)
}

// make writes by ordinary (generic-proxy) stores and cp.async visible to
// wgmma, which reads shared memory through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator registers across an
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 per warpgroup, fp32) (+)= A (64 x 16) * B (16 x 128), bf16
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// Split-K over a thread-block cluster (grid (splits, row chunks, strips),
// cluster (splits, 1, 1)).  After the main loop each block of the cluster
// holds its split's fp32 partial tile (BM x BN, row stride PLD) in shared
// memory.  Block r sums rows [r * BM / S, (r + 1) * BM / S) over the S
// tiles in rank order, through distributed shared memory, multiplies by
// scale[c] (the fp32 per-column scale of the strip, K3 / K4) unless scale
// is null, rounds once to bf16 and stores the rows below M.  The fixed
// order makes the result bit-identical from run to run.
// ---------------------------------------------------------------------------
template <int BM, int BN, int PLD, int THREADS>
__device__ __forceinline__ void reduce_partials(float* part, bf16* __restrict__ y, int m0,
                                                int n0, int M, int N,
                                                const float* __restrict__ scale) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = gridDim.x;
  const int split = blockIdx.x;
  cluster.sync();  // every split's partial tile is in its block's shared memory
  const int rows = BM / nsplit;
  for (int i = threadIdx.x; i < rows * (BN / 4); i += THREADS) {
    const int r = split * rows + i / (BN / 4), c = (i % (BN / 4)) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < nsplit; ++s) {
      const float* rp = cluster.map_shared_rank(part, s);
      const float4 v = *reinterpret_cast<const float4*>(rp + r * PLD + c);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (scale != nullptr) {
      sum.x *= scale[c];
      sum.y *= scale[c + 1];
      sum.z *= scale[c + 2];
      sum.w *= scale[c + 3];
    }
    if (m0 + r < M) {
      const uint2 out = make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
      *reinterpret_cast<uint2*>(y + (size_t)(m0 + r) * N + n0 + c) = out;
    }
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

}  // namespace deer
