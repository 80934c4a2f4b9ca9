// Fused attention for Hopper: out = softmax(scale * Q K^T + bias) V.
//
// Replaces the TPU kernel deer_vla_tpu/ops/pallas/flash_attention.py
// (flash_attention -> _run -> _kernel).  That kernel held one whole
// (batch, head) block in VMEM; here the keys are tiled and the softmax is
// computed online, so a block's shared memory does not grow with Sk.
//
// Numerics follow the TPU kernel: logits, running max, exponentials and the
// row sum are fp32; P is rounded to V's dtype before P.V (which accumulates
// in fp32); the division by the row sum comes after P.V; key columns past
// Sk are set to -1e30, so a row whose bias is -1e9 everywhere gives the same
// uniform weights as the plain version.  The bias is read through element
// strides (0 for a broadcast batch or head dim).  P is rounded against the
// running, not the final, row max (the plain version rounds against the
// final one): the outputs differ by about one bf16 rounding.
//
// bf16 path (the ViT's self-attention, (2B, 16, 257, 64) at B streams):
// one block is one warpgroup, 4 warps x 16 query rows = 64 rows, on a
// (ceil(Sq / 64), H, B) grid: 160 blocks at B = 1, 1,280 at B = 8.  The Q
// tile is loaded once and each warp keeps its Q fragments in registers.
// The kernel is built for D = 64 (the ViT, perceiver and cross-attention
// heads) and D = 128 (MPT-1B's heads); the wrapper zero-pads other
// multiples of 16 up to 128 to the next of the two.  K and V
// tiles of 64 keys go through a two-stage shared-memory ring filled by
// cp.async (16 bytes a lane, zero-filled past Sk); the next tile is in
// flight while the current one is computed.  Shared rows are padded by 16
// bytes, so the eight row addresses of each ldmatrix phase hit distinct
// bank groups.  S = Q K^T and O += P V run on the tensor cores as
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate): K fragments come from
// ldmatrix, V fragments from ldmatrix.trans, and P goes from the S
// accumulators to the A operand of P V in registers, rounded to bf16, with
// no trip through shared memory.  The online max and sum are per-thread
// fp32 with quad shuffles (the four lanes that share a row in the mma
// layout).  The output is staged in the warp's own Q rows and written with
// 16-byte stores through the caller's strides.  q, k, v and out are read
// and written through their (batch, head, seq) strides, so the ViT hands
// over its split_heads views of the fused qkv and gets back a
// (B, Sq, H, D) buffer that merge_heads reshapes for free.  mma.sync
// rather than wgmma: at 64-row warpgroups and Sk = 257 a block runs five
// key tiles, and mma.sync's register-resident P needs no shared-memory
// descriptors; wgmma's higher issue rate is not what bounds this call.
//
// Bound on an H100 SXM for the ViT call at one stream (bf16): q, k, v read
// once and out written once = 4 * 2*16*257*64 * 2 B = 4.2 MB -> 1.26 us at
// 3.35 TB/s; 4 * 2*16*257*257*64 = 0.54 GFLOP -> 0.55 us at 989 TFLOP/s, so
// the bound is bytes.  Measured on an H100 SXM at 700 W: 14 us at B = 1
// and 59 us at B = 8, 1.5x and 1.75x SDPA.  What holds it back now: at
// B = 1 the grid is 160 blocks of five dependent key tiles each, so the
// call is latency-bound (one wave, each block's tiles in a chain of
// cp.async waits and barriers); 257 = 4 * 64 + 1, so the fifth q tile of
// each head holds one real row and the fifth key tile one real key: the
// kernel does about 1.55x the tensor-core and exp work the shape needs,
// which is what bounds it at B = 8 (mma.sync and the fp32 exponentials
// issue-bound over 2.4 waves of blocks).
//
// fp32 path (cross-checks only): the first version, kept as it was: CUDA
// cores in fp32, each warp owns 8 query rows, each lane one key of the
// 32-key tile, K and V tiles staged in shared memory as fp32 with a padded
// row stride; it takes contiguous q, k, v and writes a contiguous out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper_mma.cuh"

namespace {

using deer::bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;      // query rows per block: 4 warps x 16
constexpr int TC_BKV = 64;     // keys per tile
constexpr int TC_WARPS = 4;
constexpr int TC_STAGES = 2;   // K / V ring depth
constexpr float LOG2E = 1.4426950408889634f;

struct TcArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const void* bias;
  bf16* out;
  int H, Sq, Sk;
  float scale;
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;  // element strides
  long long bb, bh, bq, bk;                                  // bias strides
};

constexpr size_t tc_smem_bytes(int d) {
  return (size_t)(TC_BQ + 2 * TC_STAGES * TC_BKV) * (d + 8) * sizeof(bf16);
}

// 64 rows x D of a (seq, D) matrix with row stride `stride` into a padded
// shared tile; rows at or past `nrows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int nrows, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  constexpr int LDS = D + 8;
#pragma unroll
  for (int it = 0; it < 64 * CPR / (TC_WARPS * 32); ++it) {
    const int i = tid + it * TC_WARPS * 32;
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = row0 + r < nrows;
    deer::cp_async16(dst + r * LDS + c,
                     ok ? src + (long long)(row0 + r) * stride + c : src, ok);
  }
}

template <int D, typename TB>
__global__ void __launch_bounds__(TC_WARPS * 32)
flash_attention_bf16(const TcArgs a) {
  constexpr int LDS = D + 8;
  constexpr int KD = D / 16;          // k16 steps over the head dim
  constexpr int ND = D / 8;           // 8-wide output tiles
  static_assert(D == 64 || D == 128, "built for D = 64 and 128 only");
  extern __shared__ uint4 smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + TC_BQ * LDS;
  bf16* vs = ks + TC_STAGES * TC_BKV * LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TC_BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qg = a.q + b * a.qb + h * a.qh;
  const bf16* kg = a.k + b * a.kb + h * a.kh;
  const bf16* vg = a.v + b * a.vb + h * a.vh;
  const TB* bias = a.bias ? static_cast<const TB*>(a.bias) + b * a.bb + h * a.bh
                          : nullptr;

  load_rows<D>(qs, qg, a.qs, q0, a.Sq, tid);
  load_rows<D>(ks, kg, a.ks, 0, a.Sk, tid);
  load_rows<D>(vs, vg, a.vs, 0, a.Sk, tid);
  deer::cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the row sums
  uint32_t qf[KD][4];  // this warp's Q fragments, loaded once
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  // the lane's ldmatrix address for A fragments of this warp's 16 Q rows
  const bf16* qlane = qs + (warp * 16 + (lane & 15)) * LDS + ((lane >> 4) << 3);
  const int ntiles = (a.Sk + TC_BKV - 1) / TC_BKV;

  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // every warp is done with the stage the next load fills
    if (j + 1 < ntiles) {
      const int st = (j + 1) % TC_STAGES;
      load_rows<D>(ks + st * TC_BKV * LDS, kg, a.ks, (j + 1) * TC_BKV, a.Sk, tid);
      load_rows<D>(vs + st * TC_BKV * LDS, vg, a.vs, (j + 1) * TC_BKV, a.Sk, tid);
    }
    deer::cp_async_commit();
    deer::cp_async_wait<1>();  // tile j (and, at j = 0, the Q tile) landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) deer::ldmatrix_x4(qf[kk], qlane + kk * 16);
    }
    const bf16* kt = ks + (j % TC_STAGES) * TC_BKV * LDS;
    const bf16* vt = vs + (j % TC_STAGES) * TC_BKV * LDS;

    // S (16 x 64 per warp) = Q K^T
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bfr[4];
        deer::ldmatrix_x4(bfr, kt + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS
                                   + kk * 16 + (((lane >> 3) & 1) << 3));
        deer::mma_bf16(s[2 * jp], qf[kk], bfr[0], bfr[1]);
        deer::mma_bf16(s[2 * jp + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // scale, bias, ragged-key mask; online max and sum in fp32
    const int kbase = j * TC_BKV;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kbase + jn * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? ra : rb;
        float x = s[jn][e] * a.scale;
        if (col < a.Sk) {
          if (bias != nullptr && row < a.Sq)
            x += to_f(bias[row * a.bq + col * a.bk]);
        } else {
          x = -1e30f;
        }
        s[jn][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[jn][0], s[jn][1]));
      mx1 = fmaxf(mx1, fmaxf(s[jn][2], s[jn][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f((m0 - mn0) * LOG2E), al1 = exp2f((m1 - mn1) * LOG2E);
    m0 = mn0;
    m1 = mn1;
    const float off0 = mn0 * LOG2E, off1 = mn1 * LOG2E;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      s[jn][0] = exp2f(fmaf(s[jn][0], LOG2E, -off0));
      s[jn][1] = exp2f(fmaf(s[jn][1], LOG2E, -off0));
      s[jn][2] = exp2f(fmaf(s[jn][2], LOG2E, -off1));
      s[jn][3] = exp2f(fmaf(s[jn][3], LOG2E, -off1));
      ps0 += s[jn][0] + s[jn][1];
      ps1 += s[jn][2] + s[jn][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      o[i][0] *= al0;
      o[i][1] *= al0;
      o[i][2] *= al1;
      o[i][3] *= al1;
    }

    // O += P V, P rounded to bf16 straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < TC_BKV / 16; ++kk) {
      const uint32_t pa[4] = {deer::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              deer::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              deer::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              deer::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        deer::ldmatrix_x4_trans(vf, vt + (kk * 16 + (lane & 15)) * LDS + dp * 16
                                        + ((lane >> 4) << 3));
        deer::mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        deer::mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // stage the warp's 16 output rows in its own Q rows (only this warp read
  // them), then 16-byte stores through the output strides
  bf16* ow = qs + warp * 16 * LDS;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    *reinterpret_cast<uint32_t*>(ow + g * LDS + i * 8 + 2 * t) =
        deer::pack_bf16(o[i][0] / l0, o[i][1] / l0);
    *reinterpret_cast<uint32_t*>(ow + (g + 8) * LDS + i * 8 + 2 * t) =
        deer::pack_bf16(o[i][2] / l1, o[i][3] / l1);
  }
  __syncwarp();
  bf16* og = a.out + b * a.ob + h * a.oh;
#pragma unroll
  for (int i = lane; i < 16 * ND; i += 32) {
    const int r = i / ND, c = (i % ND) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < a.Sq)
      *reinterpret_cast<uint4*>(og + row * a.os + c) =
          *reinterpret_cast<const uint4*>(ow + r * LDS + c);
  }
}

template <int D, typename TB>
int launch_bf16(const TcArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes(D);
  auto kern = flash_attention_bf16<D, TB>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid((a.Sq + TC_BQ - 1) / TC_BQ, a.H, B);
  kern<<<grid, TC_WARPS * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TB>
int launch_bf16_d(const TcArgs& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 64: return launch_bf16<64, TB>(a, B, st);
    case 128: return launch_bf16<128, TB>(a, B, st);
    default: return (int)cudaErrorInvalidValue;  // the wrapper pads D
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores (the first version)
// ---------------------------------------------------------------------------

constexpr int BQ = 32;                     // query rows per block
constexpr int BK = 32;                     // keys per tile: one per lane
constexpr int NWARPS = 4;
constexpr int ROWS_PER_WARP = BQ / NWARPS;  // 8

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// DCH: output dims per lane (D <= 32 * DCH)
template <typename TB, int DCH>
__global__ void __launch_bounds__(NWARPS * 32)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const TB* __restrict__ bias,
                    float* __restrict__ out, int H, int Sq, int Sk, int D,
                    float scale, long long bsb, long long bsh,
                    long long bsq, long long bsk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ds = D + 4;          // padded row stride (floats) for Q and K
  float* qs = smem;              // BQ x ds
  float* ks = qs + BQ * ds;      // BK x ds
  float* vs = ks + BK * ds;      // BK x D

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float* qb = q + bh * Sq * D;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;
  const TB* biasb = bias ? bias + b * bsb + h * bsh : nullptr;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < BQ * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    qs[r * ds + c] = (q0 + r < Sq) ? qb[(size_t)(q0 + r) * D + c] : 0.f;
  }

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][DCH];
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[rr][c] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and the Q tile written)
    for (int i = tid; i < BK * D; i += blockDim.x) {
      const int r = i / D, c = i - r * D;
      const bool ok = k0 + r < Sk;
      ks[r * ds + c] = ok ? kb[(size_t)(k0 + r) * D + c] : 0.f;
      vs[r * D + c] = ok ? vb[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    const int kcol = k0 + lane;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * ds);
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      if (q0 + r < Sq) {  // warp-uniform
        const float4* qrow = reinterpret_cast<const float4*>(qs + r * ds);
        float s = 0.f;
        for (int c = 0; c < D / 4; ++c) {
          const float4 a = qrow[c];
          const float4 kk = krow[c];
          s = fmaf(a.x, kk.x, s);
          s = fmaf(a.y, kk.y, s);
          s = fmaf(a.z, kk.z, s);
          s = fmaf(a.w, kk.w, s);
        }
        s *= scale;
        if (kcol < Sk) {
          if (biasb) s += to_f(biasb[(long long)(q0 + r) * bsq + (long long)kcol * bsk]);
        } else {
          s = -1e30f;  // ragged key edge
        }
        const float m_new = fmaxf(m[rr], warp_max(s));
        const float p = expf(s - m_new);
        const float alpha = expf(m[rr] - m_new);
        l[rr] = l[rr] * alpha + warp_sum(p);
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[rr][c] *= alpha;
#pragma unroll 8
        for (int j = 0; j < BK; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
          const float* vrow = vs + j * D;
#pragma unroll
          for (int c = 0; c < DCH; ++c) {
            const int d = lane + 32 * c;
            if (d < D) acc[rr][c] = fmaf(pj, vrow[d], acc[rr][c]);
          }
        }
        m[rr] = m_new;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    if (q0 + r < Sq) {
      float* orow = out + (bh * Sq + q0 + r) * D;
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const int d = lane + 32 * c;
        if (d < D) orow[d] = acc[rr][c] / l[rr];
      }
    }
  }
}

struct F32Args {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;
  void* out;
  int B, H, Sq, Sk, D;
  float scale;
  long long bsb, bsh, bsq, bsk;
};

template <typename TB, int DCH>
int launch_f32(const F32Args& a, cudaStream_t stream) {
  auto kern = flash_attention_f32<TB, DCH>;
  static bool smem_set = false;  // once per instantiation, for its largest D
  if (!smem_set) {
    const int dmax = 32 * DCH;
    const size_t most = (size_t)(BQ * (dmax + 4) + BK * (dmax + 4) + BK * dmax) * sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const size_t smem = (size_t)(BQ * (a.D + 4) + BK * (a.D + 4) + BK * a.D) * sizeof(float);
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const TB*>(a.bias),
      static_cast<float*>(a.out), a.H, a.Sq, a.Sk, a.D, a.scale, a.bsb, a.bsh,
      a.bsq, a.bsk);
  return (int)cudaGetLastError();
}

template <typename TB>
int launch_f32_d(const F32Args& a, cudaStream_t stream) {
  if (a.D <= 32) return launch_f32<TB, 1>(a, stream);
  if (a.D <= 64) return launch_f32<TB, 2>(a, stream);
  if (a.D <= 128) return launch_f32<TB, 4>(a, stream);
  return launch_f32<TB, 8>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out);
// bias_dtype: -1 = no bias, 0 = float32, 1 = bfloat16; bias strides in
// elements (0 on a broadcast dim).
// strides: 12 element strides, (batch, head, seq) of q, k, v and out, read
// by the bf16 path only; the last dim of each has unit stride.  The bf16
// path takes D in {64, 128}, rows 16-byte aligned; the fp32
// path contiguous tensors with D % 4 == 0, D <= 256.  The Python wrapper
// checks both.  Returns the first CUDA error of the launch, 0 if none.
extern "C" int deer_flash_attention(const void* q, const void* k, const void* v,
                                    const void* bias, void* out, int B, int H,
                                    int Sq, int Sk, int D, float scale, int dtype,
                                    int bias_dtype, long long bsb, long long bsh,
                                    long long bsq, long long bsk,
                                    const long long* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const long long* s = strides;
    const TcArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), bias, static_cast<bf16*>(out),
                   H, Sq, Sk, scale,
                   s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                   s[9], s[10], s[11], bsb, bsh, bsq, bsk};
    if (bias_dtype == 0) return launch_bf16_d<float>(a, B, D, st);
    return launch_bf16_d<bf16>(a, B, D, st);  // also the no-bias case
  }
  const F32Args a{q, k, v, bias, out, B, H, Sq, Sk, D, scale, bsb, bsh, bsq, bsk};
  if (bias_dtype == 1) return launch_f32_d<bf16>(a, st);
  return launch_f32_d<float>(a, st);
}
