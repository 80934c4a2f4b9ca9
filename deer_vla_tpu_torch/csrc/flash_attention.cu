// Fused attention for Hopper: out = softmax(scale * Q K^T + bias) V.
//
// Replaces the TPU kernel deer_vla_tpu/ops/pallas/flash_attention.py
// (flash_attention -> _run -> _kernel).  That kernel held one whole
// (batch, head) block in VMEM; here the keys are tiled and the softmax is
// computed online, so a block's shared memory does not grow with Sk and the
// grid (q-tile, head, batch) launches 9 * 16 * 2 = 288 blocks for the ViT's
// (2, 16, 257, 64) call at one stream, more than the 132 SMs.
//
// Numerics follow the TPU kernel: logits, running max, exponentials and the
// row sum are fp32; P is rounded to V's dtype before P.V (which accumulates
// in fp32); the division by the row sum comes after P.V; key columns past
// Sk are set to -1e30, so a row whose bias is -1e9 everywhere gives the same
// uniform weights as the plain version.  The bias is read through element
// strides (0 for a broadcast batch or head dim).
//
// Bound on an H100 SXM for the ViT call at one stream (bf16): q, k, v read
// once and out written once = 4 * 2*16*257*64 * 2 B = 4.2 MB -> 1.26 us at
// 3.35 TB/s; 4 * 2*16*257*257*64 = 0.54 GFLOP -> 0.55 us at 989 TFLOP/s, so
// the bound is bytes.  This first version computes on the CUDA cores in
// fp32 (no tensor cores): each warp owns 8 query rows, each lane one key of
// the 32-key tile, K and V tiles are staged in shared memory as fp32 with a
// padded row stride so the float4 reads of a quarter-warp hit distinct banks.
// It is therefore bound by the fp32 FMA and shared-memory issue rate, not by
// bytes; wgmma and TMA are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;                     // query rows per block
constexpr int BK = 32;                     // keys per tile: one per lane
constexpr int NWARPS = 4;
constexpr int ROWS_PER_WARP = BQ / NWARPS;  // 8

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
template <typename T, typename TB, int DCH>
__global__ void __launch_bounds__(NWARPS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const TB* __restrict__ bias,
                       T* __restrict__ out, int H, int Sq, int Sk, int D,
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
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  const TB* biasb = bias ? bias + b * bsb + h * bsh : nullptr;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < BQ * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    qs[r * ds + c] = (q0 + r < Sq) ? to_f(qb[(size_t)(q0 + r) * D + c]) : 0.f;
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
      ks[r * ds + c] = ok ? to_f(kb[(size_t)(k0 + r) * D + c]) : 0.f;
      vs[r * D + c] = ok ? to_f(vb[(size_t)(k0 + r) * D + c]) : 0.f;
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
        const float pv = to_f(from_f<T>(p));  // P in V's dtype before P.V
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[rr][c] *= alpha;
#pragma unroll 8
        for (int j = 0; j < BK; ++j) {
          const float pj = __shfl_sync(0xffffffffu, pv, j);
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
      T* orow = out + (bh * Sq + q0 + r) * D;
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const int d = lane + 32 * c;
        if (d < D) orow[d] = from_f<T>(acc[rr][c] / l[rr]);
      }
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;
  void* out;
  int B, H, Sq, Sk, D;
  float scale;
  long long bsb, bsh, bsq, bsk;
};

template <typename T, typename TB, int DCH>
void launch(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * (a.D + 4) + BK * (a.D + 4) + BK * a.D) * sizeof(float);
  auto kern = flash_attention_kernel<T, TB, DCH>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const TB*>(a.bias), static_cast<T*>(a.out), a.H, a.Sq, a.Sk, a.D,
      a.scale, a.bsb, a.bsh, a.bsq, a.bsk);
}

template <typename T, typename TB>
void launch_d(const Args& a, cudaStream_t stream) {
  if (a.D <= 32) launch<T, TB, 1>(a, stream);
  else if (a.D <= 64) launch<T, TB, 2>(a, stream);
  else if (a.D <= 128) launch<T, TB, 4>(a, stream);
  else launch<T, TB, 8>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out);
// bias_dtype: -1 = no bias, 0 = float32, 1 = bfloat16.
// Shapes are checked by the Python wrapper (D % 4 == 0, D <= 256).
// Returns cudaGetLastError() after the launch.
extern "C" int deer_flash_attention(const void* q, const void* k, const void* v,
                                    const void* bias, void* out, int B, int H,
                                    int Sq, int Sk, int D, float scale, int dtype,
                                    int bias_dtype, long long bsb, long long bsh,
                                    long long bsq, long long bsk, void* stream) {
  const Args a{q, k, v, bias, out, B, H, Sq, Sk, D, scale, bsb, bsh, bsq, bsk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (bias_dtype == 0) launch_d<__nv_bfloat16, float>(a, st);
    else launch_d<__nv_bfloat16, __nv_bfloat16>(a, st);  // also the no-bias case
  } else {
    if (bias_dtype == 1) launch_d<float, __nv_bfloat16>(a, st);
    else launch_d<float, float>(a, st);
  }
  return (int)cudaGetLastError();
}
