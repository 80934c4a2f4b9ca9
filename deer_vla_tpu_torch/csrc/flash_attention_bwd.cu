// The gradient of fused attention (kernel K1) for Hopper: given
// out = softmax(scale * Q K^T + bias) V and dOut, the kernels write dQ, dK
// and dV (the bias takes no gradient: no model trains one).
//
// The TPU kernel deer_vla_tpu/ops/pallas/flash_attention.py
// (flash_attention -> _run -> _kernel) has no backward (no custom_vjp), so
// this replaces none; the port needs it because the decoder's self- and
// cross-attention take K1 from 128 query rows (ops/attention.KERNEL_MIN_SQ)
// and train through it when the text is that long (cli/pretrain's MMC4
// --max_tokens 256), and --unfreeze_vit trains the ViT through it.
//
// Numerics: everything in fp32 from the inputs' values.  The forward saves
// no softmax statistics, so they are recomputed: for each query row i, the
// row max m_i and sum l_i = sum_j exp(s_ij - m_i), s_ij = scale * q_i.k_j +
// bias_ij, and delta_i = dOut_i . Out_i; then p_ij = exp(s_ij - m_i) / l_i
// (not exp(s_ij - lse_i): at a -1e9 mask bias lse_i = m_i + log l_i rounds
// to m_i in fp32, and a row masked everywhere would get p = 1 a key),
// dp_ij = dOut_i . v_j, ds_ij = p_ij (dp_ij - delta_i), and
// dQ_i = scale * sum_j ds_ij k_j, dK_j = scale * sum_i ds_ij q_i,
// dV_j = sum_i p_ij dOut_i.  p is kept in fp32 (the forward rounds it to
// V's dtype before P.V): the gradients differ from autograd through the
// plain version by about one bf16 rounding.
//
// Two kernels, neither with atomics.  rows: one warp a query row, on a
// (ceil(Sq / 4), H, B) grid of 4-warp blocks; the warp holds q_i, dOut_i
// and its dQ accumulator in registers (lane l owns elements l, l + 32, ...),
// walks the keys twice (the online max and sum, then dQ), and writes m_i,
// 1 / l_i and delta_i to an fp32 scratch.  cols: one warp a key row, on a
// (ceil(Sk / 4), H, B) grid; it holds k_j, v_j and the dK, dV accumulators
// and walks the queries once, reading the scratch.  Each dot product is a
// warp reduction by shuffles.  q, k, v, out and dOut are read through their
// (batch, head, seq) strides, the last dim of unit stride; dQ, dK, dV are
// written contiguous (B, H, S, D).
//
// Bound on an H100 SXM for the MMC4 decoder call of cli/pretrain (B = 4,
// 16 heads, S = 256, D = 128, bf16): q, k, v, out, dOut and the
// (4, 16, 256, 256) bias read once and dQ, dK, dV written once =
// (8 * 4*16*256*128 + 4*16*256*256) * 2 B = 41.9 MB -> 12.5 us at
// 3.35 TB/s; the five S x S x D products of the backward come to
// 10 * 4*16*256*256*128 = 5.4 GFLOP -> 5.4 us at 989 TFLOP/s, so the bound
// is bytes.  This first version runs on the CUDA cores (fp32 FMAs and
// shuffles), re-reads every key row once for each query row (and each query
// row once for each key row) from L2, and recomputes s three times; it is
// right and simple first, and far from that bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

constexpr int WARPS = 4;  // rows (or keys) a block, one warp each

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const void* bias;
  void* dq;
  void* dk;
  void* dv;
  float* stats;     // (3, B, H, Sq): row max, 1 / row sum, delta
  long long nrows;  // B * H * Sq
  int H, Sq, Sk, D;
  float scale;
  long long s[15];  // (batch, head, seq) strides of q, k, v, out, dout
  long long bsb, bsh, bsq, bsk;
};

template <typename T, int DPL>
__device__ __forceinline__ void load_row(const T* row, int D, int lane,
                                         float (&r)[DPL]) {
#pragma unroll
  for (int c = 0; c < DPL; ++c) {
    const int d = lane + 32 * c;
    r[c] = d < D ? to_f(row[d]) : 0.f;
  }
}

template <typename T, int DPL>
__device__ __forceinline__ void store_row(T* row, int D, int lane,
                                          const float (&r)[DPL], float mul) {
#pragma unroll
  for (int c = 0; c < DPL; ++c) {
    const int d = lane + 32 * c;
    if (d < D) row[d] = from_f<T>(r[c] * mul);
  }
}

template <typename T, int DPL>
__device__ __forceinline__ float dot_part(const float (&a)[DPL], const T* row,
                                          int D, int lane) {
  float p = 0.f;
#pragma unroll
  for (int c = 0; c < DPL; ++c) {
    const int d = lane + 32 * c;
    if (d < D) p += a[c] * to_f(row[d]);
  }
  return p;
}

// one warp a query row: its softmax statistics, delta and dQ
template <typename T, typename TB, int DPL>
__global__ void __launch_bounds__(WARPS * 32) attn_bwd_rows(const Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (i >= a.Sq) return;  // the whole warp
  const long long* s = a.s;
  const T* q = static_cast<const T*>(a.q) + b * s[0] + h * s[1] + i * s[2];
  const T* kb = static_cast<const T*>(a.k) + b * s[3] + h * s[4];
  const T* vb = static_cast<const T*>(a.v) + b * s[6] + h * s[7];
  const T* o = static_cast<const T*>(a.out) + b * s[9] + h * s[10] + i * s[11];
  const T* dob = static_cast<const T*>(a.dout) + b * s[12] + h * s[13] + i * s[14];
  const TB* bias = a.bias == nullptr ? nullptr
      : static_cast<const TB*>(a.bias) + b * a.bsb + h * a.bsh + i * a.bsq;
  float qr[DPL], dor[DPL], orow[DPL], acc[DPL];
  load_row<T, DPL>(q, a.D, lane, qr);
  load_row<T, DPL>(dob, a.D, lane, dor);
  load_row<T, DPL>(o, a.D, lane, orow);
  float delta = 0.f;
#pragma unroll
  for (int c = 0; c < DPL; ++c) {
    delta += dor[c] * orow[c];
    acc[c] = 0.f;
  }
  delta = warp_sum(delta);
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < a.Sk; ++j) {
    float sij = warp_sum(dot_part<T, DPL>(qr, kb + j * s[5], a.D, lane)) * a.scale;
    if (bias != nullptr) sij += to_f(bias[j * a.bsk]);
    const float mn = fmaxf(m, sij);
    if (mn == -INFINITY) continue;  // every key so far at a -inf bias
    l = l * expf(m - mn) + expf(sij - mn);
    m = mn;
  }
  const float inv_l = 1.f / l;
  for (int j = 0; j < a.Sk; ++j) {
    const T* kr = kb + j * s[5];
    float sij = warp_sum(dot_part<T, DPL>(qr, kr, a.D, lane)) * a.scale;
    if (bias != nullptr) sij += to_f(bias[j * a.bsk]);
    const float dp = warp_sum(dot_part<T, DPL>(dor, vb + j * s[8], a.D, lane));
    const float ds = expf(sij - m) * inv_l * (dp - delta);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < a.D) acc[c] += ds * to_f(kr[d]);
    }
  }
  const long long row = ((long long)b * a.H + h) * a.Sq + i;
  store_row<T, DPL>(static_cast<T*>(a.dq) + row * a.D, a.D, lane, acc, a.scale);
  if (lane == 0) {
    a.stats[row] = m;
    a.stats[a.nrows + row] = inv_l;
    a.stats[2 * a.nrows + row] = delta;
  }
}

// one warp a key row: dK and dV
template <typename T, typename TB, int DPL>
__global__ void __launch_bounds__(WARPS * 32) attn_bwd_cols(const Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (j >= a.Sk) return;
  const long long* s = a.s;
  const T* qb = static_cast<const T*>(a.q) + b * s[0] + h * s[1];
  const T* k = static_cast<const T*>(a.k) + b * s[3] + h * s[4] + j * s[5];
  const T* v = static_cast<const T*>(a.v) + b * s[6] + h * s[7] + j * s[8];
  const T* dob = static_cast<const T*>(a.dout) + b * s[12] + h * s[13];
  const TB* bias = a.bias == nullptr ? nullptr
      : static_cast<const TB*>(a.bias) + b * a.bsb + h * a.bsh + j * a.bsk;
  const long long row0 = ((long long)b * a.H + h) * a.Sq;
  float kr[DPL], vr[DPL], dk[DPL], dv[DPL];
  load_row<T, DPL>(k, a.D, lane, kr);
  load_row<T, DPL>(v, a.D, lane, vr);
#pragma unroll
  for (int c = 0; c < DPL; ++c) dk[c] = dv[c] = 0.f;
  for (int i = 0; i < a.Sq; ++i) {
    float qi[DPL], doi[DPL];
    load_row<T, DPL>(qb + i * s[2], a.D, lane, qi);
    load_row<T, DPL>(dob + i * s[14], a.D, lane, doi);
    float ps = 0.f, pd = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      ps += qi[c] * kr[c];
      pd += doi[c] * vr[c];
    }
    float sij = warp_sum(ps) * a.scale;
    if (bias != nullptr) sij += to_f(bias[i * a.bsq]);
    const float dp = warp_sum(pd);
    const float* st = a.stats + row0 + i;
    const float p = expf(sij - st[0]) * st[a.nrows];
    const float ds = p * (dp - st[2 * a.nrows]);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      dv[c] += p * doi[c];
      dk[c] += ds * qi[c];
    }
  }
  const long long row = ((long long)b * a.H + h) * a.Sk + j;
  store_row<T, DPL>(static_cast<T*>(a.dk) + row * a.D, a.D, lane, dk, a.scale);
  store_row<T, DPL>(static_cast<T*>(a.dv) + row * a.D, a.D, lane, dv, 1.f);
}

template <typename T, typename TB, int DPL>
int launch(const Args& a, int B, cudaStream_t st) {
  const dim3 block(WARPS * 32);
  attn_bwd_rows<T, TB, DPL><<<dim3((a.Sq + WARPS - 1) / WARPS, a.H, B), block, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_bwd_cols<T, TB, DPL><<<dim3((a.Sk + WARPS - 1) / WARPS, a.H, B), block, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename TB>
int launch_d(const Args& a, int B, cudaStream_t st) {
  if (a.D <= 32) return launch<T, TB, 1>(a, B, st);
  if (a.D <= 64) return launch<T, TB, 2>(a, B, st);
  if (a.D <= 128) return launch<T, TB, 4>(a, B, st);
  return launch<T, TB, 8>(a, B, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv);
// bias_dtype: -1 = no bias, 0 = float32, 1 = bfloat16; bias strides in
// elements (0 on a broadcast dim).  strides: 15 element strides, (batch,
// head, seq) of q, k, v, out and dout, each with a unit-stride last dim;
// dq, dk, dv contiguous (B, H, S, D); stats fp32 scratch of 3 * B * H * Sq.  D <= 256.  The Python wrapper checks all of it.
// Returns the first CUDA error of the two launches, 0 if none.
extern "C" int deer_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* bias, void* dq, void* dk, void* dv,
    void* stats, int B, int H, int Sq, int Sk, int D, float scale,
    int dtype, int bias_dtype, long long bsb, long long bsh, long long bsq,
    long long bsk, const long long* strides, void* stream) {
  Args a{q, k, v, out, dout, bias, dq, dk, dv, static_cast<float*>(stats),
         (long long)B * H * Sq, H, Sq, Sk, D, scale, {}, bsb, bsh, bsq, bsk};
  for (int t = 0; t < 15; ++t) a.s[t] = strides[t];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (bias_dtype == 0) return launch_d<bf16, float>(a, B, st);
    return launch_d<bf16, bf16>(a, B, st);  // also the no-bias case
  }
  if (bias_dtype == 1) return launch_d<float, bf16>(a, B, st);
  return launch_d<float, float>(a, B, st);
}
