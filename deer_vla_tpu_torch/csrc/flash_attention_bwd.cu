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
// Numerics: for each query row i the forward saved its row max m_i and
// 1 / l_i, l_i = sum_j exp(s_ij - m_i), s_ij = scale * q_i.k_j + bias_ij
// (flash_attention.cu); with delta_i = dOut_i . Out_i,
// p_ij = exp(s_ij - m_i) / l_i (not exp(s_ij - lse_i): at a -1e9 mask bias
// lse_i = m_i + log l_i rounds to m_i in fp32, and a row masked everywhere
// would get p = 1 a key), dp_ij = dOut_i . v_j, ds_ij = p_ij (dp_ij -
// delta_i), and dQ_i = scale * sum_j ds_ij k_j, dK_j = scale * sum_i ds_ij
// q_i, dV_j = sum_i p_ij dOut_i.
//
// bf16 path: two tensor-core kernels, neither with atomics, so a launch is
// bit-reproducible and graph-capturable.  Both are one warpgroup (4 warps x
// 16 rows) a block on 64-row tiles, rows padded by 16 bytes in shared
// memory, tiles filled by cp.async (16 bytes a lane, zero past the end),
// products by mma.sync.m16n8k16 (bf16 in, fp32 accumulate) on fragments from
// ldmatrix, as the forward.
//   attn_bwd_dq, grid (ceil(Sq / 64), H, B): loads the Q and dOut tiles
//   once, computes delta (two lanes a row, from Out and dOut) and writes it
//   to an fp32 scratch for the next kernel, then walks the key tiles
//   through a two-stage cp.async ring of K and V: S = Q K^T and
//   dP = dOut V^T, p from the saved m and 1 / l, dS = p (dP - delta), and
//   dQ += dS K with dS rounded to bf16 from the accumulators into the A
//   operand in registers (as the forward does with P), K by ldmatrix.trans.
//   attn_bwd_dkdv, grid (ceil(Sk / 64), H, B): keeps its K and V tiles in
//   shared memory and streams the query tiles (Q, dOut, the rows' m, 1 / l
//   and delta, the bias tile) through a two-stage ring; per 32 queries it
//   computes S^T = K Q^T and dP^T = V dOut^T, so P^T and dS^T sit in
//   registers as the A operand of dV += P^T dOut and dK += dS^T Q (dOut and
//   Q by ldmatrix.trans).  The bias tile is staged through shared memory
//   (16-byte cp.async where its rows allow it, else element loads), since
//   the transposed layout would read it with a stride of a whole row.
// Seven S x S x D products against the five of a kernel that sums dQ with
// atomics: S and dP are computed in both kernels.  Key columns past Sk get
// p = 0 (the forward's -1e30 fill); query rows past Sq are zero in Q and
// dOut and have m = 1 / l = 0, so they add nothing.  P and dS are rounded to
// bf16 for the products (the plain version keeps them fp32): the gradients
// differ from it by about one bf16 rounding.  Built for D = 64 and 128; the
// wrapper zero-pads other multiples of 16 as the forward's.  q, k, v, out
// and dOut are read through their (batch, head, seq) strides (16-byte
// aligned rows); dQ, dK, dV are written contiguous (B, H, S, D).
//
// Bound on an H100 SXM for the MMC4 decoder call of cli/pretrain (B = 4,
// 16 heads, S = 256, D = 128, bf16): q, k, v, out, dOut and the
// (4, 16, 256, 256) bias read once and dQ, dK, dV written once =
// (8 * 4*16*256*128 + 4*16*256*256) * 2 B = 41.9 MB -> 12.5 us at
// 3.35 TB/s; the five S x S x D products of the backward come to
// 10 * 4*16*256*256*128 = 5.4 GFLOP -> 5.4 us at 989 TFLOP/s, so the bound
// is bytes.  What holds this design back from it (PERF.md has the times):
// mma.sync issues at a fraction of wgmma's rate, and the seven products
// are 7.5 GFLOP at this call; each dK/dV block re-reads every Q and dOut
// tile and each dQ block every K and V tile (from L2); the dK/dV kernel
// with a bias holds up to 141 KB of shared memory, one block of 4 warps an
// SM, so the cp.async ring is all that hides the loads.  wgmma with TMA
// and more warps a block are the next step.
//
// fp32 path (cross-checks only: --unfreeze_vit compares the card with the
// CPU in fp32): the first version, kept as it was.  One warp a query row
// (attn_bwd_rows, on a (ceil(Sq / 4), H, B) grid of 4-warp blocks) holds
// q_i, dOut_i and its dQ accumulator in registers, walks the keys twice
// (the online max and sum, then dQ) and writes m_i, 1 / l_i and delta_i to
// an fp32 scratch; one warp a key row (attn_bwd_cols) holds k_j, v_j and
// the dK, dV accumulators and walks the queries once, reading the scratch.
// Each dot product is a warp reduction by shuffles on the CUDA cores; it
// recomputes the statistics rather than reading the forward's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using deer::bf16;

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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TILE = 64;      // rows of a tile: 4 warps x 16
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_STAGES = 2;  // ring depth
constexpr float LOG2E = 1.4426950408889634f;

struct TcArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* out;
  const bf16* dout;
  const void* bias;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const float* stats;  // (2, B, H, Sq): the forward's m and 1 / l
  float* delta;        // (B, H, Sq): written by attn_bwd_dq
  long long nrows;     // B * H * Sq
  int H, Sq, Sk;
  float scale;
  long long s[15];     // (batch, head, seq) strides of q, k, v, out, dout
  long long bb, bh, bq, bk;
  bool bias_vec;       // bias rows readable by 16-byte copies
};

// TILE rows x D of a (seq, D) matrix with row stride `stride` into a padded
// shared tile; rows at or past `nrows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int nrows, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  constexpr int LDS = D + 8;
#pragma unroll
  for (int it = 0; it < TILE * CPR / TC_THREADS; ++it) {
    const int i = tid + it * TC_THREADS;
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = row0 + r < nrows;
    deer::cp_async16(dst + r * LDS + c,
                     ok ? src + (long long)(row0 + r) * stride + c : src, ok);
  }
}

// the B fragments of two neighbouring 8-column tiles (rows n0..n0+15 of a
// row-major (n, k) tile, k slice kk) and of a row-major (k, n) tile
// (ldmatrix.trans, rows k0..k0+15, columns 16 dd..), the lane's offsets
__device__ __forceinline__ int b_off(int n0, int kk, int lane, int lds) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * lds + kk * 16
         + (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ int bt_off(int k0, int dd, int lane, int lds) {
  return (k0 + (lane & 15)) * lds + dd * 16 + ((lane >> 4) << 3);
}

// the A operand of the next product from two neighbouring C tiles
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = deer::pack_bf16(c0[0], c0[1]);
  a[1] = deer::pack_bf16(c0[2], c0[3]);
  a[2] = deer::pack_bf16(c1[0], c1[1]);
  a[3] = deer::pack_bf16(c1[2], c1[3]);
}

// stage a warp's 16 x D accumulator (times mul) in its own 16 shared rows
// `w`, then write them with 16-byte stores to rows row0.. of a contiguous
// (rows, D) output, those below nrows
template <int D>
__device__ __forceinline__ void store_rows(bf16* w, const float (&acc)[D / 8][4],
                                           float mul, bf16* dst, int row0,
                                           int nrows, int lane) {
  constexpr int LDS = D + 8, ND = D / 8;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    *reinterpret_cast<uint32_t*>(w + g * LDS + i * 8 + 2 * t) =
        deer::pack_bf16(acc[i][0] * mul, acc[i][1] * mul);
    *reinterpret_cast<uint32_t*>(w + (g + 8) * LDS + i * 8 + 2 * t) =
        deer::pack_bf16(acc[i][2] * mul, acc[i][3] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * ND; i += 32) {
    const int r = i / ND, c = (i % ND) * 8;
    if (row0 + r < nrows)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(w + r * LDS + c);
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 + 2 * TC_STAGES) * TILE * (D + 8) * sizeof(bf16);
}

template <int D, typename TB>
constexpr size_t dkdv_smem_bytes(bool bias) {
  return (size_t)(2 + 2 * TC_STAGES) * TILE * (D + 8) * sizeof(bf16)
         + TC_STAGES * 3 * TILE * sizeof(float)
         + (bias ? TC_STAGES * TILE * (TILE + 16 / sizeof(TB)) * sizeof(TB)
                 : 0);
}

// dQ and delta of 64 query rows
template <int D, typename TB>
__global__ void __launch_bounds__(TC_THREADS) attn_bwd_dq(const TcArgs a) {
  constexpr int LDS = D + 8;
  constexpr int KD = D / 16;  // k16 steps over the head dim
  constexpr int ND = D / 8;   // 8-wide output tiles
  static_assert(D == 64 || D == 128, "built for D = 64 and 128 only");
  extern __shared__ uint4 smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + TILE * LDS;
  bf16* ks = dos + TILE * LDS;
  bf16* vs = ks + TC_STAGES * TILE * LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const long long* s = a.s;
  const bf16* qg = a.q + b * s[0] + h * s[1];
  const bf16* kg = a.k + b * s[3] + h * s[4];
  const bf16* vg = a.v + b * s[6] + h * s[7];
  const bf16* og = a.out + b * s[9] + h * s[10];
  const bf16* dog = a.dout + b * s[12] + h * s[13];
  const TB* bias = a.bias ? static_cast<const TB*>(a.bias) + b * a.bb + h * a.bh
                          : nullptr;
  const long long row0 = ((long long)b * a.H + h) * a.Sq;

  load_tile<D>(qs, qg, s[2], q0, a.Sq, tid);
  load_tile<D>(dos, dog, s[14], q0, a.Sq, tid);
  load_tile<D>(ks, kg, s[5], 0, a.Sk, tid);
  load_tile<D>(vs, vg, s[8], 0, a.Sk, tid);
  deer::cp_async_commit();

  // delta of the warp's 16 rows, two lanes a row, while the tiles land
  float dl = 0.f;
  {
    const int r = q0 + warp * 16 + (lane >> 1);
    if (r < a.Sq) {
      const bf16* orow = og + r * s[11] + (lane & 1) * (D / 2);
      const bf16* drow = dog + r * s[14] + (lane & 1) * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          dl = fmaf(of.x, df.x, dl);
          dl = fmaf(of.y, df.y, dl);
        }
      }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if ((lane & 1) == 0 && r < a.Sq) a.delta[row0 + r] = dl;
  }
  // the mma layout's rows g and g + 8 were summed by lanes 2g and 2g + 16
  const float dl0 = __shfl_sync(0xffffffffu, dl, 2 * g);
  const float dl1 = __shfl_sync(0xffffffffu, dl, 2 * g + 16);
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  // rows past Sq: m = 1 / l = 0, so p = 0
  const float m0 = ra < a.Sq ? a.stats[row0 + ra] : 0.f;
  const float il0 = ra < a.Sq ? a.stats[a.nrows + row0 + ra] : 0.f;
  const float m1 = rb < a.Sq ? a.stats[row0 + rb] : 0.f;
  const float il1 = rb < a.Sq ? a.stats[a.nrows + row0 + rb] : 0.f;

  float dq[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  const int alane = (warp * 16 + (lane & 15)) * LDS + ((lane >> 4) << 3);
  const int ntiles = (a.Sk + TILE - 1) / TILE;

  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // every warp is done with the stage the next load fills
    if (j + 1 < ntiles) {
      const int st = (j + 1) % TC_STAGES;
      load_tile<D>(ks + st * TILE * LDS, kg, s[5], (j + 1) * TILE, a.Sk, tid);
      load_tile<D>(vs + st * TILE * LDS, vg, s[8], (j + 1) * TILE, a.Sk, tid);
    }
    deer::cp_async_commit();
    deer::cp_async_wait<1>();  // tile j (and, at j = 0, Q and dOut) landed
    __syncthreads();
    const bf16* kt = ks + (j % TC_STAGES) * TILE * LDS;
    const bf16* vt = vs + (j % TC_STAGES) * TILE * LDS;

    // S = Q K^T and dP = dOut V^T, 16 x 64 a warp
    float sp[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      deer::ldmatrix_x4(qa, qs + alane + kk * 16);
      deer::ldmatrix_x4(da, dos + alane + kk * 16);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int off = b_off(jp * 16, kk, lane, LDS);
        uint32_t bfr[4];
        deer::ldmatrix_x4(bfr, kt + off);
        deer::mma_bf16(sp[2 * jp], qa, bfr[0], bfr[1]);
        deer::mma_bf16(sp[2 * jp + 1], qa, bfr[2], bfr[3]);
        deer::ldmatrix_x4(bfr, vt + off);
        deer::mma_bf16(dp[2 * jp], da, bfr[0], bfr[1]);
        deer::mma_bf16(dp[2 * jp + 1], da, bfr[2], bfr[3]);
      }
    }

    // p from the forward's m and 1 / l (0 past Sk); dS = p (dP - delta)
    const int kbase = j * TILE;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kbase + jn * 8 + 2 * t + (e & 1);
        const bool lo = e < 2;
        const int row = lo ? ra : rb;
        float p = 0.f;
        if (col < a.Sk) {
          float x = sp[jn][e] * a.scale;
          if (bias != nullptr && row < a.Sq)
            x += to_f(bias[row * a.bq + col * a.bk]);
          p = exp2f((x - (lo ? m0 : m1)) * LOG2E) * (lo ? il0 : il1);
        }
        dp[jn][e] = p * (dp[jn][e] - (lo ? dl0 : dl1));
      }
    }

    // dQ += dS K, dS rounded to bf16 straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t sa[4];
      c_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t kf[4];
        deer::ldmatrix_x4_trans(kf, kt + bt_off(kk * 16, dd, lane, LDS));
        deer::mma_bf16(dq[2 * dd], sa, kf[0], kf[1]);
        deer::mma_bf16(dq[2 * dd + 1], sa, kf[2], kf[3]);
      }
    }
  }

  deer::cp_async_wait<0>();
  // only this warp read its Q rows: stage its dQ there
  store_rows<D>(qs + warp * 16 * LDS, dq, a.scale, a.dq + row0 * D,
                q0 + warp * 16, a.Sq, lane);
}

// dK and dV of 64 key rows
template <int D, typename TB>
__global__ void __launch_bounds__(TC_THREADS) attn_bwd_dkdv(const TcArgs a) {
  constexpr int LDS = D + 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int EPC = 16 / sizeof(TB);  // bias elements a 16-byte chunk
  constexpr int LDB = TILE + EPC;       // bias tile row stride
  // queries a step: 16 at D = 128 keeps S^T and dP^T small beside the
  // 128 fp32 of the dK and dV accumulators
  constexpr int QN = D == 128 ? 16 : 32;
  static_assert(D == 64 || D == 128, "built for D = 64 and 128 only");
  extern __shared__ uint4 smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + TILE * LDS;
  bf16* qs = vs + TILE * LDS;                     // TC_STAGES tiles
  bf16* dos = qs + TC_STAGES * TILE * LDS;        // TC_STAGES tiles
  float* rs = reinterpret_cast<float*>(dos + TC_STAGES * TILE * LDS);
  TB* bs = reinterpret_cast<TB*>(rs + TC_STAGES * 3 * TILE);  // with a bias

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const long long* s = a.s;
  const bf16* qg = a.q + b * s[0] + h * s[1];
  const bf16* kg = a.k + b * s[3] + h * s[4];
  const bf16* vg = a.v + b * s[6] + h * s[7];
  const bf16* dog = a.dout + b * s[12] + h * s[13];
  const TB* bias = a.bias ? static_cast<const TB*>(a.bias) + b * a.bb + h * a.bh
                          : nullptr;
  const long long row0 = ((long long)b * a.H + h) * a.Sq;

  // query tile i into stage st: Q, dOut, the rows' m, 1 / l and delta, and
  // the bias tile (rows: queries, columns: this block's keys)
  auto load_stage = [&](int i, int st) {
    const int i0 = i * TILE;
    load_tile<D>(qs + st * TILE * LDS, qg, s[2], i0, a.Sq, tid);
    load_tile<D>(dos + st * TILE * LDS, dog, s[14], i0, a.Sq, tid);
    float* rw = rs + st * 3 * TILE;
    for (int e = tid; e < 3 * TILE; e += TC_THREADS) {
      const int which = e / TILE, rr = e % TILE;
      const bool ok = i0 + rr < a.Sq;
      const float* src = which == 2 ? a.delta + row0
                                    : a.stats + which * a.nrows + row0;
      deer::cp_async4(rw + e, ok ? src + i0 + rr : src, ok);
    }
    if (bias == nullptr) return;
    TB* bt = bs + st * TILE * LDB;
    if (a.bias_vec) {
      for (int e = tid; e < TILE * (TILE / EPC); e += TC_THREADS) {
        const int r = e / (TILE / EPC), c = (e % (TILE / EPC)) * EPC;
        const bool ok = i0 + r < a.Sq && k0 + c < a.Sk;
        deer::cp_async16(bt + r * LDB + c,
                         ok ? bias + (long long)(i0 + r) * a.bq + k0 + c : bias,
                         ok);
      }
    } else {  // broadcast or unaligned rows: element loads
      for (int e = tid; e < TILE * TILE; e += TC_THREADS) {
        const int r = e / TILE, c = e % TILE;
        const bool ok = i0 + r < a.Sq && k0 + c < a.Sk;
        bt[r * LDB + c] = ok ? bias[(long long)(i0 + r) * a.bq
                                    + (long long)(k0 + c) * a.bk]
                             : from_f<TB>(0.f);
      }
    }
  };

  load_tile<D>(ks, kg, s[5], k0, a.Sk, tid);
  load_tile<D>(vs, vg, s[8], k0, a.Sk, tid);
  load_stage(0, 0);
  deer::cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const int kr0 = warp * 16 + g, kr1 = kr0 + 8;  // the lane's key rows
  const bool kok0 = k0 + kr0 < a.Sk, kok1 = k0 + kr1 < a.Sk;
  const int alane = (warp * 16 + (lane & 15)) * LDS + ((lane >> 4) << 3);
  const int ntiles = (a.Sq + TILE - 1) / TILE;

  for (int i = 0; i < ntiles; ++i) {
    __syncthreads();  // every warp is done with the stage the next load fills
    if (i + 1 < ntiles) load_stage(i + 1, (i + 1) % TC_STAGES);
    deer::cp_async_commit();
    deer::cp_async_wait<1>();  // tile i (and, at i = 0, K and V) landed
    __syncthreads();
    const int st = i % TC_STAGES;
    const bf16* qt = qs + st * TILE * LDS;
    const bf16* dot = dos + st * TILE * LDS;
    const float* r = rs + st * 3 * TILE;
    const TB* bt = bs + st * TILE * LDB;

#pragma unroll 1
    for (int n0 = 0; n0 < TILE; n0 += QN) {
      // S^T = K Q^T and dP^T = V dOut^T, 16 keys x QN queries a warp
      float sp[QN / 8][4], dp[QN / 8][4];
#pragma unroll
      for (int n = 0; n < QN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        deer::ldmatrix_x4(ka, ks + alane + kk * 16);
        deer::ldmatrix_x4(va, vs + alane + kk * 16);
#pragma unroll
        for (int jp = 0; jp < QN / 16; ++jp) {
          const int off = b_off(n0 + jp * 16, kk, lane, LDS);
          uint32_t bfr[4];
          deer::ldmatrix_x4(bfr, qt + off);
          deer::mma_bf16(sp[2 * jp], ka, bfr[0], bfr[1]);
          deer::mma_bf16(sp[2 * jp + 1], ka, bfr[2], bfr[3]);
          deer::ldmatrix_x4(bfr, dot + off);
          deer::mma_bf16(dp[2 * jp], va, bfr[0], bfr[1]);
          deer::mma_bf16(dp[2 * jp + 1], va, bfr[2], bfr[3]);
        }
      }

      // P^T from the forward's m and 1 / l (0 for keys past Sk; queries
      // past Sq have 1 / l = 0); dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int jn = 0; jn < QN / 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n0 + jn * 8 + 2 * t + (e & 1);  // query in the tile
          float p = 0.f;
          if (e < 2 ? kok0 : kok1) {
            float x = sp[jn][e] * a.scale;
            if (bias != nullptr) x += to_f(bt[c * LDB + (e < 2 ? kr0 : kr1)]);
            p = exp2f((x - r[c]) * LOG2E) * r[TILE + c];
          }
          sp[jn][e] = p;
          dp[jn][e] = p * (dp[jn][e] - r[2 * TILE + c]);
        }
      }

      // dV += P^T dOut and dK += dS^T Q, P^T and dS^T from the accumulators
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk) {
        uint32_t pa[4], sa[4];
        c_to_a(pa, sp[2 * kk], sp[2 * kk + 1]);
        c_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          const int off = bt_off(n0 + kk * 16, dd, lane, LDS);
          uint32_t f[4];
          deer::ldmatrix_x4_trans(f, dot + off);
          deer::mma_bf16(dv[2 * dd], pa, f[0], f[1]);
          deer::mma_bf16(dv[2 * dd + 1], pa, f[2], f[3]);
          deer::ldmatrix_x4_trans(f, qt + off);
          deer::mma_bf16(dk[2 * dd], sa, f[0], f[1]);
          deer::mma_bf16(dk[2 * dd + 1], sa, f[2], f[3]);
        }
      }
    }
  }

  deer::cp_async_wait<0>();
  // only this warp read its K and V rows: stage dK and dV there
  const long long krow0 = ((long long)b * a.H + h) * a.Sk;
  store_rows<D>(ks + warp * 16 * LDS, dk, a.scale, a.dk + krow0 * D,
                k0 + warp * 16, a.Sk, lane);
  store_rows<D>(vs + warp * 16 * LDS, dv, 1.f, a.dv + krow0 * D,
                k0 + warp * 16, a.Sk, lane);
}

template <int D, typename TB>
int launch_tc(const TcArgs& a, int B, cudaStream_t stream) {
  auto dq_kern = attn_bwd_dq<D, TB>;
  auto dkdv_kern = attn_bwd_dkdv<D, TB>;
  static bool smem_set = false;  // once per instantiation, at the most
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dq_smem_bytes<D>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          dkdv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)dkdv_smem_bytes<D, TB>(true));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dq_kern<<<dim3((a.Sq + TILE - 1) / TILE, a.H, B), TC_THREADS,
            dq_smem_bytes<D>(), stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv_kern<<<dim3((a.Sk + TILE - 1) / TILE, a.H, B), TC_THREADS,
              dkdv_smem_bytes<D, TB>(a.bias != nullptr), stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TB>
int launch_tc_d(const TcArgs& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 64: return launch_tc<64, TB>(a, B, st);
    case 128: return launch_tc<128, TB>(a, B, st);
    default: return (int)cudaErrorInvalidValue;  // the wrapper pads D
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores (the first version)
// ---------------------------------------------------------------------------

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
// dq, dk, dv contiguous (B, H, S, D).  bf16: D in {64, 128}, rows 16-byte
// aligned, stats the forward's fp32 (2, B, H, Sq) m and 1 / l, scratch an
// fp32 (B, H, Sq) buffer for delta.  fp32: D <= 256, stats not read (the
// pair recomputes them), scratch an fp32 (3, B, H, Sq) buffer.  The Python
// wrapper checks all of it.  Returns the first CUDA error of the two
// launches, 0 if none.
extern "C" int deer_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* bias, void* dq, void* dk, void* dv,
    const void* stats, void* scratch, int B, int H, int Sq, int Sk, int D,
    float scale, int dtype, int bias_dtype, long long bsb, long long bsh,
    long long bsq, long long bsk, const long long* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (stats == nullptr) return (int)cudaErrorInvalidValue;
    TcArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v), static_cast<const bf16*>(out),
             static_cast<const bf16*>(dout), bias, static_cast<bf16*>(dq),
             static_cast<bf16*>(dk), static_cast<bf16*>(dv),
             static_cast<const float*>(stats), static_cast<float*>(scratch),
             (long long)B * H * Sq, H, Sq, Sk, scale, {}, bsb, bsh, bsq, bsk,
             false};
    for (int t = 0; t < 15; ++t) a.s[t] = strides[t];
    const int epc = bias_dtype == 0 ? 4 : 8;  // elements in 16 bytes
    a.bias_vec = bias != nullptr && bsk == 1
                 && reinterpret_cast<uintptr_t>(bias) % 16 == 0
                 && bsb % epc == 0 && bsh % epc == 0 && bsq % epc == 0
                 && Sk % epc == 0;
    if (bias_dtype == 0) return launch_tc_d<float>(a, B, D, st);
    return launch_tc_d<bf16>(a, B, D, st);  // also the no-bias case
  }
  Args a{q, k, v, out, dout, bias, dq, dk, dv, static_cast<float*>(scratch),
         (long long)B * H * Sq, H, Sq, Sk, D, scale, {}, bsb, bsh, bsq, bsk};
  for (int t = 0; t < 15; ++t) a.s[t] = strides[t];
  if (bias_dtype == 1) return launch_d<float, bf16>(a, B, st);
  return launch_d<float, float>(a, B, st);
}
