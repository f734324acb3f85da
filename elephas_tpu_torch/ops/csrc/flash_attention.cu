// Flash attention for training on Hopper (sm_90a): forward, dq and dkv,
// plain C interface for ctypes.
//
// Replaces: elephas_tpu/ops/pallas_flash.py `_flash_fwd_tpu` (the Pallas
// `_fwd_kernel`) and `_flash_bwd_tpu` (`_dq_kernel`, `_dkv_kernel`): the
// FlashAttention-2 forward, which saves only lse = m + log l, and its
// backward, which recomputes p = exp(s - lse) tile by tile. Layouts are the
// model's: q, o, dO, dq [B, T, H, Dh]; k, v, dk, dv [B, T, Hkv, Dh] (query
// head h reads KV head h / G, G = H / Hkv, never repeated); lse and
// delta [B, H, T] float32, delta = sum_d dO*O minus the lse cotangent,
// formed in torch before the launch. Inputs and outputs are float32 or
// bfloat16; every product and sum is float32 (float32 is never rounded to
// TF32: the reference pins Precision.HIGHEST).
//
// Bound on an H100: operations. Each visible (query, key) pair costs
// 4*Dh operations forward (q.k and p.v), 6*Dh for dq (q.k, dO.v, ds.k) and
// 8*Dh for dkv (q.k, dO.v, p.dO, ds.q), against 8 or so bytes of traffic
// per row: at GPT-2 training shape (B 8, H 12, T 1024, Dh 64, causal) the
// forward is 12.9 GFLOP, 0.19 ms at 67 TFLOP/s float32, against 0.03 ms
// for its bytes.
//
// Design: the TPU walks the KV axis (Q axis for dkv) as a sequential grid
// axis and carries the online softmax in VMEM; a GPU grid has no order, so
// each block owns one output tile and loops over the tiles it needs inside
// the block. Forward and dq: one block per (Q tile, b, h), looping over the
// KV tiles the causal bound and the window leave visible (`_kv_clamp`).
// dkv: one block per (KV tile, b, kv head), looping over the visible Q
// tiles (`_q_clamp`) AND over the G query heads of its group, so dk and dv
// are summed in a fixed order in registers and written once (the TPU writes
// per-query-head partials and sums them outside). 256 threads as a 16 x 16
// grid; each thread owns a (BQ/16) x (BK/16) block of the score tile and a
// (rows/16) x (DH/16) block of the output tile, with rows and columns
// strided by 16 so a warp reads shared memory without bank conflicts (the
// row-major tiles are padded by one float). Tiles are 64 x 64 up to Dh 128
// and 32 x 32 at Dh 256, which keeps every kernel under 170 KB of shared
// memory. Keys past T and padded query rows are masked by index (-inf
// scores, p = 0), so a ragged T needs no padding in device memory and a
// padded query row adds nothing to dk or dv. Simple first: SIMT float32
// products, no tensor cores, no TMA, no pipelining.
//
// Rope on load (the `ROPE` template flag; replaces the same three Pallas
// kernels with their static `rope=True`, `_rot` at pallas_flash.py:111):
// q and k arrive UNROTATED with the duplicated half-split tables c2 = [cos|cos]
// and s2 = [-sin|sin], [B, T, Dh] float32. Each q and k tile is rotated in
// shared memory right after its load, x*C2 + roll_half(x)*S2 in float32,
// and rounded to the input type as the reference's `_rot` rounds it. The
// rotation pairs dim d with dim d + Dh/2, which the register layout above
// spreads over two threads, so it runs as its own pass over the tile after
// a barrier: one thread per (row, d < Dh/2) pair reads both elements and
// writes both. (A pass in shared memory is also what a tile landed by
// cp.async or TMA needs.) The table values are read from global memory in
// that pass (the 4 MB tables at the Llama-3-8B training shape stay in L2):
// staging them beside the tiles would add up to 130 KB of shared memory.
// dq and dk are the
// gradients of the ROTATED q and k until the store, where the accumulator
// goes through shared memory (the q or k tile, no longer read) and is
// derotated with the sign of S2 flipped, the inverse rotation. Rows past
// T are never rotated and read no table. The rotated q and k never exist
// in device memory. Shared memory per block is the same with or without
// rope (KiB, fwd / dq / dkv): 65.75 / 81.75 / 98.0 at Dh 64 and 113.75 /
// 145.75 / 162.0 at Dh 128 (64 x 64 tiles), 100.875 / 132.875 / 137.0 at
// Dh 256 (32 x 32 tiles).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Dims {
  int B, T, H, Hkv, Dh, causal, window;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename E>
__device__ __forceinline__ E from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename E>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<E>(x)); }

__device__ __forceinline__ bool visible(int qi, int kj, const Dims& D) {
  if (qi >= D.T || kj >= D.T) return false;
  if (!D.causal) return true;
  return kj <= qi && (D.window <= 0 || kj > qi - D.window);
}

// rows [t0, t0 + R) of head `head` of a [B, T, heads, Dh] tensor into a
// float32 tile [R][LD], zero past T and past Dh
template <typename E, int R, int DH, int LD>
__device__ __forceinline__ void load_tile(const E* src, int b, int t0, int head, int heads,
                                          const Dims& D, float* dst) {
  for (int idx = threadIdx.x; idx < R * DH; idx += kThreads) {
    const int r = idx / DH, d = idx - r * DH, t = t0 + r;
    float val = 0.f;
    if (t < D.T && d < D.Dh)
      val = to_f32(src[((static_cast<size_t>(b) * D.T + t) * heads + head) * D.Dh + d]);
    dst[r * LD + d] = val;
  }
}

// a [R] float32 row of a [B, H, T] statistic, zero past T
template <int R>
__device__ __forceinline__ void load_stat(const float* src, int b, int h, int t0,
                                          const Dims& D, float* dst) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int t = t0 + r;
    dst[r] = t < D.T ? src[(static_cast<size_t>(b) * D.H + h) * D.T + t] : 0.f;
  }
}

// Rotate rows [t0, t0 + R) of a float32 tile in place by the tables c2/s2
// [B, T, Dh]: x*C2 + roll_half(x)*S2 in float32, rounded to E (the
// reference's `_rot`). Products and sums are rounded one by one, as the
// plain version's separate tensor operations round them. One thread per
// (row, d < Dh/2) pair; rows past T are left as loaded (zero).
template <typename E, int R, int LD>
__device__ __forceinline__ void rotate_tile(float* tile, const float* __restrict__ c2,
                                            const float* __restrict__ s2, int b, int t0,
                                            const Dims& D) {
  const int half = D.Dh >> 1;
  for (int idx = threadIdx.x; idx < R * half; idx += kThreads) {
    const int r = idx / half, d = idx - r * half, t = t0 + r;
    if (t >= D.T) continue;
    const size_t row = (static_cast<size_t>(b) * D.T + t) * D.Dh;
    const float x1 = tile[r * LD + d], x2 = tile[r * LD + d + half];
    tile[r * LD + d] =
        round_to<E>(__fadd_rn(__fmul_rn(x1, c2[row + d]), __fmul_rn(x2, s2[row + d])));
    tile[r * LD + d + half] = round_to<E>(
        __fadd_rn(__fmul_rn(x2, c2[row + d + half]), __fmul_rn(x1, s2[row + d + half])));
  }
}

// q or k into a float32 tile, then (under rope) rotated in place: the
// barrier between is the load's, the caller's next barrier ends the pass
template <typename E, int R, int DH, int LD, bool ROPE>
__device__ __forceinline__ void load_qk(const E* src, const float* __restrict__ c2,
                                        const float* __restrict__ s2, int b, int t0, int head,
                                        int heads, const Dims& D, float* dst) {
  load_tile<E, R, DH, LD>(src, b, t0, head, heads, D, dst);
  if (ROPE) {
    __syncthreads();
    rotate_tile<E, R, LD>(dst, c2, s2, b, t0, D);
  }
}

// Derotate a float32 gradient tile (rows [t0, t0 + R) of head `head`) with
// the inverse rotation, x*C2 - roll_half(x)*S2, and store it as E into a
// [B, T, heads, Dh] tensor; rows past T are not stored.
template <typename E, int R, int LD>
__device__ __forceinline__ void derotate_store(const float* tile, const float* __restrict__ c2,
                                               const float* __restrict__ s2, int b, int t0,
                                               int head, int heads, const Dims& D, E* dst) {
  const int half = D.Dh >> 1;
  for (int idx = threadIdx.x; idx < R * half; idx += kThreads) {
    const int r = idx / half, d = idx - r * half, t = t0 + r;
    if (t >= D.T) continue;
    const size_t row = (static_cast<size_t>(b) * D.T + t) * D.Dh;
    const float x1 = tile[r * LD + d], x2 = tile[r * LD + d + half];
    E* out = dst + ((static_cast<size_t>(b) * D.T + t) * heads + head) * D.Dh;
    out[d] = from_f32<E>(__fadd_rn(__fmul_rn(x1, c2[row + d]), __fmul_rn(x2, -s2[row + d])));
    out[d + half] = from_f32<E>(
        __fadd_rn(__fmul_rn(x2, c2[row + d + half]), __fmul_rn(x1, -s2[row + d + half])));
  }
}

template <int DH, int BQ, int BK>
struct Tiles {
  static constexpr int LD = DH + 1;  // padded row of a [rows][DH] tile
  static constexpr int LDS = BK + 1; // padded row of a [BQ][BK] tile
  static constexpr int RQ = BQ / 16, RK = BK / 16, RD = DH / 16;
  static constexpr size_t fwd_smem =
      sizeof(float) * (BQ * LD + 2 * BK * LD + BQ * LDS + 3 * BQ);
  static constexpr size_t dq_smem =
      sizeof(float) * (2 * BQ * LD + 2 * BK * LD + BQ * LDS + 2 * BQ);
  static constexpr size_t dkv_smem =
      sizeof(float) * (2 * BQ * LD + 2 * BK * LD + 2 * BQ * LDS + 2 * BQ);
};

// ---- forward: one block per (Q tile, b * H + h) ------------------------------

template <typename E, int DH, int BQ, int BK, bool ROPE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                 const float* __restrict__ c2, const float* __restrict__ s2,
                 E* __restrict__ o, float* __restrict__ lse, Dims D) {
  using Tl = Tiles<DH, BQ, BK>;
  constexpr int LD = Tl::LD, LDS = Tl::LDS, RQ = Tl::RQ, RK = Tl::RK, RD = Tl::RD;
  constexpr int TPR = kThreads / BQ;  // threads per score row in the softmax
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;
  float* sM = sS + BQ * LDS;
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / D.H, h = blockIdx.y - b * D.H;
  const int hk = h / (D.H / D.Hkv);

  load_qk<E, BQ, DH, LD, ROPE>(q, c2, s2, b, q0, h, D.H, D, sQ);  // rotated once
  for (int r = tid; r < BQ; r += kThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }
  float acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  int k_lo = 0, k_hi = D.T;
  if (D.causal) {
    k_hi = min(D.T, q0 + BQ);
    if (D.window > 0) k_lo = max(0, q0 - D.window + 1) / BK * BK;
  }
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_qk<E, BK, DH, LD, ROPE>(k, c2, s2, b, k0, hk, D.Hkv, D, sK);
    load_tile<E, BK, DH, LD>(v, b, k0, hk, D.Hkv, D, sV);
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[RQ], c[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) c[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        sS[r * LDS + c] = visible(q0 + r, k0 + c, D) ? s[i][j] * D.scale : -INFINITY;
      }
    __syncthreads();

    // online softmax: TPR consecutive lanes per row
    {
      const int r = tid / TPR, lane = tid - r * TPR;
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += TPR) mx = fmaxf(mx, sS[r * LDS + c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += TPR) {
        const float sv = sS[r * LDS + c];
        const float p = m_new == -INFINITY ? 0.f : expf(sv - m_new);
        sS[r * LDS + c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        sL[r] = alpha * sL[r] + sum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float al = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[RQ], c[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = sS[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < RD; ++j) c[j] = sV[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(p[i], c[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
    if (t >= D.T) continue;
    const float l = sL[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    E* orow = o + ((static_cast<size_t>(b) * D.T + t) * D.H + h) * D.Dh;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int d = tx + 16 * j;
      if (d < D.Dh) orow[d] = from_f32<E>(acc[i][j] * inv);
    }
  }
  for (int r = tid; r < BQ; r += kThreads) {
    const int t = q0 + r;
    if (t < D.T) lse[(static_cast<size_t>(b) * D.H + h) * D.T + t] = sM[r] + logf(sL[r]);
  }
}

// ---- dq: one block per (Q tile, b * H + h) -----------------------------------

template <typename E, int DH, int BQ, int BK, bool ROPE>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                const E* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const float* __restrict__ c2,
                const float* __restrict__ s2, E* __restrict__ dq, Dims D) {
  using Tl = Tiles<DH, BQ, BK>;
  constexpr int LD = Tl::LD, LDS = Tl::LDS, RQ = Tl::RQ, RK = Tl::RK, RD = Tl::RD;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BQ * LD;   // dO
  float* sK = sO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;   // ds
  float* sLse = sS + BQ * LDS;
  float* sDel = sLse + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / D.H, h = blockIdx.y - b * D.H;
  const int hk = h / (D.H / D.Hkv);

  load_qk<E, BQ, DH, LD, ROPE>(q, c2, s2, b, q0, h, D.H, D, sQ);
  load_tile<E, BQ, DH, LD>(dout, b, q0, h, D.H, D, sO);
  load_stat<BQ>(lse, b, h, q0, D, sLse);
  load_stat<BQ>(delta, b, h, q0, D, sDel);
  float acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  int k_lo = 0, k_hi = D.T;
  if (D.causal) {
    k_hi = min(D.T, q0 + BQ);
    if (D.window > 0) k_lo = max(0, q0 - D.window + 1) / BK * BK;
  }
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    load_qk<E, BK, DH, LD, ROPE>(k, c2, s2, b, k0, hk, D.Hkv, D, sK);
    load_tile<E, BK, DH, LD>(v, b, k0, hk, D.Hkv, D, sV);
    __syncthreads();

    float s[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; ++d) {
      float a[RQ], g[RQ], c[RK], w[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        a[i] = sQ[(ty + 16 * i) * LD + d];
        g[i] = sO[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        c[j] = sK[(tx + 16 * j) * LD + d];
        w[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i;
      const float l = sLse[r], dl = sDel[r];
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, D) ? expf(s[i][j] * D.scale - l) : 0.f;
        sS[r * LDS + c] = p * (dp[i][j] - dl) * D.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[RQ], c[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) ds[i] = sS[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < RD; ++j) c[j] = sK[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(ds[i], c[j], acc[i][j]);
    }
  }

  if (ROPE) {  // d(q_rot) through shared memory, derotated at the store
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RD; ++j) sQ[(ty + 16 * i) * LD + tx + 16 * j] = acc[i][j];
    __syncthreads();
    derotate_store<E, BQ, LD>(sQ, c2, s2, b, q0, h, D.H, D, dq);
    return;
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= D.T) continue;
    E* row = dq + ((static_cast<size_t>(b) * D.T + t) * D.H + h) * D.Dh;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int d = tx + 16 * j;
      if (d < D.Dh) row[d] = from_f32<E>(acc[i][j]);
    }
  }
}

// ---- dkv: one block per (KV tile, b * Hkv + kv head) ---------------------------

template <typename E, int DH, int BQ, int BK, bool ROPE>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                 const E* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const float* __restrict__ c2,
                 const float* __restrict__ s2, E* __restrict__ dk, E* __restrict__ dv,
                 Dims D) {
  using Tl = Tiles<DH, BQ, BK>;
  constexpr int LD = Tl::LD, LDS = Tl::LDS, RQ = Tl::RQ, RK = Tl::RK, RD = Tl::RD;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sO = sQ + BQ * LD;   // dO
  float* sP = sO + BQ * LD;   // p
  float* sS = sP + BQ * LDS;  // ds
  float* sLse = sS + BQ * LDS;
  float* sDel = sLse + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / D.Hkv, hk = blockIdx.y - b * D.Hkv;
  const int G = D.H / D.Hkv;

  load_qk<E, BK, DH, LD, ROPE>(k, c2, s2, b, k0, hk, D.Hkv, D, sK);  // rotated once
  load_tile<E, BK, DH, LD>(v, b, k0, hk, D.Hkv, D, sV);
  float acc_k[RK][RD], acc_v[RK][RD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  int q_lo = 0, q_hi = D.T;
  if (D.causal) {
    q_lo = k0 / BQ * BQ;
    if (D.window > 0 && D.window < D.T) q_hi = min(D.T, k0 + BK - 1 + D.window);
  }
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();
      // under rope every head of the group reads the same table rows
      load_qk<E, BQ, DH, LD, ROPE>(q, c2, s2, b, q0, h, D.H, D, sQ);
      load_tile<E, BQ, DH, LD>(dout, b, q0, h, D.H, D, sO);
      load_stat<BQ>(lse, b, h, q0, D, sLse);
      load_stat<BQ>(delta, b, h, q0, D, sDel);
      __syncthreads();

      // scores in [q][k] orientation: rows ty + 16 i, columns tx + 16 j
      float s[RQ][RK], dp[RQ][RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < DH; ++d) {
        float a[RQ], gq[RQ], c[RK], w[RK];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          a[i] = sQ[(ty + 16 * i) * LD + d];
          gq[i] = sO[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          c[j] = sK[(tx + 16 * j) * LD + d];
          w[j] = sV[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RK; ++j) {
            s[i][j] = fmaf(a[i], c[j], s[i][j]);
            dp[i][j] = fmaf(gq[i], w[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int r = ty + 16 * i;
        const float l = sLse[r], dl = sDel[r];
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          const int c = tx + 16 * j;
          const float p = visible(q0 + r, k0 + c, D) ? expf(s[i][j] * D.scale - l) : 0.f;
          sP[r * LDS + c] = p;
          sS[r * LDS + c] = p * (dp[i][j] - dl) * D.scale;
        }
      }
      __syncthreads();

      // dv[k][d] += sum_q p[q][k] dO[q][d]; dk[k][d] += sum_q ds[q][k] q[q][d]
      // with rows k = ty + 16 i, columns d = tx + 16 j
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        float p[RK], ds[RK], go[RD], qv[RD];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          p[i] = sP[qq * LDS + ty + 16 * i];
          ds[i] = sS[qq * LDS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < RD; ++j) {
          go[j] = sO[qq * LD + tx + 16 * j];
          qv[j] = sQ[qq * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < RD; ++j) {
            acc_v[i][j] = fmaf(p[i], go[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(ds[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= D.T) continue;
    const size_t row = ((static_cast<size_t>(b) * D.T + t) * D.Hkv + hk) * D.Dh;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int d = tx + 16 * j;
      if (d < D.Dh) {
        if (!ROPE) dk[row + d] = from_f32<E>(acc_k[i][j]);
        dv[row + d] = from_f32<E>(acc_v[i][j]);
      }
    }
  }
  if (ROPE) {  // d(k_rot) through shared memory, derotated at the store
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RD; ++j) sK[(ty + 16 * i) * LD + tx + 16 * j] = acc_k[i][j];
    __syncthreads();
    derotate_store<E, BK, LD>(sK, c2, s2, b, k0, hk, D.Hkv, D, dk);
  }
}

// ---- launchers -------------------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename E, int DH, int BQ, int BK, bool ROPE>
int fwd(const void* q, const void* k, const void* v, const float* c2, const float* s2,
        void* o, float* lse, const Dims& D, cudaStream_t st) {
  const size_t smem = Tiles<DH, BQ, BK>::fwd_smem;
  auto kernel = flash_fwd_kernel<E, DH, BQ, BK, ROPE>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((D.T + BQ - 1) / BQ, D.B * D.H);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const E*>(q), static_cast<const E*>(k),
                                       static_cast<const E*>(v), c2, s2, static_cast<E*>(o),
                                       lse, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int DH, int BQ, int BK, bool ROPE>
int dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
       const float* delta, const float* c2, const float* s2, void* dq_out, const Dims& D,
       cudaStream_t st) {
  const size_t smem = Tiles<DH, BQ, BK>::dq_smem;
  auto kernel = flash_dq_kernel<E, DH, BQ, BK, ROPE>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((D.T + BQ - 1) / BQ, D.B * D.H);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(dout), lse, delta, c2, s2, static_cast<E*>(dq_out), D);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int DH, int BQ, int BK, bool ROPE>
int dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* delta, const float* c2, const float* s2, void* dk, void* dv,
        const Dims& D, cudaStream_t st) {
  const size_t smem = Tiles<DH, BQ, BK>::dkv_smem;
  auto kernel = flash_dkv_kernel<E, DH, BQ, BK, ROPE>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((D.T + BK - 1) / BK, D.B * D.Hkv);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(dout), lse, delta, c2, s2, static_cast<E*>(dk),
      static_cast<E*>(dv), D);
  return static_cast<int>(cudaGetLastError());
}

// Dh <= 64, <= 128, <= 256 pick the tile class; the wrapper refuses Dh > 256.
template <typename E, bool ROPE>
int fwd_any(const void* q, const void* k, const void* v, const float* c2, const float* s2,
            void* o, float* lse, const Dims& D, cudaStream_t st) {
#define FWD_CALL(DH, BQ, BK) fwd<E, DH, BQ, BK, ROPE>(q, k, v, c2, s2, o, lse, D, st)
  if (D.Dh <= 64) return FWD_CALL(64, 64, 64);
  if (D.Dh <= 128) return FWD_CALL(128, 64, 64);
  return FWD_CALL(256, 32, 32);
#undef FWD_CALL
}

template <typename E, bool ROPE>
int dq_any(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, const float* c2, const float* s2, void* dq_out, const Dims& D,
           cudaStream_t st) {
#define DQ_CALL(DH, BQ, BK) \
  dq<E, DH, BQ, BK, ROPE>(q, k, v, dout, lse, delta, c2, s2, dq_out, D, st)
  if (D.Dh <= 64) return DQ_CALL(64, 64, 64);
  if (D.Dh <= 128) return DQ_CALL(128, 64, 64);
  return DQ_CALL(256, 32, 32);
#undef DQ_CALL
}

template <typename E, bool ROPE>
int dkv_any(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, const float* c2, const float* s2, void* dk, void* dv,
            const Dims& D, cudaStream_t st) {
#define DKV_CALL(DH, BQ, BK) \
  dkv<E, DH, BQ, BK, ROPE>(q, k, v, dout, lse, delta, c2, s2, dk, dv, D, st)
  if (D.Dh <= 64) return DKV_CALL(64, 64, 64);
  if (D.Dh <= 128) return DKV_CALL(128, 64, 64);
  return DKV_CALL(256, 32, 32);
#undef DKV_CALL
}

bool nothing_to_do(const Dims& D) { return D.B == 0 || D.T == 0 || D.H == 0; }

template <bool ROPE>
int fwd_entry(const void* q, const void* k, const void* v, const float* c2, const float* s2,
              void* o, float* lse, const Dims& D, int bf16, void* stream) {
  if (nothing_to_do(D)) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd_any<__nv_bfloat16, ROPE>(q, k, v, c2, s2, o, lse, D, st)
              : fwd_any<float, ROPE>(q, k, v, c2, s2, o, lse, D, st);
}

template <bool ROPE>
int dq_entry(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, const float* c2, const float* s2,
             void* dq_out, const Dims& D, int bf16, void* stream) {
  if (nothing_to_do(D)) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dq_any<__nv_bfloat16, ROPE>(q, k, v, dout, lse, delta, c2, s2, dq_out, D, st)
              : dq_any<float, ROPE>(q, k, v, dout, lse, delta, c2, s2, dq_out, D, st);
}

template <bool ROPE>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const float* c2, const float* s2,
              void* dk, void* dv, const Dims& D, int bf16, void* stream) {
  if (nothing_to_do(D)) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dkv_any<__nv_bfloat16, ROPE>(q, k, v, dout, lse, delta, c2, s2, dk, dv, D, st)
              : dkv_any<float, ROPE>(q, k, v, dout, lse, delta, c2, s2, dk, dv, D, st);
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int T, int H, int Hkv, int Dh,
                                   int causal, int window, float scale, int bf16,
                                   void* stream) {
  return fwd_entry<false>(q, k, v, nullptr, nullptr, o, lse,
                          Dims{B, T, H, Hkv, Dh, causal, window, scale}, bf16, stream);
}

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  void* dq_out, int B, int T, int H, int Hkv, int Dh,
                                  int causal, int window, float scale, int bf16,
                                  void* stream) {
  return dq_entry<false>(q, k, v, dout, lse, delta, nullptr, nullptr, dq_out,
                         Dims{B, T, H, Hkv, Dh, causal, window, scale}, bf16, stream);
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   void* dk, void* dv, int B, int T, int H, int Hkv, int Dh,
                                   int causal, int window, float scale, int bf16,
                                   void* stream) {
  return dkv_entry<false>(q, k, v, dout, lse, delta, nullptr, nullptr, dk, dv,
                          Dims{B, T, H, Hkv, Dh, causal, window, scale}, bf16, stream);
}

// The rope-on-load variants: the same operands with the tables c2 and s2
// ([B, T, Dh] float32) after q, k, v (and dO, lse, delta); Dh must be even.
extern "C" int flash_attention_rope_fwd(const void* q, const void* k, const void* v,
                                        const float* c2, const float* s2, void* o,
                                        float* lse, int B, int T, int H, int Hkv, int Dh,
                                        int causal, int window, float scale, int bf16,
                                        void* stream) {
  return fwd_entry<true>(q, k, v, c2, s2, o, lse,
                         Dims{B, T, H, Hkv, Dh, causal, window, scale}, bf16, stream);
}

extern "C" int flash_attention_rope_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse,
                                       const float* delta, const float* c2,
                                       const float* s2, void* dq_out, int B, int T, int H,
                                       int Hkv, int Dh, int causal, int window, float scale,
                                       int bf16, void* stream) {
  return dq_entry<true>(q, k, v, dout, lse, delta, c2, s2, dq_out,
                        Dims{B, T, H, Hkv, Dh, causal, window, scale}, bf16, stream);
}

extern "C" int flash_attention_rope_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse,
                                        const float* delta, const float* c2,
                                        const float* s2, void* dk, void* dv, int B, int T,
                                        int H, int Hkv, int Dh, int causal, int window,
                                        float scale, int bf16, void* stream) {
  return dkv_entry<true>(q, k, v, dout, lse, delta, c2, s2, dk, dv,
                         Dims{B, T, H, Hkv, Dh, causal, window, scale}, bf16, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
