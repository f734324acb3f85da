// Grouped matrix products for mixture-of-experts FFNs on Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces: elephas_tpu/ops/grouped_matmul.py `_gmm_call` (K6-gmm, behind
// `gmm` and `gmm_t`) and `_tgmm_call` (K6-tgmm, behind `tgmm`).
//
//   gmm:    out[r] = lhs[r] @ rhs[gmap[r / tm]]      lhs [M, K], rhs [E, K, N]
//   gmm_t:  out[r] = lhs[r] @ rhs[gmap[r / tm]]^T    rhs [E, N, K], read transposed
//   tgmm:   out[e] = sum over tiles t with gmap[t] == e of lhs_t^T @ g_t
//           lhs [M, K], g [M, N] -> out [E, K, N]; an expert with no tile is 0
//
// M = len(gmap) * tm; gmap is int32 and non-decreasing (each expert's row
// tiles are contiguous). Inputs are float32 or bfloat16 (widened on load),
// every sum is float32, the output is cast once. K and N may be anything:
// the ragged edges are masked by index. tm must be a multiple of the
// 128-row block tile, so a block never straddles two experts.
//
// Bound on an H100: operations, at the shapes the MoE layers give it. A
// gmm over M rows does 2 M K N operations on M K + E' K N + M N elements
// (E' experts with a tile); at the serving layout (M 1152, K 4096, N
// 14336, 8 experts) that is 135 GFLOP on 1.9 GB, 70 operations per byte.
// gmm and gmm_t run on the tensor cores: float32 as 3xTF32 (three TF32
// products, 494.7 / 3 TFLOP/s): 0.820 ms of operations against ~0.56 ms
// of bytes; bf16 at 989 TFLOP/s. Training (M 9216) is 8x the operations
// on about the same bytes. tgmm is still a float32 SIMT GEMM (67 TFLOP/s).
//
// gmm / gmm_t design: `mma.sync` on the tensor cores, one block of 256 threads
// (8 warps as 2 x 4, each a 64 x 32 piece) per 128 x 128 output tile, looping
// over the whole contraction through a 3-stage cp.async ring of 16-byte copies
// (a stage: the lhs tile [128][BK] and the weight tile, 32 KiB; BK is 128
// bytes of contraction, 32 float32 or 64 bf16). float32: m16n8k8 3xTF32, each
// operand split into TF32 big and small parts as its fragment is loaded, as K2
// does, with cvt.rna's rounding done as an integer add and mask (the same
// bits, fewer instructions). bf16: m16n8k16. The lhs tile and gmm_t's weight
// tile [n][k] are k-contiguous: float32 fragments come as 16-byte loads of
// four k (the reduced index taken in the order (4t, 4t + 1) then (4t + 2, 4t +
// 3), K2's mma_abT), bf16 as ldmatrix. gmm's weight tile [k][n] is
// n-contiguous: float32 fragments are 4-byte loads of the matching k rows,
// bf16 ldmatrix.trans (K2's mma_pB). Rows are cut into 16-byte chunks, XOR-
// swizzled by row so every fragment load is free of bank conflicts:
// k-contiguous tiles (r & 6) ^ ((r & 1) << 2) in float32, r & 7 in bf16; gmm's
// weight tile ((r >> 2) & 3) << 1 in float32, r & 7 in bf16. The tensor cores
// round each accumulation toward zero, and the contraction reaches 14336 (w2,
// and gmm_t at training): each stage's product is summed in fresh accumulators
// and added to the float32 sums once (one accumulator over K 14336 drifts past
// the float32 pin). Rows that are not 16-byte aligned (K or N not a multiple
// of 4 in float32, of 8 in bf16) are copied element by element into the same
// ring; ragged edges are zero-filled by the copy's source size. The 16-byte
// and the element-by-element copies are separate instantiations, which keeps
// the copy's branch out of the loop. Every one of the M rows is computed,
// padding rows included. No split-K and no atomics: two launches give the same
// bits.
//
// Classes (tile; warps; stages; shared memory a block; registers a thread,
// from ptxas, no spills; blocks an SM): float32 128 x 128 x 32; 8 as 2 x 4; 3;
// 96 KiB; 219-245; one. bf16 128 x 128 x 64; the same warps; 3; 96 KiB;
// 187-218; one. Chosen by A/B on an H100 against 4 stages, 16 warps as 4 x 4
// (spills at 128 registers), 8 as 4 x 2, a 128 x 64 tile and two blocks an SM
// (bf16 faster, float32 not, both spilling at 128 registers), a 128 x 256 tile
// (spills), the TF32 planes split once a stage (slower: a second pass and
// twice the shared memory), and fresh accumulators every 16 k.
//
// The block reads its expert from gmap itself (a GPU has no scalar
// prefetch). The grid puts row tiles innermost, so consecutive blocks use
// one expert's weight panel while it is in the 50 MB L2: the counterpart
// of the TPU skipping the weight DMA when consecutive tiles hit one
// expert. The TPU kernel's K-chunking into separate calls was a VMEM
// workaround; here one launch loops over all of K.
//
// tgmm design: a float32 SIMT GEMM. One block of 256 threads owns a
// 128 x 128 output tile; each thread keeps an 8 x 8 register tile and the
// block steps through the contraction in 8-deep slices through
// double-buffered shared memory, the next slice's global loads in flight
// while the current one is multiplied; loads are coalesced along the
// contiguous dimension.
//
// tgmm: the TPU kernel accumulates across a group's tiles in VMEM because
// its grid runs in order, and finds a group's first and last tile from the
// grid position. Blocks on a GPU run in no order, so each (expert, K-tile,
// N-tile) gets one block that finds its expert's contiguous tile range by
// binary search in gmap, loops over those rows in float32 and writes once.
// No atomics: the result has the same bits every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_helpers.cuh"

namespace {

constexpr int kBM = 128;       // block tile rows
constexpr int kBN = 128;       // block tile columns
constexpr int kBK = 8;         // contraction slice
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kPad = 4;        // keeps rows 16-byte aligned, spreads banks
constexpr int kLoads = kBM * kBK / kThreads;  // elements per thread per operand

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Smem {
  float a[2][kBK][kBM + kPad];  // A slice, contraction-major
  float b[2][kBK][kBN + kPad];
};

// One 128 x 128 tile of C = A B, accumulated into acc over p in [p0, p1).
// a points at A(tile row 0, p = 0) and A(i, p) = a[i * a_si + p * a_sp];
// b points at B(p = 0, tile column 0) and B(p, j) = b[p * b_sp + j * b_sj].
// A_P_CONTIG means a_sp == 1 (else a_si == 1); B_J_CONTIG means b_sj == 1
// (else b_sp == 1). Rows past i_rem and columns past j_rem read as 0.
template <typename T, bool A_P_CONTIG, bool B_J_CONTIG>
__device__ __forceinline__ void tile_product(const T* __restrict__ a, int64_t a_si,
                                             int64_t a_sp, int i_rem,
                                             const T* __restrict__ b, int64_t b_sp,
                                             int64_t b_sj, int j_rem, int p0, int p1,
                                             Smem& sm, float (&acc)[8][8]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float ra[kLoads], rb[kLoads];

  auto load = [&](int pk) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int idx = tid + q * kThreads;
      int i, p;
      if (A_P_CONTIG) {
        p = idx % kBK;
        i = idx / kBK;
      } else {
        i = idx % kBM;
        p = idx / kBM;
      }
      const int pp = pk + p;
      ra[q] = (i < i_rem && pp < p1) ? widen(a[i * a_si + pp * a_sp]) : 0.f;
      int j;
      if (B_J_CONTIG) {
        j = idx % kBN;
        p = idx / kBN;
      } else {
        p = idx % kBK;
        j = idx / kBK;
      }
      const int pq = pk + p;
      rb[q] = (j < j_rem && pq < p1) ? widen(b[pq * b_sp + j * b_sj]) : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int idx = tid + q * kThreads;
      if (A_P_CONTIG) {
        sm.a[buf][idx % kBK][idx / kBK] = ra[q];
      } else {
        sm.a[buf][idx / kBM][idx % kBM] = ra[q];
      }
      if (B_J_CONTIG) {
        sm.b[buf][idx / kBN][idx % kBN] = rb[q];
      } else {
        sm.b[buf][idx % kBK][idx / kBK] = rb[q];
      }
    }
  };

  const int n_slices = p1 > p0 ? (p1 - p0 + kBK - 1) / kBK : 0;
  if (n_slices == 0) return;
  load(p0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < n_slices; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < n_slices;
    if (more) load(p0 + (s + 1) * kBK);  // next slice in flight
#pragma unroll
    for (int p = 0; p < kBK; ++p) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[cur][p][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[cur][p][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[cur][p][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[cur][p][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    }
    if (more) stash(cur ^ 1);
    __syncthreads();
  }
}

// The thread's r-th row / c-th column inside the 128 x 128 tile.
__device__ __forceinline__ int tile_row(int r) {
  return (r < 4 ? 0 : 64) + (threadIdx.x / 16) * 4 + (r & 3);
}
__device__ __forceinline__ int tile_col(int c) {
  return (c < 4 ? 0 : 64) + (threadIdx.x % 16) * 4 + (c & 3);
}

// First index in gmap[0, n) whose value is > e (upper) or >= e (lower).
__device__ __forceinline__ int bound(const int* gmap, int n, int e, bool upper) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    const int v = gmap[mid];
    if (upper ? v <= e : v < e) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads, 2)
    tgmm_kernel(const T* __restrict__ lhs, const T* __restrict__ g,
                const int* __restrict__ gmap, TO* __restrict__ out, int K, int N,
                int nm, int tm) {
  __shared__ __align__(16) Smem sm;
  const int row0 = blockIdx.x * kBM;  // over K
  const int col0 = blockIdx.y * kBN;  // over N
  const int e = blockIdx.z;
  const int t0 = bound(gmap, nm, e, false);
  const int t1 = bound(gmap, nm, e, true);
  float acc[8][8] = {};
  // A(i, p) = lhs[p, row0 + i]; B(p, j) = g[p, col0 + j]; p over the
  // expert's rows [t0 tm, t1 tm)
  tile_product<T, false, true>(lhs + row0, 1, K, K - row0, g + col0, N, 1, N - col0,
                               t0 * tm, t1 * tm, sm, acc);
  TO* oe = out + static_cast<int64_t>(e) * K * N;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = row0 + tile_row(r);
    if (i >= K) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = col0 + tile_col(c);
      if (j < N) store(oe + static_cast<int64_t>(i) * N + j, acc[r][c]);
    }
  }
}

// ---- gmm / gmm_t on the tensor cores ----------------------------------------------

// The output tile is kBM x kBN (128 x 128), as tgmm's.
constexpr int kGWarpsM = 2;  // warps over the tile's rows
constexpr int kGWarpsN = 4;  // warps over its columns
constexpr int kGThreads = 32 * kGWarpsM * kGWarpsN;
constexpr int kGM = kBM / kGWarpsM / 16;  // m16 tiles a warp
constexpr int kGN = kBN / kGWarpsN / 8;   // n8 tiles a warp
constexpr int kGStages = 3;

// contraction a stage: 128 bytes a row
template <typename T>
struct Gk {
  static constexpr int BK = 128 / sizeof(T);
  static constexpr int PC = 16 / sizeof(T);  // elements a 16-byte chunk
};

// chunk XOR of row r of a k-contiguous tile (128-byte rows: the lhs tile,
// gmm_t's weight tile) and of gmm's n-contiguous weight tile
template <typename T>
__device__ __forceinline__ int kx(int r) { return r & 7; }
template <>
__device__ __forceinline__ int kx<float>(int r) { return (r & 6) ^ ((r & 1) << 2); }
template <typename T>
__device__ __forceinline__ int nx(int r) { return r & 7; }
template <>
__device__ __forceinline__ int nx<float>(int r) { return ((r >> 2) & 3) << 1; }

// element (r, c) of a k-contiguous tile [.][BK], and of gmm's tile [BK][kBN]
template <typename T>
__device__ __forceinline__ int koff(int r, int c) {
  constexpr int BK = Gk<T>::BK, PC = Gk<T>::PC;
  return r * BK + (((c / PC) ^ kx<T>(r)) * PC) + (c % PC);
}
template <typename T>
__device__ __forceinline__ int noff(int r, int c) {
  constexpr int PC = Gk<T>::PC;
  return r * kBN + (((c / PC) ^ nx<T>(r)) * PC) + (c % PC);
}

// ROWS x (CPR chunks) of the matrix src[r * ld + c] into a swizzled tile,
// 0 at r >= rows or c >= cols: cp.async 16 bytes a chunk when VEC, else
// element by element (cp.async 4 bytes in float32; a plain copy in bf16)
template <typename T, int ROWS, int CPR, bool KTILE, bool VEC>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int64_t ld,
                                          int rows, int cols) {
  constexpr int PC = Gk<T>::PC;
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += kGThreads) {
    const int r = idx / CPR, ch = idx % CPR, c = ch * PC;
    T* d = dst + (KTILE ? koff<T>(r, c) : noff<T>(r, c));
    const T* s = src + r * ld + c;
    const bool row = r < rows;
    if constexpr (VEC) {
      const bool in = row && c < cols;
      cp_async16(d, in ? s : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < PC; ++e) {
        const bool in = row && c + e < cols;
        if constexpr (sizeof(T) == 4) {
          cp_async4(d + e, in ? s + e : src, in ? 4 : 0);
        } else {
          d[e] = in ? s[e] : __float2bfloat16(0.f);
        }
      }
    }
  }
}

// split_tf32 with cvt.rna's rounding (to nearest, ties away from zero)
// done as an integer add and mask: the same bits for every finite x, in
// two integer instructions where cvt.rna.tf32.f32 compiles to about four
// (a split is two roundings and a subtraction, and a thread splits 96
// values a stage for its 192 `mma`). A non-finite x gives a NaN small part,
// as cvt.rna's split does, so the product is not finite either way.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32_int(float x, uint32_t& big, uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}

// d = a * b, the first `mma` of a fresh accumulator (no zeroing of d)
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// One stage's product added to the warp's piece of the float32 sums (rows
// r0 .., columns c0 ..), acc[m][n] the m16n8 tile (16 m, 8 n). float32: A
// and gmm_t's B as 16-byte loads of k 4t .. 4t + 3, which are fragment k
// t, t + 4 of the first k8 step and t, t + 4 of the second; gmm's B as
// 4-byte loads of the same k rows. Each operand is split as it is loaded
// (the planes split once a stage were slower). The stage's twelve `mma` a
// tile go to fresh accumulators, added to acc once.
template <bool TRANS>
__device__ __forceinline__ void stage_product(const float* As, const float* Bs,
                                              float (&acc)[kGM][kGN][4], int r0, int c0,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
  float d[kGM][kGN][4];
#pragma unroll
  for (int k0 = 0; k0 < Gk<float>::BK; k0 += 16) {
    uint32_t bb[kGN][2][2], bs[kGN][2][2];
#pragma unroll
    for (int n = 0; n < kGN; ++n) {
      const int col = c0 + 8 * n + g;
      float v[4];
      if (TRANS) {
        const float4 x = *reinterpret_cast<const float4*>(Bs + koff<float>(col, k0 + 4 * t));
        v[0] = x.x;
        v[1] = x.y;
        v[2] = x.z;
        v[3] = x.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = Bs[noff<float>(k0 + 4 * t + i, col)];
      }
      split_tf32_int(v[0], bb[n][0][0], bs[n][0][0]);
      split_tf32_int(v[1], bb[n][0][1], bs[n][0][1]);
      split_tf32_int(v[2], bb[n][1][0], bs[n][1][0]);
      split_tf32_int(v[3], bb[n][1][1], bs[n][1][1]);
    }
#pragma unroll
    for (int m = 0; m < kGM; ++m) {
      const int row = r0 + 16 * m + g;
      const float4 lo = *reinterpret_cast<const float4*>(As + koff<float>(row, k0 + 4 * t));
      const float4 hi = *reinterpret_cast<const float4*>(As + koff<float>(row + 8, k0 + 4 * t));
      uint32_t ab[2][4], as[2][4];
      split_tf32_int(lo.x, ab[0][0], as[0][0]);
      split_tf32_int(hi.x, ab[0][1], as[0][1]);
      split_tf32_int(lo.y, ab[0][2], as[0][2]);
      split_tf32_int(hi.y, ab[0][3], as[0][3]);
      split_tf32_int(lo.z, ab[1][0], as[1][0]);
      split_tf32_int(hi.z, ab[1][1], as[1][1]);
      split_tf32_int(lo.w, ab[1][2], as[1][2]);
      split_tf32_int(hi.w, ab[1][3], as[1][3]);
#pragma unroll
      for (int n = 0; n < kGN; ++n) {
        if (k0 == 0) {  // mma_3xtf32's order, from 0
          mma_tf32_first(d[m][n], as[0], bb[n][0]);
          mma_tf32(d[m][n], ab[0], bs[n][0]);
          mma_tf32(d[m][n], ab[0], bb[n][0]);
        } else {
          mma_3xtf32(d[m][n], ab[0], as[0], bb[n][0], bs[n][0]);
        }
        mma_3xtf32(d[m][n], ab[1], as[1], bb[n][1], bs[n][1]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kGM; ++m)
#pragma unroll
    for (int n = 0; n < kGN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] += d[m][n][i];
}

// bf16: m16n8k16, A by ldmatrix; B by ldmatrix (gmm_t, [n][k]) or
// ldmatrix.trans (gmm, [k][n]); the stage's four `mma` a tile go to fresh
// accumulators, added to acc once
template <bool TRANS>
__device__ __forceinline__ void stage_product(const __nv_bfloat16* As,
                                              const __nv_bfloat16* Bs,
                                              float (&acc)[kGM][kGN][4], int r0, int c0,
                                              int lane) {
  using T = __nv_bfloat16;
  const int mi = lane >> 3, ri = lane & 7;
  float d[kGM][kGN][4];
#pragma unroll
  for (int m = 0; m < kGM; ++m)
#pragma unroll
    for (int n = 0; n < kGN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[m][n][i] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < Gk<T>::BK; k0 += 16) {
    uint32_t b[kGN][2];
#pragma unroll
    for (int np = 0; np < kGN / 2; ++np) {
      const int n0 = c0 + 16 * np;
      uint32_t r[4];
      if (TRANS) {  // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), ...
        ldsm_x4(r, Bs + koff<T>(n0 + ri + ((mi >> 1) << 3), k0 + ((mi & 1) << 3)));
      } else {      // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), ...
        ldsm_x4_trans(r, Bs + noff<T>(k0 + (lane & 15), n0 + ((lane >> 4) << 3)));
      }
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int m = 0; m < kGM; ++m) {
      uint32_t a[4];  // matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (0-7, k 8-15), ...
      ldsm_x4(a, As + koff<T>(r0 + 16 * m + ri + ((mi & 1) << 3), k0 + ((mi >> 1) << 3)));
#pragma unroll
      for (int n = 0; n < kGN; ++n) mma_bf16(d[m][n], a, b[n]);
    }
  }
#pragma unroll
  for (int m = 0; m < kGM; ++m)
#pragma unroll
    for (int n = 0; n < kGN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] += d[m][n][i];
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    p[1] = b;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    p[1] = __float2bfloat16(b);
  }
}

// out[r] = lhs[r] @ W (gmm: W = rhs[e] [K, N]; gmm_t: W = rhs[e]^T, rhs[e]
// [N, K]) for the 128 x 128 tile (blockIdx.x row tile, innermost;
// blockIdx.y column tile), e = gmap[row tile / tm] clamped into [0, E).
template <typename T, bool TRANS, bool VEC>
__global__ void __launch_bounds__(kGThreads, 1)
    gmm_mma_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                   const int* __restrict__ gmap, T* __restrict__ out, int K, int N, int E,
                   int tm) {
  constexpr int BK = Gk<T>::BK, PC = Gk<T>::PC;
  constexpr int A_ELEMS = kBM * BK, B_ELEMS = kBN * BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp / kGWarpsN) * (16 * kGM), c0 = (warp % kGWarpsN) * (8 * kGN);
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  int e = gmap[row0 / tm];
  e = e < 0 ? 0 : (e >= E ? E - 1 : e);  // never read outside rhs
  const T* a_src = lhs + static_cast<int64_t>(row0) * K;
  const T* w = rhs + static_cast<int64_t>(e) * K * N;

  auto load_stage = [&](int slot, int kt) {
    T* As = smem + slot * (A_ELEMS + B_ELEMS);
    T* Bs = As + A_ELEMS;
    const int k0 = kt * BK;
    load_tile<T, kBM, BK / PC, true, VEC>(As, a_src + k0, K, kBM, K - k0);
    if (TRANS) {  // rows n of rhs[e] [N, K]
      load_tile<T, kBN, BK / PC, true, VEC>(Bs, w + static_cast<int64_t>(col0) * K + k0, K,
                                             N - col0, K - k0);
    } else {      // rows k of rhs[e] [K, N]
      load_tile<T, BK, kBN / PC, false, VEC>(Bs, w + static_cast<int64_t>(k0) * N + col0, N,
                                              K - k0, N - col0);
    }
  };

  float acc[kGM][kGN][4];
#pragma unroll
  for (int m = 0; m < kGM; ++m)
#pragma unroll
    for (int n = 0; n < kGN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kGStages - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 is free
    const int nxt = kt + kGStages - 1;
    if (nxt < nk) load_stage(nxt % kGStages, nxt);
    cp_commit();
    const T* As = smem + (kt % kGStages) * (A_ELEMS + B_ELEMS);
    stage_product<TRANS>(As, As + A_ELEMS, acc, r0, c0, lane);
  }
  cp_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  const bool pair = (N & 1) == 0;
#pragma unroll
  for (int m = 0; m < kGM; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T* orow = out + static_cast<int64_t>(row0 + r0 + 16 * m + g + 8 * h) * N;
#pragma unroll
      for (int n = 0; n < kGN; ++n) {
        const int j = col0 + c0 + 8 * n + 2 * t;
        if (j + 1 < N) {
          store2(orow + j, acc[m][n][2 * h], acc[m][n][2 * h + 1], pair);
        } else if (j < N) {
          store(orow + j, acc[m][n][2 * h]);
        }
      }
    }
  }
}

template <typename T>
int launch_gmm(const void* lhs, const void* rhs, const int* gmap, void* out, int M,
               int K, int N, int E, int tm, int transpose, int vec, cudaStream_t st) {
  const dim3 grid(M / kBM, (N + kBN - 1) / kBN);
  const int smem = kGStages * (kBM + kBN) * Gk<T>::BK * static_cast<int>(sizeof(T));
  auto run = [&](auto kernel) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kGThreads, smem, st>>>(static_cast<const T*>(lhs),
                                          static_cast<const T*>(rhs), gmap,
                                          static_cast<T*>(out), K, N, E, tm);
    return static_cast<int>(cudaGetLastError());
  };
  if (vec) return transpose ? run(gmm_mma_kernel<T, true, true>) : run(gmm_mma_kernel<T, false, true>);
  return transpose ? run(gmm_mma_kernel<T, true, false>) : run(gmm_mma_kernel<T, false, false>);
}

template <typename T, typename TO>
int launch_tgmm(const void* lhs, const void* g, const int* gmap, void* out, int K,
                int N, int nm, int tm, int E, cudaStream_t st) {
  const dim3 grid((K + kBM - 1) / kBM, (N + kBN - 1) / kBN, E);
  tgmm_kernel<T, TO><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(g), gmap,
      static_cast<TO*>(out), K, N, nm, tm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gmm / gmm_t: lhs [M, K], rhs [E, K, N] (transpose = 0) or [E, N, K]
// (transpose = 1), gmap [M / tm] int32 -> out [M, N], all of one dtype
// (bf16 = 1: bfloat16, else float32). M and tm are multiples of 128. vec:
// every row of lhs and rhs starts 16-byte aligned (the base pointers are,
// and K and N are multiples of 16 bytes' worth of elements).
extern "C" int gmm(const void* lhs, const void* rhs, const int* gmap, void* out, int M,
                   int K, int N, int E, int tm, int transpose, int bf16, int vec,
                   void* stream) {
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_gmm<__nv_bfloat16>(lhs, rhs, gmap, out, M, K, N, E, tm,
                                          transpose, vec, st)
              : launch_gmm<float>(lhs, rhs, gmap, out, M, K, N, E, tm, transpose, vec, st);
}

// tgmm: lhs [M, K] and g [M, N] of one dtype (in_bf16), gmap [nm] int32,
// M = nm * tm -> out [E, K, N] float32 (out_bf16 = 0) or bfloat16.
extern "C" int tgmm(const void* lhs, const void* g, const int* gmap, void* out, int K,
                    int N, int nm, int tm, int E, int in_bf16, int out_bf16,
                    void* stream) {
  if (K == 0 || N == 0 || E == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (in_bf16) {
    return out_bf16 ? launch_tgmm<bf, bf>(lhs, g, gmap, out, K, N, nm, tm, E, st)
                    : launch_tgmm<bf, float>(lhs, g, gmap, out, K, N, nm, tm, E, st);
  }
  return out_bf16 ? launch_tgmm<float, bf>(lhs, g, gmap, out, K, N, nm, tm, E, st)
                  : launch_tgmm<float, float>(lhs, g, gmap, out, K, N, nm, tm, E, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
