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
// tiles are contiguous). Inputs are float32 or bfloat16, every sum is
// float32, the output is cast once. K and N may be anything: the ragged
// edges are zero-filled on load and masked on store. tm must be a multiple
// of the 128-row block tile, so a block never straddles two experts.
//
// Bound on an H100: operations, at the shapes the MoE layers give it. A
// gmm over M rows does 2 M K N operations on M K + E' K N + M N elements
// (E' experts with a tile); at the serving layout (M 1152, K 4096, N
// 14336, 8 experts) that is 135 GFLOP on 1.9 GB, 70 operations per byte.
// All three run on the tensor cores: float32 as 3xTF32 (three TF32
// products, 494.7 / 3 TFLOP/s): 0.820 ms of operations against ~0.56 ms
// of bytes; bf16 at 989 TFLOP/s. Training (M 9216) is 8x the operations
// on about the same bytes. tgmm does the same 2 M K N operations on M K +
// M N + E' K N elements: 1.08 TFLOP at the training w1 layout (M 9216, K
// 4096, N 14336), 6.56 ms at 3xTF32.
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
// tgmm design: gmm's block, warps, ring and products over another
// contraction. The TPU kernel accumulates across a group's tiles in VMEM
// because its grid runs in order, and finds a group's first and last tile
// from the grid position. Blocks on a GPU run in no order, so each (K tile,
// N tile, expert) gets one block that finds its expert's contiguous tile
// range [t0, t1) by binary search in gmap and loops over the rows [t0 tm,
// t1 tm) in BK-deep stages (tm is a multiple of 128: every stage is full).
// The grid puts K tiles innermost and the expert outermost, so the blocks in
// flight share one expert's rows of lhs and g in the L2. Both operands are
// contraction-outer in memory, A(i, p) = lhs[p, row0 + i] and B(p, j) =
// g[p, col0 + j], so both tiles are [BK][128] on gmm's weight-tile swizzle:
// B's fragments come as gmm's do, and A takes the transposed path,
// ldmatrix.trans in bf16; in float32 the m16 tile's rows are permuted (mma
// row q = lane / 4 is tile row 2q, row q + 8 is 2q + 1), so each fragment
// pair is one 8-byte load, free of bank conflicts on the same swizzle, and
// the sums are stored through the same permutation. Each stage (32 rows in
// float32, 64 in bf16) is summed in fresh accumulators and added to the
// float32 sums once: the contraction reaches every row of a hot expert, and
// one accumulator over 9216 rows drifts past the float32 pin (the CPU
// emulation in tests/test_torch_grouped_matmul.py). K and N edges are
// zero-filled by the copy's source size and masked on store. Blocks of an
// expert with no tile write zeros. No split-K and no atomics: two launches
// give the same bits.
//
// tgmm classes: gmm's tiles, warps, stages and shared memory; registers a
// thread from ptxas, no spills: 239 in float32, 194-222 for bf16 inputs
// (222 with the 16-byte copies). Chosen by A/B on an H100 at the training
// layouts: the permuted rows' 8-byte loads against eight 4-byte loads of
// rows q and q + 8 (5% faster), and the expert's tiles taken in groups of 8
// K tiles, N tiles outer (1% faster in float32, 2-8% slower in bf16: not
// kept). gmm keeps its own store loop: sharing one with tgmm took gmm's
// float32 kernel from 245 registers to 255 and a spill, 5% slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_helpers.cuh"

namespace {

constexpr int kBM = 128;     // block tile rows
constexpr int kBN = 128;     // block tile columns
constexpr int kGWarpsM = 2;  // warps over the tile's rows
constexpr int kGWarpsN = 4;  // warps over its columns
constexpr int kGThreads = 32 * kGWarpsM * kGWarpsN;
constexpr int kGM = kBM / kGWarpsM / 16;  // m16 tiles a warp
constexpr int kGN = kBN / kGWarpsN / 8;   // n8 tiles a warp
constexpr int kGStages = 3;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

// contraction a stage: 128 bytes a row
template <typename T>
struct Gk {
  static constexpr int BK = 128 / sizeof(T);
  static constexpr int PC = 16 / sizeof(T);  // elements a 16-byte chunk
};

// chunk XOR of row r of a k-contiguous tile (128-byte rows: the lhs tile,
// gmm_t's weight tile) and of an n-contiguous tile (gmm's weight tile,
// both of tgmm's tiles)
template <typename T>
__device__ __forceinline__ int kx(int r) { return r & 7; }
template <>
__device__ __forceinline__ int kx<float>(int r) { return (r & 6) ^ ((r & 1) << 2); }
template <typename T>
__device__ __forceinline__ int nx(int r) { return r & 7; }
template <>
__device__ __forceinline__ int nx<float>(int r) { return ((r >> 2) & 3) << 1; }

// element (r, c) of a k-contiguous tile [.][BK], and of a tile [BK][128]
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

// d = a * b, the first `mma` of a fresh accumulator (no zeroing of d)
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// One stage's product added to the warp's piece of the float32 sums (rows
// r0 .., columns c0 ..), acc[m][n] the m16n8 tile (16 m, 8 n). A is the
// k-contiguous lhs tile [m][k], or tgmm's [k][m] (AT); B is gmm's [k][n],
// or gmm_t's [n][k] (BT). float32: k-contiguous operands as 16-byte loads
// of k 4t .. 4t + 3, which are fragment k t, t + 4 of the first k8 step
// and t, t + 4 of the second; [k][.] operands as 4-byte loads of the same
// k rows, or tgmm's A as 8-byte loads of the permuted row pair. Each
// operand is split as it is loaded (the planes split once a stage were
// slower). The stage's twelve `mma` a tile go to fresh accumulators, added
// to acc once.
template <bool AT, bool BT>
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
      if (BT) {
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
      uint32_t ab[2][4], as[2][4];
      if (AT) {  // tile rows 2g, 2g + 1 (mma rows g, g + 8), k 4t .. 4t + 3
        float2 x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] = *reinterpret_cast<const float2*>(
              As + noff<float>(k0 + 4 * t + i, r0 + 16 * m + 2 * g));
        split_tf32_int(x[0].x, ab[0][0], as[0][0]);
        split_tf32_int(x[0].y, ab[0][1], as[0][1]);
        split_tf32_int(x[1].x, ab[0][2], as[0][2]);
        split_tf32_int(x[1].y, ab[0][3], as[0][3]);
        split_tf32_int(x[2].x, ab[1][0], as[1][0]);
        split_tf32_int(x[2].y, ab[1][1], as[1][1]);
        split_tf32_int(x[3].x, ab[1][2], as[1][2]);
        split_tf32_int(x[3].y, ab[1][3], as[1][3]);
      } else {
        const int row = r0 + 16 * m + g;
        const float4 lo = *reinterpret_cast<const float4*>(As + koff<float>(row, k0 + 4 * t));
        const float4 hi = *reinterpret_cast<const float4*>(As + koff<float>(row + 8, k0 + 4 * t));
        split_tf32_int(lo.x, ab[0][0], as[0][0]);
        split_tf32_int(hi.x, ab[0][1], as[0][1]);
        split_tf32_int(lo.y, ab[0][2], as[0][2]);
        split_tf32_int(hi.y, ab[0][3], as[0][3]);
        split_tf32_int(lo.z, ab[1][0], as[1][0]);
        split_tf32_int(hi.z, ab[1][1], as[1][1]);
        split_tf32_int(lo.w, ab[1][2], as[1][2]);
        split_tf32_int(hi.w, ab[1][3], as[1][3]);
      }
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

// bf16: m16n8k16, A by ldmatrix ([m][k]) or ldmatrix.trans (tgmm's [k][m]);
// B by ldmatrix (gmm_t, [n][k]) or ldmatrix.trans (gmm and tgmm, [k][n]);
// the stage's four `mma` a tile go to fresh accumulators, added to acc once
template <bool AT, bool BT>
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
      if (BT) {  // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), ...
        ldsm_x4(r, Bs + koff<T>(n0 + ri + ((mi >> 1) << 3), k0 + ((mi & 1) << 3)));
      } else {   // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), ...
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
      if (AT) {
        ldsm_x4_trans(a, As + noff<T>(k0 + ((mi >> 1) << 3) + ri, r0 + 16 * m + ((mi & 1) << 3)));
      } else {
        ldsm_x4(a, As + koff<T>(r0 + 16 * m + ri + ((mi & 1) << 3), k0 + ((mi >> 1) << 3)));
      }
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

// The block's 128 x 128 sums over ns stages of the contraction through the
// kGStages-deep cp.async ring; load(tile, s) issues stage s's copies into
// the ring slot at tile (A's 128 x BK elements, then B's).
template <typename T, bool AT, bool BT, typename Load>
__device__ __forceinline__ void ring_product(T* smem, int ns, const Load& load,
                                             float (&acc)[kGM][kGN][4], int r0, int c0,
                                             int lane) {
  constexpr int A_ELEMS = kBM * Gk<T>::BK, STAGE = (kBM + kBN) * Gk<T>::BK;
#pragma unroll
  for (int m = 0; m < kGM; ++m)
#pragma unroll
    for (int n = 0; n < kGN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < ns) load(smem + s * STAGE, s);
    cp_commit();
  }
  for (int s = 0; s < ns; ++s) {
    cp_wait<kGStages - 2>();
    __syncthreads();  // stage s landed for every thread; stage s - 1 is free
    const int nxt = s + kGStages - 1;
    if (nxt < ns) load(smem + (nxt % kGStages) * STAGE, nxt);
    cp_commit();
    const T* As = smem + (s % kGStages) * STAGE;
    stage_product<AT, BT>(As, As + A_ELEMS, acc, r0, c0, lane);
  }
  cp_wait<0>();
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp / kGWarpsN) * (16 * kGM), c0 = (warp % kGWarpsN) * (8 * kGN);
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  int e = gmap[row0 / tm];
  e = e < 0 ? 0 : (e >= E ? E - 1 : e);  // never read outside rhs
  const T* a_src = lhs + static_cast<int64_t>(row0) * K;
  const T* w = rhs + static_cast<int64_t>(e) * K * N;

  auto load = [&](T* As, int kt) {
    T* Bs = As + kBM * BK;
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
  ring_product<T, false, TRANS>(smem, (K + BK - 1) / BK, load, acc, r0, c0, lane);

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

// out[e] for one 128 x 128 tile of [K, N] (blockIdx.x: rows row0 .. of K,
// innermost; blockIdx.y: columns col0 .. of N; blockIdx.z: e), the sum over
// the expert's rows p of lhs[p, row0 + i] g[p, col0 + j].
template <typename T, typename TO, bool VEC>
__global__ void __launch_bounds__(kGThreads, 1)
    tgmm_mma_kernel(const T* __restrict__ lhs, const T* __restrict__ g,
                    const int* __restrict__ gmap, TO* __restrict__ out, int K, int N, int nm,
                    int tm) {
  constexpr int BK = Gk<T>::BK, PC = Gk<T>::PC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp / kGWarpsN) * (16 * kGM), c0 = (warp % kGWarpsN) * (8 * kGN);
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const int e = blockIdx.z;
  const int t0 = bound(gmap, nm, e, false), t1 = bound(gmap, nm, e, true);
  const T* a_src = lhs + static_cast<int64_t>(t0) * tm * K + row0;
  const T* b_src = g + static_cast<int64_t>(t0) * tm * N + col0;

  auto load = [&](T* As, int s) {  // rows p of lhs [., K] and of g [., N]
    const int64_t p = static_cast<int64_t>(s) * BK;
    load_tile<T, BK, kBM / PC, false, VEC>(As, a_src + p * K, K, BK, K - row0);
    load_tile<T, BK, kBN / PC, false, VEC>(As + kBM * BK, b_src + p * N, N, BK, N - col0);
  };
  float acc[kGM][kGN][4];
  ring_product<T, true, false>(smem, (t1 - t0) * (tm / BK), load, acc, r0, c0, lane);

  // sums 0, 1 of acc[m][n] are mma row q = lane / 4, sums 2, 3 row q + 8:
  // tile rows 2q and 2q + 1 in float32 (A's rows permuted), q and q + 8 in bf16
  const int q = lane >> 2, t = lane & 3;
  const bool pair = (N & 1) == 0;
  TO* oe = out + static_cast<int64_t>(e) * K * N;
#pragma unroll
  for (int m = 0; m < kGM; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + r0 + 16 * m + (sizeof(T) == 4 ? 2 * q + h : q + 8 * h);
      if (i >= K) continue;
      TO* orow = oe + static_cast<int64_t>(i) * N;
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

template <typename T, typename TO, typename Kernel>
int launch(Kernel kernel, dim3 grid, cudaStream_t st, const void* a, const void* b,
           const int* gmap, TO* out, int K, int N, int x, int tm) {
  const int smem = kGStages * (kBM + kBN) * Gk<T>::BK * static_cast<int>(sizeof(T));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kGThreads, smem, st>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                        gmap, out, K, N, x, tm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gmm(const void* lhs, const void* rhs, const int* gmap, void* out, int M,
               int K, int N, int E, int tm, int transpose, int vec, cudaStream_t st) {
  const dim3 grid(M / kBM, (N + kBN - 1) / kBN);
  T* o = static_cast<T*>(out);
  auto run = [&](auto kernel) {
    return launch<T>(kernel, grid, st, lhs, rhs, gmap, o, K, N, E, tm);
  };
  if (vec) return transpose ? run(gmm_mma_kernel<T, true, true>) : run(gmm_mma_kernel<T, false, true>);
  return transpose ? run(gmm_mma_kernel<T, true, false>) : run(gmm_mma_kernel<T, false, false>);
}

template <typename T, typename TO>
int launch_tgmm(const void* lhs, const void* g, const int* gmap, void* out, int K,
                int N, int nm, int tm, int E, cudaStream_t st) {
  constexpr int PC = Gk<T>::PC;
  const dim3 grid((K + kBM - 1) / kBM, (N + kBN - 1) / kBN, E);
  // every row of lhs and g starts on a 16-byte boundary: 16-byte copies
  const bool vec = K % PC == 0 && N % PC == 0 && reinterpret_cast<uintptr_t>(lhs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  TO* o = static_cast<TO*>(out);
  return vec ? launch<T>(tgmm_mma_kernel<T, TO, true>, grid, st, lhs, g, gmap, o, K, N, nm, tm)
             : launch<T>(tgmm_mma_kernel<T, TO, false>, grid, st, lhs, g, gmap, o, K, N, nm, tm);
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
// M = nm * tm, tm a multiple of 128 -> out [E, K, N] float32 (out_bf16 =
// 0) or bfloat16.
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
