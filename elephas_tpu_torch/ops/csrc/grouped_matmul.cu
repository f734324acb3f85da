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
// 14336, 8 experts) that is 135 GFLOP on 1.9 GB, 70 operations per byte,
// far above the ~20 at which the 67 TFLOP/s float32 rate binds: ~2.0 ms
// against ~0.56 ms of bytes. Training (M 9216) is 8x the operations on
// about the same bytes.
//
// Design: a float32 SIMT GEMM, simple first (no wgmma, no TMA, no tensor
// cores). One block of 256 threads owns a 128 x 128 output tile; each
// thread keeps an 8 x 8 register tile and the block steps through the
// contraction in 8-deep slices through double-buffered shared memory, the
// next slice's global loads in flight while the current one is multiplied.
// One device function does all three products, parameterised by strides:
// which operand dimension is contiguous in memory picks the thread-to-
// element map of the loads, so every load is coalesced along the
// contiguous dimension (gmm_t reads the weights transposed in place, as
// the TPU kernel's BlockSpec does).
//
// gmm: the block reads its expert from gmap itself (a GPU has no scalar
// prefetch). The grid puts row tiles innermost, so consecutive blocks use
// one expert's weight panel while it is in the 50 MB L2: the counterpart
// of the TPU skipping the weight DMA when consecutive tiles hit one
// expert. The TPU kernel's K-chunking into separate calls was a VMEM
// workaround; here one launch loops over all of K.
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

template <typename T, bool TRANSPOSE>
__global__ void __launch_bounds__(kThreads, 2)
    gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
               const int* __restrict__ gmap, T* __restrict__ out, int K, int N,
               int E, int tm) {
  __shared__ __align__(16) Smem sm;
  const int row0 = blockIdx.x * kBM;  // row tiles innermost
  const int col0 = blockIdx.y * kBN;
  int e = gmap[row0 / tm];
  e = e < 0 ? 0 : (e >= E ? E - 1 : e);  // never read outside rhs
  const T* w = rhs + static_cast<int64_t>(e) * K * N;
  float acc[8][8] = {};
  // A(i, p) = lhs[row0 + i, p]; B(p, j) = w[p, col0 + j] (or w[col0 + j, p])
  tile_product<T, true, !TRANSPOSE>(
      lhs + static_cast<int64_t>(row0) * K, K, 1, kBM,
      TRANSPOSE ? w + static_cast<int64_t>(col0) * K : w + col0,
      TRANSPOSE ? 1 : N, TRANSPOSE ? K : 1, N - col0, 0, K, sm, acc);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    T* orow = out + static_cast<int64_t>(row0 + tile_row(r)) * N;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = col0 + tile_col(c);
      if (j < N) store(orow + j, acc[r][c]);
    }
  }
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

template <typename T>
int launch_gmm(const void* lhs, const void* rhs, const int* gmap, void* out, int M,
               int K, int N, int E, int tm, int transpose, cudaStream_t st) {
  const dim3 grid(M / kBM, (N + kBN - 1) / kBN);
  if (transpose) {
    gmm_kernel<T, true><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(lhs), static_cast<const T*>(rhs), gmap,
        static_cast<T*>(out), K, N, E, tm);
  } else {
    gmm_kernel<T, false><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(lhs), static_cast<const T*>(rhs), gmap,
        static_cast<T*>(out), K, N, E, tm);
  }
  return static_cast<int>(cudaGetLastError());
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
// (bf16 = 1: bfloat16, else float32). M and tm are multiples of 128.
extern "C" int gmm(const void* lhs, const void* rhs, const int* gmap, void* out, int M,
                   int K, int N, int E, int tm, int transpose, int bf16, void* stream) {
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_gmm<__nv_bfloat16>(lhs, rhs, gmap, out, M, K, N, E, tm,
                                          transpose, st)
              : launch_gmm<float>(lhs, rhs, gmap, out, M, K, N, E, tm, transpose, st);
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
