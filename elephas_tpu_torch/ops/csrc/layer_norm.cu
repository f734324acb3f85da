// Fused LayerNorm forward and backward for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces: elephas_tpu/ops/layer_norm.py `fused_layer_norm` (the Pallas
// `_fwd_kernel` with `_stats`): LayerNorm over the last axis of [N, D]
// float32 rows, centred variance, affine scale and bias, float32 output;
// and its VJP `_fused_bwd` (the Pallas `_bwd_kernel`): x-hat recomputed
// from x alone, dx = rstd * (h - mean(h) - x-hat * mean(h * x-hat)) with
// h = g * scale, dscale = sum over rows of g * x-hat, dbias = sum of g.
//
// Bound on an H100: bytes. The forward reads each row once and writes it
// once, 2*N*D*4 bytes (plus 2*D*4 for scale and bias); about 8 operations
// per element is far below the ~20 float32 operations per byte at which
// the card's 67 TFLOP/s, not its 3.35 TB/s, would be the limit. At the
// decode shape [8, 768] the whole call moves 55 KB, so the launch
// dominates; at the training shape [8192, 768], 50.3 MB, 15.0 us. The
// backward reads x and g and writes dx, 3*N*D*4 bytes, with about 12
// operations per element: at the training shape that is 75.5 MB, 22.5 us.
//
// Forward design: each row is read from device memory exactly once and its
// statistics are the TPU kernel's `_stats`: the mean first, then the
// CENTRED sum of squares over (x - mean) (E[x^2] - mean^2 cancels in
// float32 when |mean| >> std), then the affine output. The mean's sum runs
// in double and x - mean is formed in double before it is rounded, so a
// row riding at 1e4 keeps float32 accuracy in the centred values; the
// variance is summed in float32 and rstd = rsqrtf(var + eps). Two routes,
// chosen by D:
//  - rows (D <= kRowMaxD): one warp owns a whole row, in registers, with
//    the backward's rows-route helpers (`load_row`, `row_col`, `warp_sum`):
//    float4 at columns 4 (l + 32 j) when D % 4 == 0 and the rows are
//    16-byte aligned, else scalars at columns l + 32 j. The two sums are
//    butterfly shuffles inside the warp: no block barrier and no shared
//    memory for the row (the block-per-row kernel below takes four
//    barriers a row and holds at most 8 rows an SM in flight). The warp
//    issues its next row's loads before this row's sums, as the backward
//    does. scale and bias sit in registers for the lane's columns, loaded
//    once a block; the output is written as float4 where the loads were.
//    4 warps a block; a block's warps take rows blockIdx * 4 + w, then
//    every gridDim * 4-th row. The grid gives each warp one row (the
//    decode shape [8, 768]: two blocks, no row waits behind another) until
//    that takes more than kFwdOneRowBlocks blocks, then two rows (the
//    training shape [8192, 768]: 1024 blocks, the second row's loads in
//    flight during the first's sums). A row's bits depend on its warp
//    alone, not on the grid or the card, and its statistics are computed
//    by the same code, in the same order, as the backward's recompute.
//  - wide (D > kRowMaxD): one block of 256 threads a row; the row is staged
//    in shared memory (D floats, threads stride it by index), the mean and
//    the centred variance are block sums.
//
// Backward design: the TPU kernel sums dscale and dbias into one resident
// block across its SEQUENTIAL grid; a GPU grid runs in no order. So pass 1
// gives each block a contiguous run of rows and writes per-column partials
// of g * x-hat and g once as [n_blocks, D]; pass 2 sums each column's
// partials over the blocks in a fixed order. No atomics, and the block
// count depends on N alone: the sums are the same bits on every run. Each
// row's statistics are recomputed exactly as the forward computes them
// (the mean summed in double, x - mean formed in double, the centred
// variance). Pass 1 has two routes, chosen by D, both hand-written:
//  - rows (D <= kRowMaxD): one warp owns a whole row. Lane l holds the
//    row's x and g in registers, as float4 at columns 4 (l + 32 j) when
//    D % 4 == 0 and the rows are 16-byte aligned, else as scalars at
//    columns l + 32 j. The mean, the centred variance, mean(h) and
//    mean(h * x-hat) are butterfly shuffle sums inside the warp: no block
//    barrier per row (the block-per-row kernel below takes 8). The warp
//    issues its next row's loads before this row's reductions, so two rows
//    are in flight per warp (rows of up to 768 columns; wider rows keep one
//    in flight, for registers). Each lane owns fixed columns, so it keeps
//    the partials of g * x-hat and g for them in registers across its
//    rows; at the end the block adds its warps' partials in warp order
//    through shared memory. 4 warps a block; the warps of a block take its
//    rows in turn (row r0 + w, r0 + w + 4, ...).
//  - wide (kRowMaxD < D <= the wrapper's limit): one block of 256 threads
//    walks its rows one after another, staging x and g in shared memory,
//    with four block sums a row, and keeps the partials in shared memory.
// Pass 2: one block per 32 columns; its 16 row groups each sum every 16th
// block's partial in block order, then the 16 group sums are added in
// group order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sum over the block; `red` holds one partial per warp. Every thread gets
// the total. Ends with a barrier so `red` can be reused at once.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = 0;
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

// Forward, wide route: one block a row.
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int d, float eps) {
  extern __shared__ float row[];  // [d]
  __shared__ double red_d[kWarps];
  __shared__ float red_f[kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * d;

  double s = 0.0;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = x[base + i];
    row[i] = v;
    s += v;
  }
  const double mean = block_sum(s, red_d) / d;

  // each thread re-reads only the elements it wrote: no barrier needed
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float c = static_cast<float>(static_cast<double>(row[i]) - mean);
    row[i] = c;
    ss += c * c;
  }
  const float var = block_sum(ss, red_f) / d;
  const float rstd = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < d; i += kThreads)
    out[base + i] = row[i] * rstd * scale[i] + bias[i];
}

// Pass 1, wide route: rows [blockIdx.x * rows, ...) of one block.
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ g, float* __restrict__ dx,
                      float* __restrict__ ds_part, float* __restrict__ db_part, int n,
                      int d, int rows, float eps) {
  extern __shared__ float buf[];  // x row, g row, dscale and dbias partials: [4][d]
  float* xr = buf;
  float* gr = xr + d;
  float* ps = gr + d;
  float* pb = ps + d;
  __shared__ double red_d[kWarps];
  __shared__ float red_f[kWarps];
  for (int i = threadIdx.x; i < d; i += kThreads) ps[i] = pb[i] = 0.f;

  const int r1 = min(n, (blockIdx.x + 1) * rows);
  for (int r = blockIdx.x * rows; r < r1; ++r) {
    const size_t base = static_cast<size_t>(r) * d;
    double s = 0.0;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float v = x[base + i];
      xr[i] = v;
      gr[i] = g[base + i];
      s += v;
    }
    const double mean = block_sum(s, red_d) / d;
    float ss = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float c = static_cast<float>(static_cast<double>(xr[i]) - mean);
      xr[i] = c;
      ss += c * c;
    }
    const float var = block_sum(ss, red_f) / d;
    const float rstd = rsqrtf(var + eps);

    float sh = 0.f, shx = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float h = gr[i] * scale[i];
      sh += h;
      shx += h * (xr[i] * rstd);
    }
    const float mean_h = block_sum(sh, red_f) / d;
    const float mean_hx = block_sum(shx, red_f) / d;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float xhat = xr[i] * rstd;
      const float gi = gr[i];
      dx[base + i] = rstd * (gi * scale[i] - mean_h - xhat * mean_hx);
      ps[i] += gi * xhat;
      pb[i] += gi;
    }
  }
  const size_t part = static_cast<size_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    ds_part[part + i] = ps[i];
    db_part[part + i] = pb[i];
  }
}

// ---- pass 1, rows route: one warp a row, the row in registers -------------------

constexpr int kRowWarps = 4;
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kRowMaxD = 1024;          // 8 float4 (or 32 scalars) a lane
constexpr int kRowPrefetchMaxNV = 6;    // two rows in flight up to D 768
constexpr int kFwdOneRowBlocks = 1024;  // the forward's grid: one row a warp up to this
                                        // many blocks, two rows a warp past it

// the butterfly leaves the same total, summed in the same order, in every lane
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The lane's columns: element (j, e) is column 4 (lane + 32 j) + e when VEC,
// else (4 j + e) * 32 + lane.
template <bool VEC>
__device__ __forceinline__ int row_col(int lane, int j, int e) {
  return VEC ? 4 * (lane + 32 * j) + e : (4 * j + e) * 32 + lane;
}

// the lane's NV x 4 elements of one row, 0 past d
template <int NV, bool VEC>
__device__ __forceinline__ void load_row(float (&v)[NV][4], const float* __restrict__ p,
                                         int d, int lane) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (VEC) {
      const int c = row_col<true>(lane, j, 0);
      const float4 t = c < d ? __ldg(reinterpret_cast<const float4*>(p + c))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      v[j][0] = t.x;
      v[j][1] = t.y;
      v[j][2] = t.z;
      v[j][3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = row_col<false>(lane, j, e);
        v[j][e] = c < d ? __ldg(p + c) : 0.f;
      }
    }
  }
}

// Forward, rows route: one warp a row, the row in registers.
template <int NV, bool VEC>
__global__ void __launch_bounds__(kRowThreads)
layer_norm_fwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                           const float* __restrict__ bias, float* __restrict__ out, int n,
                           int d, float eps) {
  constexpr bool kPrefetch = NV <= kRowPrefetchMaxNV;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kRowWarps;
  float s[NV][4], b[NV][4], xa[NV][4];
  load_row<NV, VEC>(s, scale, d, lane);
  load_row<NV, VEC>(b, bias, d, lane);

  int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r < n) load_row<NV, VEC>(xa, x + static_cast<size_t>(r) * d, d, lane);
  for (; r < n; r += stride) {
    const int rn = r + stride;
    float xb[NV][4];
    if (kPrefetch && rn < n)  // the next row's loads fly during this row's sums
      load_row<NV, VEC>(xb, x + static_cast<size_t>(rn) * d, d, lane);
    double sd = 0.0;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sd += static_cast<double>(xa[j][e]);
    const double mean = warp_sum(sd) / d;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float c = row_col<VEC>(lane, j, e) < d
                            ? static_cast<float>(static_cast<double>(xa[j][e]) - mean)
                            : 0.f;
        xa[j][e] = c;
        ss += c * c;
      }
    const float rstd = rsqrtf(warp_sum(ss) / d + eps);
    float* o = out + static_cast<size_t>(r) * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = xa[j][e] * rstd * s[j][e] + b[j][e];
      if (VEC) {
        const int c = row_col<true>(lane, j, 0);
        if (c < d) *reinterpret_cast<float4*>(o + c) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = row_col<false>(lane, j, e);
          if (c < d) o[c] = y[e];
        }
      }
    }
    if (kPrefetch) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xa[j][e] = xb[j][e];
    } else if (rn < n) {
      load_row<NV, VEC>(xa, x + static_cast<size_t>(rn) * d, d, lane);
    }
  }
}

template <int NV, bool VEC>
__global__ void __launch_bounds__(kRowThreads)
layer_norm_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                           const float* __restrict__ g, float* __restrict__ dx,
                           float* __restrict__ ds_part, float* __restrict__ db_part, int n,
                           int d, int rows, float eps) {
  constexpr bool kPrefetch = NV <= kRowPrefetchMaxNV;
  extern __shared__ float part[];  // [kRowWarps][2][d]: each warp's partials
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rows, r1 = min(n, r0 + rows);

  float s[NV][4], ps[NV][4], pb[NV][4], xa[NV][4], ga[NV][4];
  load_row<NV, VEC>(s, scale, d, lane);
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ps[j][e] = pb[j][e] = 0.f;

  int r = r0 + warp;
  if (r < r1) {
    load_row<NV, VEC>(xa, x + static_cast<size_t>(r) * d, d, lane);
    load_row<NV, VEC>(ga, g + static_cast<size_t>(r) * d, d, lane);
  }
  for (; r < r1; r += kRowWarps) {
    const int rn = r + kRowWarps;
    float xb[NV][4], gb[NV][4];
    if (kPrefetch && rn < r1) {  // the next row's loads fly during this row's sums
      load_row<NV, VEC>(xb, x + static_cast<size_t>(rn) * d, d, lane);
      load_row<NV, VEC>(gb, g + static_cast<size_t>(rn) * d, d, lane);
    }
    double sd = 0.0;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sd += static_cast<double>(xa[j][e]);
    const double mean = warp_sum(sd) / d;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float c = row_col<VEC>(lane, j, e) < d
                            ? static_cast<float>(static_cast<double>(xa[j][e]) - mean)
                            : 0.f;
        xa[j][e] = c;
        ss += c * c;
      }
    const float rstd = rsqrtf(warp_sum(ss) / d + eps);
    float sh = 0.f, shx = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h = ga[j][e] * s[j][e];
        sh += h;
        shx += h * (xa[j][e] * rstd);
      }
    sh = warp_sum(sh);
    shx = warp_sum(shx);
    const float mean_h = sh / d, mean_hx = shx / d;
    float* out = dx + static_cast<size_t>(r) * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xhat = xa[j][e] * rstd;
        const float gi = ga[j][e];
        o[e] = rstd * (gi * s[j][e] - mean_h - xhat * mean_hx);
        ps[j][e] += gi * xhat;
        pb[j][e] += gi;
      }
      if (VEC) {
        const int c = row_col<true>(lane, j, 0);
        if (c < d) *reinterpret_cast<float4*>(out + c) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = row_col<false>(lane, j, e);
          if (c < d) out[c] = o[e];
        }
      }
    }
    if (kPrefetch) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xa[j][e] = xb[j][e];
          ga[j][e] = gb[j][e];
        }
    } else if (rn < r1) {
      load_row<NV, VEC>(xa, x + static_cast<size_t>(rn) * d, d, lane);
      load_row<NV, VEC>(ga, g + static_cast<size_t>(rn) * d, d, lane);
    }
  }

  // the block's partials: each warp's, then added in warp order
  float* mine = part + static_cast<size_t>(warp) * 2 * d;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = row_col<VEC>(lane, j, e);
      if (c < d) {
        mine[c] = ps[j][e];
        mine[d + c] = pb[j][e];
      }
    }
  __syncthreads();
  const size_t at = static_cast<size_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += kRowThreads) {
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) {
      a += part[static_cast<size_t>(w) * 2 * d + i];
      c += part[static_cast<size_t>(w) * 2 * d + d + i];
    }
    ds_part[at + i] = a;
    db_part[at + i] = c;
  }
}

// ---- pass 2: each column's partials summed over the blocks in a fixed order ----------

constexpr int kRedCols = 32;
constexpr int kRedGroups = 16;

__global__ void __launch_bounds__(kRedCols * kRedGroups)
layer_norm_bwd_reduce_kernel(const float* __restrict__ ds_part,
                             const float* __restrict__ db_part, float* __restrict__ dscale,
                             float* __restrict__ dbias, int n_blocks, int d) {
  __shared__ float red[2][kRedGroups][kRedCols];
  const int col = threadIdx.x % kRedCols, grp = threadIdx.x / kRedCols;
  const int i = blockIdx.x * kRedCols + col;
  float a = 0.f, c = 0.f;
  if (i < d) {
    for (int k = grp; k < n_blocks; k += kRedGroups) {
      a += ds_part[static_cast<size_t>(k) * d + i];
      c += db_part[static_cast<size_t>(k) * d + i];
    }
  }
  red[0][grp][col] = a;
  red[1][grp][col] = c;
  __syncthreads();
  if (grp == 0 && i < d) {
    float ta = 0.f, tc = 0.f;
#pragma unroll
    for (int q = 0; q < kRedGroups; ++q) {
      ta += red[0][q][col];
      tc += red[1][q][col];
    }
    dscale[i] = ta;
    dbias[i] = tc;
  }
}

template <int NV>
int launch_fwd_rows(const float* x, const float* scale, const float* bias, float* out, int n,
                    int d, int blocks, int vec, float eps, cudaStream_t st) {
  if (vec) {
    layer_norm_fwd_rows_kernel<NV, true><<<blocks, kRowThreads, 0, st>>>(x, scale, bias, out,
                                                                         n, d, eps);
  } else {
    layer_norm_fwd_rows_kernel<NV, false><<<blocks, kRowThreads, 0, st>>>(x, scale, bias, out,
                                                                          n, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NV>
int launch_rows(const float* x, const float* scale, const float* g, float* dx,
                float* ds_part, float* db_part, int n, int d, int n_blocks, int rows,
                int vec, float eps, cudaStream_t st) {
  const size_t smem = 2 * kRowWarps * static_cast<size_t>(d) * sizeof(float);
  if (vec) {
    layer_norm_bwd_rows_kernel<NV, true><<<n_blocks, kRowThreads, smem, st>>>(
        x, scale, g, dx, ds_part, db_part, n, d, rows, eps);
  } else {
    layer_norm_bwd_rows_kernel<NV, false><<<n_blocks, kRowThreads, smem, st>>>(
        x, scale, g, dx, ds_part, db_part, n, d, rows, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// route 0: rows (d <= 1024, vec: d % 4 == 0 and x, scale, bias and out
// 16-byte aligned); route 1: wide.
extern "C" int layer_norm_fwd(const float* x, const float* scale, const float* bias,
                              float* out, int n, int d, int route, int vec, float eps,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (d > kRowMaxD || (vec && d % 4)) return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return static_cast<int>(cudaGetLastError());
    const int rows = n > kRowWarps * kFwdOneRowBlocks ? 2 * kRowWarps : kRowWarps;
    const int blocks = (n + rows - 1) / rows;
    switch ((d + 127) / 128) {  // float4 (or 4 scalars) a lane
      case 1: return launch_fwd_rows<1>(x, scale, bias, out, n, d, blocks, vec, eps, st);
      case 2: return launch_fwd_rows<2>(x, scale, bias, out, n, d, blocks, vec, eps, st);
      case 3: return launch_fwd_rows<3>(x, scale, bias, out, n, d, blocks, vec, eps, st);
      case 4: return launch_fwd_rows<4>(x, scale, bias, out, n, d, blocks, vec, eps, st);
      case 5: return launch_fwd_rows<5>(x, scale, bias, out, n, d, blocks, vec, eps, st);
      case 6: return launch_fwd_rows<6>(x, scale, bias, out, n, d, blocks, vec, eps, st);
      case 7: return launch_fwd_rows<7>(x, scale, bias, out, n, d, blocks, vec, eps, st);
      default: return launch_fwd_rows<8>(x, scale, bias, out, n, d, blocks, vec, eps, st);
    }
  }
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      layer_norm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) layer_norm_fwd_kernel<<<n, kThreads, smem, st>>>(x, scale, bias, out, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// route 0: rows (d <= 1024, vec: d % 4 == 0 and every row 16-byte
// aligned); route 1: wide. n_blocks blocks of `rows` rows each for pass 1.
extern "C" int layer_norm_bwd(const float* x, const float* scale, const float* g,
                              float* dx, float* ds_part, float* db_part, float* dscale,
                              float* dbias, int n, int d, int n_blocks, int rows,
                              int route, int vec, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (n_blocks > 0 && route == 0) {
    if (d > kRowMaxD || (vec && d % 4)) return static_cast<int>(cudaErrorInvalidValue);
    const int nv = (d + 127) / 128;   // float4 (or 4 scalars) a lane
    int r;
    switch (nv) {
      case 1: r = launch_rows<1>(x, scale, g, dx, ds_part, db_part, n, d, n_blocks, rows, vec, eps, st); break;
      case 2: r = launch_rows<2>(x, scale, g, dx, ds_part, db_part, n, d, n_blocks, rows, vec, eps, st); break;
      case 3: r = launch_rows<3>(x, scale, g, dx, ds_part, db_part, n, d, n_blocks, rows, vec, eps, st); break;
      case 4: r = launch_rows<4>(x, scale, g, dx, ds_part, db_part, n, d, n_blocks, rows, vec, eps, st); break;
      case 5: r = launch_rows<5>(x, scale, g, dx, ds_part, db_part, n, d, n_blocks, rows, vec, eps, st); break;
      case 6: r = launch_rows<6>(x, scale, g, dx, ds_part, db_part, n, d, n_blocks, rows, vec, eps, st); break;
      case 7: r = launch_rows<7>(x, scale, g, dx, ds_part, db_part, n, d, n_blocks, rows, vec, eps, st); break;
      default: r = launch_rows<8>(x, scale, g, dx, ds_part, db_part, n, d, n_blocks, rows, vec, eps, st); break;
    }
    if (r) return r;
  } else if (n_blocks > 0) {
    const size_t smem = 4 * static_cast<size_t>(d) * sizeof(float);
    err = cudaFuncSetAttribute(layer_norm_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    layer_norm_bwd_kernel<<<n_blocks, kThreads, smem, st>>>(x, scale, g, dx, ds_part,
                                                            db_part, n, d, rows, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  layer_norm_bwd_reduce_kernel<<<(d + kRedCols - 1) / kRedCols, kRedCols * kRedGroups, 0,
                                 st>>>(ds_part, db_part, dscale, dbias, n_blocks, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
