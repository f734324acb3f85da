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
// dominates. The backward reads x and g and writes dx, 3*N*D*4 bytes, with
// about 12 operations per element: at the training shape [8192, 768] that
// is 75.5 MB, 22.5 us.
//
// Forward design: one block per row, so no block waits on another and the
// grid needs no second pass. The row is read from device memory exactly
// once, into shared memory (D floats, no padding: threads stride the row
// by index and mask nothing). The mean is reduced first; then the CENTRED
// sum of squares over (x - mean), read back from shared memory, as the TPU
// kernel's `_stats` insists (E[x^2] - mean^2 cancels in float32 when
// |mean| >> std); then the affine output is written. The mean's sum runs
// in double and x - mean is formed in double before it is rounded, so a
// row riding at 1e4 keeps float32 accuracy in the centred values.
//
// Backward design: the TPU kernel sums dscale and dbias into one resident
// block across its SEQUENTIAL grid; a GPU grid runs in no order. So pass 1
// gives each block a contiguous run of rows: it recomputes the row
// statistics exactly as the forward does (same sums, same order), writes
// dx, and keeps per-column partials of g * x-hat and g in shared memory,
// then writes them once as [n_blocks, D]. Pass 2 sums the partials of
// each column over the blocks in block order. No atomics: the sums are the
// same bits on every run. Each thread owns the columns i = tid + k * 256
// of every row, so the shared row and partial buffers need no barrier
// beyond those of the block reductions.

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

// Pass 1 of the backward: rows [blockIdx.x * rows, ...) of one block.
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

// Pass 2: each column's partials summed in block order.
__global__ void layer_norm_bwd_reduce_kernel(const float* __restrict__ ds_part,
                                             const float* __restrict__ db_part,
                                             float* __restrict__ dscale,
                                             float* __restrict__ dbias, int n_blocks, int d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d) return;
  float a = 0.f, c = 0.f;
  for (int k = 0; k < n_blocks; ++k) {
    a += ds_part[static_cast<size_t>(k) * d + i];
    c += db_part[static_cast<size_t>(k) * d + i];
  }
  dscale[i] = a;
  dbias[i] = c;
}

}  // namespace

extern "C" int layer_norm_fwd(const float* x, const float* scale, const float* bias,
                              float* out, int n, int d, float eps, void* stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      layer_norm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0)
    layer_norm_fwd_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        x, scale, bias, out, d, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int layer_norm_bwd(const float* x, const float* scale, const float* g,
                              float* dx, float* ds_part, float* db_part, float* dscale,
                              float* dbias, int n, int d, int n_blocks, int rows,
                              float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 4 * static_cast<size_t>(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      layer_norm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks > 0) {
    layer_norm_bwd_kernel<<<n_blocks, kThreads, smem, st>>>(x, scale, g, dx, ds_part,
                                                            db_part, n, d, rows, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  layer_norm_bwd_reduce_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      ds_part, db_part, dscale, dbias, n_blocks, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
