// Fused LayerNorm forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: elephas_tpu/ops/layer_norm.py `fused_layer_norm` (the Pallas
// `_fwd_kernel` with `_stats`): LayerNorm over the last axis of [N, D]
// float32 rows, centred variance, affine scale and bias, float32 output.
//
// Bound on an H100: bytes. Each row is read once and written once,
// 2*N*D*4 bytes (plus 2*D*4 for scale and bias); about 8 operations per
// element is far below the ~20 float32 operations per byte at which the
// card's 67 TFLOP/s, not its 3.35 TB/s, would be the limit. At the decode
// shape [8, 768] the whole call moves 55 KB, so the launch dominates.
//
// Design: one block per row, so no block waits on another and the grid
// needs no second pass. The row is read from device memory exactly once,
// into shared memory (D floats, no padding: threads stride the row by
// index and mask nothing). The mean is reduced first; then the CENTRED
// sum of squares over (x - mean), read back from shared memory, as the
// TPU kernel's `_stats` insists (E[x^2] - mean^2 cancels in float32 when
// |mean| >> std); then the affine output is written. The mean's sum runs
// in double and x - mean is formed in double before it is rounded, so a
// row riding at 1e4 keeps float32 accuracy in the centred values.

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

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
