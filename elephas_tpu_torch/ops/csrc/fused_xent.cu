// Fused per-sample categorical cross-entropy from logits for Hopper
// (sm_90a), forward and backward, plain C interface for ctypes.
//
// Replaces: elephas_tpu/ops/pallas_ops.py `fused_xent_from_logits` (the
// Pallas `_fwd_kernel`: per row, out = sum_j y_j * (lse(x) - x_j) with
// lse = log(sum_j exp(x_j - max x)) + max x) and its VJP `_fused_bwd` (the
// Pallas `_bwd_kernel`: dx = (softmax(x) - y) * g, the softmax recomputed
// from x alone). Logits are float32 or bf16 and every operation runs in
// float32; labels and g are float32; the forward writes float32 [B], the
// backward dx in the logits' type. Note the forward is the kernel's
// sum_j y_j * (lse - x_j), not lse - <y, x>: the two differ on rows whose
// labels do not sum to 1, and the backward is the latter's gradient. Both
// are kept as the TPU kernels have them.
//
// Bound on an H100: bytes. The forward reads x and y once each and writes
// one float a row, 2*B*C*4 + 4*B bytes at float32; the backward reads x, y
// and g and writes dx, 3*B*C*4 + 4*B. About 5 operations per element
// (one expf) is far below the ~20 float32 operations per byte at which the
// card's 67 TFLOP/s, not its 3.35 TB/s, would bind. At the MLP fit's shape
// [1024, 10] a call moves 86 KB, so the launch dominates.
//
// Design: the TPU pads B to 8-row blocks and C to 128 lanes with -1e30
// logits; here nothing is padded. A row belongs to one group of threads,
// which strides over its columns by index and masks nothing: a warp per
// row for C <= 1024 (eight rows a block), the whole 256-thread block per
// row above that. Each group makes three passes over its row, in the TPU
// kernel's order: the row max, then sum exp(x - max) (expf and logf, no
// fast-math intrinsics), then the output (forward: the sum of y * (lse -
// x); backward: dx = (exp(x - max) / sum - y) * g, written in place). No
// row waits on another and no sum crosses a block, so no second pass and
// no atomics: the same bits on every run. The second and third passes
// re-read x; for narrow rows that is L1, for wide rows (the 50257-class
// check) it costs up to two extra reads of x from device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWideRow = 1024;  // above this many classes: a block per row

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Max (kMax) or sum over the TPR threads of one row: a warp by shuffles, or
// the block through `red` (one value a warp, summed in warp order). Every
// thread of the row gets the result. The block form ends with a barrier so
// `red` can be reused at once.
template <int TPR, bool kMax>
__device__ __forceinline__ float row_reduce(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  if (TPR == 32) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < TPR / 32; ++w) t = kMax ? fmaxf(t, red[w]) : t + red[w];
  __syncthreads();
  return t;
}

// The row max and sum_j exp(x_j - max) of one row, over its TPR threads.
template <int TPR, typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ x, int c, int lane,
                                          float* red, float& m, float& s) {
  float mx = -INFINITY;
  for (int j = lane; j < c; j += TPR) mx = fmaxf(mx, to_f32(x[j]));
  m = row_reduce<TPR, true>(mx, red);
  float acc = 0.f;
  for (int j = lane; j < c; j += TPR) acc += expf(to_f32(x[j]) - m);
  s = row_reduce<TPR, false>(acc, red);
}

template <int TPR, typename T>
__global__ void __launch_bounds__(kThreads)
fused_xent_fwd_kernel(const T* __restrict__ x, const float* __restrict__ y,
                      float* __restrict__ out, int b, int c) {
  __shared__ float red[kThreads / 32];
  const int row = blockIdx.x * (kThreads / TPR) + threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  // a warp-per-row block may hang past the last row: the whole warp leaves
  // (its reductions are its own); a block-per-row grid has no such row
  if (row >= b) return;
  const size_t base = static_cast<size_t>(row) * c;
  float m, s;
  row_stats<TPR>(x + base, c, lane, red, m, s);
  const float lse = logf(s) + m;
  float acc = 0.f;
  for (int j = lane; j < c; j += TPR) acc += y[base + j] * (lse - to_f32(x[base + j]));
  acc = row_reduce<TPR, false>(acc, red);
  if (lane == 0) out[row] = acc;
}

template <int TPR, typename T>
__global__ void __launch_bounds__(kThreads)
fused_xent_bwd_kernel(const T* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ g, T* __restrict__ dx, int b, int c) {
  __shared__ float red[kThreads / 32];
  const int row = blockIdx.x * (kThreads / TPR) + threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  if (row >= b) return;
  const size_t base = static_cast<size_t>(row) * c;
  float m, s;
  row_stats<TPR>(x + base, c, lane, red, m, s);
  const float gr = g[row];
  for (int j = lane; j < c; j += TPR) {
    const float p = expf(to_f32(x[base + j]) - m) / s;
    store(dx + base + j, (p - y[base + j]) * gr);
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* y, float* out, int b, int c,
                       cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (c <= kWideRow) {
    const int rows = kThreads / 32;
    fused_xent_fwd_kernel<32, T><<<(b + rows - 1) / rows, kThreads, 0, stream>>>(
        xt, y, out, b, c);
  } else {
    fused_xent_fwd_kernel<kThreads, T><<<b, kThreads, 0, stream>>>(xt, y, out, b, c);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* y, const float* g, void* dx, int b,
                       int c, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* dxt = static_cast<T*>(dx);
  if (c <= kWideRow) {
    const int rows = kThreads / 32;
    fused_xent_bwd_kernel<32, T><<<(b + rows - 1) / rows, kThreads, 0, stream>>>(
        xt, y, g, dxt, b, c);
  } else {
    fused_xent_bwd_kernel<kThreads, T><<<b, kThreads, 0, stream>>>(xt, y, g, dxt, b, c);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// logits x [b, c] (float32, or bf16 when x_bf16), labels y [b, c] float32,
// out [b] float32; all contiguous on one device, b >= 1, c >= 1.
int fused_xent_fwd(const void* x, const void* y, void* out, int b, int c, int x_bf16,
                   void* stream) {
  const float* yf = static_cast<const float*>(y);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_fwd<__nv_bfloat16>(x, yf, of, b, c, s)
                : launch_fwd<float>(x, yf, of, b, c, s);
}

// As the forward, plus the cotangent g [b] float32 and dx [b, c] in the
// logits' type.
int fused_xent_bwd(const void* x, const void* y, const void* g, void* dx, int b, int c,
                   int x_bf16, void* stream) {
  const float* yf = static_cast<const float*>(y);
  const float* gf = static_cast<const float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_bwd<__nv_bfloat16>(x, yf, gf, dx, b, c, s)
                : launch_bwd<float>(x, yf, gf, dx, b, c, s);
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
