// Fused per-sample categorical cross-entropy from logits for Hopper
// (sm_90a), forward and backward, plain C interface for ctypes.
//
// Replaces: elephas_tpu/ops/pallas_ops.py `fused_xent_from_logits` (the
// Pallas `_fwd_kernel`: per row, out = sum_j y_j * (lse(x) - x_j) with
// lse = log(sum_j exp(x_j - max x)) + max x) and its VJP `_fused_bwd` (the
// Pallas `_bwd_kernel`: dx = (softmax(x) - y) * g, the softmax recomputed
// from x alone). Logits are float32, bf16 or fp16 and every operation runs
// in float32 (a 16-bit logit widens exactly); labels and g are float32; the
// forward writes float32 [B], the backward dx in the logits' type. Note the forward is the kernel's
// sum_j y_j * (lse - x_j), not lse - <y, x>: the two differ on rows whose
// labels do not sum to 1, and the backward is the latter's gradient. Both
// are kept as the TPU kernels have them.
//
// Bound on an H100: bytes. The forward reads x and y once each and writes
// one float a row, B*C*(sizeof x + 4) + 4*B bytes; the backward also reads
// g and writes dx. About 5 operations per element (one expf) is far below
// the ~20 float32 operations per byte at which the card's 67 TFLOP/s, not
// its 3.35 TB/s, would bind. At the MLP fit's shape [1024, 10] a call
// moves 86 KB, so the launch and one memory latency set its time.
//
// Design: every input byte is read from device memory once. Nothing is
// padded (the TPU padded B to 8-row blocks and C to 128 lanes with -1e30
// logits); each route masks the ragged edge by index. Within a row the
// order is the TPU kernel's: the row max, then sum exp(x - max) (expf and
// logf, no fast-math intrinsics; on routes 1 and 2 each CTA's part of the
// sum takes its own max and is rescaled once), then the output (forward:
// the sum of y * (lse - x); backward: dx = (exp(x - max) / sum - y) * g on
// rows of up to 128 classes, as the reference divides, and (exp(x - max) *
// (1 / sum) - y) * g on wider ones, which moves a fifth of the softmax by
// one ulp, well inside the 1e-6 pin, where the division cost up to 28% of
// the widest rows' time). No sum crosses a row except in the cluster's
// fixed rank order, and no atomics are used: the same bits on every run.
// The wrapper (`elephas_tpu_torch/ops/fused_xent.py` `xent_plan`) picks the
// route and its parameters and reads the constants below from this text;
// the C entry points validate them, and `fused_xent_launch_shape` reports
// the launch a plan makes. Three routes:
//  0 warp (C <= kWarpMax, the MLP fit's rows among them): one warp a row,
//    the row (at most 32 values a lane) in registers after its one read,
//    as float4 / 4 x bf16 at columns 4 (lane + 32 j) when C % 4 == 0 and
//    the rows are 16-byte aligned, else scalars at columns (4 j + e) * 32 +
//    lane. Three butterfly reductions (max, sum, and the forward's
//    output); the second and third passes load nothing. The fit's
//    card-against-CPU test hangs on the bits of its [1024, 10] rows (Adam
//    turns a rounding in a near-zero gradient into a whole step): they are
//    the scalar layout's, dividing.
//  1 cluster (the row fits eight CTAs' shared memory): a cluster of n <= 8
//    CTAs splits the row into slices of `slice` elements. Each CTA copies
//    its slice of x and of y into shared memory once, with one bulk copy
//    each (cp.async.bulk, completion on an mbarrier) over the 16-byte
//    aligned middle and scalar loads for the unaligned head and tail (at
//    C = 50257 a float32 row starts 4 mod 16). From shared memory it forms
//    its own max m_r and s_r = sum exp(x - m_r), each a block reduction
//    (each thread folds the elements lo + t, lo + t + 256, ... in order, a
//    butterfly in each warp, the warps in order), and pushes (m_r, s_r)
//    into every rank's shared memory through distributed shared memory,
//    each store followed by a remote arrival on that rank's mbarrier; a
//    slice of -inf logits (a masked block of a vocabulary) pushes s_r = 0,
//    where exp(-inf - -inf) would be NaN. No CTA waits at a cluster barrier
//    for a row: each waits for its own mbarrier's n arrivals (only the
//    start's cluster arrive / wait, split around the first two passes,
//    makes sure every CTA's barriers exist before anyone pushes). Each
//    merges in rank order, M = max m_r and S = sum_r s_r exp(m_r - M): one
//    rescale a CTA, where a per-element online rescale would add a rounding
//    to every term. The last pass runs from shared memory; the forward's
//    partials are pushed into rank 0, which adds them in rank order. A CTA
//    leaves once every push into it has arrived and it has made its own,
//    so none touches the shared memory of a CTA that has left.
//  2 stream (past the cluster's capacity): the same kernel with a cluster
//    of 8 and nothing staged: its passes read x (three times) and y from
//    device memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpMax = 1024;      // route 0: one warp a row up to this many classes
constexpr int kWarpRows = 4;        // route 0: rows (warps) a block
constexpr int kThreads = 256;       // routes 1 and 2: threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kSliceUnit = 8;       // a cluster slice is a multiple of this many elements
// dynamic shared memory a cluster CTA may take: the H100's 227 KB a block
// less 1 KB for the kernel's static shared memory
constexpr int kSmemBudget = 231424;

enum Route { kWarp = 0, kCluster = 1, kStream = 2 };

// the logits' type, as the wrapper codes it
enum XType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// bf16 to float is exact: the bits shifted up
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v)));
}
// fp16 to float is exact too; back, rounded to nearest even
__device__ __forceinline__ float f16_lo(uint32_t u) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(u & 0xffffu)));
}
__device__ __forceinline__ float f16_hi(uint32_t u) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(u >> 16)));
}
__device__ __forceinline__ uint32_t f16_bits(float v) {
  return static_cast<uint32_t>(__half_as_ushort(__float2half_rn(v)));
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store1(__half* p, float v) { *p = __float2half_rn(v); }

// four consecutive elements at p (16-byte aligned for float32, 8 for
// bf16 and fp16) widened to float, and back
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, float* v) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = bf16_lo(t.x), v[1] = bf16_hi(t.x), v[2] = bf16_lo(t.y), v[3] = bf16_hi(t.y);
  } else {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = f16_lo(t.x), v[1] = f16_hi(t.x), v[2] = f16_lo(t.y), v[3] = f16_hi(t.y);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ p, const float* v) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_bits(v[0]) | bf16_bits(v[1]) << 16,
                                              bf16_bits(v[2]) | bf16_bits(v[3]) << 16);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(f16_bits(v[0]) | f16_bits(v[1]) << 16,
                                              f16_bits(v[2]) | f16_bits(v[3]) << 16);
  }
}

// the butterfly leaves the same value, combined in the same order, in every lane
template <bool kMax>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  return v;
}

// Max or sum over the block's kThreads threads: a butterfly in each warp,
// then the warps' values in warp order. Every thread gets the result; the
// closing barrier lets `red` be reused at once.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = warp_reduce<kMax>(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t = kMax ? fmaxf(t, red[w]) : t + red[w];
  __syncthreads();
  return t;
}

// ---- route 0: one warp a row -----------------------------------------------------

// the lane's element (j, e): column 4 (lane + 32 j) + e when VEC, else
// (4 j + e) * 32 + lane
template <bool VEC>
__device__ __forceinline__ int warp_col(int lane, int j, int e) {
  return VEC ? 4 * (lane + 32 * j) + e : (4 * j + e) * 32 + lane;
}

template <typename T, int NV, bool VEC, bool BWD>
__global__ void __launch_bounds__(32 * kWarpRows)
xent_warp_kernel(const T* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ g, float* __restrict__ out, T* __restrict__ dx,
                 int b, int c) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= b) return;  // the whole warp leaves: its reductions are its own
  const size_t base = static_cast<size_t>(row) * c;
  float xv[NV][4], yv[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (VEC) {
      const int col = warp_col<true>(lane, j, 0);
      if (col < c) {  // c % 4 == 0: the whole vector is in the row
        load4(x + base + col, xv[j]);
        load4(y + base + col, yv[j]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) xv[j][e] = -INFINITY, yv[j][e] = 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = warp_col<false>(lane, j, e);
        xv[j][e] = col < c ? to_f32(x[base + col]) : -INFINITY;
        yv[j][e] = col < c ? y[base + col] : 0.f;
      }
    }
  }
  const float gr = BWD ? g[row] : 0.f;
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) m = fmaxf(m, xv[j][e]);
  m = warp_reduce<true>(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (warp_col<VEC>(lane, j, e) < c) {
        const float ex = expf(xv[j][e] - m);
        s += ex;
        if (BWD) xv[j][e] = ex;
      }
    }
  s = warp_reduce<false>(s);
  if (BWD) {
    // rows of up to 128 classes (NV 1) divide, as the reference does; the
    // wider variants multiply by 1 / s, where the division spilled. Only
    // the row's own elements are worked: dividing the -inf padding too cost
    // the fit's [1024, 10] backward a quarter of its time on the H100.
    const float inv = __frcp_rn(s);
    auto grad = [&](float ex, float yy) { return ((NV == 1 ? ex / s : ex * inv) - yy) * gr; };
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (VEC) {
        const int col = warp_col<true>(lane, j, 0);
        if (col < c) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] = grad(xv[j][e], yv[j][e]);
          store4(dx + base + col, d);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = warp_col<false>(lane, j, e);
          if (col < c) store1(dx + base + col, grad(xv[j][e], yv[j][e]));
        }
      }
    }
  } else {
    const float lse = logf(s) + m;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (warp_col<VEC>(lane, j, e) < c) acc += yv[j][e] * (lse - xv[j][e]);
    acc = warp_reduce<false>(acc);
    if (lane == 0) out[row] = acc;
  }
}

// ---- route 1: a row on chip across a thread-block cluster ------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes of shared memory for a slice: x and y, each from the 16-byte
// boundary at or below the slice's first element (the wrapper's
// `_cluster_smem`, which plans on the CPU, is held to the launch shape's)
__host__ __device__ __forceinline__ long long slice_bytes(long long slice, int elem) {
  return (((slice + 16 / elem) * elem + 15) / 16) * 16;
}

// Where elements [lo, hi) of one row of `src` go in shared memory: element j
// at dst[j - base], base being the element at the 16-byte boundary at or
// below lo; the aligned middle [ja, jb) by one bulk copy, the ends by
// scalar loads.
template <typename E>
struct Slice {
  int base, ja, jb;
};

template <typename E>
__device__ __forceinline__ Slice<E> slice_of(const E* src, int lo, int hi) {
  constexpr int kPer = 16 / sizeof(E);
  const int head = static_cast<int>((reinterpret_cast<uintptr_t>(src + lo) & 15) / sizeof(E));
  int ja = lo + (kPer - head) % kPer;  // the first 16-byte aligned element at or past lo
  int jb = hi - static_cast<int>((reinterpret_cast<uintptr_t>(src + hi) & 15) / sizeof(E));
  if (jb <= ja) ja = jb = hi;          // no aligned middle: every element by scalars
  return {lo - head, ja, jb};
}

template <typename E>
__device__ __forceinline__ uint32_t bulk_bytes(const Slice<E>& s) {
  return static_cast<uint32_t>(s.jb - s.ja) * sizeof(E);
}

// thread 0, after the barrier expects the bytes: the aligned middle
template <typename E>
__device__ __forceinline__ void bulk_copy(const E* src, E* dst, const Slice<E>& s,
                                          uint64_t* bar) {
  if (s.jb > s.ja)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(dst + (s.ja - s.base))),
        "l"(src + s.ja), "r"(bulk_bytes(s)), "r"(smem_addr(bar))
        : "memory");
}

// the threads of warp 1: the unaligned ends (fewer than 16 bytes each, or
// the whole of a slice too short for an aligned middle: under 32 bytes)
template <typename E>
__device__ __forceinline__ void scalar_ends(const E* src, E* dst, const Slice<E>& s, int lo,
                                            int hi) {
  const int t = static_cast<int>(threadIdx.x) - 32;
  if (t < 0 || t >= 32) return;
  if (t < s.ja - lo) dst[lo + t - s.base] = src[lo + t];
  if (t < hi - s.jb) dst[s.jb + t - s.base] = src[s.jb + t];
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// wait for phase 0 of a barrier of this CTA; CLUSTER: its arrivals came
// from other CTAs too, with their stores before them
template <bool CLUSTER>
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    if (CLUSTER)
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(bar))
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(bar))
          : "memory");
  }
}

// v into CTA `rank`'s copy of the shared variable at `local`, then one
// arrival on that CTA's barrier `bar`, released to the cluster so the
// store is seen by whoever sees the barrier complete
__device__ __forceinline__ void push(float* local, float v, uint64_t* bar, int rank) {
  asm volatile(
      "{\n.reg .b32 ra, rb;\nmapa.shared::cluster.u32 ra, %0, %2;\n"
      "mapa.shared::cluster.u32 rb, %1, %2;\nst.shared::cluster.f32 [ra], %3;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [rb];\n}\n" ::"r"(smem_addr(local)),
      "r"(smem_addr(bar)), "r"(rank), "f"(v)
      : "memory");
}

__device__ __forceinline__ void push2(float2* local, float2 v, uint64_t* bar, int rank) {
  asm volatile(
      "{\n.reg .b32 ra, rb;\nmapa.shared::cluster.u32 ra, %0, %2;\n"
      "mapa.shared::cluster.u32 rb, %1, %2;\nst.shared::cluster.v2.f32 [ra], {%3, %4};\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [rb];\n}\n" ::"r"(smem_addr(local)),
      "r"(smem_addr(bar)), "r"(rank), "f"(v.x), "f"(v.y)
      : "memory");
}

// Routes 1 (STAGED: the slice in shared memory) and 2 (streamed from
// device memory). Rank r of a cluster of n holds elements [r slice,
// (r + 1) slice) of row blockIdx.x / n. Each CTA forms its own max m_r and
// s_r = sum exp(x - m_r), and pushes (m_r, s_r) into every rank; each then
// merges them in rank order, M = max m_r and S = sum_r s_r exp(m_r - M)
// (one rescale a CTA), and runs the last pass with M and 1 / S.
template <typename T, bool BWD, bool STAGED>
__global__ void __launch_bounds__(kThreads)
xent_cluster_kernel(const T* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ g, float* __restrict__ out, T* __restrict__ dx,
                    int c, int slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  // 0: the slice's bulk copies; 1: the stats of every rank are in;
  // 2 (rank 0): the forward's partials of every rank are in
  __shared__ __align__(8) uint64_t bar[3];
  __shared__ float red[kWarps];
  __shared__ float2 stats[kMaxCluster];  // [rank]: (m_r, s_r), pushed by rank r
  __shared__ float part_out[kMaxCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / n;
  const int lo = rank * slice, hi = min(c, lo + slice);
  const size_t base = static_cast<size_t>(row) * c;
  const T* px = x + base;
  const float* py = y + base;
  T* sx = reinterpret_cast<T*>(smem);
  float* sy = reinterpret_cast<float*>(smem + slice_bytes(slice, sizeof(T)));
  const Slice<T> xs = slice_of(px, lo, hi);
  const Slice<float> ys = slice_of(py, lo, hi);
  auto xv = [&](int j) { return to_f32(STAGED ? sx[j - xs.base] : px[j]); };
  auto yv = [&](int j) { return STAGED ? sy[j - ys.base] : py[j]; };

  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], n);
    mbar_init(&bar[2], n);
    if (n > 1) asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (STAGED) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       smem_addr(&bar[0])),
                   "r"(bulk_bytes(xs) + bulk_bytes(ys))
                   : "memory");
      bulk_copy(px, sx, xs, &bar[0]);
      bulk_copy(py, sy, ys, &bar[0]);
    }
  }
  if (STAGED) {
    scalar_ends(px, sx, xs, lo, hi);
    scalar_ends(py, sy, ys, lo, hi);
  }
  __syncthreads();  // the scalar ends are in, and the barriers are initialised
  // this CTA's barriers are initialised: waited for before the first push
  // (a cluster of one exchanges nothing: its own m_r and s_r are the row's,
  // the same bits as the merge, whose one term is s_0 exp(0) = s_0)
  if (n > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (STAGED) mbar_wait0<false>(&bar[0]);

  float m = -INFINITY;
#pragma unroll 4
  for (int j = lo + threadIdx.x; j < hi; j += kThreads) m = fmaxf(m, xv(j));
  m = block_reduce<true>(m, red);
  float s = 0.f;
#pragma unroll 4
  for (int j = lo + threadIdx.x; j < hi; j += kThreads) s += expf(xv(j) - m);
  s = block_reduce<false>(s, red);
  if (m == -INFINITY) s = 0.f;  // a slice of -inf logits adds nothing to the row's sum
  if (n > 1) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (threadIdx.x < n) push2(&stats[rank], make_float2(m, s), &bar[1], threadIdx.x);
    mbar_wait0<true>(&bar[1]);
    m = stats[0].x;
    for (int r = 1; r < n; ++r) m = fmaxf(m, stats[r].x);
    s = 0.f;
    for (int r = 0; r < n; ++r) s += stats[r].y * expf(stats[r].x - m);
  }

  if (BWD) {
    const float inv = __frcp_rn(s), gr = g[row];
#pragma unroll 4
    for (int j = lo + threadIdx.x; j < hi; j += kThreads)
      store1(dx + base + j, (expf(xv(j) - m) * inv - yv(j)) * gr);
  } else {
    const float lse = logf(s) + m;
    float acc = 0.f;
#pragma unroll 4
    for (int j = lo + threadIdx.x; j < hi; j += kThreads) acc += yv(j) * (lse - xv(j));
    acc = block_reduce<false>(acc, red);
    if (n == 1) {
      if (threadIdx.x == 0) out[row] = acc;
      return;
    }
    if (threadIdx.x == 0) push(&part_out[rank], acc, &bar[2], 0);
    if (rank == 0 && threadIdx.x == 0) {
      mbar_wait0<true>(&bar[2]);
      float t = part_out[0];
      for (int r = 1; r < n; ++r) t += part_out[r];
      out[row] = t;
    }
  }
}

// ---- launchers -------------------------------------------------------------------

template <typename T>
struct Args {
  const T* x;
  const float* y;
  const float* g;
  float* out;
  T* dx;
  int b, c;
};

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The launch a plan makes over b rows of c classes with elem-byte logits,
// or cudaErrorInvalidValue for a plan its route does not take.
struct Shape {
  int blocks, threads, smem;
};

inline cudaError_t shape_of(int b, int c, int elem, int route, int vec, int n, int slice,
                            Shape* s) {
  if (b < 1 || c < 1) return cudaErrorInvalidValue;
  switch (route) {
    case kWarp:
      if (c > kWarpMax || (vec != 1 && vec != 4) || c % vec) return cudaErrorInvalidValue;
      *s = {(b + kWarpRows - 1) / kWarpRows, 32 * kWarpRows, 0};
      return cudaSuccess;
    case kCluster:
    case kStream: {
      // every rank holds at least one element, the slices cover the row,
      // and a staged slice fits the shared-memory budget
      if (n < 1 || n > kMaxCluster || slice < 1 || slice % kSliceUnit ||
          static_cast<long long>(n) * slice < c || static_cast<long long>(n - 1) * slice >= c ||
          static_cast<long long>(b) * n >= (1ll << 31))
        return cudaErrorInvalidValue;
      const long long smem = route == kCluster ? slice_bytes(slice, elem) + slice_bytes(slice, 4)
                                               : 0;
      if (smem > kSmemBudget) return cudaErrorInvalidValue;
      *s = {b * n, kThreads, static_cast<int>(smem)};
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool BWD, int NV>
cudaError_t warp_route(const Args<T>& a, int vec, const Shape& s, cudaStream_t st) {
  if (vec == 4) {
    if (!aligned(a.x, 4 * sizeof(T)) || !aligned(a.y, 16) || (BWD && !aligned(a.dx, 4 * sizeof(T))))
      return cudaErrorInvalidValue;
    xent_warp_kernel<T, NV, true, BWD><<<s.blocks, s.threads, 0, st>>>(a.x, a.y, a.g, a.out,
                                                                       a.dx, a.b, a.c);
  } else {
    xent_warp_kernel<T, NV, false, BWD><<<s.blocks, s.threads, 0, st>>>(a.x, a.y, a.g, a.out,
                                                                        a.dx, a.b, a.c);
  }
  return cudaGetLastError();
}

template <typename T, bool BWD, bool STAGED>
cudaError_t cluster_route(const Args<T>& a, int n, int slice, const Shape& s, cudaStream_t st) {
  auto kernel = xent_cluster_kernel<T, BWD, STAGED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         s.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s.blocks);
  cfg.blockDim = dim3(s.threads);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n > 1;  // a cluster of one is a plain launch
  err = cudaLaunchKernelEx(&cfg, kernel, a.x, a.y, a.g, a.out, a.dx, a.c, slice);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool BWD>
cudaError_t launch(const Args<T>& a, int route, int vec, int n, int slice, cudaStream_t st) {
  Shape s;
  const cudaError_t err = shape_of(a.b, a.c, sizeof(T), route, vec, n, slice, &s);
  if (err != cudaSuccess) return err;
  if (route == kWarp) {
    if (a.c <= 128) return warp_route<T, BWD, 1>(a, vec, s, st);
    if (a.c <= 256) return warp_route<T, BWD, 2>(a, vec, s, st);
    if (a.c <= 512) return warp_route<T, BWD, 4>(a, vec, s, st);
    return warp_route<T, BWD, 8>(a, vec, s, st);
  }
  return route == kCluster ? cluster_route<T, BWD, true>(a, n, slice, s, st)
                           : cluster_route<T, BWD, false>(a, n, slice, s, st);
}

template <bool BWD>
int dispatch(const void* x, const void* y, const void* g, float* out, void* dx, int b, int c,
             int x_type, int route, int vec, int n, int slice, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  const float* gf = static_cast<const float*>(g);
  switch (x_type) {
    case kF32: {
      const Args<float> a{static_cast<const float*>(x), yf, gf, out, static_cast<float*>(dx),
                          b, c};
      return static_cast<int>(launch<float, BWD>(a, route, vec, n, slice, st));
    }
    case kBF16: {
      const Args<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(x), yf, gf, out,
                                  static_cast<__nv_bfloat16*>(dx), b, c};
      return static_cast<int>(launch<__nv_bfloat16, BWD>(a, route, vec, n, slice, st));
    }
    case kF16: {
      const Args<__half> a{static_cast<const __half*>(x), yf, gf, out, static_cast<__half*>(dx),
                           b, c};
      return static_cast<int>(launch<__half, BWD>(a, route, vec, n, slice, st));
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// logits x [b, c] of x_type (0 float32, 1 bf16, 2 fp16), labels y [b, c] float32,
// out [b] float32; all contiguous on one device, b >= 1, c >= 1. route:
// 0 warp (vec 1 or 4 elements a load), 1 cluster (n CTAs a row, each
// `slice` elements), 2 stream; the wrapper's `xent_plan` chooses them.
// Returns a cudaError_t: cudaErrorInvalidValue for parameters the route
// does not take.
int fused_xent_fwd(const void* x, const void* y, void* out, int b, int c, int x_type, int route,
                   int vec, int n, int slice, void* stream) {
  return dispatch<false>(x, y, nullptr, static_cast<float*>(out), nullptr, b, c, x_type, route,
                         vec, n, slice, stream);
}

// As the forward, plus the cotangent g [b] float32 and dx [b, c] in the
// logits' type.
int fused_xent_bwd(const void* x, const void* y, const void* g, void* dx, int b, int c,
                   int x_type, int route, int vec, int n, int slice, void* stream) {
  return dispatch<true>(x, y, g, nullptr, dx, b, c, x_type, route, vec, n, slice, stream);
}

// The launch a plan makes, without launching: shape[0] blocks of shape[1]
// threads, each with shape[2] bytes of dynamic shared memory. Returns the
// entry points' cudaErrorInvalidValue for a plan they refuse (alignment,
// which depends on the pointers, aside).
int fused_xent_launch_shape(int b, int c, int x_type, int route, int vec, int n, int slice,
                            int* shape) {
  Shape s;
  if (x_type < kF32 || x_type > kF16) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = shape_of(b, c, x_type == kF32 ? 4 : 2, route, vec, n, slice, &s);
  if (err == cudaSuccess) shape[0] = s.blocks, shape[1] = s.threads, shape[2] = s.smem;
  return static_cast<int>(err);
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
