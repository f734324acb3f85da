// Split-K flash decoding for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: elephas_tpu/ops/flash_decode.py `flash_decode_lse` (the Pallas
// `_decode_kernel_lse`): grouped decode attention of one query position per
// row against a dense cache. q [B, Hkv, G, Dh] float32, k/v [B, Hkv, T, Dh]
// float32 or bfloat16, pos [B] int32 -> out [B, Hkv, G, Dh] float32 and
// lse [B, Hkv, G] float32 (log of the softmax denominator). Row b sees
// cache slots 0..pos[b], cut to the last `window` of them under a sliding
// window; a ring cache masks by slot age (pos - j) mod T < min(window,
// pos + 1), exactly as decode_attention_reference_lse does.
//
// Bound on an H100: bytes. A decode step reads every K/V row up to pos
// once, 2 * Dh * sizeof(kv) bytes per visible slot and KV head, and does
// 4 * G * Dh operations on it: at G <= 8 that is at most 4 float32
// operations per byte, far below the ~20 at which the 67 TFLOP/s float32
// rate would bind. GPT-2-small decode with 8 slots and a full 1024-slot
// float32 cache reads ~50 MB per launch, ~15 us at 3.35 TB/s.
//
// Design: the TPU kernel walks T as a sequential grid axis and carries the
// online softmax in VMEM from one step to the next; a GPU grid has no
// order. So pass 1 splits T into `n_split` chunks, one block per (split,
// kv head, row), enough blocks to fill the 132 SMs at small batch. Each
// block reads pos[b] from device memory (no host sync), clips its chunk to
// the visible range and exits without reading K/V when nothing in it is
// visible, then streams its chunk through shared memory in 64-slot tiles
// (16-byte loads where Dh allows) and runs a float32 online softmax for all
// G queries of the group, which share every K/V tile. It writes an
// unnormalised partial (o, m, l) to scratch the wrapper allocates. Pass 2
// merges the partials of each (b, h, g) by log-sum-exp: o = sum_s
// exp(m_s - M) o_s / L, lse = M + log L. Simple first: no tensor cores,
// no TMA; those come when the kernel is made fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // cache slots per shared-memory tile

struct Params {
  const float* q;  // [B, Hkv, G, Dh]
  const void* k;   // [B, Hkv, T, Dh]
  const void* v;
  const int* pos;  // [B]
  float* o_part;   // [B, Hkv, n_split, G, Dh]
  float* m_part;   // [B, Hkv, n_split, G]
  float* l_part;   // [B, Hkv, n_split, G]
  float* out;      // [B, Hkv, G, Dh]
  float* lse;      // [B, Hkv, G]
  int B, Hkv, G, Dh, T, window, ring, n_split, chunk;
  float scale;
};

__device__ __forceinline__ bool visible(int j, int p, const Params& P) {
  if (P.ring) {
    int age = (p - j) % P.T;
    if (age < 0) age += P.T;
    return age < min(P.window, p + 1);
  }
  return j <= p && (P.window <= 0 || j > p - P.window);
}

// Copy `count` contiguous cache elements to float32 shared memory.
__device__ __forceinline__ void load_tile(const float* src, float* dst, int count,
                                          bool vec) {
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < count / 4; i += kThreads) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
  }
}

__device__ __forceinline__ void load_tile(const __nv_bfloat16* src, float* dst,
                                          int count, bool vec) {
  if (vec) {
    const uint2* s2 = reinterpret_cast<const uint2*>(src);  // 4 bf16 each
    for (int i = threadIdx.x; i < count / 4; i += kThreads) {
      const uint2 w = s2[i];
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
      const float2 fa = __bfloat1622float2(a);
      const float2 fb = __bfloat1622float2(b);
      dst[4 * i + 0] = fa.x;
      dst[4 * i + 1] = fa.y;
      dst[4 * i + 2] = fb.x;
      dst[4 * i + 3] = fb.y;
    }
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads)
      dst[i] = __bfloat162float(src[i]);
  }
}

template <typename KV>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(Params P) {
  extern __shared__ float smem[];
  const int G = P.G, Dh = P.Dh;
  float* sq = smem;                 // [G, Dh]
  float* sk = sq + G * Dh;          // [kTile, Dh]
  float* sv = sk + kTile * Dh;      // [kTile, Dh]
  float* ss = sv + kTile * Dh;      // [G, kTile] scores, then probabilities
  float* sacc = ss + G * kTile;     // [G, Dh] unnormalised output
  float* sm = sacc + G * Dh;        // [G] running max
  float* sl = sm + G;               // [G] running denominator
  float* salpha = sl + G;           // [G] rescale of the current tile

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = P.pos[b];
  const size_t bh = static_cast<size_t>(b) * P.Hkv + h;
  const size_t part = bh * P.n_split + split;
  float* o_part = P.o_part + part * G * Dh;
  float* m_part = P.m_part + part * G;
  float* l_part = P.l_part + part * G;

  // visible slots of this split: [lo, hi)
  int lo = split * P.chunk;
  int hi = min(lo + P.chunk, P.T);
  if (!P.ring) {
    hi = min(hi, p + 1);
    if (P.window > 0) lo = max(lo, p - P.window + 1);
  }
  if (lo >= hi) {  // nothing visible here: an empty partial, no K/V read
    for (int i = tid; i < G * Dh; i += kThreads) o_part[i] = 0.f;
    for (int g = tid; g < G; g += kThreads) {
      m_part[g] = -INFINITY;
      l_part[g] = 0.f;
    }
    return;
  }

  const float* q = P.q + bh * G * Dh;
  for (int i = tid; i < G * Dh; i += kThreads) {
    sq[i] = q[i];
    sacc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    sm[g] = -INFINITY;
    sl[g] = 0.f;
  }
  const KV* kb = static_cast<const KV*>(P.k) + bh * static_cast<size_t>(P.T) * Dh;
  const KV* vb = static_cast<const KV*>(P.v) + bh * static_cast<size_t>(P.T) * Dh;
  // 16-byte loads when every tile start is aligned: Dh % 4 == 0 keeps the
  // tile offsets aligned once the two base pointers are
  const bool vec = (Dh & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(kb) | reinterpret_cast<uintptr_t>(vb)) & 15) == 0;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);
    __syncthreads();  // the previous tile's readers are done
    load_tile(kb + static_cast<size_t>(t0) * Dh, sk, n * Dh, vec);
    load_tile(vb + static_cast<size_t>(t0) * Dh, sv, n * Dh, vec);
    __syncthreads();

    // scores: one warp per slot, lanes across Dh
    for (int jj = warp; jj < n; jj += kWarps) {
      const bool keep = visible(t0 + jj, p, P);
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
        for (int e = lane; e < Dh; e += 32) d += sq[g * Dh + e] * sk[jj * Dh + e];
        for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        if (lane == 0) ss[g * kTile + jj] = keep ? d * P.scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int jj = lane; jj < n; jj += 32) mx = fmaxf(mx, ss[g * kTile + jj]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int jj = lane; jj < n; jj += 32) {
        const float s = ss[g * kTile + jj];
        const float pj = s == -INFINITY ? 0.f : expf(s - m_new);
        ss[g * kTile + jj] = pj;
        psum += pj;
      }
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        // m_old == -inf means nothing was visible before: l and acc are 0
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        sl[g] = alpha * sl[g] + psum;
        sm[g] = m_new;
        salpha[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g, e] = alpha_g * acc[g, e] + sum_j p[g, j] * v[j, e]
    for (int i = tid; i < G * Dh; i += kThreads) {
      const int g = i / Dh, e = i - g * Dh;
      float a = sacc[i] * salpha[g];
      for (int jj = 0; jj < n; ++jj) a += ss[g * kTile + jj] * sv[jj * Dh + e];
      sacc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * Dh; i += kThreads) o_part[i] = sacc[i];
  for (int g = tid; g < G; g += kThreads) {
    m_part[g] = sm[g];
    l_part[g] = sl[g];
  }
}

// One block per (b, h, g): merge the n_split partials by log-sum-exp.
__global__ void decode_combine_kernel(Params P) {
  const int G = P.G, Dh = P.Dh, S = P.n_split;
  const size_t row = blockIdx.x;  // (b * Hkv + h) * G + g
  const int g = static_cast<int>(row % G);
  const size_t bh = row / G;
  const float* m = P.m_part + bh * S * G + g;  // stride G per split
  const float* l = P.l_part + bh * S * G + g;
  float M = -INFINITY;
  for (int s = 0; s < S; ++s)
    if (l[s * G] > 0.f) M = fmaxf(M, m[s * G]);
  float L = 0.f;
  for (int s = 0; s < S; ++s)
    if (l[s * G] > 0.f) L += l[s * G] * expf(m[s * G] - M);
  const float* o = P.o_part + (bh * S * G + g) * Dh;  // stride G*Dh per split
  for (int e = threadIdx.x; e < Dh; e += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      if (l[s * G] > 0.f) acc += expf(m[s * G] - M) * o[static_cast<size_t>(s) * G * Dh + e];
    P.out[row * Dh + e] = acc / L;
  }
  if (threadIdx.x == 0) P.lse[row] = M + logf(L);
}

template <typename KV>
int launch(const Params& P, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(P.G) * P.Dh + 2 * kTile * P.Dh + P.G * kTile + 3 * P.G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(P.n_split, P.Hkv, P.B);
  decode_split_kernel<KV><<<grid, kThreads, smem, stream>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = (P.Dh + 31) / 32;  // Dh <= 128: at most 4 warps
  const int threads = 32 * (warps < 4 ? warps : 4);
  decode_combine_kernel<<<P.B * P.Hkv * P.G, threads, 0, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_decode_lse(const float* q, const void* k, const void* v,
                                const int* pos, float* o_part, float* m_part,
                                float* l_part, float* out, float* lse, int B, int Hkv,
                                int G, int Dh, int T, int window, int ring, int n_split,
                                int chunk, float scale, int kv_bf16, void* stream) {
  const Params P{q, k, v, pos, o_part, m_part, l_part, out, lse,
                 B, Hkv, G, Dh, T, window, ring, n_split, chunk, scale};
  if (B == 0 || Hkv == 0 || G == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? launch<__nv_bfloat16>(P, st) : launch<float>(P, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
