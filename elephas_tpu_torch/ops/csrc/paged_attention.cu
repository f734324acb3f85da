// Paged attention for Hopper (sm_90a): single-token decode and multi-row
// chunk attention read straight out of a KV page pool through a block
// table, plain C interface for ctypes.
//
// Replaces: elephas_tpu/ops/paged_attention.py `paged_flash_decode_lse`
// (the Pallas `_paged_decode_kernel_lse`) and `paged_flash_chunk`
// (`_paged_chunk_kernel`). One layer's pool k/v [P, Hkv, page, Dh] float32
// or bfloat16, the block table [S, M] int32 (slot s's logical page m lives
// in pool page table[s, m]; unmapped cells hold 0, the trash page), q
// float32. Decode: q [S, Hkv, G, Dh], pos [S] -> out [S, Hkv, G, Dh] and
// lse [S, Hkv, G] float32; slot s sees positions 0..pos[s]. Chunk: q
// [S, Hkv, G, C, Dh] (row r = g*C + c at position pos0[s] + c), pos0 [S]
// -> out [S, Hkv, G, C, Dh] float32; row r sees positions 0..its own. A
// sliding window keeps the last `window` positions. Positions are clipped
// to the table's M*page, exactly as the plain versions' gathered view is.
//
// Bound on an H100. Decode: bytes, as the dense K4: every live K/V row of
// the slot read once, 2*Dh*sizeof(kv) bytes per visible position and KV
// head, against 4*G*Dh operations. Chunk at prefill (C up to 1024 rows per
// slot): operations, 4*Dh per visible (query, key) pair, as the flash
// attention forward.
//
// Design. The TPU walks the logical pages as a sequential grid axis, its
// index map dereferencing the table (scalar prefetch) and clamping at the
// last live page, with the online softmax carried in VMEM. A GPU grid has
// no order, so:
// - decode is split-K flash decoding, as K4 (flash_decode.cu): one block per
//   (split, KV head, slot) over a range of positions clipped to the slot's
//   visible range [max(pos - window + 1, 0), pos] (no K/V read past pos,
//   an empty split exits at once), then a log-sum-exp combine of the
//   partials. `pos` stays on the device;
// - chunk is one block per (tile of query rows, KV head, slot), looping over
//   the key tiles up to its last row's position, with an online softmax per
//   row, as the flash attention forward (flash_attention.cu): 16 x 16
//   threads, register-blocked SIMT float32 products, shared tiles padded by
//   one float against bank conflicts. Rows past G*C are masked by index.
// Both gather a 64-row key tile page by page: each row's pool offset comes
// from the table once per tile (a table cell outside [0, P) reads the trash
// page, so nothing is ever addressed outside the pool), then each row of Dh
// contiguous elements is one coalesced load (16 bytes a thread where Dh
// allows). A page smaller than the tile fills it from several pages; a
// larger one over several tiles. Masked scores are -inf and their weight is
// exactly 0, so the trash page's finite garbage never reaches an output.
// Simple first: no tensor cores, no TMA, no pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;  // key rows per shared-memory tile

struct Pool {
  const void* k;     // [P, Hkv, page, Dh]
  const void* v;
  const int* table;  // [S, M]
  int P, Hkv, page, M, Dh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);  // 4 bf16
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Element offset in the pool of position j of slot s, KV head h.
__device__ __forceinline__ long long row_offset(const Pool& pl, int s, int h, int j) {
  const int m = j / pl.page;
  int pid = pl.table[static_cast<size_t>(s) * pl.M + m];
  if (pid < 0 || pid >= pl.P) pid = 0;
  return ((static_cast<long long>(pid) * pl.Hkv + h) * pl.page + (j - m * pl.page)) *
         pl.Dh;
}

// True when rows of Dh elements can be read 16 bytes (float) or 8 bytes
// (bf16) at a time: every row offset is a multiple of Dh.
template <typename E>
__device__ __forceinline__ bool vector_rows(const Pool& pl) {
  const uintptr_t a =
      reinterpret_cast<uintptr_t>(pl.k) | reinterpret_cast<uintptr_t>(pl.v);
  return (pl.Dh & 3) == 0 && (a & (4 * sizeof(E) - 1)) == 0;
}

// Gather `rows` tile rows into dst[r * ld + c] for c < Dh: rows < n from
// the pool at their offsets `roff`, the rest zero.
template <typename E, int NT>
__device__ __forceinline__ void gather_rows(const E* base, const long long* roff, int n,
                                            int rows, int Dh, int ld, bool vec, float* dst) {
  if (vec) {
    const int q4 = Dh >> 2;
    for (int i = threadIdx.x; i < rows * q4; i += NT) {
      const int r = i / q4, c = (i - r * q4) * 4;
      const float4 x = r < n ? load4(base + roff[r] + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      float* d = dst + r * ld + c;
      d[0] = x.x;
      d[1] = x.y;
      d[2] = x.z;
      d[3] = x.w;
    }
  } else {
    for (int i = threadIdx.x; i < rows * Dh; i += NT) {
      const int r = i / Dh, c = i - r * Dh;
      dst[r * ld + c] = r < n ? to_f32(base[roff[r] + c]) : 0.f;
    }
  }
}

// ---- decode: split-K over the slot's positions, then a combine -------------

constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;

struct Decode {
  const float* q;  // [S, Hkv, G, Dh]
  const int* pos;  // [S]
  float* o_part;   // [S, Hkv, n_split, G, Dh]
  float* m_part;   // [S, Hkv, n_split, G]
  float* l_part;
  float* out;      // [S, Hkv, G, Dh]
  float* lse;      // [S, Hkv, G]
  int S, G, window, n_split, chunk;
  float scale;
};

template <typename KV>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_split_kernel(Pool pl, Decode P) {
  extern __shared__ long long smem_ll[];
  long long* sroff = smem_ll;                       // [kTile] row offsets
  float* sq = reinterpret_cast<float*>(sroff + kTile);  // [G, Dh]
  const int G = P.G, Dh = pl.Dh;
  float* sk = sq + G * Dh;          // [kTile, Dh]
  float* sv = sk + kTile * Dh;      // [kTile, Dh]
  float* ss = sv + kTile * Dh;      // [G, kTile] scores, then probabilities
  float* sacc = ss + G * kTile;     // [G, Dh] unnormalised output
  float* sm = sacc + G * Dh;        // [G] running max
  float* sl = sm + G;               // [G] running denominator
  float* salpha = sl + G;           // [G] rescale of the current tile

  const int split = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = P.pos[s];
  const size_t sh = static_cast<size_t>(s) * pl.Hkv + h;
  const size_t part = sh * P.n_split + split;
  float* o_part = P.o_part + part * G * Dh;
  float* m_part = P.m_part + part * G;
  float* l_part = P.l_part + part * G;

  // visible positions of this split: [lo, hi), never past pos or M*page
  int lo = split * P.chunk;
  int hi = min(min(lo + P.chunk, pl.M * pl.page), p + 1);
  if (P.window > 0) lo = max(lo, p - P.window + 1);
  if (lo >= hi) {  // nothing visible here: an empty partial, no K/V read
    for (int i = tid; i < G * Dh; i += kDecodeThreads) o_part[i] = 0.f;
    for (int g = tid; g < G; g += kDecodeThreads) {
      m_part[g] = -INFINITY;
      l_part[g] = 0.f;
    }
    return;
  }

  const float* q = P.q + sh * G * Dh;
  for (int i = tid; i < G * Dh; i += kDecodeThreads) {
    sq[i] = q[i];
    sacc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kDecodeThreads) {
    sm[g] = -INFINITY;
    sl[g] = 0.f;
  }
  const KV* kb = static_cast<const KV*>(pl.k);
  const KV* vb = static_cast<const KV*>(pl.v);
  const bool vec = vector_rows<KV>(pl);

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int jj = tid; jj < n; jj += kDecodeThreads) sroff[jj] = row_offset(pl, s, h, t0 + jj);
    __syncthreads();
    gather_rows<KV, kDecodeThreads>(kb, sroff, n, n, Dh, Dh, vec, sk);
    gather_rows<KV, kDecodeThreads>(vb, sroff, n, n, Dh, Dh, vec, sv);
    __syncthreads();

    // scores: one warp per position, lanes across Dh (all of [lo, hi) is
    // visible)
    for (int jj = warp; jj < n; jj += kDecodeWarps) {
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
        for (int e = lane; e < Dh; e += 32) d += sq[g * Dh + e] * sk[jj * Dh + e];
        for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        if (lane == 0) ss[g * kTile + jj] = d * P.scale;
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int g = warp; g < G; g += kDecodeWarps) {
      float mx = -INFINITY;
      for (int jj = lane; jj < n; jj += 32) mx = fmaxf(mx, ss[g * kTile + jj]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int jj = lane; jj < n; jj += 32) {
        const float pj = expf(ss[g * kTile + jj] - m_new);
        ss[g * kTile + jj] = pj;
        psum += pj;
      }
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        // m_old == -inf means nothing was seen before: l and acc are 0
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        sl[g] = alpha * sl[g] + psum;
        sm[g] = m_new;
        salpha[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g, e] = alpha_g * acc[g, e] + sum_j p[g, j] * v[j, e]
    for (int i = tid; i < G * Dh; i += kDecodeThreads) {
      const int g = i / Dh, e = i - g * Dh;
      float a = sacc[i] * salpha[g];
      for (int jj = 0; jj < n; ++jj) a += ss[g * kTile + jj] * sv[jj * Dh + e];
      sacc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * Dh; i += kDecodeThreads) o_part[i] = sacc[i];
  for (int g = tid; g < G; g += kDecodeThreads) {
    m_part[g] = sm[g];
    l_part[g] = sl[g];
  }
}

// One block per (s, h, g): merge the n_split partials by log-sum-exp.
__global__ void paged_decode_combine_kernel(Pool pl, Decode P) {
  const int G = P.G, Dh = pl.Dh, NS = P.n_split;
  const size_t row = blockIdx.x;  // (s * Hkv + h) * G + g
  const int g = static_cast<int>(row % G);
  const size_t sh = row / G;
  const float* m = P.m_part + sh * NS * G + g;  // stride G per split
  const float* l = P.l_part + sh * NS * G + g;
  float M = -INFINITY;
  for (int i = 0; i < NS; ++i)
    if (l[i * G] > 0.f) M = fmaxf(M, m[i * G]);
  float L = 0.f;
  for (int i = 0; i < NS; ++i)
    if (l[i * G] > 0.f) L += l[i * G] * expf(m[i * G] - M);
  const float* o = P.o_part + (sh * NS * G + g) * Dh;  // stride G*Dh per split
  for (int e = threadIdx.x; e < Dh; e += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < NS; ++i)
      if (l[i * G] > 0.f) acc += expf(m[i * G] - M) * o[static_cast<size_t>(i) * G * Dh + e];
    P.out[row * Dh + e] = acc / L;
  }
  if (threadIdx.x == 0) P.lse[row] = M + logf(L);
}

size_t decode_smem(int G, int Dh) {
  return sizeof(long long) * kTile +
         sizeof(float) * (2 * static_cast<size_t>(G) * Dh + 2 * kTile * Dh + G * kTile + 3 * G);
}

template <typename KV>
int decode(const Pool& pl, const Decode& P, cudaStream_t stream) {
  const size_t smem = decode_smem(P.G, pl.Dh);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_split_kernel<KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(P.n_split, pl.Hkv, P.S);
  paged_decode_split_kernel<KV><<<grid, kDecodeThreads, smem, stream>>>(pl, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = (pl.Dh + 31) / 32;
  const int threads = 32 * (warps < 4 ? warps : 4);
  paged_decode_combine_kernel<<<P.S * pl.Hkv * P.G, threads, 0, stream>>>(pl, P);
  return static_cast<int>(cudaGetLastError());
}

// ---- chunk: one block per (row tile, KV head, slot) ---------------------------

constexpr int kChunkThreads = 256;

struct Chunk {
  const float* q;   // [S, Hkv, R, Dh], R = G * C
  const int* pos0;  // [S]
  float* out;       // [S, Hkv, R, Dh]
  int S, G, C, window;
  float scale;
};

template <int DH, int BQ, int BK>
struct ChunkTiles {
  static constexpr int LD = DH + 1;   // padded row of a [rows][DH] tile
  static constexpr int LDS = BK + 1;  // padded row of the [BQ][BK] scores
  static constexpr size_t smem = sizeof(long long) * BK +
                                 sizeof(float) * (BQ * LD + 2 * BK * LD + BQ * LDS + 3 * BQ) +
                                 sizeof(int) * BQ;
};

template <typename E, int DH, int BQ, int BK>
__global__ void __launch_bounds__(kChunkThreads)
paged_chunk_kernel(Pool pl, Chunk P) {
  using Tl = ChunkTiles<DH, BQ, BK>;
  constexpr int LD = Tl::LD, LDS = Tl::LDS;
  constexpr int RQ = BQ / 16, RK = BK / 16, RD = DH / 16;
  constexpr int TPR = kChunkThreads / BQ;  // threads per score row
  extern __shared__ long long smem_ll[];
  long long* sroff = smem_ll;                          // [BK]
  float* sQ = reinterpret_cast<float*>(sroff + BK);    // [BQ][LD]
  float* sK = sQ + BQ * LD;                            // [BK][LD]
  float* sV = sK + BK * LD;                            // [BK][LD]
  float* sS = sV + BK * LD;                            // [BQ][LDS]
  float* sM = sS + BQ * LDS;
  float* sL = sM + BQ;
  float* sA = sL + BQ;
  int* sPos = reinterpret_cast<int*>(sA + BQ);         // [BQ] query positions

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * BQ, h = blockIdx.y, s = blockIdx.z;
  const int C = P.C, R = P.G * C, Dh = pl.Dh;
  const int p0 = P.pos0[s];
  const size_t sh = static_cast<size_t>(s) * pl.Hkv + h;

  const float* q = P.q + sh * R * Dh;
  for (int i = tid; i < BQ * DH; i += kChunkThreads) {
    const int r = i / DH, d = i - r * DH;
    sQ[r * LD + d] = (r0 + r < R && d < Dh) ? q[static_cast<size_t>(r0 + r) * Dh + d] : 0.f;
  }
  // the gathers write columns < Dh only: the padding columns stay zero
  for (int i = tid; i < 2 * BK * LD; i += kChunkThreads) sK[i] = 0.f;
  for (int r = tid; r < BQ; r += kChunkThreads) {
    sPos[r] = r0 + r < R ? p0 + (r0 + r) % C : -1;
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }
  float acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  // keys this tile's rows can see: [k_lo, k_hi)
  const int r_last = min(r0 + BQ, R) - 1;
  const bool one_group = r0 / C == r_last / C;
  const int c_min = one_group ? r0 % C : 0;
  const int c_max = one_group ? r_last % C : C - 1;
  const int k_hi = min(p0 + c_max + 1, pl.M * pl.page);
  const int k_lo = P.window > 0 ? max(0, p0 + c_min - P.window + 1) : 0;
  const E* kb = static_cast<const E*>(pl.k);
  const E* vb = static_cast<const E*>(pl.v);
  const bool vec = vector_rows<E>(pl);

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    const int n = min(BK, k_hi - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int jj = tid; jj < n; jj += kChunkThreads) sroff[jj] = row_offset(pl, s, h, k0 + jj);
    __syncthreads();
    gather_rows<E, kChunkThreads>(kb, sroff, n, BK, Dh, LD, vec, sK);
    gather_rows<E, kChunkThreads>(vb, sroff, n, BK, Dh, LD, vec, sV);
    __syncthreads();

    float sc[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) sc[i][j] = 0.f;
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
        for (int j = 0; j < RK; ++j) sc[i][j] = fmaf(a[i], c[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i, qp = sPos[r];
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int c = tx + 16 * j, key = k0 + c;
        const bool keep = c < n && key <= qp && (P.window <= 0 || key > qp - P.window);
        sS[r * LDS + c] = keep ? sc[i][j] * P.scale : -INFINITY;
      }
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
        const float pr = m_new == -INFINITY ? 0.f : expf(sv - m_new);
        sS[r * LDS + c] = pr;
        sum += pr;
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
      float pr[RQ], c[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pr[i] = sS[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < RD; ++j) c[j] = sV[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(pr[i], c[j], acc[i][j]);
    }
  }
  __syncthreads();

  float* out = P.out + sh * R * Dh;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
    if (r0 + r >= R) continue;
    const float l = sL[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = out + static_cast<size_t>(r0 + r) * Dh;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int d = tx + 16 * j;
      if (d < Dh) orow[d] = acc[i][j] * inv;
    }
  }
}

template <typename E, int DH, int BQ, int BK>
int chunk(const Pool& pl, const Chunk& P, cudaStream_t st) {
  const size_t smem = ChunkTiles<DH, BQ, BK>::smem;
  auto kernel = paged_chunk_kernel<E, DH, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = P.G * P.C;
  const dim3 grid((R + BQ - 1) / BQ, pl.Hkv, P.S);
  kernel<<<grid, kChunkThreads, smem, st>>>(pl, P);
  return static_cast<int>(cudaGetLastError());
}

// Dh <= 64, <= 128, <= 256 pick the tile class; the wrapper refuses Dh > 256.
template <typename E>
int chunk_any(const Pool& pl, const Chunk& P, cudaStream_t st) {
  if (pl.Dh <= 64) return chunk<E, 64, 64, 64>(pl, P, st);
  if (pl.Dh <= 128) return chunk<E, 128, 64, 64>(pl, P, st);
  return chunk<E, 256, 32, 32>(pl, P, st);
}

}  // namespace

extern "C" int paged_decode_lse(const float* q, const void* k, const void* v,
                                const int* table, const int* pos, float* o_part,
                                float* m_part, float* l_part, float* out, float* lse, int S,
                                int Hkv, int G, int Dh, int P, int page, int M, int window,
                                int n_split, int chunk_len, float scale, int kv_bf16,
                                void* stream) {
  const Pool pl{k, v, table, P, Hkv, page, M, Dh};
  const Decode D{q, pos, o_part, m_part, l_part, out, lse, S, G, window, n_split, chunk_len,
                 scale};
  if (S == 0 || Hkv == 0 || G == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? decode<__nv_bfloat16>(pl, D, st) : decode<float>(pl, D, st);
}

extern "C" int paged_chunk(const float* q, const void* k, const void* v, const int* table,
                           const int* pos0, float* out, int S, int Hkv, int G, int C, int Dh,
                           int P, int page, int M, int window, float scale, int kv_bf16,
                           void* stream) {
  const Pool pl{k, v, table, P, Hkv, page, M, Dh};
  const Chunk D{q, pos0, out, S, G, C, window, scale};
  if (S == 0 || Hkv == 0 || G == 0 || C == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? chunk_any<__nv_bfloat16>(pl, D, st) : chunk_any<float>(pl, D, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
