// Split-K flash decoding for Hopper (sm_90a), shared by the dense decode
// (flash_decode.cu, K4) and the paged decode (paged_attention.cu,
// K5-decode): one query position per (slot, KV head), the G query rows of
// its group, against the slot's cached K/V rows up to pos, with the lse.
// Device code and its launch only, in an anonymous namespace; each source
// that includes it instantiates it with its own row-addressing policy.
//
// Rows. Both caches have one layout, K/V [P, Hkv, page, Dh] float32 or
// bfloat16: a dense cache [B, Hkv, T, Dh] is B pages of T rows. Logical
// row j of slot s sits in page id(s, j / page) at row j % page. The paged
// policy (PagedRows) reads id from the block table [S, M], and a cell
// outside [0, P) reads the trash page 0; the dense one (DenseRows) returns
// s, so a ring cache's logical positions past T wrap round the slot's one
// page: position j lives in slot j mod T.
//
// The visible range of a slot at pos is the logical rows [lo, hi):
// - ring (dense only): the n = min(window, pos + 1, T) positions ending at
//   pos, [pos - n + 1, pos + 1), each in slot j mod T, so a tile may wrap;
// - otherwise hi = min(pos, cap - 1) + 1 (cap = M * page, or T) and lo =
//   max(0, pos - window + 1) under a window, else 0. lo comes from the
//   unclipped pos, as the plain versions' mask does: a sequence-sharded
//   rank passes a pos past its T, and sees [pos - window + 1, T).
//
// Bound on an H100: bytes. Every visible K/V row is read once, 2 * Dh *
// sizeof(kv) bytes per position and KV head, against 4 * G * Dh
// operations: at G <= 8 at most 4 float32 operations a byte.
//
// Design. The TPU walks T (or the logical pages) as a sequential grid axis
// and carries the online softmax in VMEM. A GPU grid has no order, so this
// is split-K flash decoding: one block per (split, KV head and group of up
// to 8 query rows, slot), then a log-sum-exp combine of the partials (a
// second launch, no atomics). The host fixes the split count from S * Hkv
// and the SM count alone (about four blocks an SM). Each block cuts ITS
// slot's visible range on the device: the range is U = ceil((hi - lo) / A)
// units of A rows (A = 16, or the page where that is smaller), and split i
// takes units [i U / n, (i + 1) U / n) counted from lo, so the pieces are
// contiguous, in split order, cover the range once, and differ by at most
// one unit (the last, which may be cut at hi, is never the short one).
// `pos` stays on the device, no K/V row outside the range is read, and an
// empty piece exits at once with an empty partial. A short slot thus
// spreads over every split, as a long one does, where a split of the cache
// length would leave it one block.
// The piece is walked in tiles of BT rows (32 up to Dh 128, 16 up to 256:
// five or more blocks an SM fit in shared memory) through a ring of two
// stages: the page ids of a tile's pages are found once per page into a
// small ring of cells one tile ahead, then every 16-byte row chunk of the
// tile's K and V is issued as cp.async before any is waited on (its row,
// chunk and page stepped on without a division; bf16 rows stay bf16 and
// are widened on read; rows whose Dh * size is not a multiple of 16 bytes,
// or unaligned K/V, are copied element by element into the same ring), and
// tile t + 1's copies fly during tile t's scores and P.V. One block
// barrier a tile. Each warp owns a quarter of every tile's keys; a key's
// score is summed by LPK = 128 / BT lanes over their chunks of the row
// (the rows are padded so that a phase's lanes read distinct banks) and
// reduced by log2(LPK) shuffles. Each warp keeps its own online softmax (m
// warp-wide, l per lane) and its own G x Dh accumulator in registers (lane
// l holds columns l + 32 i), each probability handed to the warp by one
// shuffle. The four warps merge once, at the end of the piece, in warp
// order. The combine, one warp a query row, is launched as a programmatic
// dependent (Hopper's griddepcontrol): its blocks are resident before the
// split kernel ends, so its launch does not wait behind it. Masked scores
// are -inf and weigh exactly 0, so a trash page's finite garbage never
// reaches an output.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_helpers.cuh"

namespace {

// K/V [P, Hkv, page, Dh]
struct KV {
  const void* k;
  const void* v;
  int Hkv, page, Dh;
};

// a page pool read through the block table [S, M]
struct PagedRows {
  const int* table;
  int P, M;
  __device__ __forceinline__ int id(int s, int m) const {
    const int pid = table[static_cast<size_t>(s) * M + m];
    return pid < 0 || pid >= P ? 0 : pid;
  }
};

// a dense cache [S, Hkv, T, Dh]: slot s is page s
struct DenseRows {
  __device__ __forceinline__ int id(int s, int) const { return s; }
};

constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kDecodeStages = 2;  // tiles in the cp.async ring

struct Decode {
  const float* q;  // [S, Hkv, G, Dh]
  const int* pos;  // [S]
  float* o_part;   // [S, Hkv, n_split, G, Dh]
  float* m_part;   // [S, Hkv, n_split, G]
  float* l_part;
  float* out;      // [S, Hkv, G, Dh]
  float* lse;      // [S, Hkv, G]
  int S, G, window, ring, cap, n_split, align, n_gc;
  float scale;
};

// the visible logical rows [lo, hi) of a slot at pos (empty when lo >= hi)
__device__ __forceinline__ void visible_range(const Decode& P, int pos, int& lo, int& hi) {
  if (P.ring) {
    const int n = min(min(P.window, pos + 1), P.cap);
    lo = pos - n + 1;
    hi = pos + 1;
  } else {
    hi = min(pos, P.cap - 1) + 1;
    lo = P.window > 0 ? max(0, pos - P.window + 1) : 0;
  }
}

// The tile shape of a head-dim class DHC (Dh <= DHC): BT key rows a tile,
// KPW of them owned by each warp, LPK lanes summing one key's score, CPL
// output columns a lane.
template <int DHC>
struct DecodeTile {
  static constexpr int BT = DHC <= 128 ? 32 : 16;
  static constexpr int KPW = BT / kDecodeWarps;
  static constexpr int LPK = 32 / KPW;
  static constexpr int CPL = DHC / 32;
};

// A ring row's stride in 16-byte chunks: at least the row's c16 chunks and,
// when several keys share a phase of 8 lanes (LPK < 8), congruent to LPK
// mod 8, so the phase's lanes (LPK chunks of each of 8 / LPK rows) hit 8
// distinct bank quads.
__host__ __device__ inline int ring_ld16(int c16, int lpk) {
  return lpk >= 8 ? c16 : c16 + ((lpk - c16 % 8) % 8 + 8) % 8;
}

template <typename E, int DHC, int MAXG>
struct DecodeSmem {
  using Tl = DecodeTile<DHC>;
  int c16, ld16, qld;  // chunks of a row, ring stride (chunks), q stride (floats)
  size_t ring, merge, q, cells;
  __host__ __device__ DecodeSmem(int Dh) {
    c16 = (Dh * static_cast<int>(sizeof(E)) + 15) / 16;
    ld16 = ring_ld16(c16, Tl::LPK);
    qld = c16 * (16 / static_cast<int>(sizeof(E)));
    ring = static_cast<size_t>(kDecodeStages) * 2 * Tl::BT * ld16 * 16;
    merge = sizeof(float) * kDecodeWarps * MAXG * (DHC + 2);
    q = sizeof(float) * MAXG * qld;
    cells = sizeof(int) * kDecodeStages * (Tl::BT + 1);
  }
  __host__ __device__ size_t bytes() const { return (ring > merge ? ring : merge) + q + cells; }
};

// True when rows can be copied in 16-byte chunks: Dh * sizeof(E) is a
// multiple of 16 and both K and V start 16-byte aligned.
template <typename E>
__device__ __forceinline__ bool chunk_rows(const KV& kv) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(kv.k) | reinterpret_cast<uintptr_t>(kv.v);
  return (kv.Dh * sizeof(E)) % 16 == 0 && (a & 15) == 0;
}

// 16 bytes of a ring row widened to float32: 4 floats or 8 bf16
__device__ __forceinline__ void chunk_f32(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}
__device__ __forceinline__ void chunk_f32(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename E, int DHC, int MAXG, typename Rows>
__global__ void __launch_bounds__(kDecodeThreads)
decode_split_kernel(KV kv, Rows rows, Decode P) {
  using Tl = DecodeTile<DHC>;
  constexpr int BT = Tl::BT, KPW = Tl::KPW, LPK = Tl::LPK, CPL = Tl::CPL;
  constexpr int VE = 16 / sizeof(E);  // elements of a 16-byte chunk
  const DecodeSmem<E, DHC, MAXG> L(kv.Dh);
  const int Dh = kv.Dh, page = kv.page, c16 = L.c16, ld = L.ld16 * VE, qld = L.qld;
  extern __shared__ __align__(16) unsigned char smem[];
  E* ring = reinterpret_cast<E*>(smem);  // [stage][k, v][BT][ld]
  float* merge = reinterpret_cast<float*>(smem);  // after the loop: [warp][MAXG][DHC + 2]
  float* sq = reinterpret_cast<float*>(smem + (L.ring > L.merge ? L.ring : L.merge));
  int* cells = reinterpret_cast<int*>(sq + MAXG * qld);  // [stage][BT + 1] page ids

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the combine may start
  const int split = blockIdx.x, s = blockIdx.z;
  const int h = blockIdx.y / P.n_gc, g0 = (blockIdx.y - h * P.n_gc) * MAXG;
  const int Gb = min(MAXG, P.G - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t sh = static_cast<size_t>(s) * kv.Hkv + h;
  const size_t part = (sh * P.n_split + split) * P.G + g0;
  float* o_part = P.o_part + part * Dh;
  float* m_part = P.m_part + part;
  float* l_part = P.l_part + part;

  // q first: its loads fly with pos's
  const float* q = P.q + (sh * P.G + g0) * Dh;
  const int pos = P.pos[s];
  for (int i = tid; i < Gb * qld; i += kDecodeThreads) {
    const int g = i / qld, e = i - g * qld;
    sq[i] = e < Dh ? q[g * Dh + e] : 0.f;
  }
  // this split's piece [a, b) of the visible range [lo, hi)
  int lo, hi;
  visible_range(P, pos, lo, hi);
  const int units = hi > lo ? (hi - lo + P.align - 1) / P.align : 0;
  const int a = lo + static_cast<int>(static_cast<long long>(split) * units / P.n_split) * P.align;
  const int b = min(hi, lo + static_cast<int>(static_cast<long long>(split + 1) * units /
                                              P.n_split) * P.align);
  if (a >= b) {  // nothing visible here: an empty partial, no K/V read
    for (int i = tid; i < Gb * Dh; i += kDecodeThreads) o_part[i] = 0.f;
    for (int g = tid; g < Gb; g += kDecodeThreads) {
      m_part[g] = -INFINITY;
      l_part[g] = 0.f;
    }
    return;
  }

  const int n_tiles = (b - a + BT - 1) / BT;
  // the page id of each page tile t touches
  auto cell = [&](int t, int i, int& pid) {
    const int m0 = (a + t * BT) / page;
    const int m1 = (min(b, a + (t + 1) * BT) - 1) / page;
    if (t >= n_tiles || i > m1 - m0) return false;
    pid = rows.id(s, m0 + i);
    return true;
  };
  const bool vec = chunk_rows<E>(kv);
  // a thread's first chunk of a tile, and the step to its next
  const int r_first = tid / c16, c_first = tid - r_first * c16;
  const int r_step = kDecodeThreads / c16, c_step = kDecodeThreads - r_step * c16;
  const E* kb = static_cast<const E*>(kv.k);
  const E* vb = static_cast<const E*>(kv.v);
  // issue every copy of tile t into stage st before waiting on any
  auto issue = [&](int t, int st) {
    const int t0 = a + t * BT, n = min(BT, b - t0);
    const int m0 = t0 / page;
    const int* cs = cells + (t % kDecodeStages) * (BT + 1);
    E* dk = ring + static_cast<size_t>(st) * 2 * BT * ld;
    E* dv = dk + BT * ld;
    if (vec) {
      // chunk tid + k * 128 of the tile: row r, chunk c, and row r's page
      // (cell mi, row pr in it), all stepped on without a division
      int r = r_first, c = c_first, pr = t0 - m0 * page + r, mi = pr / page;
      pr -= mi * page;
      while (r < n) {
        const size_t off =
            ((static_cast<size_t>(cs[mi]) * kv.Hkv + h) * page + pr) * Dh + c * VE;
        cp_async16(dk + r * ld + c * VE, kb + off, 16);
        cp_async16(dv + r * ld + c * VE, vb + off, 16);
        c += c_step;
        r += r_step;
        pr += r_step;
        if (c >= c16) {
          c -= c16;
          ++r;
          ++pr;
        }
        while (pr >= page) {
          pr -= page;
          ++mi;
        }
      }
    } else {
      const int w = c16 * VE;  // columns past Dh are zero
      for (int i = tid; i < n * w; i += kDecodeThreads) {
        const int r = i / w, e = i - r * w, j = t0 + r, m = j / page;
        const size_t off =
            ((static_cast<size_t>(cs[m - m0]) * kv.Hkv + h) * page + (j - m * page)) * Dh;
        const bool in = e < Dh;
        if constexpr (sizeof(E) == 4) {
          cp_async4(dk + r * ld + e, in ? kb + off + e : kb, in ? 4 : 0);
          cp_async4(dv + r * ld + e, in ? vb + off + e : vb, in ? 4 : 0);
        } else {
          dk[r * ld + e] = in ? kb[off + e] : E(0.f);
          dv[r * ld + e] = in ? vb[off + e] : E(0.f);
        }
      }
    }
  };

  // prologue: the cells of the first kDecodeStages tiles, the copies of all
  // but the last of them
  for (int t = 0; t < kDecodeStages; ++t)
    for (int i = tid; i <= BT; i += kDecodeThreads) {
      int pid;
      if (cell(t, i, pid)) cells[t * (BT + 1) + i] = pid;
    }
  __syncthreads();
  for (int t = 0; t < kDecodeStages - 1; ++t) {
    if (t < n_tiles) issue(t, t);
    cp_commit();
  }

  float m[MAXG], l[MAXG], acc[MAXG][CPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[g][i] = 0.f;
  }
  const int sub = lane % LPK;

  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<kDecodeStages - 2>();
    __syncthreads();  // tile t landed for all; stage (t - 1) and its cells are free
    const int tn = t + kDecodeStages - 1;
    if (tn < n_tiles) issue(tn, tn % kDecodeStages);
    cp_commit();
    int pid_next = 0;  // a cell of tile t + kDecodeStages, stored after this tile's work
    const bool has_next = tid <= BT && cell(t + kDecodeStages, tid, pid_next);

    const int t0 = a + t * BT, n = min(BT, b - t0);
    const int k0 = warp * KPW, nw = min(KPW, n - k0);
    if (nw > 0) {  // warp-uniform
      const E* ks = ring + static_cast<size_t>(t % kDecodeStages) * 2 * BT * ld;
      const E* vs = ks + BT * ld;
      const int key = k0 + lane / LPK;
      const bool live = key < n;
      float d[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) d[g] = 0.f;
      if (live) {
        for (int c = sub; c < c16; c += LPK) {
          float kf[VE];
          chunk_f32(ks + key * ld + c * VE, kf);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < Gb) {
              const float* qg = sq + g * qld + c * VE;
#pragma unroll
              for (int e = 0; e < VE; e += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(qg + e);
                d[g] = fmaf(qv.x, kf[e], d[g]);
                d[g] = fmaf(qv.y, kf[e + 1], d[g]);
                d[g] = fmaf(qv.z, kf[e + 2], d[g]);
                d[g] = fmaf(qv.w, kf[e + 3], d[g]);
              }
            }
          }
        }
      }
      float pr[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < Gb) {
#pragma unroll
          for (int off = 1; off < LPK; off <<= 1)
            d[g] += __shfl_xor_sync(0xffffffffu, d[g], off);
          const float sc = live ? d[g] * P.scale : -INFINITY;
          float mx = sc;
#pragma unroll
          for (int off = LPK; off < 32; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[g], mx);  // finite: the warp has a live key
          const float alpha = expf(m[g] - m_new);  // 0 while nothing was seen
          pr[g] = live ? expf(sc - m_new) : 0.f;
          l[g] = alpha * l[g] + (sub == 0 ? pr[g] : 0.f);
          m[g] = m_new;
#pragma unroll
          for (int i = 0; i < CPL; ++i) acc[g][i] *= alpha;
        }
      }
      for (int j = 0; j < nw; ++j) {
        const E* vrow = vs + (k0 + j) * ld;
        float v[CPL];
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int e = lane + 32 * i;
          v[i] = e < Dh ? widen(vrow[e]) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < Gb) {
            const float pj = __shfl_sync(0xffffffffu, pr[g], j * LPK);
#pragma unroll
            for (int i = 0; i < CPL; ++i) acc[g][i] = fmaf(pj, v[i], acc[g][i]);
          }
        }
      }
    }
    if (has_next) cells[(t % kDecodeStages) * (BT + 1) + tid] = pid_next;
  }
  cp_wait<0>();

  // merge the warps once, in warp order
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
  }
  __syncthreads();  // every warp is done with the ring, which the merge reuses
  float* mine = merge + warp * MAXG * (DHC + 2);
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < Gb) {
      float* row = mine + g * (DHC + 2);
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int e = lane + 32 * i;
        if (e < Dh) row[e] = acc[g][i];
      }
      if (lane == 0) {
        row[DHC] = m[g];
        row[DHC + 1] = l[g];
      }
    }
  }
  __syncthreads();
  constexpr int WS = MAXG * (DHC + 2);  // a warp's stride
  for (int i = tid; i < Gb * Dh; i += kDecodeThreads) {
    const int g = i / Dh, e = i - g * Dh;
    const float* r = merge + g * (DHC + 2);
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) M = fmaxf(M, r[w * WS + DHC]);
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) o += r[w * WS + e] * expf(r[w * WS + DHC] - M);
    o_part[i] = o;
  }
  for (int g = tid; g < Gb; g += kDecodeThreads) {
    const float* r = merge + g * (DHC + 2);
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) M = fmaxf(M, r[w * WS + DHC]);
    float Lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) Lsum += r[w * WS + DHC + 1] * expf(r[w * WS + DHC] - M);
    m_part[g] = M;
    l_part[g] = Lsum;
  }
}

// One warp per (s, h, g) query row: merge the n_split partials by
// log-sum-exp in a fixed order. Lane i holds split i's (m, l) (i + 32's, ...
// in later rounds); l's weighted sum is a butterfly over the lanes; the
// weights exp(m_i - M) reach the lanes by shuffle, and each lane sums its
// output columns (lane + 32 c) over the splits in split order, the partial
// rows of 8 splits loaded before any is summed. An empty split (l = 0,
// o = 0) weighs 0. Launched as a programmatic dependent of the split
// kernel: its blocks are resident before the split kernel ends and wait
// (griddepcontrol.wait) for its results.
constexpr int kCombineWarps = 4;
constexpr int kMaxCols = 256 / 32;  // Dh <= 256
constexpr int kCombineBatch = 8;    // splits loaded together

__global__ void __launch_bounds__(32 * kCombineWarps)
decode_combine_kernel(KV kv, Decode P) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int G = P.G, Dh = kv.Dh, NS = P.n_split;
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kCombineWarps + (threadIdx.x >> 5);
  if (row >= static_cast<size_t>(P.S) * kv.Hkv * G) return;  // warp-uniform
  const size_t sh = row / G, at = sh * NS * G + row % G;
  const float* m = P.m_part + at;  // stride G per split
  const float* l = P.l_part + at;
  const float* o = P.o_part + at * Dh;  // stride G * Dh per split
  float M = -INFINITY;
  for (int i = lane; i < NS; i += 32) {
    const float li = l[static_cast<size_t>(i) * G];
    if (li > 0.f) M = fmaxf(M, m[static_cast<size_t>(i) * G]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  float L = 0.f, acc[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.f;
  for (int i0 = 0; i0 < NS; i0 += 32) {
    const int i = i0 + lane;
    const float li = i < NS ? l[static_cast<size_t>(i) * G] : 0.f;
    const float w = li > 0.f ? expf(m[static_cast<size_t>(i) * G] - M) : 0.f;
    L += li * w;
    const int n = min(32, NS - i0);
    for (int j0 = 0; j0 < n; j0 += kCombineBatch) {
      float ov[kCombineBatch][kMaxCols];
#pragma unroll
      for (int j = 0; j < kCombineBatch; ++j) {
        const float* oj = o + static_cast<size_t>(i0 + j0 + j) * G * Dh;
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          const int e = lane + 32 * c;
          ov[j][c] = j0 + j < n && e < Dh ? oj[e] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kCombineBatch; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, j0 + j);  // 0 past n
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) acc[c] = fmaf(wj, ov[j][c], acc[c]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
  const float inv = 1.f / L;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int e = lane + 32 * c;
    if (e < Dh) P.out[row * Dh + e] = acc[c] * inv;
  }
  if (lane == 0) P.lse[row] = M + logf(L);
}

template <typename E, int DHC, int MAXG, typename Rows>
int decode_launch(const KV& kv, const Rows& rows, Decode P, cudaStream_t stream) {
  const size_t smem = DecodeSmem<E, DHC, MAXG>(kv.Dh).bytes();
  auto kernel = decode_split_kernel<E, DHC, MAXG, Rows>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  P.n_gc = (P.G + MAXG - 1) / MAXG;
  const dim3 grid(P.n_split, kv.Hkv * P.n_gc, P.S);
  kernel<<<grid, kDecodeThreads, smem, stream>>>(kv, rows, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the combine of the S * Hkv * G rows' partials, a programmatic dependent
  // of the split kernel (which executes griddepcontrol.launch_dependents)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((P.S * kv.Hkv * P.G + kCombineWarps - 1) / kCombineWarps);
  cfg.blockDim = dim3(32 * kCombineWarps);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_combine_kernel, kv, P);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// query rows a block: 1, 2, 4 or 8 (more take several blocks)
template <typename E, int DHC, typename Rows>
int decode_g(const KV& kv, const Rows& rows, const Decode& P, cudaStream_t st) {
  if (P.G <= 1) return decode_launch<E, DHC, 1>(kv, rows, P, st);
  if (P.G <= 2) return decode_launch<E, DHC, 2>(kv, rows, P, st);
  if (P.G <= 4) return decode_launch<E, DHC, 4>(kv, rows, P, st);
  return decode_launch<E, DHC, 8>(kv, rows, P, st);
}

}  // namespace
