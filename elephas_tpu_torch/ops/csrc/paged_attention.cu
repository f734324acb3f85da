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
// - decode is split-K flash decoding: one block per (split, KV head and
//   group of up to 8 query rows, slot), then a log-sum-exp combine of the
//   partials (a second launch, no atomics). The host fixes the split count
//   from S * Hkv and the SM count alone (about four blocks an SM). Each
//   block cuts ITS slot's visible range [lo, p] (lo = max(p - window + 1,
//   0), p = pos clipped to M * page - 1) on the device: the range is U =
//   ceil((p - lo + 1) / A) units of A rows (A = 16, or the page where that
//   is smaller), and split i takes units [i U / n, (i + 1) U / n) counted
//   from lo, so the pieces are contiguous, in split order, cover the range
//   once, and differ by at most one unit (the last, which may be cut at p,
//   is never the short one). `pos` stays on the device, no K/V row past p
//   is read, and an empty piece exits at once with an empty partial. A
//   short slot thus spreads over every split, as a long one does, where a
//   split of the cache length would leave it one block.
//   The piece is walked in tiles of BT rows (32 up to Dh 128, 16 up to
//   256: five or more blocks an SM fit in shared memory) through a ring of
//   two stages: the table cells of a tile's pages are read once per page
//   into a small ring of cells one tile ahead, then every 16-byte row chunk
//   of the tile's K and V is issued as cp.async before any is waited on
//   (its row, chunk and page stepped on without a division; bf16 rows stay
//   bf16 and are widened on read; rows whose Dh * size is not a multiple
//   of 16 bytes, or an unaligned pool, are copied element by element into
//   the same ring), and tile t + 1's copies fly during tile t's scores and
//   P.V. One block barrier a tile. Each warp owns a quarter of every
//   tile's keys; a key's score is summed by LPK = 128 / BT lanes over
//   their chunks of the row (the rows are padded so that a phase's lanes
//   read distinct banks) and reduced by log2(LPK) shuffles. Each warp
//   keeps its own online softmax (m warp-wide, l per lane) and its own
//   G x Dh accumulator in registers (lane l holds columns l + 32 i), each
//   probability handed to the warp by one shuffle. The four warps merge
//   once, at the end of the piece, in warp order. The combine, one warp a
//   query row, is launched as a programmatic dependent (Hopper's
//   griddepcontrol): its blocks are resident before the split kernel ends,
//   so its launch does not wait behind it;
// - chunk is one block per (tile of query rows, KV head, slot), looping over
//   the key tiles up to its last row's position, with an online softmax per
//   row, as the flash attention forward (flash_attention.cu): 16 x 16
//   threads, register-blocked SIMT float32 products, shared tiles padded by
//   one float against bank conflicts. Rows past G*C are masked by index.
//   It gathers a 64-row key tile page by page: each row's pool offset comes
//   from the table once per tile, then each row of Dh contiguous elements
//   is one coalesced load (16 bytes a thread where Dh allows). A page
//   smaller than the tile fills it from several pages; a larger one spans
//   several tiles. No tensor cores, no pipelining yet.
// In both, a table cell outside [0, P) reads the trash page, so nothing is
// ever addressed outside the pool; masked scores are -inf and their weight
// is exactly 0, so the trash page's finite garbage never reaches an output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "mma_helpers.cuh"

namespace {

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
constexpr int kDecodeStages = 2;   // tiles in the cp.async ring

struct Decode {
  const float* q;  // [S, Hkv, G, Dh]
  const int* pos;  // [S]
  float* o_part;   // [S, Hkv, n_split, G, Dh]
  float* m_part;   // [S, Hkv, n_split, G]
  float* l_part;
  float* out;      // [S, Hkv, G, Dh]
  float* lse;      // [S, Hkv, G]
  int S, G, window, n_split, align, n_gc;
  float scale;
};

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
// multiple of 16 and both pools start 16-byte aligned.
template <typename E>
__device__ __forceinline__ bool chunk_rows(const Pool& pl) {
  const uintptr_t a =
      reinterpret_cast<uintptr_t>(pl.k) | reinterpret_cast<uintptr_t>(pl.v);
  return (pl.Dh * sizeof(E)) % 16 == 0 && (a & 15) == 0;
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

template <typename E, int DHC, int MAXG>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_split_kernel(Pool pl, Decode P) {
  using Tl = DecodeTile<DHC>;
  constexpr int BT = Tl::BT, KPW = Tl::KPW, LPK = Tl::LPK, CPL = Tl::CPL;
  constexpr int VE = 16 / sizeof(E);  // elements of a 16-byte chunk
  const DecodeSmem<E, DHC, MAXG> L(pl.Dh);
  const int Dh = pl.Dh, page = pl.page, c16 = L.c16, ld = L.ld16 * VE, qld = L.qld;
  extern __shared__ __align__(16) unsigned char smem[];
  E* ring = reinterpret_cast<E*>(smem);  // [stage][k, v][BT][ld]
  float* merge = reinterpret_cast<float*>(smem);  // after the loop: [warp][MAXG][DHC + 2]
  float* sq = reinterpret_cast<float*>(smem + (L.ring > L.merge ? L.ring : L.merge));
  int* cells = reinterpret_cast<int*>(sq + MAXG * qld);  // [stage][BT + 1] pool page ids

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the combine may start
  const int split = blockIdx.x, s = blockIdx.z;
  const int h = blockIdx.y / P.n_gc, g0 = (blockIdx.y - h * P.n_gc) * MAXG;
  const int Gb = min(MAXG, P.G - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t sh = static_cast<size_t>(s) * pl.Hkv + h;
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
  // this split's piece [a, b) of the visible range [lo, p]
  const int p = min(pos, pl.M * page - 1);
  const int lo = P.window > 0 ? max(0, p - P.window + 1) : 0;
  const int units = (p - lo + P.align) / P.align;
  const int a = lo + static_cast<int>(static_cast<long long>(split) * units / P.n_split) * P.align;
  const int b = min(p + 1, lo + static_cast<int>(static_cast<long long>(split + 1) * units /
                                                 P.n_split) * P.align);
  if (a >= b) {  // nothing visible here: an empty partial, no K/V read
    for (int i = tid; i < Gb * Dh; i += kDecodeThreads) o_part[i] = 0.f;
    for (int g = tid; g < Gb; g += kDecodeThreads) {
      m_part[g] = -INFINITY;
      l_part[g] = 0.f;
    }
    return;
  }

  const int* trow = pl.table + static_cast<size_t>(s) * pl.M;
  const int n_tiles = (b - a + BT - 1) / BT;
  // the pool page id of each page tile t touches, clamped into the pool
  auto cell = [&](int t, int i, int& pid) {
    const int m0 = (a + t * BT) / page;
    const int m1 = (min(b, a + (t + 1) * BT) - 1) / page;
    if (t >= n_tiles || i > m1 - m0) return false;
    pid = trow[m0 + i];
    if (pid < 0 || pid >= pl.P) pid = 0;
    return true;
  };
  const bool vec = chunk_rows<E>(pl);
  // a thread's first chunk of a tile, and the step to its next
  const int r_first = tid / c16, c_first = tid - r_first * c16;
  const int r_step = kDecodeThreads / c16, c_step = kDecodeThreads - r_step * c16;
  const E* kb = static_cast<const E*>(pl.k);
  const E* vb = static_cast<const E*>(pl.v);
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
            ((static_cast<size_t>(cs[mi]) * pl.Hkv + h) * page + pr) * Dh + c * VE;
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
            ((static_cast<size_t>(cs[m - m0]) * pl.Hkv + h) * page + (j - m * page)) * Dh;
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
          v[i] = e < Dh ? to_f32(vrow[e]) : 0.f;
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
constexpr int kMaxCols = 256 / 32;  // the wrapper refuses Dh > 256
constexpr int kCombineBatch = 8;    // splits loaded together

__global__ void __launch_bounds__(32 * kCombineWarps)
paged_decode_combine_kernel(Pool pl, Decode P) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int G = P.G, Dh = pl.Dh, NS = P.n_split;
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kCombineWarps + (threadIdx.x >> 5);
  if (row >= static_cast<size_t>(P.S) * pl.Hkv * G) return;  // warp-uniform
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

template <typename E, int DHC, int MAXG>
int decode_launch(const Pool& pl, Decode P, cudaStream_t stream) {
  const size_t smem = DecodeSmem<E, DHC, MAXG>(pl.Dh).bytes();
  auto kernel = paged_decode_split_kernel<E, DHC, MAXG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  P.n_gc = (P.G + MAXG - 1) / MAXG;
  const dim3 grid(P.n_split, pl.Hkv * P.n_gc, P.S);
  kernel<<<grid, kDecodeThreads, smem, stream>>>(pl, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = P.S * pl.Hkv * P.G;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kCombineWarps - 1) / kCombineWarps);
  cfg.blockDim = dim3(32 * kCombineWarps);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_decode_combine_kernel, pl, P);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// query rows a block: 1, 2, 4 or 8 (more take several blocks)
template <typename E, int DHC>
int decode_g(const Pool& pl, const Decode& P, cudaStream_t st) {
  if (P.G <= 1) return decode_launch<E, DHC, 1>(pl, P, st);
  if (P.G <= 2) return decode_launch<E, DHC, 2>(pl, P, st);
  if (P.G <= 4) return decode_launch<E, DHC, 4>(pl, P, st);
  return decode_launch<E, DHC, 8>(pl, P, st);
}

// Dh <= 64, <= 128, <= 256 pick the tile class; the wrapper refuses Dh > 256.
template <typename E>
int decode_any(const Pool& pl, const Decode& P, cudaStream_t st) {
  if (pl.Dh <= 64) return decode_g<E, 64>(pl, P, st);
  if (pl.Dh <= 128) return decode_g<E, 128>(pl, P, st);
  return decode_g<E, 256>(pl, P, st);
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
                                int n_split, int align, float scale, int kv_bf16,
                                void* stream) {
  const Pool pl{k, v, table, P, Hkv, page, M, Dh};
  const Decode D{q, pos, o_part, m_part, l_part, out, lse, S, G, window, n_split, align, 1,
                 scale};
  if (S == 0 || Hkv == 0 || G == 0) return static_cast<int>(cudaGetLastError());
  if (n_split < 1 || align < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? decode_any<__nv_bfloat16>(pl, D, st) : decode_any<float>(pl, D, st);
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
