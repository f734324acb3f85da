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
// head, against 4*G*Dh operations. Chunk: the prefill insert (one slot, C
// 256 at pos0 0, 12 KV heads, Dh 64, float32) moves 3.15 MB (K/V rows, q
// and out once) and does 4*Dh operations per visible (query, key) pair,
// 101 M; on the tensor cores at 3xTF32 (494.7/3 TFLOP/s) those take 0.61
// us against 0.94 us for the bytes, so it is bound by bytes.
//
// Design. The TPU walks the logical pages as a sequential grid axis, its
// index map dereferencing the table (scalar prefetch) and clamping at the
// last live page, with the online softmax carried in VMEM. A GPU grid has
// no order, so:
// - decode is decode_split.cuh's split-K flash decoding over the pool with
//   the table's row policy (PagedRows): pieces of the visible range cut
//   from pos on the device, a two-stage cp.async ring whose table cells
//   are read one tile ahead, a per-warp online softmax and a combine
//   launched as a programmatic dependent;
// - chunk is K2-fwd's tensor-core online softmax (flash_tiles.cuh) over
//   the page table: one block per (16 query rows, KV head, slot). The
//   rows are taken position-major across the G heads of the KV group,
//   (c, g) for c in [c0, c0 + 16 / G), so the block's rows share one
//   causal key range and each K/V tile is read once for all G heads; q's
//   layout (r = g*C + c) stays, the block gathers its rows and
//   splits them once into their two TF32 planes in shared memory. 16-row
//   blocks give the GPT-2 insert (one slot, C 256, 12 KV heads) 192
//   blocks on 132 SMs, two at a time on each (shared memory and 128
//   registers a thread allow it), the block whose rows see the most keys
//   scheduled first. The rows' keys are walked in stages of BS = 8 W rows through a
//   three-stage cp.async ring: W warps (8, 4 and 2 for Dh up to 64, 128
//   and 256) share the 16 rows, warp w takes the w-th 8 keys of every
//   stage with its own online softmax, and at the end each warp scales its
//   (l, o) into a slot of shared memory and one pass sums the slots in
//   warp order. At an insert the walk, not the bytes, sets the time (a
//   stage's splits and products cost a lone warp far more than its
//   copies), so the warps split the keys: the last rows' walk over 256
//   keys is four stages. Each warp computes its 16 x 8 block of s = q.k^T
//   on `mma.sync` with each (product, k half) in its own accumulator
//   (mma_qkT8: one accumulator would chain every `mma` of the row), masks
//   by position in registers (a sub-tile wholly visible skips the
//   per-element test, one wholly masked is skipped), keeps m and l of rows
//   g and g + 8 by quad shuffles (exp by ex2.approx, within float32's
//   rounding of the plain version), and adds p.v, each tile's product in
//   fresh accumulators added once in float32. float32 pools run 3xTF32,
//   split by cvt.rna's integer form (mma_helpers.cuh); a bf16 pool stays
//   bf16 in the ring and is widened on load, exact in TF32, so its
//   products are two TF32 ones at float32 accuracy, as the reference's
//   float32 HIGHEST-precision compute. The K/V stage is gathered page by
//   page: each key row's table cell is read a stage ahead and turned into
//   its pool offset after the stage's work (so the read never stalls a
//   warp); then every 16-byte chunk of the stage is issued as cp.async
//   (rows past the range and columns past Dh zero filled; rows whose Dh *
//   size is not a multiple of 16 bytes, or an unaligned pool, are copied
//   element by element). One block barrier a stage.
// In both, a table cell outside [0, P) reads the trash page, so nothing is
// ever addressed outside the pool; masked scores are -inf and their weight
// is exactly 0, so the trash page's finite garbage never reaches an output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "decode_split.cuh"
#include "flash_tiles.cuh"

namespace {

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---- decode ------------------------------------------------------------------

// Dh <= 64, <= 128, <= 256 pick the tile class; the wrapper refuses Dh > 256.
template <typename E>
int decode_any(const KV& kv, const PagedRows& rows, const Decode& P, cudaStream_t st) {
  if (kv.Dh <= 64) return decode_g<E, 64>(kv, rows, P, st);
  if (kv.Dh <= 128) return decode_g<E, 128>(kv, rows, P, st);
  return decode_g<E, 256>(kv, rows, P, st);
}

// ---- chunk: one block per (16 query rows, KV head, slot) -------------------------

constexpr int kChunkRows = 16;   // query rows a block: one warp's mma rows
constexpr int kChunkKeys = 8;    // keys a warp takes from each stage: one mma n
constexpr int kChunkStages = 3;  // stages in the cp.async ring

// W warps a block, by head-dim class: a stage is BS = 8 W key rows. Up to
// Dh 64 two blocks fit an SM's shared memory, and MINB holds the registers
// to 128 a thread so that two fit its register file too (left free, nvcc
// takes more, and the GPT-2 insert's 192 blocks run in two waves).
template <int DH>
struct ChunkTile {
  static constexpr int W = DH <= 64 ? 8 : DH <= 128 ? 4 : 2;
  static constexpr int NT = 32 * W, BS = kChunkKeys * W, LDO = DH + 4, MINB = DH <= 64 ? 2 : 1;
};

struct Chunk {
  const float* q;   // [S, Hkv, G, C, Dh] = [S, Hkv, R, Dh], row r = g * C + c
  const int* pos0;  // [S]
  float* out;       // [S, Hkv, R, Dh]
  int S, G, C, window, cap;
  int vec_q, vec_kv;  // q rows, K/V rows may be read 16 bytes at a time
  float scale;
};

// q's two TF32 planes, the ring of K and V stages, the ring of row offsets
// (after the walk: the warps' merge slots)
template <typename E, int DH>
constexpr size_t chunk_smem() {
  using Tl = ChunkTile<DH>;
  const size_t walk = 2 * kChunkRows * DH * sizeof(float) +
                      kChunkStages * 2 * Tl::BS * DH * sizeof(E) +
                      kChunkStages * Tl::BS * sizeof(long long);
  const size_t merge = sizeof(float) * (Tl::W * kChunkRows * (Tl::LDO + 2) + kChunkRows);
  return walk > merge ? walk : merge;
}

template <typename E, int DH>
__global__ void __launch_bounds__(ChunkTile<DH>::NT, ChunkTile<DH>::MINB)
paged_chunk_kernel(KV kv, PagedRows rows, Chunk P) {
  using Tl = ChunkTile<DH>;
  constexpr int W = Tl::W, NT = Tl::NT, BS = Tl::BS, LDO = Tl::LDO;
  constexpr int PC = 16 / sizeof(E), CH = DH / PC;  // elements, chunks of a tile row
  extern __shared__ __align__(16) unsigned char shm[];
  float* sQ = reinterpret_cast<float*>(shm);  // [16][DH] q's big TF32 plane, swizzled
  float* sQs = sQ + kChunkRows * DH;           // its small plane
  E* ring = reinterpret_cast<E*>(sQs + kChunkRows * DH);  // [stage][K, V][BS][DH], swizzled
  long long* roff = reinterpret_cast<long long*>(ring + kChunkStages * 2 * BS * DH);  // [stage][BS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  // the last rows see the most keys: their blocks are scheduled first
  const int rb = static_cast<int>(gridDim.x - 1 - blockIdx.x), h = blockIdx.y, s = blockIdx.z;
  const int G = P.G, C = P.C, R = G * C, Dh = kv.Dh, page = kv.page;
  const int r0 = rb * kChunkRows;  // rows r0 .. r0 + 15 of the order i = c * G + g
  const int p0 = P.pos0[s];        // read here, used below: the reads that follow fly with it
  const size_t sh = static_cast<size_t>(s) * kv.Hkv + h;
  // block row r (i = r0 + r) is q's row (i % G) * C + i / G
  auto q_row = [&](int i) { return (i - i / G * G) * C + i / G; };
  // Row r of stage t is a key j whose pool offset is found in two steps, so
  // that the table read is in flight while other work is done: the table
  // cell of the key's page, then the offset, -1 for a key past `end` (zero
  // filled).
  auto cell_of = [&](int j, int end) {
    return j < end ? rows.table[static_cast<size_t>(s) * rows.M + j / page] : 0;
  };
  auto offset_of = [&](int j, int end, int cell) -> long long {
    if (j >= end) return -1;
    const int pid = cell < 0 || cell >= rows.P ? 0 : cell;
    return ((static_cast<long long>(pid) * kv.Hkv + h) * page + j % page) * Dh;
  };
  // the block's q rows, read now into registers (zero past Dh and past the
  // last row), split into their two TF32 planes once stage 0 is in flight
  constexpr int QN = (kChunkRows * (DH / 4) + NT - 1) / NT;  // float4s a thread
  float4 qx[QN];
  const float* qb = P.q + sh * R * Dh;
#pragma unroll
  for (int k = 0; k < QN; ++k) {
    const int idx = tid + k * NT, r = idx / (DH / 4), c = 4 * (idx - r * (DH / 4)), i = r0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (idx < kChunkRows * (DH / 4) && i < R && c < Dh) {
      const float* src = qb + static_cast<size_t>(q_row(i)) * Dh + c;
      if (P.vec_q) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        x[0] = v.x;
        x[1] = v.y;
        x[2] = v.z;
        x[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = c + e < Dh ? src[e] : 0.f;
      }
    }
    qx[k] = make_float4(x[0], x[1], x[2], x[3]);
  }

  // the keys the block's rows see, [k_lo, k_hi): n_st stages of BS (none
  // for rows whose window lies past the table: they are written as 0)
  const int i_last = min(r0 + kChunkRows, R) - 1;
  const int p_first = p0 + r0 / G, p_last = p0 + i_last / G;
  const int k_hi = min(p_last + 1, P.cap);
  const int k_lo = P.window > 0 ? max(0, p_first - P.window + 1) : 0;
  const int n_st = k_hi > k_lo ? (k_hi - k_lo + BS - 1) / BS : 0;

  const E* kb = static_cast<const E*>(kv.k);
  const E* vb = static_cast<const E*>(kv.v);
  auto key = [&](int t, int r) { return k_lo + t * BS + r; };  // row r of stage t
  // every copy of stage t into its slot of the ring (loops kept rolled: the
  // kernel fits 128 registers a thread without spilling only so)
  auto issue = [&](int t) {
    const int st = t % kChunkStages;
    const long long* ro = roff + st * BS;
    E* dK = ring + static_cast<size_t>(st) * 2 * BS * DH;
    E* dV = dK + BS * DH;
    if (P.vec_kv) {
#pragma unroll 1
      for (int idx = tid; idx < BS * CH; idx += NT) {
        const int r = idx / CH, ch = idx - r * CH;
        const long long o = ro[r];
        const bool in = o >= 0 && ch * PC < Dh;
        const int at = r * DH + ((ch ^ chunk_xor<E>(r)) * PC);
        cp_async16(dK + at, in ? kb + o + ch * PC : kb, in ? 16 : 0);
        cp_async16(dV + at, in ? vb + o + ch * PC : vb, in ? 16 : 0);
      }
    } else {
#pragma unroll 1
      for (int idx = tid; idx < BS * DH; idx += NT) {
        const int r = idx / DH, c = idx - r * DH;
        const long long o = ro[r];
        const bool in = o >= 0 && c < Dh;
        dK[sw<E, DH>(r, c)] = in ? kb[o + c] : E(0.f);
        dV[sw<E, DH>(r, c)] = in ? vb[o + c] : E(0.f);
      }
    }
  };

  // the ring's first stages of offsets
  if (tid < BS) {
#pragma unroll
    for (int t = 0; t < kChunkStages; ++t) {
      const int j = key(t, tid), end = t < n_st ? k_hi : 0;
      roff[t * BS + tid] = offset_of(j, end, cell_of(j, end));
    }
  }
  __syncthreads();
  for (int t = 0; t < kChunkStages - 1; ++t) {  // all but the last stage of the ring
    if (t < n_st) issue(t);
    cp_commit();
  }
#pragma unroll
  for (int k = 0; k < QN; ++k) {
    const int idx = tid + k * NT, r = idx / (DH / 4), ch = idx - r * (DH / 4);
    if (idx >= kChunkRows * (DH / 4)) break;
    const float x[4] = {qx[k].x, qx[k].y, qx[k].z, qx[k].w};
    uint32_t big[4], small[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32_int(x[e], big[e], small[e]);
    const int at = r * DH + ((ch ^ chunk_xor<float>(r)) * 4);
    *reinterpret_cast<uint4*>(sQ + at) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(sQs + at) = make_uint4(small[0], small[1], small[2], small[3]);
  }

  // this thread's rows g and g + 8: their positions, -1 past the last row
  int qp[2];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int i = r0 + g + 8 * ii;
    qp[ii] = i < R ? p0 + i / G : -1;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DH / 8][4] = {};
  const bool rows_full = r0 + kChunkRows <= R;

  for (int t = 0; t < n_st; ++t) {
    cp_wait<kChunkStages - 2>();
    __syncthreads();  // stage t has landed; every warp is done with stage t - 1,
    const int tn = t + kChunkStages - 1;  // whose slot takes stage tn
    if (tn < n_st) issue(tn);
    cp_commit();
    // the table cell of stage t + kChunkStages, turned into its offset and
    // stored after this stage's work
    const bool ahead = tid < BS && tn + 1 < n_st;
    const int j_next = key(tn + 1, tid), end_next = ahead ? k_hi : 0;
    const int cell_next = cell_of(j_next, end_next);

    // this warp's keys [k0, k0 + 8)
    const int k0 = k_lo + t * BS + warp * kChunkKeys;
    const bool none =
        k0 >= k_hi || (P.window > 0 && k0 + kChunkKeys - 1 <= p_first - P.window);
    if (!none) {  // warp-uniform
      const E* sK = ring + static_cast<size_t>(t % kChunkStages) * 2 * BS * DH;
      const E* sV = sK + BS * DH;
      float sc[1][4];
      mma_qkT8<DH, E>(sc[0], sQ, sQs, sK, warp * kChunkKeys, lane);
      const bool all = rows_full && k0 + kChunkKeys - 1 <= p_first &&
                       k0 + kChunkKeys <= P.cap && (P.window <= 0 || k0 > p_last - P.window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kj = k0 + 2 * t4 + (e & 1);
        const bool vis = all || (kj <= qp[i] && kj < P.cap &&
                                 (P.window <= 0 || kj > qp[i] - P.window));
        const float x = vis ? sc[0][e] * P.scale : -INFINITY;
        sc[0][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = mx[i] == -INFINITY ? 0.f : __expf(sc[0][e] - mx[i]);
        sc[0][e] = p;
        sum[i] += p;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        alpha[i] = mx[i] == -INFINITY ? 1.f : __expf(m[i] - mx[i]);
        l[i] = alpha[i] * l[i] + sum[i];
        m[i] = mx[i];
      }
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      mma_pB_tf32<DH, kChunkKeys, E, true>(acc, sc, sV, warp * kChunkKeys, lane);
    }
    if (ahead) roff[(t % kChunkStages) * BS + tid] = offset_of(j_next, end_next, cell_next);
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with q and the ring, which the merge reuses

  // merge the warps' (m, l, o) in warp order: M = max m_w, L = sum l_w
  // exp(m_w - M), O = sum o_w exp(m_w - M); each warp scales its own into
  // its slot, and one pass sums the slots
  float* slot = reinterpret_cast<float*>(shm);  // [warp]: o, then m and l
  float* mine = slot + warp * kChunkRows * (LDO + 2);
  float* sM = mine + kChunkRows * LDO;  // [16] this warp's m, then [16] its weighted l
  if (t4 == 0) {
    sM[g] = m[0];
    sM[g + 8] = m[1];
  }
  __syncthreads();
  constexpr int SLOT = kChunkRows * (LDO + 2);  // a warp's slot: o [16][LDO], m [16], l [16]
  float wt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) M = fmaxf(M, slot[w * SLOT + kChunkRows * LDO + g + 8 * i]);
    wt[i] = m[i] == -INFINITY ? 0.f : expf(m[i] - M);
  }
  // (the o slots and the l cells do not overlap the m cells: no barrier)
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(mine + (g + 8 * i) * LDO + 8 * n + 2 * t4) =
          make_float2(acc[n][2 * i] * wt[i], acc[n][2 * i + 1] * wt[i]);
  if (t4 == 0) {
    sM[kChunkRows + g] = l[0] * wt[0];
    sM[kChunkRows + g + 8] = l[1] * wt[1];
  }
  __syncthreads();
  // each row's L once, then o = O / L into out (0 for a row that sees no
  // key); rows past R are not written
  float* sL = slot + W * SLOT;  // [16] L, past every slot
  if (tid < kChunkRows) {
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) L += slot[w * SLOT + kChunkRows * LDO + kChunkRows + tid];
    sL[tid] = L;
  }
  __syncthreads();
  const int q4 = Dh % 4 == 0 ? 4 : 1;  // columns a thread writes at once
  for (int idx = tid; idx < kChunkRows * Dh / q4; idx += NT) {
    const int r = idx / (Dh / q4), d = (idx - r * (Dh / q4)) * q4, i = r0 + r;
    if (i >= R) break;  // the rows past R come last
    float O[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float* o = slot + w * SLOT + r * LDO + d;
      if (q4 == 4) {
        const float4 x = *reinterpret_cast<const float4*>(o);
        O[0] += x.x;
        O[1] += x.y;
        O[2] += x.z;
        O[3] += x.w;
      } else {
        O[0] += o[0];
      }
    }
    const float L = sL[r], f = L > 0.f ? 1.f / L : 0.f;
    float* dst = P.out + (sh * R + q_row(i)) * Dh + d;
    if (q4 == 4)
      *reinterpret_cast<float4*>(dst) = make_float4(O[0] * f, O[1] * f, O[2] * f, O[3] * f);
    else
      dst[0] = O[0] * f;
  }
}

template <typename E, int DH>
int chunk_launch(const KV& kv, const PagedRows& rows, const Chunk& P, cudaStream_t st) {
  const size_t smem = chunk_smem<E, DH>();
  auto kernel = paged_chunk_kernel<E, DH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P.G * P.C + kChunkRows - 1) / kChunkRows, kv.Hkv, P.S);
  kernel<<<grid, ChunkTile<DH>::NT, smem, st>>>(kv, rows, P);
  return static_cast<int>(cudaGetLastError());
}

// Dh <= 64, <= 128, <= 256 pick the tile class; the wrapper refuses Dh > 256.
template <typename E>
int chunk_any(const KV& kv, const PagedRows& rows, const Chunk& P, cudaStream_t st) {
  if (kv.Dh <= 64) return chunk_launch<E, 64>(kv, rows, P, st);
  if (kv.Dh <= 128) return chunk_launch<E, 128>(kv, rows, P, st);
  return chunk_launch<E, 256>(kv, rows, P, st);
}

}  // namespace

extern "C" int paged_decode_lse(const float* q, const void* k, const void* v,
                                const int* table, const int* pos, float* o_part,
                                float* m_part, float* l_part, float* out, float* lse, int S,
                                int Hkv, int G, int Dh, int P, int page, int M, int window,
                                int n_split, int align, float scale, int kv_bf16,
                                void* stream) {
  const KV kv{k, v, Hkv, page, Dh};
  const PagedRows rows{table, P, M};
  const Decode D{q, pos, o_part, m_part, l_part, out, lse, S, G, window, 0, M * page, n_split,
                 align, 1, scale};
  if (S == 0 || Hkv == 0 || G == 0) return static_cast<int>(cudaGetLastError());
  if (n_split < 1 || align < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? decode_any<__nv_bfloat16>(kv, rows, D, st)
                 : decode_any<float>(kv, rows, D, st);
}

extern "C" int paged_chunk(const float* q, const void* k, const void* v, const int* table,
                           const int* pos0, float* out, int S, int Hkv, int G, int C, int Dh,
                           int P, int page, int M, int window, float scale, int kv_bf16,
                           void* stream) {
  const KV kv{k, v, Hkv, page, Dh};
  const PagedRows rows{table, P, M};
  const int es = kv_bf16 ? 2 : 4;
  const Chunk D{q, pos0, out, S, G, C, window, M * page,
                Dh % 4 == 0 && aligned16(q), (Dh * es) % 16 == 0 && aligned16(k) && aligned16(v),
                scale};
  if (S == 0 || Hkv == 0 || G == 0 || C == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? chunk_any<__nv_bfloat16>(kv, rows, D, st) : chunk_any<float>(kv, rows, D, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
