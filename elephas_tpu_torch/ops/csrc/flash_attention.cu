// Flash attention for training on Hopper (sm_90a): forward, dq and dkv,
// plain C interface for ctypes.
//
// Replaces: elephas_tpu/ops/pallas_flash.py `_flash_fwd_tpu` (the Pallas
// `_fwd_kernel`) and `_flash_bwd_tpu` (`_dq_kernel`, `_dkv_kernel`): the
// FlashAttention-2 forward, which saves only lse = m + log l, and its
// backward, which recomputes p = exp(s - lse) tile by tile. Layouts are the
// model's: q, o, dO, dq [B, T, H, Dh]; k, v, dk, dv [B, T, Hkv, Dh] (query
// head h reads KV head h / G, G = H / Hkv, never repeated); lse and
// delta [B, H, T] float32, delta = sum_d dO*O minus the lse cotangent,
// formed in torch before the launch. Inputs and outputs are float32 or
// bfloat16; every sum is float32.
//
// Bound on an H100: operations. Each visible (query, key) pair costs
// 4*Dh operations forward (q.k and p.v), 6*Dh for dq (q.k, dO.v, ds.k) and
// 8*Dh for dkv (q.k, dO.v, p.dO, ds.q), against 8 or so bytes of traffic
// per row. Float32 products at float32 accuracy run as 3xTF32 on the
// tensor cores (three TF32 products each, 495/3 TFLOP/s); bf16 products at
// 989 TFLOP/s. At GPT-2 training shape (B 8, H 12, T 1024, Dh 64, causal,
// float32) dq is 19.4 GFLOP, 0.117 ms at 3xTF32, against 0.02 ms for its
// bytes.
//
// Grid: the TPU walks the KV axis (Q axis for dkv) as a sequential grid
// axis and carries its sums in VMEM; a GPU grid has no order, so each
// block owns one output tile and loops over the tiles it needs inside the
// block. Forward and dq: one block per (Q tile, b, h), looping over the KV
// tiles the causal bound and the window leave visible (`_kv_clamp`). dkv:
// one block per (KV tile, b, kv head), looping over the visible Q tiles
// (`_q_clamp`) AND over the G query heads of its group, so dk and dv are
// summed in a fixed order and written once (the TPU writes per-query-head
// partials and sums them outside). No atomics: two runs give the same
// bits. Keys past T and padded query rows are masked by index (-inf
// scores, p = 0), so a ragged T needs no padding in device memory.
//
// All three run on the tensor cores through `mma.sync`:
// float32 inputs as 3xTF32 (each operand split in registers into a TF32
// big part, cvt.rna, and the TF32 rounding of the rest; small*big +
// big*small + big*big, float32 accumulation: float32 accuracy, as the
// reference's Precision.HIGHEST), bf16 inputs as bf16 m16n8k16 with p and
// ds rounded to bf16 before the second products, as the Pallas kernels
// round them. A block's own tile (Q in the forward, Q and dO in dq, K and
// V in dkv) stays in shared memory; the streamed tiles (K, V in the
// forward and dq; Q, dO, lse, delta in dkv) land in a ring by cp.async,
// 16 bytes a thread: right after the step's one barrier the copy of a
// later tile starts into the stage every warp has just finished, and it is
// in flight while the current tile is computed. dq and dkv use two stages
// (the next tile lands while this one is computed); the forward three, so
// that under rope the next K tile, landed, is rotated in place by each
// warp before it computes this tile, with no barrier of its own. Rows past
// T are zero-filled by the copy's source size. Tiles
// keep their storage type in shared memory, rows of 16-byte chunks
// XOR-swizzled by row, so every fragment load is free of bank conflicts.
// Forward warps: RG warps, each owning 16 query rows across the whole KV
// tile, so the online softmax never crosses warps. Each warp computes its
// 16 x BK piece of s = q.k^T, keeps the running max m and sum l of rows g
// and g + 8 (g = lane / 4) in registers, takes each tile's row max and
// row sum over its quad of lanes by shuffles, rescales its 16 x Dh o by
// alpha = exp(m_old - m_new) and adds p.v. l sums p in float32; bf16 rounds
// p to bf16 only as the A operand of p.v, as the reference's
// `p.astype(v.dtype)`. A warp skips a tile none of its rows sees (half the
// warps of the causal diagonal's last tiles). The epilogue writes o / l
// and lse = m + log l from registers.
// Backward warps: RG row groups of 16 own-tile rows times SP = 2 splits of the
// streamed tile's rows. Each warp computes its 16 x (streamed rows / 2)
// piece of s = q.k^T and dp = dO.v^T (in dkv their transposes), forms p
// and ds in registers and feeds them straight back as the A operand of dq
// += ds.k, or of dv += p^T.dO and dk += ds^T.q, each warp holding a 16 x
// Dh partial sum; the two splits are added in a fixed order through
// shared memory at the end. The tensor cores round every accumulation
// toward zero, so each tile's second product is summed in fresh registers
// and added to the running sum in float32 (one accumulator over every
// tile of T 2048 at G 4 drifts past the float32 pin). Per class (threads;
// own rows, streamed rows; shared memory a block, float32 / bf16; blocks
// an SM in float32):
//   forward:   Dh <= 64:  256; 128, 32; 80 / 40 KiB; two blocks an SM
//              (128 registers a thread);
//              Dh <= 128: 256; 128, 32; 160 / 80 KiB; one block an SM;
//              Dh <= 256: 128; 64, 16; 160 / 80 KiB; one block an SM.
//              o alone is Dh / 2 accumulator floats a thread; 32 streamed
//              rows keep s and its split operands to 48 more.
//              (Chosen by A/B timing on an H100 against 64-row KV tiles,
//              64-row Q tiles and three or four blocks an SM.)
//   Dh <= 64:  dq and dkv 256; 64, 64; 96 / 48 KiB (dkv 97 / 49); two
//              blocks an SM (the launch bounds cap a thread at 128
//              registers);
//   Dh <= 128: dq 256; 64, 64; 192 / 96 KiB; one block an SM;
//              dkv 256; 64, 32; 128.5 / 64.5 KiB; one block an SM (up to
//              255 registers a thread: dk and dv alone are 128);
//   Dh <= 256: 128; 32, 32; 192 / 96 KiB (dkv 192.5 / 96.5); one block.
//   At Dh 256 dk and dv together would hold 256 accumulator registers a
//   thread, so dkv launches twice, dv then dk, each recomputing s.
// Rows whose start is not 16-byte aligned (Dh * sizeof(E) not a multiple
// of 16, or a tensor at an unaligned offset) are copied element by element
// into the same ring.
//
// Rope on load (the `ROPE` template flag; replaces the same three Pallas
// kernels with their static `rope=True`, `_rot` at pallas_flash.py:111):
// q and k arrive UNROTATED with the duplicated half-split tables c2 = [cos|cos]
// and s2 = [-sin|sin], [B, T, Dh] float32. Each q and k tile is rotated in
// shared memory right after it lands, x*C2 + roll_half(x)*S2 in float32,
// and rounded to the input type as the reference's `_rot` rounds it. The
// rotation pairs dim d with dim d + Dh/2, so it runs as its own pass over
// the landed tile after a barrier: one thread per (row, d < Dh/2) pair
// reads both elements and writes both. The table values are read from
// global memory in that pass (the 4 MB tables at the Llama-3-8B training
// shape stay in L2). dq and dk are the gradients of the ROTATED q and k
// until the store, where the summed tile in shared memory is derotated
// with the sign of S2 flipped, the inverse rotation. Rows past T are never
// rotated and read no table. The rotated q and k never exist in device
// memory. Every kernel's shared memory per block is the same with or
// without rope. The forward rotates its resident Q tile once, before its
// sweep, and each K tile one step before it is used, four pairs a thread
// at a time from 16-byte table reads where Dh is a multiple of 8 and the
// rows are 16-byte aligned (`rotate_sw4`; pair by pair, that pass took
// over 40% of the forward's time at the Llama-3-8B shape on an H100).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_helpers.cuh"

namespace {

struct Dims {
  int B, T, H, Hkv, Dh, causal, window;
  float scale;
  int vec16;  // the copied rows may be copied 16 bytes at a time
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename E>
__device__ __forceinline__ E from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int qi, int kj, const Dims& D) {
  if (qi >= D.T || kj >= D.T) return false;
  if (!D.causal) return true;
  return kj <= qi && (D.window <= 0 || kj > qi - D.window);
}

// ---- tensor-core tile helpers (the forward's, dq's and dkv's) --------------------

// A tile in shared memory: R rows of DH elements of E in their storage type
// (a row is 128, 256 or 512 bytes), cut into 16-byte chunks; chunk c of row
// r sits at chunk c ^ chunk_xor<E>(r). Element (r, c) is at sw<E, DH>(r, c).
// The XOR keeps every fragment load free of bank conflicts. bf16 (r & 7):
// 8 consecutive rows x one chunk (32-bit pairs and ldmatrix rows), and 4
// even or odd rows x 8 words. float32 (0, 4, 2, 6, 4, 0, 6, 2 for r & 7):
// 16-byte loads by rows r and r + 1 (r even) x 4 chunks, and 4 even or odd
// rows x 8 words.
template <typename E>
__device__ __forceinline__ int chunk_xor(int r) { return r & 7; }
template <>
__device__ __forceinline__ int chunk_xor<float>(int r) { return (r & 6) ^ ((r & 1) << 2); }

template <typename E, int DH>
__device__ __forceinline__ int sw(int r, int c) {
  constexpr int PC = 16 / sizeof(E);
  static_assert(DH * sizeof(E) % 128 == 0, "a tile row spans whole 128-byte lines");
  return r * DH + (((c / PC) ^ chunk_xor<E>(r)) * PC) + (c % PC);
}

// rows [t0, t0 + R) of head `head` of a [B, T, heads, Dh] tensor into a
// swizzled tile, by cp.async: 16-byte chunks, zero past T and past Dh by
// the source size (D.vec16), else element by element
template <typename E, int R, int DH, int NT>
__device__ __forceinline__ void copy_tile(E* dst, const E* __restrict__ src, int b, int t0,
                                          int head, int heads, const Dims& D) {
  constexpr int PC = 16 / sizeof(E), CH = DH / PC;
  for (int idx = threadIdx.x; idx < R * CH; idx += NT) {
    const int r = idx / CH, ch = idx - r * CH, t = t0 + r, c = ch * PC;
    E* d = dst + r * DH + ((ch ^ chunk_xor<E>(r)) * PC);
    const bool row = t < D.T;
    const E* s = src + ((static_cast<size_t>(b) * D.T + (row ? t : 0)) * heads + head) * D.Dh + c;
    if (D.vec16) {
      const bool in = row && c < D.Dh;
      cp_async16(d, in ? s : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < PC; ++e) d[e] = row && c + e < D.Dh ? s[e] : from_f32<E>(0.f);
    }
  }
}

// rows [t0, t0 + R) of a [B, H, T] float32 statistic, zero past T
template <int R, int NT>
__device__ __forceinline__ void copy_stat(float* dst, const float* __restrict__ src, int b,
                                          int h, int t0, const Dims& D) {
  for (int r = threadIdx.x; r < R; r += NT) {
    const int t = t0 + r;
    const bool in = t < D.T;
    cp_async4(dst + r, in ? src + (static_cast<size_t>(b) * D.H + h) * D.T + t : src,
              in ? 4 : 0);
  }
}

// Rotate rows [t0, t0 + R) of a landed swizzled tile in place by the tables
// c2/s2 [B, T, Dh]: x*C2 + roll_half(x)*S2 in float32, each product and
// sum rounded as the plain version's tensor operations round them, the
// result in E (the reference's `_rot`). One thread per (row, d < Dh/2).
template <typename E, int R, int DH, int NT>
__device__ __forceinline__ void rotate_sw(E* tile, const float* __restrict__ c2,
                                          const float* __restrict__ s2, int b, int t0,
                                          const Dims& D) {
  const int half = D.Dh >> 1;
  for (int idx = threadIdx.x; idx < R * half; idx += NT) {
    const int r = idx / half, d = idx - r * half, t = t0 + r;
    if (t >= D.T) continue;
    const size_t row = (static_cast<size_t>(b) * D.T + t) * D.Dh;
    E& e1 = tile[sw<E, DH>(r, d)];
    E& e2 = tile[sw<E, DH>(r, d + half)];
    const float x1 = to_f32(e1), x2 = to_f32(e2);
    e1 = from_f32<E>(__fadd_rn(__fmul_rn(x1, c2[row + d]), __fmul_rn(x2, s2[row + d])));
    e2 = from_f32<E>(
        __fadd_rn(__fmul_rn(x2, c2[row + d + half]), __fmul_rn(x1, s2[row + d + half])));
  }
}

// four consecutive elements of a swizzled tile (a 4-aligned column start
// keeps them inside one 16-byte chunk) as float32, and back
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

__device__ __forceinline__ float rot1(float x, float c, float y, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
}

// rotate_sw four pairs at a time, for Dh a multiple of 8 and rows copied
// 16 bytes at a time (D.vec16; the caller checks both): each thread takes
// pairs (d .. d + 3, d + Dh/2 .. d + Dh/2 + 3) of a row as 16-byte table
// reads and 16- or 8-byte tile accesses, and starts the table reads of
// two such groups before it rotates either. The forward rotates every K tile
// it streams, and pair by pair the pass's instructions and L2 round trips
// held its warps. The arithmetic, and so the rotated tile, is rotate_sw's.
template <typename E, int R, int DH, int NT>
__device__ __forceinline__ void rotate_sw4(E* tile, const float* __restrict__ c2,
                                           const float* __restrict__ s2, int b, int t0,
                                           const Dims& D) {
  constexpr int G4 = DH / 8, N = (R * G4 + NT - 1) / NT;  // groups a row, a thread
  constexpr int BATCH = 2;  // groups whose table reads are in flight together
  const int half = D.Dh >> 1;
#pragma unroll 1
  for (int j0 = 0; j0 < N; j0 += BATCH) {  // not unrolled: one batch's registers live
    float4 cs[BATCH][4];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int idx = threadIdx.x + (j0 + j) * NT, r = idx / G4, d = 4 * (idx % G4);
      const bool on = j0 + j < N && idx < R * G4 && d < half && t0 + r < D.T;
      const size_t at = on ? (static_cast<size_t>(b) * D.T + t0 + r) * D.Dh + d : 0;
      cs[j][0] = *reinterpret_cast<const float4*>(c2 + at);
      cs[j][1] = *reinterpret_cast<const float4*>(s2 + at);
      cs[j][2] = *reinterpret_cast<const float4*>(c2 + at + half);
      cs[j][3] = *reinterpret_cast<const float4*>(s2 + at + half);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int idx = threadIdx.x + (j0 + j) * NT, r = idx / G4, d = 4 * (idx % G4);
      if (j0 + j >= N || idx >= R * G4 || d >= half || t0 + r >= D.T) continue;
      E* p1 = tile + sw<E, DH>(r, d);
      E* p2 = tile + sw<E, DH>(r, d + half);
      const float4 x = ld4(p1), y = ld4(p2);
      const float4 c = cs[j][0], sn = cs[j][1], c_ = cs[j][2], s_ = cs[j][3];
      st4(p1, make_float4(rot1(x.x, c.x, y.x, sn.x), rot1(x.y, c.y, y.y, sn.y),
                          rot1(x.z, c.z, y.z, sn.z), rot1(x.w, c.w, y.w, sn.w)));
      st4(p2, make_float4(rot1(y.x, c_.x, x.x, s_.x), rot1(y.y, c_.y, x.y, s_.y),
                          rot1(y.z, c_.z, x.z, s_.z), rot1(y.w, c_.w, x.w, s_.w)));
    }
  }
}

// the forward's rotation of a landed tile: four pairs at a time where the
// rows and the tables allow it, else rotate_sw
template <typename E, int R, int DH, int NT>
__device__ __forceinline__ void rotate_landed(E* tile, const float* __restrict__ c2,
                                              const float* __restrict__ s2, int b, int t0,
                                              const Dims& D) {
  if (D.vec16 && D.Dh % 8 == 0)
    rotate_sw4<E, R, DH, NT>(tile, c2, s2, b, t0, D);
  else
    rotate_sw<E, R, DH, NT>(tile, c2, s2, b, t0, D);
}

__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c[16 x NW] += A[ra .. ra+16) . B[rb .. rb+NW)^T over all DH columns, A and
// B swizzled tiles; c in the m16n8 accumulator layout, one [4] per 8
// columns (rows g and g + 8, columns 2t and 2t + 1, g = lane / 4, t = lane
// % 4). float32: m16n8k8 3xTF32, each operand split as it is loaded. The
// reduced index is summed in any order, so within each 16 columns the
// thread's four (4t .. 4t + 3) come in one 16-byte load: columns 4t and
// 4t + 1 are the first k-step's t and t + 4, 4t + 2 and 4t + 3 the second's.
template <int DH, int NW>
__device__ __forceinline__ void mma_abT(float (&c)[NW / 8][4], const float* A, int ra,
                                        const float* B, int rb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < DH; k0 += 16) {
    const float4 lo = *reinterpret_cast<const float4*>(A + sw<float, DH>(ra + g, k0 + 4 * t));
    const float4 hi = *reinterpret_cast<const float4*>(A + sw<float, DH>(ra + g + 8, k0 + 4 * t));
    uint32_t ab[2][4], as[2][4];
    split_tf32(lo.x, ab[0][0], as[0][0]);
    split_tf32(hi.x, ab[0][1], as[0][1]);
    split_tf32(lo.y, ab[0][2], as[0][2]);
    split_tf32(hi.y, ab[0][3], as[0][3]);
    split_tf32(lo.z, ab[1][0], as[1][0]);
    split_tf32(hi.z, ab[1][1], as[1][1]);
    split_tf32(lo.w, ab[1][2], as[1][2]);
    split_tf32(hi.w, ab[1][3], as[1][3]);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(B + sw<float, DH>(rb + 8 * j + g, k0 + 4 * t));
      uint32_t bb[2][2], bs[2][2];
      split_tf32(x.x, bb[0][0], bs[0][0]);
      split_tf32(x.y, bb[0][1], bs[0][1]);
      split_tf32(x.z, bb[1][0], bs[1][0]);
      split_tf32(x.w, bb[1][1], bs[1][1]);
      mma_3xtf32(c[j], ab[0], as[0], bb[0], bs[0]);
      mma_3xtf32(c[j], ab[1], as[1], bb[1], bs[1]);
    }
  }
}

// bf16: m16n8k16, fragments read as 32-bit pairs
template <int DH, int NW>
__device__ __forceinline__ void mma_abT(float (&c)[NW / 8][4], const __nv_bfloat16* A, int ra,
                                        const __nv_bfloat16* B, int rb, int lane) {
  using E = __nv_bfloat16;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < DH; k0 += 16) {
    const uint32_t a[4] = {word(A + sw<E, DH>(ra + g, k0 + 2 * t)),
                           word(A + sw<E, DH>(ra + g + 8, k0 + 2 * t)),
                           word(A + sw<E, DH>(ra + g, k0 + 2 * t + 8)),
                           word(A + sw<E, DH>(ra + g + 8, k0 + 2 * t + 8))};
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const uint32_t b[2] = {word(B + sw<E, DH>(rb + 8 * j + g, k0 + 2 * t)),
                             word(B + sw<E, DH>(rb + 8 * j + g, k0 + 2 * t + 8))};
      mma_bf16(c[j], a, b);
    }
  }
}

// c[16 x DH] += P[16 x KW] . B[rb .. rb+KW) with P in registers, in the
// accumulator layout mma_abT leaves (p or ds), and B a swizzled tile whose
// rows are the reduced index. The tensor cores round each accumulation
// toward zero, so a chain of mma into one accumulator over every tile of
// a long sequence drifts (past the float32 pin at T 2048, G 4): each
// 8 columns of this tile's product are summed in a fresh accumulator and
// added to c once, in float32. float32: the m16n8 accumulator does not
// have the m16n8k8 A layout, so the reduced index of each 8-wide chunk is
// taken in the order (0, 2, 4, 6, 1, 3, 5, 7): A's column t is the chunk's
// column 2t, its column t + 4 the chunk's 2t + 1, and B's rows follow.
template <int DH, int KW>
__device__ __forceinline__ void mma_pB(float (&c)[DH / 8][4], const float (&p)[KW / 8][4],
                                       const float* B, int rb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t ab[KW / 8][4], as[KW / 8][4];
#pragma unroll
  for (int j = 0; j < KW / 8; ++j) {
    split_tf32(p[j][0], ab[j][0], as[j][0]);
    split_tf32(p[j][2], ab[j][1], as[j][1]);
    split_tf32(p[j][1], ab[j][2], as[j][2]);
    split_tf32(p[j][3], ab[j][3], as[j][3]);
  }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    float d[4] = {};
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
      uint32_t bb[2], bs[2];
      split_tf32(B[sw<float, DH>(rb + 8 * j + 2 * t, 8 * n + g)], bb[0], bs[0]);
      split_tf32(B[sw<float, DH>(rb + 8 * j + 2 * t + 1, 8 * n + g)], bb[1], bs[1]);
      mma_3xtf32(d, ab[j], as[j], bb, bs);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += d[e];
  }
}

// bf16: two accumulator tiles are one m16n8k16 A operand once rounded to
// bf16 (as the reference rounds p and ds); B by ldmatrix.trans
template <int DH, int KW>
__device__ __forceinline__ void mma_pB(float (&c)[DH / 8][4], const float (&p)[KW / 8][4],
                                       const __nv_bfloat16* B, int rb, int lane) {
  using E = __nv_bfloat16;
  uint32_t a[KW / 16][4];
#pragma unroll
  for (int j = 0; j < KW / 16; ++j) {
    a[j][0] = pack_bf16(p[2 * j][0], p[2 * j][1]);
    a[j][1] = pack_bf16(p[2 * j][2], p[2 * j][3]);
    a[j][2] = pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]);
    a[j][3] = pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3]);
  }
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) {
    float d0[4] = {}, d1[4] = {};
#pragma unroll
    for (int j = 0; j < KW / 16; ++j) {
      uint32_t b[4];
      ldsm_x4_trans(b, B + sw<E, DH>(rb + 16 * j + (lane & 15), 16 * n + (lane >> 4) * 8));
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(d0, a[j], b0);
      mma_bf16(d1, a[j], b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c[2 * n][e] += d0[e];
      c[2 * n + 1][e] += d1[e];
    }
  }
}

// The SP warps of a row group hold partial sums of the same 16 rows; add
// them into a float32 tile [rows][LDA] in shared memory in a fixed order
// (split 0, then 1, ...), so two runs give the same bits.
template <int DH, int SP, int LDA>
__device__ __forceinline__ void sum_splits(float* sD, const float (&acc)[DH / 8][4], int sp,
                                           int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < SP; ++s) {
    if (sp == s) {
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& d = sD[(r0 + g + 8 * (e >> 1)) * LDA + 8 * n + 2 * t + (e & 1)];
          d = s == 0 ? acc[n][e] : d + acc[n][e];
        }
    }
    __syncthreads();
  }
}

// a float32 tile [R][LDA] as E into rows [t0, t0 + R) of head `head` of a
// [B, T, heads, Dh] tensor; rows past T are not stored
template <typename E, int R, int LDA, int NT>
__device__ __forceinline__ void store_tile(const float* tile, int b, int t0, int head,
                                           int heads, const Dims& D, E* dst) {
  for (int idx = threadIdx.x; idx < R * D.Dh; idx += NT) {
    const int r = idx / D.Dh, d = idx - r * D.Dh, t = t0 + r;
    if (t < D.T)
      dst[((static_cast<size_t>(b) * D.T + t) * heads + head) * D.Dh + d] =
          from_f32<E>(tile[r * LDA + d]);
  }
}

// The same store through the inverse rotation, x*C2 - roll_half(x)*S2: the
// gradient of the rotated q or k becomes that of the unrotated one.
template <typename E, int R, int LDA, int NT>
__device__ __forceinline__ void derotate_store(const float* tile, const float* __restrict__ c2,
                                               const float* __restrict__ s2, int b, int t0,
                                               int head, int heads, const Dims& D, E* dst) {
  const int half = D.Dh >> 1;
  for (int idx = threadIdx.x; idx < R * half; idx += NT) {
    const int r = idx / half, d = idx - r * half, t = t0 + r;
    if (t >= D.T) continue;
    const size_t row = (static_cast<size_t>(b) * D.T + t) * D.Dh;
    const float x1 = tile[r * LDA + d], x2 = tile[r * LDA + d + half];
    E* out = dst + ((static_cast<size_t>(b) * D.T + t) * heads + head) * D.Dh;
    out[d] = from_f32<E>(__fadd_rn(__fmul_rn(x1, c2[row + d]), __fmul_rn(x2, -s2[row + d])));
    out[d + half] = from_f32<E>(
        __fadd_rn(__fmul_rn(x2, c2[row + d + half]), __fmul_rn(x1, -s2[row + d + half])));
  }
}

// The backward's tile classes: RG row groups of 16 rows of the block's own
// tile, SP warps splitting the streamed tile's BS rows, MIN_BLOCKS blocks an
// SM for the register budget.
template <int RG_, int SP_, int BS_, int MIN_BLOCKS_>
struct BwdTiles {
  static constexpr int RG = RG_, SP = SP_, BS = BS_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int NT = 32 * RG * SP, BO = 16 * RG;  // threads, own rows
};
template <int DH>
struct DqTiles;
template <>
struct DqTiles<64> : BwdTiles<4, 2, 64, 2> {};
template <>
struct DqTiles<128> : BwdTiles<4, 2, 64, 1> {};
template <>
struct DqTiles<256> : BwdTiles<2, 2, 32, 1> {};
template <int DH>
struct DkvTiles;
template <>
struct DkvTiles<64> : BwdTiles<4, 2, 64, 2> {};
template <>
struct DkvTiles<128> : BwdTiles<4, 2, 32, 1> {};
template <>
struct DkvTiles<256> : BwdTiles<2, 2, 32, 1> {};

// own tile (two arrays) + a two-stage ring of two streamed arrays (+ the
// ring's lse and delta for dkv), or the float32 sum tile, whichever is larger
template <typename E, int DH, typename Tl>
constexpr size_t bwd_smem(bool stats) {
  const size_t tiles = (2 * Tl::BO + 4 * Tl::BS) * DH * sizeof(E) +
                       (stats ? 4 * Tl::BS * sizeof(float) : 0);
  const size_t sums = Tl::BO * (DH + 4) * sizeof(float);
  return tiles > sums ? tiles : sums;
}

// Every (query, key) pair of the tile [q0, q0 + nq) x [k0, k0 + nk) is
// visible: the tile skips the per-element index masking (2-3% of dq and
// dkv at the GPT-2 and Llama-3-8B training shapes).
__device__ __forceinline__ bool all_visible(int q0, int nq, int k0, int nk, const Dims& D) {
  if (q0 + nq > D.T || k0 + nk > D.T) return false;
  if (!D.causal) return true;
  return k0 + nk - 1 <= q0 && (D.window <= 0 || k0 > q0 + nq - 1 - D.window);
}

// No (query, key) pair of the tile is visible: a warp of the forward skips
// it (up to half the warps of the causal diagonal's tiles).
__device__ __forceinline__ bool none_visible(int q0, int nq, int k0, int nk, const Dims& D) {
  if (q0 >= D.T) return true;
  if (!D.causal) return false;
  return k0 > q0 + nq - 1 || (D.window > 0 && k0 + nk - 1 <= q0 - D.window);
}

// KV tiles [k_lo, k_hi) a Q tile [q0, q0 + BQ) sees under the causal bound
// and the window (the reference's `_kv_clamp`)
template <int BQ, int BK>
__device__ __forceinline__ void kv_range(int q0, const Dims& D, int& k_lo, int& k_hi) {
  k_lo = 0;
  k_hi = D.T;
  if (D.causal) {
    k_hi = min(D.T, q0 + BQ);
    if (D.window > 0) k_lo = max(0, q0 - D.window + 1) / BK * BK;
  }
}

// ---- forward: one block per (b * H + h, Q tile) --------------------------------

// The forward's tile classes: RG warps of 16 query rows each, BK streamed
// KV rows a step, MIN_BLOCKS blocks an SM for the register budget.
template <int RG_, int BK_, int MIN_BLOCKS_>
struct FwdTiles {
  static constexpr int RG = RG_, BK = BK_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int NT = 32 * RG, BQ = 16 * RG;  // threads, query rows
};
template <int DH>
struct FwdClass;
template <>
struct FwdClass<64> : FwdTiles<8, 32, 2> {};
template <>
struct FwdClass<128> : FwdTiles<8, 32, 1> {};
template <>
struct FwdClass<256> : FwdTiles<4, 16, 1> {};

constexpr int kFwdStages = 3;  // the forward's ring: computed, rotated, in flight

// the resident Q tile + the ring of K and V tiles
template <typename E, int DH>
constexpr size_t fwd_smem() {
  using Tl = FwdClass<DH>;
  return (Tl::BQ + 2 * kFwdStages * Tl::BK) * DH * sizeof(E);
}

template <typename E, int DH, bool ROPE>
__global__ void __launch_bounds__(FwdClass<DH>::NT, FwdClass<DH>::MIN_BLOCKS)
flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                 const float* __restrict__ c2, const float* __restrict__ s2,
                 E* __restrict__ o, float* __restrict__ lse, Dims D) {
  using Tl = FwdClass<DH>;
  constexpr int NT = Tl::NT, BQ = Tl::BQ, BK = Tl::BK;
  extern __shared__ __align__(16) unsigned char shm[];
  E* sQ = reinterpret_cast<E*>(shm);
  E* sKV = sQ + BQ * DH;  // stage s: K at sKV + 2 s BK DH, V after it

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / D.H, h = blockIdx.x - b * D.H;
  const int hk = h / (D.H / D.Hkv);
  // under causal the last Q tile sees the most KV tiles: schedule it first
  const int qt = D.causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = qt * BQ;
  int k_lo, k_hi;
  kv_range<BQ, BK>(q0, D, k_lo, k_hi);
  const int n_k = (k_hi - k_lo + BK - 1) / BK;

  // K and V tile i of the sweep into its stage of the ring
  auto stage = [&](int i) { return sKV + (i % kFwdStages) * 2 * BK * DH; };
  auto load = [&](int i) {
    copy_tile<E, BK, DH, NT>(stage(i), k, b, k_lo + i * BK, hk, D.Hkv, D);
    copy_tile<E, BK, DH, NT>(stage(i) + BK * DH, v, b, k_lo + i * BK, hk, D.Hkv, D);
  };
  copy_tile<E, BQ, DH, NT>(sQ, q, b, q0, h, D.H, D);
  load(0);
  cp_commit();
  if (n_k > 1) load(1);
  cp_commit();
  if (ROPE) {  // Q rotated once, and K tile 0, before the sweep
    cp_wait<1>();
    __syncthreads();
    rotate_landed<E, BQ, DH, NT>(sQ, c2, s2, b, q0, D);
    rotate_landed<E, BK, DH, NT>(stage(0), c2, s2, b, k_lo, D);
  }

  const int r0 = 16 * warp;  // the warp's rows of the tile; the thread's: r0 + g, r0 + g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DH / 8][4] = {};

  for (int it = 0; it < n_k; ++it) {
    const int k0 = k_lo + it * BK;
    E* sK = stage(it);
    E* sV = sK + BK * DH;
    cp_wait<0>();
    __syncthreads();  // tile it + 1 has landed and tile it is rotated; every warp is
    if (it + 2 < n_k) load(it + 2);  // done with tile it - 1, whose stage takes it + 2
    cp_commit();
    if (ROPE && it + 1 < n_k)  // rotated while other warps compute tile it
      rotate_landed<E, BK, DH, NT>(stage(it + 1), c2, s2, b, k0 + BK, D);

    if (none_visible(q0 + r0, 16, k0, BK, D)) continue;  // p = 0, alpha = 1

    // s = q.k^T of the warp's 16 rows over the whole KV tile, then the
    // online softmax of rows g and g + 8 (the quad of lanes 4g .. 4g + 3
    // holds a row)
    float s[BK / 8][4] = {};
    mma_abT<DH, BK>(s, sQ, r0, sK, 0, lane);
    const bool all = all_visible(q0 + r0, 16, k0, BK, D);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int qi = q0 + r0 + g + 8 * i, kj = k0 + 8 * j + 2 * t4 + (e & 1);
        const float x = all || visible(qi, kj, D) ? s[j][e] * D.scale : -INFINITY;
        s[j][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = mx[i] == -INFINITY ? 0.f : expf(s[j][e] - mx[i]);
        s[j][e] = p;
        sum[i] += p;  // l sums p unrounded; bf16 rounds it only for p.v
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      alpha[i] = mx[i] == -INFINITY ? 1.f : expf(m[i] - mx[i]);
      l[i] = alpha[i] * l[i] + sum[i];
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    mma_pB<DH, BK>(acc, s, sV, 0, lane);
  }

  // o = acc / l as E and lse = m + log l; rows past T are not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + r0 + g + 8 * i;
    if (t >= D.T) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    E* orow = o + ((static_cast<size_t>(b) * D.T + t) * D.H + h) * D.Dh;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * n + 2 * t4 + c;
        if (d < D.Dh) orow[d] = from_f32<E>(acc[n][2 * i + c] * inv);
      }
    if (t4 == 0) lse[(static_cast<size_t>(b) * D.H + h) * D.T + t] = m[i] + logf(l[i]);
  }
}

// ---- dq: one block per (b * H + h, Q tile) -------------------------------------

template <typename E, int DH, bool ROPE>
__global__ void __launch_bounds__(DqTiles<DH>::NT, DqTiles<DH>::MIN_BLOCKS)
flash_dq_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                const E* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const float* __restrict__ c2,
                const float* __restrict__ s2, E* __restrict__ dq, Dims D) {
  using Tl = DqTiles<DH>;
  constexpr int NT = Tl::NT, BQ = Tl::BO, BK = Tl::BS, KW = BK / Tl::SP;
  constexpr int LDA = DH + 4;
  extern __shared__ __align__(16) unsigned char shm[];
  E* sQ = reinterpret_cast<E*>(shm);
  E* sO = sQ + BQ * DH;   // dO
  E* sKV = sO + BQ * DH;  // stage s: K at sKV + 2 s BK DH, V after it

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % Tl::RG, sp = warp / Tl::RG, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / D.H, h = blockIdx.x - b * D.H;
  const int hk = h / (D.H / D.Hkv);
  // under causal the last Q tile sees the most KV tiles: schedule it first
  const int qt = D.causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = qt * BQ;
  int k_lo, k_hi;
  kv_range<BQ, BK>(q0, D, k_lo, k_hi);
  const int n_k = (k_hi - k_lo + BK - 1) / BK;

  copy_tile<E, BQ, DH, NT>(sQ, q, b, q0, h, D.H, D);
  copy_tile<E, BQ, DH, NT>(sO, dout, b, q0, h, D.H, D);
  copy_tile<E, BK, DH, NT>(sKV, k, b, k_lo, hk, D.Hkv, D);
  copy_tile<E, BK, DH, NT>(sKV + BK * DH, v, b, k_lo, hk, D.Hkv, D);
  cp_commit();

  const int ra = 16 * rg + g;  // this thread's rows of the tile: ra and ra + 8
  float lse_r[2], del_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + ra + 8 * i;
    const size_t at = (static_cast<size_t>(b) * D.H + h) * D.T + t;
    lse_r[i] = t < D.T ? lse[at] : 0.f;
    del_r[i] = t < D.T ? delta[at] : 0.f;
  }
  float acc[DH / 8][4] = {};

  for (int it = 0; it < n_k; ++it) {
    const int k0 = k_lo + it * BK;
    E* sK = sKV + (it & 1) * 2 * BK * DH;
    E* sV = sK + BK * DH;
    cp_wait<0>();
    __syncthreads();     // tile it has landed; every warp is done with tile it - 1
    if (it + 1 < n_k) {  // so its stage takes tile it + 1 while tile it is computed
      E* nK = sKV + ((it + 1) & 1) * 2 * BK * DH;
      copy_tile<E, BK, DH, NT>(nK, k, b, k0 + BK, hk, D.Hkv, D);
      copy_tile<E, BK, DH, NT>(nK + BK * DH, v, b, k0 + BK, hk, D.Hkv, D);
    }
    cp_commit();
    if (ROPE) {
      if (it == 0) rotate_sw<E, BQ, DH, NT>(sQ, c2, s2, b, q0, D);  // rotated once
      rotate_sw<E, BK, DH, NT>(sK, c2, s2, b, k0, D);
      __syncthreads();
    }

    float s[KW / 8][4] = {}, dp[KW / 8][4] = {};
    mma_abT<DH, KW>(s, sQ, 16 * rg, sK, sp * KW, lane);
    mma_abT<DH, KW>(dp, sO, 16 * rg, sV, sp * KW, lane);
    const bool all = all_visible(q0, BQ, k0, BK, D);
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int qi = q0 + ra + 8 * i, kj = k0 + sp * KW + 8 * j + 2 * t4 + (e & 1);
        const float p =
            all || visible(qi, kj, D) ? expf(s[j][e] * D.scale - lse_r[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - del_r[i]) * D.scale;  // ds
      }
    mma_pB<DH, KW>(acc, s, sK, sp * KW, lane);
  }
  __syncthreads();  // every tile is read

  float* sD = reinterpret_cast<float*>(shm);
  sum_splits<DH, Tl::SP, LDA>(sD, acc, sp, 16 * rg, lane);
  if (ROPE)
    derotate_store<E, BQ, LDA, NT>(sD, c2, s2, b, q0, h, D.H, D, dq);
  else
    store_tile<E, BQ, LDA, NT>(sD, b, q0, h, D.H, D, dq);
}

// ---- dkv: one block per (b * Hkv + kv head, KV tile) ---------------------------

template <typename E, int DH, bool ROPE, bool DK, bool DV>
__global__ void __launch_bounds__(DkvTiles<DH>::NT, DkvTiles<DH>::MIN_BLOCKS)
flash_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                 const E* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const float* __restrict__ c2,
                 const float* __restrict__ s2, E* __restrict__ dk, E* __restrict__ dv,
                 Dims D) {
  using Tl = DkvTiles<DH>;
  constexpr int NT = Tl::NT, BK = Tl::BO, BQ = Tl::BS, QW = BQ / Tl::SP;
  constexpr int LDA = DH + 4;
  extern __shared__ __align__(16) unsigned char shm[];
  E* sK = reinterpret_cast<E*>(shm);
  E* sV = sK + BK * DH;
  E* sQO = sV + BK * DH;  // stage s: Q at sQO + 2 s BQ DH, dO after it
  float* sStat = reinterpret_cast<float*>(sQO + 4 * BQ * DH);  // stage s: lse, delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % Tl::RG, sp = warp / Tl::RG, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / D.Hkv, hk = blockIdx.x - b * D.Hkv;
  const int G = D.H / D.Hkv;
  // under causal the first KV tile sees the most Q tiles, and blockIdx.y =
  // 0 is scheduled first for every (b, kv head)
  const int k0 = blockIdx.y * BK;
  int q_lo = 0, q_hi = D.T;
  if (D.causal) {
    q_lo = k0 / BQ * BQ;
    if (D.window > 0 && D.window < D.T) q_hi = min(D.T, k0 + BK - 1 + D.window);
  }
  const int n_q = (q_hi - q_lo + BQ - 1) / BQ, n_it = G * n_q;

  // Q, dO, lse and delta of step `it` (head hk G + it / n_q) into stage st;
  // under rope every head of the group reads the same table rows
  auto load_step = [&](int it, int st) {
    const int gi = it / n_q, q0 = q_lo + (it - gi * n_q) * BQ, h = hk * G + gi;
    E* dst = sQO + 2 * st * BQ * DH;
    copy_tile<E, BQ, DH, NT>(dst, q, b, q0, h, D.H, D);
    copy_tile<E, BQ, DH, NT>(dst + BQ * DH, dout, b, q0, h, D.H, D);
    copy_stat<BQ, NT>(sStat + 2 * st * BQ, lse, b, h, q0, D);
    copy_stat<BQ, NT>(sStat + 2 * st * BQ + BQ, delta, b, h, q0, D);
  };
  copy_tile<E, BK, DH, NT>(sK, k, b, k0, hk, D.Hkv, D);
  copy_tile<E, BK, DH, NT>(sV, v, b, k0, hk, D.Hkv, D);
  load_step(0, 0);
  cp_commit();

  const int ra = 16 * rg + g;  // this thread's key rows of the tile: ra and ra + 8
  float acc_k[DH / 8][4] = {}, acc_v[DH / 8][4] = {};

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, gi = it / n_q, q0 = q_lo + (it - gi * n_q) * BQ;
    cp_wait<0>();
    __syncthreads();  // step it has landed; every warp is done with step it - 1,
    if (it + 1 < n_it) load_step(it + 1, st ^ 1);  // whose stage takes step it + 1
    cp_commit();
    E* sQ = sQO + 2 * st * BQ * DH;
    E* sO = sQ + BQ * DH;
    const float* sL = sStat + 2 * st * BQ;
    const float* sDl = sL + BQ;
    if (ROPE) {
      if (it == 0) rotate_sw<E, BK, DH, NT>(sK, c2, s2, b, k0, D);  // rotated once
      rotate_sw<E, BQ, DH, NT>(sQ, c2, s2, b, q0, D);
      __syncthreads();
    }

    // s^T and dp^T: rows are keys, columns queries
    float s[QW / 8][4] = {}, dp[QW / 8][4] = {};
    mma_abT<DH, QW>(s, sK, 16 * rg, sQ, sp * QW, lane);
    if (DK) mma_abT<DH, QW>(dp, sV, 16 * rg, sO, sp * QW, lane);
    const bool all = all_visible(q0, BQ, k0, BK, D);
#pragma unroll
    for (int j = 0; j < QW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = sp * QW + 8 * j + 2 * t4 + (e & 1);
        const int kj = k0 + ra + 8 * (e >> 1);
        const float p =
            all || visible(q0 + c, kj, D) ? expf(s[j][e] * D.scale - sL[c]) : 0.f;
        if (DK) dp[j][e] = p * (dp[j][e] - sDl[c]) * D.scale;  // ds^T
        s[j][e] = p;                                            // p^T
      }
    if (DV) mma_pB<DH, QW>(acc_v, s, sO, sp * QW, lane);
    if (DK) mma_pB<DH, QW>(acc_k, dp, sQ, sp * QW, lane);
  }
  __syncthreads();  // every tile is read

  float* sD = reinterpret_cast<float*>(shm);
  if (DV) {
    sum_splits<DH, Tl::SP, LDA>(sD, acc_v, sp, 16 * rg, lane);
    store_tile<E, BK, LDA, NT>(sD, b, k0, hk, D.Hkv, D, dv);
    __syncthreads();
  }
  if (DK) {
    sum_splits<DH, Tl::SP, LDA>(sD, acc_k, sp, 16 * rg, lane);
    if (ROPE)
      derotate_store<E, BK, LDA, NT>(sD, c2, s2, b, k0, hk, D.Hkv, D, dk);
    else
      store_tile<E, BK, LDA, NT>(sD, b, k0, hk, D.Hkv, D, dk);
  }
}

// ---- launchers -------------------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the copied operands (q, k, v, and dO in the backward) may be copied 16
// bytes at a time: every row of each (and of the forward's rope tables)
// starts on a 16-byte boundary
template <typename E, typename... P>
Dims copy_dims(Dims D, const P*... ptrs) {
  D.vec16 = (D.Dh * sizeof(E)) % 16 == 0 && (aligned16(ptrs) && ...);
  return D;
}

template <typename E, int DH, bool ROPE>
int fwd(const void* q, const void* k, const void* v, const float* c2, const float* s2,
        void* o, float* lse, const Dims& D, cudaStream_t st) {
  using Tl = FwdClass<DH>;
  const size_t smem = fwd_smem<E, DH>();
  auto kernel = flash_fwd_kernel<E, DH, ROPE>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(D.B * D.H, (D.T + Tl::BQ - 1) / Tl::BQ);
  kernel<<<grid, Tl::NT, smem, st>>>(static_cast<const E*>(q), static_cast<const E*>(k),
                                     static_cast<const E*>(v), c2, s2, static_cast<E*>(o),
                                     lse, copy_dims<E>(D, q, k, v, c2, s2));
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int DH, bool ROPE>
int dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
       const float* delta, const float* c2, const float* s2, void* dq_out, const Dims& D,
       cudaStream_t st) {
  using Tl = DqTiles<DH>;
  const size_t smem = bwd_smem<E, DH, Tl>(false);
  auto kernel = flash_dq_kernel<E, DH, ROPE>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(D.B * D.H, (D.T + Tl::BO - 1) / Tl::BO);
  kernel<<<grid, Tl::NT, smem, st>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(dout), lse, delta, c2, s2, static_cast<E*>(dq_out),
      copy_dims<E>(D, q, k, v, dout));
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int DH, bool ROPE, bool DK, bool DV>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const float* c2, const float* s2,
               void* dk, void* dv, const Dims& D, cudaStream_t st) {
  using Tl = DkvTiles<DH>;
  const size_t smem = bwd_smem<E, DH, Tl>(true);
  auto kernel = flash_dkv_kernel<E, DH, ROPE, DK, DV>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(D.B * D.Hkv, (D.T + Tl::BO - 1) / Tl::BO);
  kernel<<<grid, Tl::NT, smem, st>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(dout), lse, delta, c2, s2, static_cast<E*>(dk),
      static_cast<E*>(dv), copy_dims<E>(D, q, k, v, dout));
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int DH, bool ROPE>
int dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* delta, const float* c2, const float* s2, void* dk, void* dv,
        const Dims& D, cudaStream_t st) {
  if constexpr (DH <= 128) {
    return dkv_launch<E, DH, ROPE, true, true>(q, k, v, dout, lse, delta, c2, s2, dk, dv, D,
                                               st);
  } else {  // dv, then dk: both at once would not fit the registers
    const int err = dkv_launch<E, DH, ROPE, false, true>(q, k, v, dout, lse, delta, c2, s2,
                                                         dk, dv, D, st);
    if (err) return err;
    return dkv_launch<E, DH, ROPE, true, false>(q, k, v, dout, lse, delta, c2, s2, dk, dv, D,
                                                st);
  }
}

// Dh <= 64, <= 128, <= 256 pick the tile class; the wrapper refuses Dh > 256.
template <typename E, bool ROPE>
int fwd_any(const void* q, const void* k, const void* v, const float* c2, const float* s2,
            void* o, float* lse, const Dims& D, cudaStream_t st) {
#define FWD_CALL(DH) fwd<E, DH, ROPE>(q, k, v, c2, s2, o, lse, D, st)
  if (D.Dh <= 64) return FWD_CALL(64);
  if (D.Dh <= 128) return FWD_CALL(128);
  return FWD_CALL(256);
#undef FWD_CALL
}

template <typename E, bool ROPE>
int dq_any(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, const float* c2, const float* s2, void* dq_out, const Dims& D,
           cudaStream_t st) {
#define DQ_CALL(DH) dq<E, DH, ROPE>(q, k, v, dout, lse, delta, c2, s2, dq_out, D, st)
  if (D.Dh <= 64) return DQ_CALL(64);
  if (D.Dh <= 128) return DQ_CALL(128);
  return DQ_CALL(256);
#undef DQ_CALL
}

template <typename E, bool ROPE>
int dkv_any(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, const float* c2, const float* s2, void* dk, void* dv,
            const Dims& D, cudaStream_t st) {
#define DKV_CALL(DH) dkv<E, DH, ROPE>(q, k, v, dout, lse, delta, c2, s2, dk, dv, D, st)
  if (D.Dh <= 64) return DKV_CALL(64);
  if (D.Dh <= 128) return DKV_CALL(128);
  return DKV_CALL(256);
#undef DKV_CALL
}

bool nothing_to_do(const Dims& D) { return D.B == 0 || D.T == 0 || D.H == 0; }

template <bool ROPE>
int fwd_entry(const void* q, const void* k, const void* v, const float* c2, const float* s2,
              void* o, float* lse, const Dims& D, int bf16, void* stream) {
  if (nothing_to_do(D)) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd_any<__nv_bfloat16, ROPE>(q, k, v, c2, s2, o, lse, D, st)
              : fwd_any<float, ROPE>(q, k, v, c2, s2, o, lse, D, st);
}

template <bool ROPE>
int dq_entry(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, const float* c2, const float* s2,
             void* dq_out, const Dims& D, int bf16, void* stream) {
  if (nothing_to_do(D)) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dq_any<__nv_bfloat16, ROPE>(q, k, v, dout, lse, delta, c2, s2, dq_out, D, st)
              : dq_any<float, ROPE>(q, k, v, dout, lse, delta, c2, s2, dq_out, D, st);
}

template <bool ROPE>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const float* c2, const float* s2,
              void* dk, void* dv, const Dims& D, int bf16, void* stream) {
  if (nothing_to_do(D)) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dkv_any<__nv_bfloat16, ROPE>(q, k, v, dout, lse, delta, c2, s2, dk, dv, D, st)
              : dkv_any<float, ROPE>(q, k, v, dout, lse, delta, c2, s2, dk, dv, D, st);
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int T, int H, int Hkv, int Dh,
                                   int causal, int window, float scale, int bf16,
                                   void* stream) {
  return fwd_entry<false>(q, k, v, nullptr, nullptr, o, lse,
                          Dims{B, T, H, Hkv, Dh, causal, window, scale}, bf16, stream);
}

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  void* dq_out, int B, int T, int H, int Hkv, int Dh,
                                  int causal, int window, float scale, int bf16,
                                  void* stream) {
  return dq_entry<false>(q, k, v, dout, lse, delta, nullptr, nullptr, dq_out,
                         Dims{B, T, H, Hkv, Dh, causal, window, scale}, bf16, stream);
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   void* dk, void* dv, int B, int T, int H, int Hkv, int Dh,
                                   int causal, int window, float scale, int bf16,
                                   void* stream) {
  return dkv_entry<false>(q, k, v, dout, lse, delta, nullptr, nullptr, dk, dv,
                          Dims{B, T, H, Hkv, Dh, causal, window, scale}, bf16, stream);
}

// The rope-on-load variants: the same operands with the tables c2 and s2
// ([B, T, Dh] float32) after q, k, v (and dO, lse, delta); Dh must be even.
extern "C" int flash_attention_rope_fwd(const void* q, const void* k, const void* v,
                                        const float* c2, const float* s2, void* o,
                                        float* lse, int B, int T, int H, int Hkv, int Dh,
                                        int causal, int window, float scale, int bf16,
                                        void* stream) {
  return fwd_entry<true>(q, k, v, c2, s2, o, lse,
                         Dims{B, T, H, Hkv, Dh, causal, window, scale}, bf16, stream);
}

extern "C" int flash_attention_rope_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse,
                                       const float* delta, const float* c2,
                                       const float* s2, void* dq_out, int B, int T, int H,
                                       int Hkv, int Dh, int causal, int window, float scale,
                                       int bf16, void* stream) {
  return dq_entry<true>(q, k, v, dout, lse, delta, c2, s2, dq_out,
                        Dims{B, T, H, Hkv, Dh, causal, window, scale}, bf16, stream);
}

extern "C" int flash_attention_rope_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse,
                                        const float* delta, const float* c2,
                                        const float* s2, void* dk, void* dv, int B, int T,
                                        int H, int Hkv, int Dh, int causal, int window,
                                        float scale, int bf16, void* stream) {
  return dkv_entry<true>(q, k, v, dout, lse, delta, c2, s2, dk, dv,
                         Dims{B, T, H, Hkv, Dh, causal, window, scale}, bf16, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
