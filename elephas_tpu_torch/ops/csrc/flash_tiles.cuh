// Tensor-core attention tile helpers shared by the flash-attention kernels
// (flash_attention.cu, K2) and the paged chunk kernel (paged_attention.cu,
// K5-chunk): the swizzled shared-memory tile layout and the two products
// of an attention step on `mma.sync`, s = q.k^T and o += p.v, with a warp
// owning 16 query rows. Device functions only, in an anonymous namespace.
//
// float32 operands run as 3xTF32 (mma_helpers.cuh): K2's `mma_abT` /
// `mma_pB` on float32 tiles, and K5-chunk's `mma_qkT8` (q given as its
// two TF32 planes, 8 keys a warp) / `mma_pB_tf32`. A bf16 K or V tile
// under float32 q and p (K5-chunk's products with a bf16 B) is widened on
// load: a bf16 value is exact in TF32, so its small part is 0 and each
// product is two TF32 ones, small*big' + big*big', still at float32
// accuracy. K2's bf16 path (bf16 q, k, v and p rounded to bf16) keeps its
// m16n8k16 products (`mma_abT` / `mma_pB` with bf16 operands).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_helpers.cuh"

namespace {

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

// four consecutive elements of a swizzled tile (a 4-aligned column start
// keeps them inside one 16-byte chunk) as float32; one element
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// a B operand element as TF32: split in two for float32 (with cvt.rna, or
// its integer form where INT); a widened bf16 is its own big part (its
// small part is 0)
template <bool INT>
__device__ __forceinline__ void split_b(float x, uint32_t& big, uint32_t& small, float) {
  split_tf32_as<INT>(x, big, small);
}
template <bool INT>
__device__ __forceinline__ void split_b(float x, uint32_t& big, uint32_t&, __nv_bfloat16) {
  big = __float_as_uint(x);
}

// c += A.B as TF32 products: small*big' + big*big', and big*small' between
// them unless B is exact in TF32 (a widened bf16)
template <bool EXACT_B>
__device__ __forceinline__ void mma_tf32x(float (&c)[4], const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                          const uint32_t (&bs)[2]) {
  if constexpr (EXACT_B) {
    mma_tf32(c, as, bb);
    mma_tf32(c, ab, bb);
  } else {
    mma_3xtf32(c, ab, as, bb, bs);
  }
}

// c[16 x NW] += A[ra .. ra+16) . B[rb .. rb+NW)^T over all DH columns, A and
// B swizzled float32 tiles; c in the m16n8 accumulator layout, one [4] per
// 8 columns (rows g and g + 8, columns 2t and 2t + 1, g = lane / 4, t =
// lane % 4). m16n8k8 3xTF32, each operand split as it is loaded. The
// reduced index is summed in any order, so within each 16 columns the
// thread's four (4t .. 4t + 3) come in one 16-byte load: columns 4t and
// 4t + 1 are the first k-step's t and t + 4, 4t + 2 and 4t + 3 the
// second's.
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

// c[16 x 8] = A[0 .. 16) . B[rb .. rb+8)^T over all DH columns, for a warp
// that owns 8 keys: A given as its two TF32 planes (big in Ab, small in
// As, split once beforehand), B a swizzled float32 tile split on load by
// cvt.rna's integer form, or a bf16 tile widened (exact in TF32: its small
// part is 0, two products instead of three). With one 8-key tile a single
// accumulator would chain every product of every k-step, one `mma`
// latency each; each (product, k half) here has its own accumulator, 6
// (or 4) independent chains of DH / 16, summed in float32 at the end.
template <int DH, typename TB>
__device__ __forceinline__ void mma_qkT8(float (&c)[4], const float* Ab, const float* As,
                                         const TB* B, int rb, int lane) {
  constexpr bool kExact = sizeof(TB) == 2;
  constexpr int NA = kExact ? 2 : 3;  // products a k half
  const int g = lane >> 2, t = lane & 3;
  float d[2][NA][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < DH; k0 += 16) {
    const float4 lo = ld4(Ab + sw<float, DH>(g, k0 + 4 * t));
    const float4 hi = ld4(Ab + sw<float, DH>(g + 8, k0 + 4 * t));
    const float4 slo = ld4(As + sw<float, DH>(g, k0 + 4 * t));
    const float4 shi = ld4(As + sw<float, DH>(g + 8, k0 + 4 * t));
    const float4 x = ld4(B + sw<TB, DH>(rb + g, k0 + 4 * t));
    const uint32_t ab[2][4] = {
        {__float_as_uint(lo.x), __float_as_uint(hi.x), __float_as_uint(lo.y), __float_as_uint(hi.y)},
        {__float_as_uint(lo.z), __float_as_uint(hi.z), __float_as_uint(lo.w), __float_as_uint(hi.w)}};
    const uint32_t as[2][4] = {
        {__float_as_uint(slo.x), __float_as_uint(shi.x), __float_as_uint(slo.y),
         __float_as_uint(shi.y)},
        {__float_as_uint(slo.z), __float_as_uint(shi.z), __float_as_uint(slo.w),
         __float_as_uint(shi.w)}};
    const float xs[2][2] = {{x.x, x.y}, {x.z, x.w}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t bb[2], bs[2];
      if constexpr (kExact) {
        bb[0] = __float_as_uint(xs[h][0]);
        bb[1] = __float_as_uint(xs[h][1]);
      } else {
        split_tf32_int(xs[h][0], bb[0], bs[0]);
        split_tf32_int(xs[h][1], bb[1], bs[1]);
      }
      mma_tf32(d[h][0], as[h], bb);
      mma_tf32(d[h][NA - 1], ab[h], bb);
      if constexpr (!kExact) mma_tf32(d[h][1], ab[h], bs);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float x = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int a = 0; a < NA; ++a) x += d[h][a][e];
    c[e] = x;
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
// rows are the reduced index: float32, split on load (by cvt.rna, or its
// integer form where INT), or bf16, widened and exact in TF32 (two
// products). The tensor cores round each accumulation toward zero, so
// a chain of mma into one accumulator over every tile of a long sequence
// drifts (past the float32 pin at T 2048, G 4): each 8 columns of this
// tile's product are summed in a fresh accumulator and added to c once, in
// float32. The m16n8 accumulator does not have the m16n8k8 A layout, so
// the reduced index of each 8-wide chunk is taken in the order (0, 2, 4,
// 6, 1, 3, 5, 7): A's column t is the chunk's column 2t, its column t + 4
// the chunk's 2t + 1, and B's rows follow.
template <int DH, int KW, typename TB, bool INT>
__device__ __forceinline__ void mma_pB_tf32(float (&c)[DH / 8][4], const float (&p)[KW / 8][4],
                                            const TB* B, int rb, int lane) {
  constexpr bool kExact = sizeof(TB) == 2;
  const int g = lane >> 2, t = lane & 3;
  uint32_t ab[KW / 8][4], as[KW / 8][4];
#pragma unroll
  for (int j = 0; j < KW / 8; ++j) {
    split_tf32_as<INT>(p[j][0], ab[j][0], as[j][0]);
    split_tf32_as<INT>(p[j][2], ab[j][1], as[j][1]);
    split_tf32_as<INT>(p[j][1], ab[j][2], as[j][2]);
    split_tf32_as<INT>(p[j][3], ab[j][3], as[j][3]);
  }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    float d[4] = {};
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
      uint32_t bb[2], bs[2];
      split_b<INT>(ld1(B + sw<TB, DH>(rb + 8 * j + 2 * t, 8 * n + g)), bb[0], bs[0], TB());
      split_b<INT>(ld1(B + sw<TB, DH>(rb + 8 * j + 2 * t + 1, 8 * n + g)), bb[1], bs[1],
                   TB());
      mma_tf32x<kExact>(d, ab[j], as[j], bb, bs);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += d[e];
  }
}

template <int DH, int KW>
__device__ __forceinline__ void mma_pB(float (&c)[DH / 8][4], const float (&p)[KW / 8][4],
                                       const float* B, int rb, int lane) {
  mma_pB_tf32<DH, KW, float, false>(c, p, B, rb, lane);
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

}  // namespace
