// Tensor-core and cp.async helpers shared by the hand-written Hopper
// kernels (sm_90a) of the port: flash_attention.cu (K2), grouped_matmul.cu
// (K6), flash_decode.cu (K4) and paged_attention.cu (K5). Device functions
// only, in an anonymous namespace, so each source that includes this
// header gets its own copy.
//
// float32 products at float32 accuracy run as 3xTF32 on the tensor cores:
// each operand x is split into big = tf32(x) (cvt.rna) and small =
// tf32(x - big), and a product is small*big' + big*small' + big*big'
// summed in float32 (small*small is below float32's rounding). bf16
// products are one m16n8k16 `mma` with float32 accumulation. Fragment
// layouts (g = lane / 4, t = lane % 4): m16n8k8 A (16 x 8, row) holds
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8, col) holds
// (k t, n g), (k t + 4, n g); the m16n8 accumulator holds (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). m16n8k16 bf16: the same with
// 32-bit pairs along k (2t, 2t + 1 and 2t + 8, 2t + 9).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two float32 values rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to float32 accuracy, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// split_tf32 with cvt.rna's rounding (to nearest, ties away from zero)
// done as an integer add and mask: the same bits for every finite x, in
// two integer instructions where cvt.rna.tf32.f32 compiles to about four
// (a split is two roundings and a subtraction; K6-gmm splits 96 values a
// thread a stage for its 192 `mma`, K5-chunk about as many). A non-finite
// x gives a NaN small part, as cvt.rna's split does, so the product is not
// finite either way.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32_int(float x, uint32_t& big, uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}

// the split with cvt.rna (INT false) or its integer form (INT true)
template <bool INT>
__device__ __forceinline__ void split_tf32_as(float x, uint32_t& big, uint32_t& small) {
  if constexpr (INT)
    split_tf32_int(x, big, small);
  else
    split_tf32(x, big, small);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: small*big + big*small + big*big (small*small is below float32's
// rounding), in that order into the float32 accumulator
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a) : "memory");
}

// four 8 x 8 b16 matrices, lane l giving the row address of matrix l / 8;
// register i holds matrix i in the mma fragment layout (untransposed)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a) : "memory");
}

}  // namespace
