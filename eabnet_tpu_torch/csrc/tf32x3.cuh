// float32 products on the tensor cores as three TF32 products (3xTF32),
// and products of bf16 operands as one bf16 product, shared by the port's
// kernels (lstm_bf.cu, tcm_chain.cu).
//
// x = hi + lo for the 3xTF32 split. hi is x rounded to TF32 (10 mantissa
// bits, to nearest, ties away from zero: cvt.rna.tf32.f32's rounding, done
// here with an integer add and mask, as cvt issues through the slower
// conversion unit); lo = x - hi is exact in float32 and goes in as it is:
// the tensor cores read the top 19 bits of a TF32 operand, which truncates
// lo. The tensor cores' float32 sum truncates where an FADD rounds, so a
// long reduction adds the mma results of a few k-steps into float32 sums.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

static __device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b, mma.sync m16n8k8 with TF32 operands and a float32 sum
static __device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the small cross terms first, a_lo b_lo dropped
static __device__ __forceinline__ void mma3(float* c, const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

static __device__ __forceinline__ void split4(const float* v, uint32_t* hi,
                                       uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
}

// Two floats rounded to bf16 and packed, the first in the low half (the
// lower k of an mma operand pair)
static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b, mma.sync m16n8k8 with bf16 operands and a float32 sum. A row
// pair (k, k + 1) in one register: with frag_a's permuted TF32 k slots
// (tq and tq + 4 hold k0 + 2 tq and k0 + 2 tq + 1), the bf16 fragment is
// the same two values of rows g and g + 8 in their natural order, and B's
// register the same two k of column g.
static __device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// c += a b as one bf16 mma into zeroed registers, then a float32 add: the
// tensor cores' float32 sum truncates, so a long chain drifts
static __device__ __forceinline__ void mma_bf16_add(float* c,
                                             const uint32_t* a, uint32_t b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(t, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}
