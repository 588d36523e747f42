// Float32 products on the TF32 tensor cores of Hopper (sm_90a), to float32
// accuracy: the 3xTF32 split, shared by the port's kernels that take it
// (csrc/flash_attention.cu, K3; csrc/ssd_scan.cu, K9).
//
// Each operand x is split into big = x rounded to TF32 and small = x - big
// (which the tensor core reads truncated to TF32), and a.b is summed as
// a_small.b_big + a_big.b_small + a_big.b_big (the small terms first) with
// float32 accumulation; what is dropped is ~2^-21 of the product.  One
// TF32 product alone is ~1e-3 off.
//
// Fragments are those of mma.sync m16n8k8 (row.col): lane (g = lane / 4,
// t = lane % 4) holds A at (row g, col t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); B at (row t, col g), (t + 4, g); C at (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
#pragma once
#include <stdint.h>

namespace {

// x = big + small: big is x rounded to TF32 (to nearest, ties away, as
// cvt.rna: add half a TF32 ulp to the magnitude bits and clear the 13 low
// ones; two integer operations, where cvt runs on the slower conversion
// pipe); small = x - big is exact in float32 and goes to the tensor core
// as it is, which reads its top 19 bits (truncation, within 2^-21 of x)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b to float32 accuracy from three TF32 products, small terms first
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t a_big[4],
                                           const uint32_t a_small[4],
                                           const uint32_t b_big[2],
                                           const uint32_t b_small[2]) {
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

}  // namespace
