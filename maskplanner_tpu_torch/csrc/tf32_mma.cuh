// 3xTF32 tensor-core products with mma.sync, shared by the fused
// set-abstraction backward (fused_sa_bwd.cu, the input gradients) and the
// weight-gradient kernel (sa_weight_grad.cu).
//
// A float32 value a is split into two TF32 values, hi = rna(a) and
// lo = rna(a - hi) (rna: round to nearest, ties away from zero, to a 10-bit
// mantissa, as cvt.rna.tf32.f32). The product a * b is formed as
// lo_a * hi_b + hi_a * lo_b + hi_a * hi_b, each term in an
// mma.sync.aligned.m16n8k8 TF32 product accumulated in float32: the
// dropped lo_a * lo_b and the remainders of lo are below 2^-21 of |a b|,
// so the product is as accurate as a float32 one
// (tests/test_torch_port_sa_backward.py holds the emulation,
// ops/fused_sa.py::matmul_3xtf32, within 2x the float32 product's own
// error from float64). This is what the TPU kernel's precision="highest"
// multi-pass MXU product is to the TPU.
//
// Fragments of m16n8k8 (PTX ISA), with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)

#pragma once

#include <cstdint>

namespace tf32 {

// rna on the int32 view: add half a TF32 ulp to the magnitude, then cut
// the 13 low mantissa bits. For every finite x this is cvt.rna.tf32.f32,
// but on the integer pipe rather than the slower conversion unit.
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32, from split operands; the small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                     uint32_t b1_hi, uint32_t b0_lo,
                                     uint32_t b1_lo) {
  mma(c, a_lo, b0_hi, b1_hi);
  mma(c, a_hi, b0_lo, b1_lo);
  mma(c, a_hi, b0_hi, b1_hi);
}

// 16-byte asynchronous copy global -> shared; with valid == false the 16
// bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace tf32
