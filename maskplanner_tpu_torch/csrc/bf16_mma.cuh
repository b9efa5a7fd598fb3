// bf16 tensor-core products with mma.sync, for the bf16 mode of the fused
// set-abstraction backward's weight gradients (K2,
// sa_weight_grad.cu::dw_partial_bf16). The bf16 forward and K1's bf16 mode
// run on wgmma (fused_sa_fwd_bf16.cu, fused_sa_bwd_bf16.cu,
// wgmma_bf16.cuh).
//
// The TPU kernel's precision="default" product
// (maskplanner_tpu/ops/pallas/fused_sa_train.py, `_dot`) is one MXU pass
// on operands rounded to bf16, summed in float32. Here it is
// mma.sync.aligned.m16n8k16 with bf16 operands and float32 accumulators:
// each operand is rounded to nearest even (as torch's .to(torch.bfloat16)),
// the products of two bf16 values are exact in float32, and the sums are
// the tensor core's (ops/fused_sa.py::matmul_bf16 emulates it).
//
// Fragments of m16n8k16 (PTX ISA), with g = lane / 4 and t = lane % 4; a
// 32-bit register holds two bf16 values, the lower column (or k) index in
// its low half:
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                           a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, k x n):      b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8):             c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                           c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace bf16 {

// Two float32 values rounded to nearest even into one register of two
// bf16 values, `lo` in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a * b, m16n8k16, bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace bf16
