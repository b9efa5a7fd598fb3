// Device functions shared by the fused set-abstraction forward
// (fused_sa_fwd.cu) and backward (fused_sa_bwd.cu).
//
// The backward recomputes the forward's activations and routes the
// max-pool gradient to the first neighbour whose activation EQUALS the
// pooled value the forward wrote. So both kernels must form every
// activation bit for bit alike: they share the selection distance, the
// layer product and the LayerNorm below, and nothing else computes them.

#pragma once

#include <cuda_runtime.h>

namespace fused_sa {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows per thread in the layer products
constexpr float kLayerNormEps = 1e-6f;

// What layer_product stores: the sum, max(sum, 0), or the sum where the
// value already in the output is > 0 and 0 elsewhere (a ReLU's backward,
// with the activation as the mask, overwritten in place).
enum Store { kStorePlain, kStoreRelu, kStoreMaskByOut };

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float x, float y, float z) {
  const float dx = __fsub_rn(qx, x);
  const float dy = __fsub_rn(qy, y);
  const float dz = __fsub_rn(qz, z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// out[k][o] = bias[o] + sum_i in[k][i] * w[i][o] for k < rows, o < n_out,
// by the whole block (bias may be null: 0). w4 is (n_in, n_out / 4) float4,
// row-major; n_out is a multiple of 4; kStore is a Store. A thread
// computes a kRows x 4 tile: rows kg + r * kq (neighbouring lanes take
// neighbouring rows; with an odd row stride no bank conflict) and outputs
// 4 og .. 4 og + 3 (one float4 of weights per input, shared by the lanes of
// the same og). Each output is one fmaf chain over i in ascending order,
// whatever the tiling. The caller synchronises afterwards.
template <int kStore>
__device__ __forceinline__ void layer_product(
    const float* in, int ld_in, int n_in, int rows, const float4* w4,
    const float* bias, int n_out, float* out, int ld_out) {
  const int o4 = n_out >> 2;
  const int kq = (rows + kRows - 1) / kRows;
  for (int e = threadIdx.x; e < kq * o4; e += blockDim.x) {
    const int kg = e % kq;
    const int og = e / kq;
    const float* h[kRows];
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int k = kg + r * kq;
      h[r] = in + (k < rows ? k : kg) * ld_in;  // rows past the end: unused
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = bias == nullptr ? 0.f : __ldg(bias + 4 * og + c);
      }
    }
    for (int i = 0; i < n_in; ++i) {
      const float4 w = __ldg(w4 + static_cast<size_t>(i) * o4 + og);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float hv = h[r][i];
        acc[r][0] = fmaf(w.x, hv, acc[r][0]);
        acc[r][1] = fmaf(w.y, hv, acc[r][1]);
        acc[r][2] = fmaf(w.z, hv, acc[r][2]);
        acc[r][3] = fmaf(w.w, hv, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int k = kg + r * kq;
      if (k >= rows) continue;
      float* o = out + k * ld_out + 4 * og;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (kStore == kStoreRelu) {
          o[c] = fmaxf(acc[r][c], 0.f);
        } else if (kStore == kStoreMaskByOut) {
          o[c] = o[c] > 0.f ? acc[r][c] : 0.f;
        } else {
          o[c] = acc[r][c];
        }
      }
    }
  }
}

// LayerNorm statistics of one row of n channels, by one warp: centred
// two-pass mean and variance. Every lane returns the same mu and inv.
__device__ __forceinline__ void layer_norm_stats(const float* row, int n,
                                                 int lane, float& mu,
                                                 float& inv) {
  const float inv_c = 1.f / static_cast<float>(n);
  float sum = 0.f;
  for (int c = lane; c < n; c += 32) sum += row[c];
  mu = warp_sum(sum) * inv_c;
  float sq = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float d = row[c] - mu;
    sq = fmaf(d, d, sq);
  }
  inv = rsqrtf(warp_sum(sq) * inv_c + kLayerNormEps);
}

__device__ __forceinline__ float layer_norm_xhat(float h, float mu,
                                                 float inv) {
  return (h - mu) * inv;
}

// The activation after LayerNorm: relu(gamma * xhat + beta).
__device__ __forceinline__ float layer_norm_act(float xhat, float gamma,
                                                float beta) {
  return fmaxf(fmaf(xhat, gamma, beta), 0.f);
}

}  // namespace fused_sa
