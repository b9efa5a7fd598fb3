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

#include "tf32_mma.cuh"

// Timing studies of the backward only (fused_sa_bwd.cu, which documents
// the bits); 0 in every real build.
#ifndef SA_BWD_SKIP
#define SA_BWD_SKIP 0
#endif

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

// A group of n consecutive threads of the block (whole warps) that works
// and synchronises on its own: barrier `bar` (0: the whole block).
struct Threads {
  int tid;  // the thread's index in the group
  int n;    // threads in the group
  int bar;  // its named barrier

  __device__ __forceinline__ void sync() const {
    if (bar == 0) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(n) : "memory");
    }
  }
};

// Copy rows [i0, i0 + cnt) of a row-major (n, n_out) weight in device
// memory (16-byte aligned rows, n_out a multiple of 4) into shared memory
// at stride ldw, asynchronously (cp.async), by the threads of `th`;
// commits one group of copies.
__device__ __forceinline__ void stage_rows(const Threads& th,
                                           const float* __restrict__ w,
                                           int n_out, int i0, int cnt,
                                           float* dst, int ldw) {
  const int o4 = n_out >> 2;
  for (int e = th.tid; e < cnt * o4; e += th.n) {
    const int i = e / o4;
    const int c = (e - i * o4) << 2;
    tf32::cp_async16(dst + i * ldw + c,
                     w + static_cast<size_t>(i0 + i) * n_out + c, true);
  }
  tf32::cp_async_commit();
}

// The layer product of layer_product, out[k][o] = bias[o] + sum_i
// in[k][i] * w[i][o], for the backward's recompute, with the weights in
// shared memory. Either the whole weight wt (n_in, n_out) already sits at
// wbuf (resident, stride ldw), or its rows go through wbuf in tiles of
// `tile` input channels, two buffers of stride ldw (at least n_out, a
// multiple of 4), the next tile copied (cp.async) while the block computes
// on the current one. Each output is still ONE fmaf chain over i in
// ascending order, starting from the bias, whatever the tiling: tiles go in
// order and a thread keeps its accumulators across them. So every value is
// bit for bit the one layer_product and the forward kernel form, which the
// backward's first-winner routing needs. A thread computes kR rows x 4
// outputs (kR chosen by the caller so that the rows x n_out outputs keep
// every thread busy); a warp spans at most 8 rows (with a row stride of 4
// mod 32 its reads of `in` are conflict-free) and 4 outputs per row it
// spans. Above th.n work items it makes several passes, streaming the
// weights again. store is a Store, kStorePlain or kStoreRelu (an argument,
// not a template parameter: one copy of the code). Every thread of `th`
// must call it; the caller synchronises afterwards.
template <int kR>
__device__ void staged_product(const Threads& th, int store, const float* in,
                               int ld_in, int n_in,
                               int rows, const float* __restrict__ wt,
                               const float* __restrict__ bias, int n_out,
                               float* out, int ld_out, float* wbuf, int tile,
                               int ldw, bool resident) {
  const int o4 = n_out >> 2;
  const int kq = (rows + kR - 1) / kR;
  // a warp: kb rows x ob float4 outputs; kw warps along the rows
  const int kb = kq % 8 == 0 ? 8 : (kq % 4 == 0 ? 4 : (kq % 2 == 0 ? 2 : 1));
  const int ob = 32 / kb;
  const int kw = kq / kb;
  const int warps = kw * ((o4 + ob - 1) / ob);
  const int lane = th.tid & 31;
  if (resident) tile = n_in;
  const int n_tiles = (n_in + tile - 1) / tile;
  for (int base = 0; base < warps; base += th.n >> 5) {
    const int wi = base + (th.tid >> 5);
    const int kg = (wi % kw) * kb + lane % kb;
    const int og = (wi / kw) * ob + lane / kb;
    const bool active = wi < warps && og < o4;
    const float* h[kR];
    float acc[kR][4];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int k = kg + r * kq;
      h[r] = in + (k < rows ? k : 0) * ld_in;  // rows past the end: unused
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = (bias == nullptr || !active) ? 0.f
                                                 : __ldg(bias + 4 * og + c);
      }
    }
    const bool stage = !resident && !(SA_BWD_SKIP & 64);
    if (stage) stage_rows(th, wt, n_out, 0, min(tile, n_in), wbuf, ldw);
    for (int t = 0; t < n_tiles; ++t) {
      const int i0 = t * tile;
      if (!resident) {
        if (t + 1 < n_tiles && stage) {
          stage_rows(th, wt, n_out, i0 + tile, min(tile, n_in - i0 - tile),
                     wbuf + ((t + 1) & 1) * tile * ldw, ldw);
          tf32::cp_async_wait<1>();
        } else {
          tf32::cp_async_wait<0>();
        }
        th.sync();
      }
      if (active && !(SA_BWD_SKIP & 128)) {
        const float* wb = wbuf + (t & 1) * tile * ldw + 4 * og;
        const int cnt = min(tile, n_in - i0);
#pragma unroll 4
        for (int i = 0; i < cnt; ++i) {
          const float4 w = *reinterpret_cast<const float4*>(wb + i * ldw);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float hv = h[r][i0 + i];
            acc[r][0] = fmaf(w.x, hv, acc[r][0]);
            acc[r][1] = fmaf(w.y, hv, acc[r][1]);
            acc[r][2] = fmaf(w.z, hv, acc[r][2]);
            acc[r][3] = fmaf(w.w, hv, acc[r][3]);
          }
        }
      }
      if (!resident) th.sync();  // the buffer is refilled two tiles on
    }
    if (!active) continue;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int k = kg + r * kq;
      if (k >= rows) continue;
      float* o = out + k * ld_out + 4 * og;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        o[c] = store == kStoreRelu ? fmaxf(acc[r][c], 0.f) : acc[r][c];
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
