// First-K ball-query selection, shared by the fused set-abstraction forward
// (fused_sa_fwd.cu) and the ball-group gather and ball query
// (group_gather.cu), so that every kernel that selects neighbours selects
// the same ones.
//
// Semantics (the JAX package's query_ball_point): the first k_nb points in
// ascending index order with |x - q|^2 <= r^2, the distance formed by
// fused_sa::sq_dist in the plain version's fixed order, so the indices
// equal the plain version's bit for bit; slots past the in-radius count
// repeat the first in-radius index; an empty ball gives index 0.
//
// Two schemes, the same indices:
// - select_first_k: the block scans blockDim.x consecutive points a round;
//   in each warp __ballot_sync + __popc rank the in-radius points, the
//   warps' ballots are summed in shared memory so the block keeps the index
//   order, and the scan stops at the round in which the k_nb-th point is
//   found;
// - select_first_k_warp: one warp scans 32 kPer points a step with no
//   barrier, each step's points loaded one step ahead, so that several
//   warps select for several queries at once (the fused forward).

#pragma once

#include <cuda_runtime.h>

#include "fused_sa_common.cuh"

namespace ball_select {

// By the whole block (blockDim.x a multiple of 32, at most 1024). pts: the
// (n, 3) points of one cloud; sel: k_nb ints and ballots: 32 unsigned, both
// in shared memory. On return (synchronised) sel[0 .. k_nb) holds the
// neighbour indices; idx_out, when not null, gets them too.
__device__ __forceinline__ void select_first_k(
    const float* __restrict__ pts, int n, float qx, float qy, float qz,
    float radius2, int k_nb, int* sel, unsigned* ballots,
    int* __restrict__ idx_out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  int count = 0;  // identical in every thread (read from shared memory)
  for (int base = 0; base < n && count < k_nb; base += blockDim.x) {
    const int j = base + tid;
    const bool in = j < n && fused_sa::sq_dist(qx, qy, qz, pts[3 * j],
                                               pts[3 * j + 1],
                                               pts[3 * j + 2]) <= radius2;
    const unsigned m = __ballot_sync(0xffffffffu, in);
    if (lane == 0) ballots[warp] = m;
    __syncthreads();
    int rank = count;
    int total = 0;
    for (int w = 0; w < n_warps; ++w) {
      const int c = __popc(ballots[w]);
      if (w < warp) rank += c;
      total += c;
    }
    if (in) {
      rank += __popc(m & ((1u << lane) - 1u));
      if (rank < k_nb) sel[rank] = j;
    }
    count += total;
    __syncthreads();
  }
  // missing slots repeat the first neighbour; an empty ball gives index 0
  const int found = count < k_nb ? count : k_nb;
  const int first = found > 0 ? sel[0] : 0;
  __syncthreads();
  for (int k = tid; k < k_nb; k += blockDim.x) {
    const int v = k < found ? sel[k] : first;
    sel[k] = v;
    if (idx_out != nullptr) idx_out[k] = v;
  }
  __syncthreads();
}

// The same selection by one warp (all 32 lanes call it), kPer points a
// lane a step: lane l tests points base + p * 32 + l, so a step's ballots,
// taken in p order, keep the index order. Each step's points are loaded
// one step ahead, so that their latency overlaps the step before. sel:
// k_nb ints in shared memory; on return (after __syncwarp) sel[0 .. k_nb)
// holds the neighbour indices, and so does idx_out.
template <int kPer>
__device__ __forceinline__ void select_first_k_warp(
    const float* __restrict__ pts, int n, float qx, float qy, float qz,
    float radius2, int k_nb, int* sel, int* __restrict__ idx_out) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  float px[kPer], py[kPer], pz[kPer];
  auto load = [&](int base) {  // clamped past the end: always in bounds
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int jc = min(base + p * 32 + lane, n - 1);
      px[p] = __ldg(pts + 3 * jc);
      py[p] = __ldg(pts + 3 * jc + 1);
      pz[p] = __ldg(pts + 3 * jc + 2);
    }
  };
  int count = 0;  // identical in every lane
  load(0);
  for (int base = 0; base < n && count < k_nb; base += 32 * kPer) {
    bool in[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      in[p] = base + p * 32 + lane < n &&
              fused_sa::sq_dist(qx, qy, qz, px[p], py[p], pz[p]) <= radius2;
    }
    load(base + 32 * kPer);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const unsigned m = __ballot_sync(0xffffffffu, in[p]);
      if (in[p]) {
        const int rank = count + __popc(m & below);
        if (rank < k_nb) sel[rank] = base + p * 32 + lane;
      }
      count += __popc(m);
    }
  }
  __syncwarp();
  // missing slots repeat the first neighbour; an empty ball gives index 0
  const int found = count < k_nb ? count : k_nb;
  const int first = found > 0 ? sel[0] : 0;
  __syncwarp();
  for (int k = lane; k < k_nb; k += 32) {
    const int v = k < found ? sel[k] : first;
    sel[k] = v;
    idx_out[k] = v;
  }
  __syncwarp();
}

}  // namespace ball_select
