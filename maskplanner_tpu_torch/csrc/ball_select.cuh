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
// One scheme, a warp a query (select_first_k_warp): the warp scans 32 kPer
// points a step with no barrier, each step's points loaded one step ahead,
// so that several warps select for several queries at once. The block-wide
// scan that group_gather.cu used before (a round of blockDim.x points, the
// warps' ballots summed through shared memory between two __syncthreads)
// is gone: no kernel calls it since group_gather.cu selects a warp a query
// too.

#pragma once

#include <cuda_runtime.h>

#include "fused_sa_common.cuh"

namespace ball_select {

// The selection by one warp (all 32 lanes call it), kPer points a lane a
// step: lane l tests points base + p * 32 + l, so a step's ballots, taken
// in p order, keep the index order. The whole steps test no bound, and
// each loads its successor's points ahead, so that their latency overlaps
// the step before; the ragged last step clamps its loads. A ballot with
// no point in the ball (most of them: sa1 finds its 32 neighbours among
// 2200 points) skips the ranks. pts: the cloud in device memory (read
// through the read-only cache), or with kShared a copy staged in shared
// memory. sel: k_nb ints in shared memory; on return (after __syncwarp)
// sel[0 .. k_nb) holds the neighbour indices, and so does idx_out.
template <int kPer, bool kShared = false>
__device__ __forceinline__ void select_first_k_warp(
    const float* __restrict__ pts, int n, float qx, float qy, float qz,
    float radius2, int k_nb, int* sel, int* __restrict__ idx_out) {
  constexpr int kStep = 32 * kPer;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  float px[kPer], py[kPer], pz[kPer];
  auto load = [&](int p, int j) {
    if constexpr (kShared) {
      px[p] = pts[3 * j];
      py[p] = pts[3 * j + 1];
      pz[p] = pts[3 * j + 2];
    } else {
      px[p] = __ldg(pts + 3 * j);
      py[p] = __ldg(pts + 3 * j + 1);
      pz[p] = __ldg(pts + 3 * j + 2);
    }
  };
  int count = 0;  // identical in every lane
  auto rank = [&](int base, const bool (&in)[kPer]) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const unsigned m = __ballot_sync(0xffffffffu, in[p]);
      if (m != 0u) {
        if (in[p]) {
          const int r = count + __popc(m & below);
          if (r < k_nb) sel[r] = base + p * 32 + lane;
        }
        count += __popc(m);
      }
    }
  };
  const int n_whole = n - n % kStep;  // points of the whole steps
  int base = 0;
  if (n_whole > 0) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) load(p, p * 32 + lane);
  }
  for (; base < n_whole && count < k_nb; base += kStep) {
    bool in[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      in[p] = fused_sa::sq_dist(qx, qy, qz, px[p], py[p], pz[p]) <= radius2;
    }
    // the next step's points (the last whole step reloads its own)
    const int next = min(base + kStep, n_whole - kStep);
#pragma unroll
    for (int p = 0; p < kPer; ++p) load(p, next + p * 32 + lane);
    rank(base, in);
  }
  if (base < n && count < k_nb) {  // the ragged last step
    bool in[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int j = base + p * 32 + lane;
      load(p, min(j, n - 1));
      in[p] = j < n &&
              fused_sa::sq_dist(qx, qy, qz, px[p], py[p], pz[p]) <= radius2;
    }
    rank(base, in);
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
