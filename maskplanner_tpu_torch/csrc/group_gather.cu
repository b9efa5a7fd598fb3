// Ball-group gather and ball query for Hopper (sm_90a).
//
// Replaces two Pallas kernels:
// - maskplanner_tpu/ops/pallas/group_gather.py (`_ball_group_raw`, body
//   `_kernel`): for every query q (an FPS centroid), the first K source
//   points in index order with |x - q|^2 <= r^2, then the rows
//   [x - q ; f] (offsets first, then features) of those neighbours, written
//   as (B, S, K, 3 + F) f32, and the indices (B, S, K) int32;
// - maskplanner_tpu/ops/pallas/ball_query.py (`ball_query_pallas`): the
//   same indices alone.
// Both take the selection from ball_select.cuh, the code the fused SA
// forward uses, so that every neighbour list of the port is the same.
//
// What bounds it on this card: at sa2 of the flagship step (B 64, S 128,
// K 64, F 128) the bytes: 275 MB of output, about 0.08 ms at 3.35 TB/s.
// At sa1 (S 512, K 32, no features) the output is 17 MB and the distance
// scan (at most 168 M point pairs, fewer since the scan stops at the K-th
// neighbour) is the larger of the two, both well under 0.1 ms.
//
// What the design does about it: one block per query. The block selects
// the neighbours into shared memory, then writes the query's K x (3 + F)
// output values, which are contiguous in device memory, with neighbouring
// threads on neighbouring values: every store instruction of a warp covers
// 128 consecutive bytes whatever the row stride (131 floats at sa2, not
// 16-byte aligned), and a warp's loads read consecutive channels of one
// source row. The TPU kernel's one-hot matrix extraction, hi/lo bf16 split
// and float-coded indices exist because the TPU has no gather; here the
// rows are read straight from the tables, so the values are exact copies
// (offsets: one float subtraction, as in the plain version). Several
// queries a block, and staging the cloud in shared memory for sa1's scan,
// are later work.
//
// The single-pass variant (ball_group_single_forward) replaces the same
// kernel's single_pass=True, which bf16 models group with: every gathered
// channel lands rounded to bf16, the offsets as bf16(x) - q in float32,
// and the consumer, a bf16 MLP, rounds the row to bf16. Here the kernel
// writes that row itself, as bf16: bf16(bf16(x) - q) and bf16(f), each
// rounded to nearest even, which halves the bytes written (sa2: 138 MB
// at batch 64), the bound of this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "ball_select.cuh"
#include "fused_sa_common.cuh"

namespace {

using fused_sa::kThreads;

// Out: float (the values) or __nv_bfloat16 (the single-pass row).
template <bool kGather, typename Out>
__global__ void __launch_bounds__(kThreads)
    ball_group_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ new_xyz,
                      const float* __restrict__ feats, int n, int s, int f,
                      int k_nb, float radius2, Out* __restrict__ grouped,
                      int* __restrict__ idx_out) {
  extern __shared__ int smem[];
  int* sel = smem;                                             // k_nb
  unsigned* ballots = reinterpret_cast<unsigned*>(sel + k_nb);  // 32

  const int query = blockIdx.x;  // b * s + j
  const int b = query / s;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  const float qx = new_xyz[3 * static_cast<size_t>(query)];
  const float qy = new_xyz[3 * static_cast<size_t>(query) + 1];
  const float qz = new_xyz[3 * static_cast<size_t>(query) + 2];

  ball_select::select_first_k(pts, n, qx, qy, qz, radius2, k_nb, sel,
                              ballots,
                              idx_out + static_cast<size_t>(query) * k_nb);
  if (!kGather) return;

  // -- the query's K x cin output values, channel-last -------------------
  constexpr bool kSingle = !std::is_same<Out, float>::value;
  const int cin = 3 + f;
  Out* out = grouped + static_cast<size_t>(query) * k_nb * cin;
  const float* fb = feats + static_cast<size_t>(b) * n * f;
  for (int e = threadIdx.x; e < k_nb * cin; e += blockDim.x) {
    const int k = e / cin;
    const int c = e - k * cin;
    const int j = sel[k];
    float v;
    if (c < 3) {
      const float qc = c == 0 ? qx : (c == 1 ? qy : qz);
      float x = pts[3 * j + c];
      if (kSingle) x = __bfloat162float(__float2bfloat16_rn(x));
      v = __fsub_rn(x, qc);
    } else {
      v = fb[static_cast<size_t>(j) * f + (c - 3)];
    }
    if constexpr (kSingle) {
      out[e] = __float2bfloat16_rn(v);
    } else {
      out[e] = v;
    }
  }
}

template <bool kGather, typename Out = float>
int launch(const float* xyz, const float* new_xyz, const float* feats, int b,
           int n, int s, int f, int k_nb, float radius2, Out* grouped,
           int* idx, void* stream) {
  if (b <= 0 || n <= 0 || s <= 0 || k_nb <= 0 || f < 0 ||
      (f > 0 && feats == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int) * k_nb + sizeof(unsigned) * 32;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  ball_group_kernel<kGather, Out>
      <<<b * s, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          xyz, new_xyz, feats, n, s, f, k_nb, radius2, grouped, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz (b, n, 3), new_xyz (b, s, 3), feats (b, n, f) or null when f == 0, all
// f32 contiguous; radius2 = r^2 in f32. Writes grouped (b, s, k_nb, 3 + f)
// f32 ([x - q ; f] of each neighbour) and idx (b, s, k_nb) int32. Returns a
// cudaError_t as int (0 = launched).
extern "C" int ball_group_forward(const float* xyz, const float* new_xyz,
                                  const float* feats, int b, int n, int s,
                                  int f, int k_nb, float radius2,
                                  float* grouped, int* idx, void* stream) {
  return launch<true>(xyz, new_xyz, feats, b, n, s, f, k_nb, radius2, grouped,
                      idx, stream);
}

// The single-pass variant: as ball_group_forward, but grouped (b, s, k_nb,
// 3 + f) bf16, bf16(bf16(x) - q) and bf16(f) of each neighbour.
extern "C" int ball_group_single_forward(const float* xyz,
                                         const float* new_xyz,
                                         const float* feats, int b, int n,
                                         int s, int f, int k_nb,
                                         float radius2, void* grouped,
                                         int* idx, void* stream) {
  return launch<true>(xyz, new_xyz, feats, b, n, s, f, k_nb, radius2,
                      static_cast<__nv_bfloat16*>(grouped), idx, stream);
}

// The indices alone: idx (b, s, k_nb) int32, as ball_group_forward's.
extern "C" int ball_query_forward(const float* xyz, const float* new_xyz,
                                  int b, int n, int s, int k_nb,
                                  float radius2, int* idx, void* stream) {
  return launch<false>(xyz, new_xyz, nullptr, b, n, s, 0, k_nb, radius2,
                       static_cast<float*>(nullptr), idx, stream);
}
