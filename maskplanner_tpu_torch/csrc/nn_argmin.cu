// Masked nearest-neighbour argmin for Hopper (sm_90a).
//
// Replaces the Pallas kernel maskplanner_tpu/ops/pallas/nn_argmin.py::
// nn_argmin_pallas (body `_kernel`): for every row x_i of x (b, p1, d), the
// index of the nearest row y_j of y (b, p2, d) among the valid ones
// (y_mask), by squared distance. Ties go to the lowest index; a row with no
// valid y row gives 0. Only the (b, p1) indices reach device memory; the
// chamfer terms recompute the matched distances by a gather.
//
// The distance is formed in the fixed order of ops/distance.py,
// ((t0 + t1) + t2) + ... with t_d = (x_d - y_d)^2, through round-to-nearest
// intrinsics so that no FMA contraction changes it. The plain PyTorch
// version forms it the same way, and the two must give identical indices.
// (The TPU kernel's |y|^2 - 2 x.y form can flip near-ties.)
//
// What bounds it on this card: f32 arithmetic, 3 operations per coordinate
// pair (subtract, multiply, add) plus a compare per pair; the bytes (the two
// sets and the indices) are small. At the flagship training step the four
// launches make about 4.6 G such operations, about 0.07 ms at 67 TFLOP/s.
//
// What the design does about it: one block of 128 threads per (cloud, 128
// query rows), one query row per thread with its coordinates in registers.
// y is streamed through shared memory in tiles of rows that every thread of
// the block reads at the same address (a broadcast, no bank conflict),
// together with the tile's validity flags. Each thread keeps its running
// minimum and index in registers and writes its index once.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kTileFloats = 8192;  // 32 KB of y rows per tile

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
    nn_argmin_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const unsigned char* __restrict__ y_mask, int p1, int p2,
                     int d, int tile_rows, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* ys = smem;                                            // tile_rows * d
  unsigned char* valid =
      reinterpret_cast<unsigned char*>(ys + tile_rows * d);    // tile_rows

  const int b = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < p1;
  float q[DMAX];
#pragma unroll
  for (int c = 0; c < DMAX; ++c) {
    q[c] = (active && c < d) ? x[(static_cast<size_t>(b) * p1 + row) * d + c]
                             : 0.f;
  }
  const float* yb = y + static_cast<size_t>(b) * p2 * d;
  const unsigned char* mb =
      y_mask == nullptr ? nullptr : y_mask + static_cast<size_t>(b) * p2;

  float best = INFINITY;
  int best_j = 0;
  for (int base = 0; base < p2; base += tile_rows) {
    const int rows = min(tile_rows, p2 - base);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < rows * d; e += kThreads) {
      ys[e] = yb[static_cast<size_t>(base) * d + e];
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      valid[r] = mb == nullptr ? 1 : mb[base + r];
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < rows; ++r) {
      if (!valid[r]) continue;
      const float* yr = ys + r * d;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < DMAX; ++c) {
        if (c < d) {
          const float diff = __fsub_rn(q[c], yr[c]);
          const float t = __fmul_rn(diff, diff);
          acc = c == 0 ? t : __fadd_rn(acc, t);
        }
      }
      if (acc < best) {  // strict: the first minimum keeps its index
        best = acc;
        best_j = base + r;
      }
    }
  }
  if (active) out[static_cast<size_t>(b) * p1 + row] = best_j;
}

template <int DMAX>
int launch(const float* x, const float* y, const unsigned char* y_mask, int b,
           int p1, int p2, int d, int* out, cudaStream_t stream) {
  int tile_rows = kTileFloats / d;
  if (tile_rows > p2) tile_rows = p2;
  const size_t smem = sizeof(float) * static_cast<size_t>(tile_rows) * d +
                      static_cast<size_t>(tile_rows);
  const dim3 grid((p1 + kThreads - 1) / kThreads, b);
  nn_argmin_kernel<DMAX><<<grid, kThreads, smem, stream>>>(
      x, y, y_mask, p1, p2, d, tile_rows, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (b, p1, d), y (b, p2, d) f32 contiguous, y_mask (b, p2) bool (one byte
// each) or null; 1 <= d <= 128. Writes out (b, p1) int32. Returns a
// cudaError_t as int (0 = launched).
extern "C" int nn_argmin_forward(const float* x, const float* y,
                                 const unsigned char* y_mask, int b, int p1,
                                 int p2, int d, int* out, void* stream) {
  if (b <= 0 || p1 <= 0 || p2 <= 0 || d <= 0 || d > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 8) return launch<8>(x, y, y_mask, b, p1, p2, d, out, s);
  if (d <= 32) return launch<32>(x, y, y_mask, b, p1, p2, d, out, s);
  return launch<128>(x, y, y_mask, b, p1, p2, d, out, s);
}
