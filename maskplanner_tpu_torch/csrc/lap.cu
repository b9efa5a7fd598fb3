// Batched exact linear assignment (Jonker-Volgenant) for Hopper (sm_90a).
//
// Replaces the Pallas kernel maskplanner_tpu/ops/pallas/lap.py::lap_jv_pallas
// (body `_lap_kernel`): for every square cost matrix of a batch, a
// cost-optimal permutation col4row, by the shortest-augmenting-path scheme
// of scipy's rectangular_lsap with the update rules of
// maskplanner_tpu/ops/hungarian.py::_solve_square. On exact ties it may
// pick another equal-cost permutation than scipy.
//
// What bounds it on this card: latency. A problem of size n makes n
// augmentations of up to n dependent Dijkstra steps, each ending in an
// argmin over the columns; there is no bulk arithmetic and the bytes are
// the n x n costs (1.9 KB at the flagship's 22 x 22).
//
// What the design does about it: one block per problem, so the 64 problems
// of a training step run side by side on 64 SMs. The whole cost matrix
// sits in shared memory (dynamic: 64 KB at n = 128). One thread per column
// keeps that column's shortest distance, its path row, its potential v and
// its scanned flag in registers; the row potentials u, col4row, row4col
// and the scanned rows sit in shared memory. A Dijkstra step's argmin is a warp-shuffle reduction,
// plus one round through shared memory over the warps when n > 32; ties go
// to the lowest column, as torch.argmin does in the plain version. One
// thread walks the augmenting path. Every value is f32, formed in the
// plain version's order, so the two normally agree index for index.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr float kInf = 1e18f;

// (v, j) beats (best_v, best_j) when smaller, or equal at a lower column.
__device__ __forceinline__ void arg_min_merge(float v, int j, float& best_v,
                                              int& best_j) {
  if (v < best_v || (v == best_v && j < best_j)) {
    best_v = v;
    best_j = j;
  }
}

__global__ void __launch_bounds__(kMaxN)
    lap_kernel(const float* __restrict__ cost, int n,
               int* __restrict__ col4row_out) {
  extern __shared__ float c[];  // n * n costs
  __shared__ float u[kMaxN];
  __shared__ float sh_short[kMaxN];
  __shared__ int sh_path[kMaxN];
  __shared__ int col4row[kMaxN];
  __shared__ int row4col[kMaxN];
  __shared__ int s_rows[kMaxN];
  __shared__ float warp_v[kMaxN / 32];
  __shared__ int warp_j[kMaxN / 32];

  const int j = threadIdx.x;  // this thread's column
  const int lane = j & 31;
  const int warp = j >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool col = j < n;
  const float* cb = cost + static_cast<size_t>(blockIdx.x) * n * n;
  for (int e = j; e < n * n; e += blockDim.x) c[e] = cb[e];
  if (col) {
    u[j] = 0.f;
    col4row[j] = -1;
    row4col[j] = -1;
  }
  float v = 0.f;
  __syncthreads();

  for (int cur = 0; cur < n; ++cur) {
    float shortest = kInf;
    int path = -1;
    bool scanned = false;
    if (col) s_rows[j] = 0;
    __syncthreads();
    int i = cur;        // identical in every thread
    int sink = -1;
    float minval = 0.f;
    while (sink < 0) {
      if (j == 0) s_rows[i] = 1;
      if (col && !scanned) {
        const float d = ((minval + c[i * n + j]) - u[i]) - v;
        if (d < shortest) {
          shortest = d;
          path = i;
        }
      }
      // argmin over the unscanned columns
      float best_v = (col && !scanned) ? shortest : kInf;
      int best_j = col ? j : kMaxN;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
        const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
        arg_min_merge(ov, oj, best_v, best_j);
      }
      if (n_warps > 1) {
        if (lane == 0) {
          warp_v[warp] = best_v;
          warp_j[warp] = best_j;
        }
        __syncthreads();
        best_v = warp_v[0];
        best_j = warp_j[0];
        for (int w = 1; w < n_warps; ++w) {
          arg_min_merge(warp_v[w], warp_j[w], best_v, best_j);
        }
      }
      minval = best_v;
      if (j == best_j) scanned = true;
      const int nxt = row4col[best_j];
      if (nxt < 0) {
        sink = best_j;
      } else {
        i = nxt;
      }
      __syncthreads();  // s_rows, warp_v/warp_j are rewritten next step
    }
    // potentials (scipy rectangular_lsap)
    if (col) {
      sh_short[j] = shortest;
      sh_path[j] = path;
    }
    __syncthreads();
    if (col) {
      // thread j updates row j's potential, then its own column's
      if (j == cur) {
        u[j] = u[j] + minval;
      } else if (s_rows[j]) {
        const int cj = col4row[j] < 0 ? 0 : col4row[j];
        u[j] = u[j] + (minval - sh_short[cj]);
      }
      if (scanned) v = (v + shortest) - minval;
    }
    __syncthreads();
    // augment along the alternating path that ends at the sink
    if (j == 0) {
      int jj = sink;
      while (true) {
        const int r = sh_path[jj];
        row4col[jj] = r;
        const int prev = col4row[r];
        col4row[r] = jj;
        if (r == cur) break;
        jj = prev;
      }
    }
    __syncthreads();
  }
  if (col) col4row_out[static_cast<size_t>(blockIdx.x) * n + j] = col4row[j];
}

}  // namespace

// cost (b, n, n) f32 contiguous, 1 <= n <= 128. Writes col4row (b, n) int32.
// Returns a cudaError_t as int (0 = launched).
extern "C" int lap_forward(const float* cost, int b, int n, int* col4row,
                           void* stream) {
  if (b <= 0 || n <= 0 || n > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((n + 31) / 32) * 32;
  const size_t smem = sizeof(float) * static_cast<size_t>(n) * n;
  cudaError_t err = cudaFuncSetAttribute(
      lap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lap_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, n, col4row);
  return static_cast<int>(cudaGetLastError());
}
