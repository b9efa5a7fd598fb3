// Iterative farthest point sampling for Hopper (sm_90a).
//
// Replaces the Pallas kernel maskplanner_tpu/ops/pallas/fps.py::fps_pallas
// (body `_kernel`): for every cloud, start from a given index, then
// `npoint` times record the current pick, lower every point's running
// min-distance by its squared distance to that pick, and take the point
// with the largest running distance next (ties -> the lowest index).
//
// What bounds it on this card: latency, not bytes or FLOPs. Each of the
// `npoint` steps depends on the previous one (512 steps at sa1), every step
// ends in a block-wide argmax, and there is one block per cloud, so at a
// batch of 64 only 64 of the 132 SMs have work.
//
// What the design does about it: the whole step runs inside one block with
// no trip to device memory. Each thread keeps its points' coordinates and
// running distances in registers (PPT points per thread: 5120 points on
// 1024 threads -> 5); a copy of the cloud in shared
// memory (60 KB at 5120 points, above the 48 KB default, so the kernel
// raises its dynamic shared memory limit) serves the centroid lookup. The
// argmax is a warp-shuffle reduction followed by one over the warps' winners
// in shared memory: two __syncthreads per step. Making several clouds share
// an SM, or one cloud span a cluster, is left to later work.
//
// The squared distance is formed as (x-cx)^2 + (y-cy)^2 + (z-cz)^2 with
// round-to-nearest intrinsics, so that no FMA contraction changes it: the
// plain PyTorch version forms it the same way and the two must pick
// identical indices.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSlots = 8;  // points per thread: clouds of up to 8192

__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx,
                                         float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (v, i) beats (best_v, best_i) when it is larger, or equal at a lower index.
__device__ __forceinline__ void arg_max_merge(float v, int i, float& best_v,
                                              int& best_i) {
  if (v > best_v || (v == best_v && i < best_i)) {
    best_v = v;
    best_i = i;
  }
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
    fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
               int n, int npoint, int* __restrict__ out) {
  extern __shared__ float cloud[];  // x[n], y[n], z[n]
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];
  __shared__ int next_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;

  for (int e = tid; e < 3 * n; e += blockDim.x) {
    cloud[(e % 3) * n + e / 3] = pts[e];
  }

  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int j = tid + p * blockDim.x;
    if (j < n) {
      px[p] = pts[3 * j];
      py[p] = pts[3 * j + 1];
      pz[p] = pts[3 * j + 2];
    } else {
      px[p] = py[p] = pz[p] = 0.f;
    }
    dist[p] = 1e10f;
  }
  int far = start[b];
  __syncthreads();

  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) out[static_cast<size_t>(b) * npoint + i] = far;
    const float cx = cloud[far], cy = cloud[n + far], cz = cloud[2 * n + far];
    float best_v = -INFINITY;
    int best_i = INT_MAX;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int j = tid + p * blockDim.x;
      if (j < n) {
        dist[p] = fminf(dist[p], sq_dist(px[p], py[p], pz[p], cx, cy, cz));
        // j grows with p: a strict '>' keeps the lowest index among ties
        if (dist[p] > best_v) {
          best_v = dist[p];
          best_i = j;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_down_sync(0xffffffffu, best_v, off);
      const int k = __shfl_down_sync(0xffffffffu, best_i, off);
      arg_max_merge(v, k, best_v, best_i);
    }
    if (lane == 0) {
      warp_v[warp] = best_v;
      warp_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = lane < n_warps ? warp_v[lane] : -INFINITY;
      best_i = lane < n_warps ? warp_i[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_down_sync(0xffffffffu, best_v, off);
        const int k = __shfl_down_sync(0xffffffffu, best_i, off);
        arg_max_merge(v, k, best_v, best_i);
      }
      if (lane == 0) next_s = best_i;
    }
    __syncthreads();
    far = next_s;
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, const int* start, int b, int n,
                   int npoint, int threads, int* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(3) * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fps_kernel<PPT><<<b, threads, smem, stream>>>(xyz, start, n, npoint, out);
  return cudaGetLastError();
}

}  // namespace

// xyz (b, n, 3) f32 contiguous, start (b,) int32 in [0, n) -> out (b, npoint)
// int32. Returns a cudaError_t as int (0 = launched).
extern "C" int fps_forward(const float* xyz, const int* start, int b, int n,
                           int npoint, int* out, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 || n > kMaxSlots * kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = n >= kMaxThreads ? kMaxThreads : ((n + 31) / 32) * 32;
  const int ppt = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one instantiation per slot count keeps the register arrays exact at
  // the model's sizes (5120 points -> 5 slots)
  switch (ppt) {
#define MP_FPS_CASE(P) \
  case P:              \
    return static_cast<int>(launch<P>(xyz, start, b, n, npoint, threads, out, s));
    MP_FPS_CASE(1)
    MP_FPS_CASE(2)
    MP_FPS_CASE(3)
    MP_FPS_CASE(4)
    MP_FPS_CASE(5)
    MP_FPS_CASE(6)
    MP_FPS_CASE(7)
    MP_FPS_CASE(8)
#undef MP_FPS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
