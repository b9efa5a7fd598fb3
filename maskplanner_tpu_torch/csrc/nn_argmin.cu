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
// What bounds it on this card: the issue of f32 instructions. A pair costs
// d subtracts, d multiplies and d - 1 adds, none of which may fuse into an
// FMA, plus a compare and two selects; the bytes (the two sets and the
// indices) are small. FSUB, FMUL and FADD issue at 128 a clock on an SM,
// half the rate of the FMA-counted peak, so this design's floor is about
// twice the operations bound.
//
// What the design does about it:
// - A block takes 32 * R query rows of one cloud: each thread holds R rows
//   in registers and scans U y rows at a time (R = 2, U = 2 at d = 24;
//   R = 8, U = 2 at d = 6), so that every y coordinate read from shared
//   memory (a broadcast, 16 bytes at a time) feeds R independent
//   subtract-multiply-add chains, and R x U chains are in flight. (R = 4 at
//   d = 24 spills registers; R = 2 with U = 2 does not, and runs the
//   segment calls faster.)
// - The block's warps split the cloud's y rows into contiguous slices, so
//   that the 449-row sets of the segment terms still put about 16 warps on
//   every SM. Each warp stages its slice in shared memory once (cp.async,
//   no block barrier), in tiles only when the set is larger than the
//   staging budget; masked rows and the padding rows get +inf as their
//   first coordinate, so they never win and the inner loop has no branch.
// - d is a template: exactly 6 and 24 (the main path) with vector loads,
//   and a general instantiation for any other d up to 128.
// - Above 128 coordinates (the segment chamfer at lambda_points >= 22,
//   d = 6 lambda), the chunked path, nn_argmin_chunked_kernel, with no
//   limit on d: a block takes 128 query rows of one cloud, one a thread,
//   and walks y in tiles of kTileRows rows; for each tile it walks d in
//   chunks of kChunk coordinates, staging the x and y chunks in shared
//   memory, and carries each (x, y) pair's partial sum in a register
//   across the chunks, so that the sum is still formed left to right over
//   every coordinate. Coordinates past d and rows past p2 are padded with
//   0, which adds +0 to a sum: bitwise nothing. Each tile's rows are then
//   compared in index order with a strict '<', masked rows skipped. It is
//   a simple kernel that is right; its time and bound are in PERF.md.
// - The warps' (distance, index) winners are merged in shared memory in
//   slice order with a strict '<': every thread forms the same bits for
//   the same pair, so the lowest index among equal distances wins, as in
//   one sequential scan.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarpsPerSm = 16;         // the warps a launch aims to fill
constexpr int kStageBytes = 64 * 1024;   // y rows staged by a block
constexpr int kDevices = 16;             // devices whose setting is kept
constexpr int kChunkThreads = 128;       // query rows a block, chunked path
constexpr int kTileRows = 32;            // y rows a tile, chunked path
constexpr int kChunk = 32;               // coordinates a chunk
constexpr int kChunkStride = kChunk + 4;  // a staged row: 16-byte aligned

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// The warp copies `count` floats from src to dst (16 bytes at a time when
// both are 16-byte aligned, `vec`) and waits for them.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int count, int lane, bool vec) {
  int done = 0;
  if (vec) {
    const int n4 = count >> 2;
    for (int e = lane; e < n4; e += 32) cp_async16(dst + 4 * e, src + 4 * e);
    done = n4 << 2;
  }
  for (int e = done + lane; e < count; e += 32) cp_async4(dst + e, src + e);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// U consecutive staged y rows into registers: 16-byte loads when the rows'
// floats come in whole vectors, else one coordinate at a time.
template <int DMAX, int U, bool kExact>
__device__ __forceinline__ void load_rows(float (&yv)[U][DMAX],
                                          const float* src, int dd) {
  if constexpr (kExact && (U * DMAX) % 4 == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int k = 0; k < U * DMAX / 4; ++k) {
      const float4 v = s4[k];
      yv[(4 * k) / DMAX][(4 * k) % DMAX] = v.x;
      yv[(4 * k + 1) / DMAX][(4 * k + 1) % DMAX] = v.y;
      yv[(4 * k + 2) / DMAX][(4 * k + 2) % DMAX] = v.z;
      yv[(4 * k + 3) / DMAX][(4 * k + 3) % DMAX] = v.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int c = 0; c < DMAX; ++c) yv[u][c] = c < dd ? src[u * dd + c] : 0.f;
    }
  }
}

__device__ __forceinline__ float term(float q, float y) {
  const float diff = __fsub_rn(q, y);
  return __fmul_rn(diff, diff);
}

// DMAX coordinates (exactly, with kExact; else at most, d at run time), R
// query rows a thread, U y rows an iteration.
template <int DMAX, int R, int U, bool kExact, int kThreads>
__global__ void __launch_bounds__(kThreads)
    nn_argmin_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const unsigned char* __restrict__ y_mask, int p1, int p2,
                     int d, int slice, int tile, bool vec,
                     int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int dd = kExact ? DMAX : d;
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  float* smem = reinterpret_cast<float*>(smem4);
  float* ys = smem + warp * tile * dd;             // this warp's tile
  float* cand_v = smem + n_warps * tile * dd;      // n_warps x 32R
  int* cand_j = reinterpret_cast<int*>(cand_v + n_warps * 32 * R);

  const int q0 = blockIdx.x * 32 * R;
  float q[R][DMAX];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + r * 32 + lane;
    const float* xr = x + (static_cast<size_t>(b) * p1 + row) * dd;
#pragma unroll
    for (int c = 0; c < DMAX; ++c) {
      q[r][c] = (row < p1 && c < dd) ? xr[c] : 0.f;
    }
  }
  float best[R];
  int best_j[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best[r] = INFINITY;
    best_j[r] = 0;
  }

  const float* yb = y + static_cast<size_t>(b) * p2 * dd;
  const unsigned char* mb =
      y_mask == nullptr ? nullptr : y_mask + static_cast<size_t>(b) * p2;
  const int lo = warp * slice;
  const int hi = min(p2, lo + slice);
  for (int t0 = lo; t0 < hi; t0 += tile) {
    const int rows = min(tile, hi - t0);
    const int padded = (rows + U - 1) / U * U;
    __syncwarp();  // the warp no longer reads the previous tile
    stage_rows(ys, yb + static_cast<size_t>(t0) * dd, rows * dd, lane, vec);
    __syncwarp();
    for (int r = lane; r < padded; r += 32) {
      if (r >= rows || (mb != nullptr && !mb[t0 + r])) ys[r * dd] = INFINITY;
    }
    __syncwarp();
    for (int r0 = 0; r0 < padded; r0 += U) {
      float yv[U][DMAX];
      load_rows<DMAX, U, kExact>(yv, ys + r0 * dd, dd);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = t0 + r0 + u;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float acc = term(q[r][0], yv[u][0]);
#pragma unroll
          for (int c = 1; c < DMAX; ++c) {
            if (c < dd) acc = __fadd_rn(acc, term(q[r][c], yv[u][c]));
          }
          if (acc < best[r]) {  // strict: the first minimum keeps its index
            best[r] = acc;
            best_j[r] = j;
          }
        }
      }
    }
  }

  // merge the warps' winners in slice order (lower slices hold lower
  // indices, so a strict '<' keeps the lowest index among equals)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cand_v[warp * 32 * R + r * 32 + lane] = best[r];
    cand_j[warp * 32 * R + r * 32 + lane] = best_j[r];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 32 * R; e += blockDim.x) {
    float v = cand_v[e];
    int j = cand_j[e];
    for (int w = 1; w < n_warps; ++w) {
      const float vw = cand_v[w * 32 * R + e];
      if (vw < v) {
        v = vw;
        j = cand_j[w * 32 * R + e];
      }
    }
    if (q0 + e < p1) out[static_cast<size_t>(b) * p1 + q0 + e] = j;
  }
}

template <int DMAX, int R, int U, bool kExact, int kMaxWarps>
int launch(const float* x, const float* y, const unsigned char* y_mask, int b,
           int p1, int p2, int d, int* out, cudaStream_t stream) {
  constexpr int kThreads = 32 * kMaxWarps;
  constexpr int kCandBytes = kMaxWarps * 32 * R * 8;
  auto kernel = nn_argmin_kernel<DMAX, R, U, kExact, kThreads>;
  int device = 0;
  int n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool smem_set[kDevices] = {};
  bool unknown = false;
  bool& set = device < kDevices ? smem_set[device] : unknown;
  if (!set) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStageBytes + kCandBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    set = true;
  }
  // warps a block: enough blocks x warps to put kWarpsPerSm warps on every
  // SM, each warp at least 8 y rows
  const int groups = (p1 + 32 * R - 1) / (32 * R);
  const long long blocks = static_cast<long long>(groups) * b;
  long long want = (static_cast<long long>(n_sm) * kWarpsPerSm) / blocks;
  want = std::min<long long>(want, (p2 + 7) / 8);
  int warps = static_cast<int>(
      std::max<long long>(1, std::min<long long>(want, kMaxWarps)));
  int slice = (p2 + warps - 1) / warps;
  slice = (slice + U - 1) / U * U;
  warps = (p2 + slice - 1) / slice;
  int tile = kStageBytes / (warps * d * 4) / U * U;
  tile = std::max(U, std::min(slice, tile));
  const size_t smem = sizeof(float) * static_cast<size_t>(warps) * tile * d +
                      static_cast<size_t>(warps) * 32 * R * 8;
  const bool vec = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   (static_cast<long long>(p2) * d) % 4 == 0 &&
                   (slice * d) % 4 == 0 && (tile * d) % 4 == 0;
  const dim3 grid(groups, b);
  kernel<<<grid, warps * 32, smem, stream>>>(x, y, y_mask, p1, p2, d, slice,
                                             tile, vec, out);
  return static_cast<int>(cudaGetLastError());
}


// -- the chunked path (any d) -------------------------------------------------

__global__ void __launch_bounds__(kChunkThreads)
    nn_argmin_chunked_kernel(const float* __restrict__ x,
                             const float* __restrict__ y,
                             const unsigned char* __restrict__ y_mask, int p1,
                             int p2, int d, int* __restrict__ out) {
  __shared__ __align__(16) float xs[kChunkThreads * kChunkStride];
  __shared__ __align__(16) float ys[kTileRows * kChunkStride];
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kChunkThreads;
  const float* xb = x + static_cast<size_t>(b) * p1 * d;
  const float* yb = y + static_cast<size_t>(b) * p2 * d;
  const unsigned char* mb =
      y_mask == nullptr ? nullptr : y_mask + static_cast<size_t>(b) * p2;

  float best = INFINITY;
  int best_j = 0;
  for (int t0 = 0; t0 < p2; t0 += kTileRows) {
    float acc[kTileRows];
#pragma unroll
    for (int u = 0; u < kTileRows; ++u) acc[u] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      __syncthreads();  // the previous chunk is read
      for (int e = t; e < kChunkThreads * kChunk; e += kChunkThreads) {
        const int r = e / kChunk;
        const int c = e % kChunk;
        const int row = q0 + r;
        xs[r * kChunkStride + c] =
            (row < p1 && c0 + c < d) ? xb[static_cast<size_t>(row) * d + c0 + c]
                                     : 0.f;
      }
      for (int e = t; e < kTileRows * kChunk; e += kChunkThreads) {
        const int r = e / kChunk;
        const int c = e % kChunk;
        const int row = t0 + r;
        ys[r * kChunkStride + c] =
            (row < p2 && c0 + c < d) ? yb[static_cast<size_t>(row) * d + c0 + c]
                                     : 0.f;
      }
      __syncthreads();
      float q[kChunk];
      const float4* x4 = reinterpret_cast<const float4*>(xs + t * kChunkStride);
#pragma unroll
      for (int k = 0; k < kChunk / 4; ++k) {
        const float4 v = x4[k];
        q[4 * k] = v.x;
        q[4 * k + 1] = v.y;
        q[4 * k + 2] = v.z;
        q[4 * k + 3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < kTileRows; ++u) {
        const float4* y4 =
            reinterpret_cast<const float4*>(ys + u * kChunkStride);
        float a = acc[u];
#pragma unroll
        for (int k = 0; k < kChunk / 4; ++k) {
          const float4 v = y4[k];  // a broadcast
          a = __fadd_rn(a, term(q[4 * k], v.x));
          a = __fadd_rn(a, term(q[4 * k + 1], v.y));
          a = __fadd_rn(a, term(q[4 * k + 2], v.z));
          a = __fadd_rn(a, term(q[4 * k + 3], v.w));
        }
        acc[u] = a;
      }
    }
    // the tile's rows in index order: a strict '<' keeps the first minimum
#pragma unroll
    for (int u = 0; u < kTileRows; ++u) {
      const int j = t0 + u;
      if (j < p2 && (mb == nullptr || mb[j]) && acc[u] < best) {
        best = acc[u];
        best_j = j;
      }
    }
  }
  if (q0 + t < p1) out[static_cast<size_t>(b) * p1 + q0 + t] = best_j;
}

int nn_argmin_chunked(const float* x, const float* y,
                      const unsigned char* y_mask, int b, int p1, int p2,
                      int d, int* out, cudaStream_t stream) {
  const dim3 grid((p1 + kChunkThreads - 1) / kChunkThreads, b);
  nn_argmin_chunked_kernel<<<grid, kChunkThreads, 0, stream>>>(
      x, y, y_mask, p1, p2, d, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (b, p1, d), y (b, p2, d) f32 contiguous, y_mask (b, p2) bool (one byte
// each) or null; d >= 1 (above 128 the chunked path). Writes out (b, p1)
// int32. Returns a cudaError_t as int (0 = launched).
extern "C" int nn_argmin_forward(const float* x, const float* y,
                                 const unsigned char* y_mask, int b, int p1,
                                 int p2, int d, int* out, void* stream) {
  if (b <= 0 || b > 65535 || p1 <= 0 || p2 <= 0 || d <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 128) return nn_argmin_chunked(x, y, y_mask, b, p1, p2, d, out, s);
  // <coordinates, query rows a thread, y rows an iteration, exact d,
  // warps a block at most>
  if (d == 24) return launch<24, 2, 2, true, 16>(x, y, y_mask, b, p1, p2, d, out, s);
  if (d == 6) return launch<6, 8, 2, true, 16>(x, y, y_mask, b, p1, p2, d, out, s);
  if (d <= 8) return launch<8, 4, 1, false, 16>(x, y, y_mask, b, p1, p2, d, out, s);
  if (d <= 32) return launch<32, 2, 1, false, 16>(x, y, y_mask, b, p1, p2, d, out, s);
  return launch<128, 1, 1, false, 8>(x, y, y_mask, b, p1, p2, d, out, s);
}

// The chunked path at any d >= 1 (nn_argmin_forward's route above 128
// coordinates; at smaller d, its checks), with nn_argmin_forward's
// arguments.
extern "C" int nn_argmin_chunked_forward(const float* x, const float* y,
                                         const unsigned char* y_mask, int b,
                                         int p1, int p2, int d, int* out,
                                         void* stream) {
  if (b <= 0 || b > 65535 || p1 <= 0 || p2 <= 0 || d <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return nn_argmin_chunked(x, y, y_mask, b, p1, p2, d, out,
                           static_cast<cudaStream_t>(stream));
}
