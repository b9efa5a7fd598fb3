// Iterative farthest point sampling for Hopper (sm_90a).
//
// Replaces the Pallas kernel maskplanner_tpu/ops/pallas/fps.py::fps_pallas
// (body `_kernel`): for every cloud, start from a given index, then
// `npoint` times record the current pick, lower every point's running
// min-distance by its squared distance to that pick, and take the point
// with the largest running distance next (ties -> the lowest index).
//
// What bounds it on this card: latency, not bytes or FLOPs. Each of the
// `npoint` steps depends on the previous one (512 steps at sa1), and every
// step ends in a block-wide argmax. One block takes one cloud, so a step
// costs the issue of its distance updates on one SM (about 12 instructions
// a point: 3 subtracts, 3 multiplies, 2 adds, a min, and a compare and two
// selects of the local argmax) plus the chain of the argmax: the warp
// reductions, a barrier and the reduction of the warps' winners. On an
// H100 80GB HBM3 at a 700 W limit, at 5120 points, the step takes about
// 0.53 us, of which a build without the distance update (FPS_NO_UPDATE,
// bench_fps_argmin.py) keeps about 0.33 us: the argmax chain and its
// local compares.
//
// What the design does about it:
// - Contiguous ownership: thread t owns points [t*P, (t+1)*P) and keeps
//   their coordinates and running distances in registers, so lane order is
//   index order and the lowest index among ties is the lowest lane's.
// - A warp argmax in two reductions: the running distances are >= 0, so
//   their bit patterns order as unsigned integers. `redux.sync` takes the
//   largest key, and a second `redux.sync` the lowest index among the
//   lanes that hold it (the others offer ~0).
// - One barrier a step: each warp writes its (key, index) to a slot of a
//   double buffer (step & 1); after one __syncthreads every warp reduces
//   the slots itself the same way, so no second barrier and no broadcast
//   through shared memory. A slot is written again only two steps later,
//   after the next barrier, which every reader of it has passed.
// - The centroid comes from a float4 copy of the cloud in shared memory
//   (one 16-byte load); the picks are staged in shared memory and written
//   once at the end.
// - 512 threads a cloud above 2048 points, else 256: fewer, fuller threads
//   lengthen the local compare chain, more add warps to the barrier and to
//   the issue of the per-warp reductions (256, 512 and 1024 are timed by
//   bench_fps_argmin.py). A pairwise tree for the local argmax measured no
//   faster than the linear scan. A cluster of blocks per cloud is not
//   tried: it would halve the update's issue at batch 64 but add a
//   cluster-wide exchange to every step's chain.
// Padded slots (j >= n) keep the running distance 0 at coordinates 0, and
// fminf(0, d >= 0) stays 0: their key 0 is never above a real point's, and
// among equal keys a real point's lower index wins (once every real point
// is at 0, the lowest, index 0, is picked, as the plain version does).
//
// A start index outside [0, n) prints the cloud and the index and traps,
// so that it fails loudly at the next synchronize without a host sync.
//
// Clouds of more than kMaxPoints points (16 bytes of shared memory a point
// and at most 20 in a thread's registers) take the large path,
// fps_large_kernel: one block of 1024 threads a cloud, thread t owning
// points t, t + 1024, ..., and no size limit. The coordinates are read from
// device memory at every step (12 bytes a point, L2-resident at batch 64
// and 16384 points); the running min-distances, which only their owner
// reads and writes, live in shared memory while they fit (4 bytes a point,
// beside the staged picks: kLargeSmem), else in a scratch buffer the
// wrapper allocates (fps_large_scratch_floats). A thread's points no
// longer run in lane order, so the argmax takes the lowest explicit index
// among the largest keys, at each level (a thread's own strict '>' over its
// rising indices, then warp_arg_max on the indices themselves). The
// squared distance and the start-index trap are the small path's. It is a
// simple kernel that is right; its time and bound are in PERF.md.
//
// Two build switches serve timing studies only (bench_fps_argmin.py sets
// them; no path of the port does): FPS_THREADS=t fixes the threads a block,
// and the P=20 case of fps_forward is reached only through it (256 threads
// at more than 4096 points); FPS_NO_UPDATE replaces the distance update by
// one instruction, so that what remains is the argmax chain.
//
// The squared distance is formed as (x-cx)^2 + (y-cy)^2 + (z-cz)^2 with
// round-to-nearest intrinsics, so that no FMA contraction changes it: the
// plain PyTorch version forms it the same way and the two must pick
// identical indices.
//
// The masked mode (a (b, n) validity mask; the kMasked instantiation of
// either path, the unmasked code unchanged) is the JAX package's
// farthest_point_sample(mask=...) (maskplanner_tpu/ops/sampling.py:86-98),
// which has no Pallas kernel: an invalid point's running distance starts at
// -1e10 and stays there, an invalid start is replaced by the cloud's first
// valid point (0 when none is valid), and the argmax takes the lowest index
// among the largest distances as before. A negative float's bits do not
// order as an unsigned integer, so the mode's key is 0 for a negative
// distance (invalid points, and the small path's padded slots, which take
// -1e10 too) and the bits plus one otherwise: every valid point ranks
// above every invalid one, and a cloud with no valid point repeats index 0.
// The first valid point is a block-wide minimum through the same warp
// slots, taken once, before the loop, when the start is invalid.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdio>

namespace {

constexpr int kMaxPoints = 8192;   // points a cloud of the small path
constexpr int kMaxStaged = 8192;   // picks staged in shared memory
constexpr int kLargeThreads = 1024;  // threads a cloud of the large path
// dynamic shared memory the large path may take (of the 227 KB a block can
// use, the rest left to its static slots)
constexpr size_t kLargeSmem = 226 * 1024;
constexpr int kDevices = 16;  // devices whose shared memory setting is kept

__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx,
                                         float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The lowest index among the warp's lanes that hold its largest key, and
// that key. Lanes own increasing index ranges, so the lowest such index is
// the lowest lane's.
__device__ __forceinline__ int warp_arg_max(unsigned key, int index,
                                            unsigned& max_key) {
  max_key = __reduce_max_sync(0xffffffffu, key);
  return static_cast<int>(__reduce_min_sync(
      0xffffffffu, key == max_key ? static_cast<unsigned>(index) : ~0u));
}

// The most threads a block of P points a thread may have: registers for
// the 4 P values a thread keeps.
__host__ __device__ constexpr int threads_for(int P) {
  return P <= 8 ? 1024 : (P <= 16 ? 512 : 256);
}

// The masked mode's key of a running distance (the header): 0 below 0,
// else the bits plus one.
__device__ __forceinline__ unsigned masked_key(float d) {
  return d < 0.f ? 0u : __float_as_uint(d) + 1u;
}

// The lowest of the block's `own` indices (~0u where a thread has none,
// and where no thread has one), through the warps' slots, on every thread;
// the slots are free again when it returns.
__device__ __forceinline__ unsigned block_min_index(unsigned own,
                                                    uint2 (*slots)[32]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned m = __reduce_min_sync(0xffffffffu, own);
  if (lane == 0) slots[0][warp].x = m;
  __syncthreads();
  const unsigned all = __reduce_min_sync(
      0xffffffffu, lane < n_warps ? slots[0][lane].x : ~0u);
  __syncthreads();
  return all;
}

template <int P, bool kMasked>
__global__ void __launch_bounds__(threads_for(P))
    fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
               const unsigned char* __restrict__ mask, int n, int npoint,
               int* __restrict__ out) {
  extern __shared__ float4 cloud[];  // n points (x, y, z, 0), then picks
  __shared__ uint2 slots[2][32];     // (key, index) of each warp

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  // thread 0 records each pick: in shared memory, written out at the end,
  // unless there are more picks than kMaxStaged
  const bool staged = npoint <= kMaxStaged;
  int* const picks = staged ? reinterpret_cast<int*>(cloud + n)
                            : out + static_cast<size_t>(b) * npoint;

  int far = start[b];
  if (far < 0 || far >= n) {
    if (tid == 0) {
      printf("fps: cloud %d has start index %d outside [0, %d)\n", b, far,
             n);
    }
    __trap();
  }
  float* flat = reinterpret_cast<float*>(cloud);
  for (int e = tid; e < 3 * n; e += blockDim.x) {
    flat[(e / 3) * 4 + e % 3] = pts[e];
  }
  __syncthreads();
  const unsigned char* valid =
      kMasked ? mask + static_cast<size_t>(b) * n : nullptr;
  float px[P], py[P], pz[P], dist[P];
  unsigned first_own = ~0u;  // the thread's lowest valid index
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = tid * P + p;
    if (j < n) {
      const float4 c = cloud[j];
      px[p] = c.x;
      py[p] = c.y;
      pz[p] = c.z;
      dist[p] = 1e10f;
      if (kMasked) {
        if (valid[j]) {
          first_own = min(first_own, static_cast<unsigned>(j));
        } else {
          dist[p] = -1e10f;
        }
      }
    } else {
      px[p] = py[p] = pz[p] = 0.f;
      dist[p] = kMasked ? -1e10f : 0.f;
    }
  }
  if (kMasked && !valid[far]) {  // block-uniform: every thread reads far
    const unsigned first = block_min_index(first_own, slots);
    far = first < static_cast<unsigned>(n) ? static_cast<int>(first) : 0;
  }

  uint2* const own_slot = &slots[0][warp];
  const uint2* const read_slot = &slots[0][lane];
  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) picks[i] = far;
    const float4 c = cloud[far];
#ifdef FPS_NO_UPDATE
    const float cut = fabsf(c.x);
#pragma unroll
    for (int p = 0; p < P; ++p) dist[p] = fminf(dist[p], cut);
#else
#pragma unroll
    for (int p = 0; p < P; ++p) {
      dist[p] = fminf(dist[p], sq_dist(px[p], py[p], pz[p], c.x, c.y, c.z));
    }
#endif
    // p grows with the index: a strict '>' keeps the lowest among ties
    float best = dist[0];
    int best_p = 0;
#pragma unroll
    for (int p = 1; p < P; ++p) {
      if (dist[p] > best) {
        best = dist[p];
        best_p = p;
      }
    }
    const int buf = (i & 1) * 32;
    unsigned max_key;
    const int g = warp_arg_max(kMasked ? masked_key(best)
                                       : __float_as_uint(best),
                               tid * P + best_p, max_key);
    if (lane == 0) own_slot[buf] = make_uint2(max_key, g);
    __syncthreads();
    // every warp reduces the warps' winners; lanes past the warps hold key
    // 0, which warp 0 ties or beats at a lower index
    const uint2 s = lane < n_warps ? read_slot[buf] : make_uint2(0u, ~0u);
    far = warp_arg_max(s.x, static_cast<int>(s.y), max_key);
  }
  if (staged) {
    __syncthreads();
    for (int e = tid; e < npoint; e += blockDim.x) {
      out[static_cast<size_t>(b) * npoint + e] = picks[e];
    }
  }
}

template <int P, bool kMasked>
cudaError_t launch(const float* xyz, const int* start,
                   const unsigned char* mask, int b, int n, int npoint,
                   int threads, int* out, cudaStream_t stream) {
  const int staged = npoint <= kMaxStaged ? npoint : 0;
  const size_t smem = static_cast<size_t>(n) * sizeof(float4) +
                      static_cast<size_t>(staged) * sizeof(int);
  // the shared memory limit, raised when a call needs more (a call costs
  // host time)
  static size_t smem_set[kDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  size_t unknown = 0;
  size_t& set = device < kDevices ? smem_set[device] : unknown;
  if (smem > 48 * 1024 && smem > set) {
    err = cudaFuncSetAttribute(fps_kernel<P, kMasked>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    set = smem;
  }
  fps_kernel<P, kMasked><<<b, threads, smem, stream>>>(xyz, start, mask, n,
                                                     npoint, out);
  return cudaGetLastError();
}


// -- the large path (any n, one block of kLargeThreads a cloud) ---------------

// Picks staged in shared memory, and whether the running distances fit there
// beside them (else they take `n` floats of scratch a cloud).
__host__ __device__ inline int large_staged(int npoint) {
  return npoint <= kMaxStaged ? npoint : 0;
}

inline bool large_dist_shared(int n, int npoint) {
  return (static_cast<size_t>(n) + large_staged(npoint)) * 4 <= kLargeSmem;
}

template <bool kMasked>
__global__ void __launch_bounds__(kLargeThreads)
    fps_large_kernel(const float* __restrict__ xyz,
                     const int* __restrict__ start,
                     const unsigned char* __restrict__ mask, int n,
                     int npoint, float* __restrict__ scratch,
                     int* __restrict__ out) {
  // the running distances (unless `scratch`), then the staged picks
  extern __shared__ float smem[];
  __shared__ uint2 slots[2][32];  // (key, index) of each warp

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int threads = blockDim.x;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  float* dist = scratch == nullptr ? smem : scratch + static_cast<size_t>(b) * n;
  const bool staged = npoint <= kMaxStaged;
  int* const picks =
      staged ? reinterpret_cast<int*>(scratch == nullptr ? smem + n : smem)
             : out + static_cast<size_t>(b) * npoint;

  int far = start[b];
  if (far < 0 || far >= n) {
    if (tid == 0) {
      printf("fps: cloud %d has start index %d outside [0, %d)\n", b, far,
             n);
    }
    __trap();
  }
  // a thread's own points only: no barrier needed before the first step
  if (kMasked) {
    const unsigned char* valid = mask + static_cast<size_t>(b) * n;
    unsigned first_own = ~0u;  // the thread's lowest valid index
    for (int j = tid; j < n; j += threads) {
      dist[j] = valid[j] ? 1e10f : -1e10f;
      if (valid[j]) first_own = min(first_own, static_cast<unsigned>(j));
    }
    if (!valid[far]) {  // block-uniform
      const unsigned first = block_min_index(first_own, slots);
      far = first < static_cast<unsigned>(n) ? static_cast<int>(first) : 0;
    }
  } else {
    for (int j = tid; j < n; j += threads) dist[j] = 1e10f;
  }

  uint2* const own_slot = &slots[0][warp];
  const uint2* const read_slot = &slots[0][lane];
  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) picks[i] = far;
    const float cx = pts[3 * far];
    const float cy = pts[3 * far + 1];
    const float cz = pts[3 * far + 2];
    // j grows: a strict '>' keeps the lowest index among a thread's ties; a
    // thread without points offers key 0 at index ~0 (masked: below -1e10,
    // which an invalid point holds)
    float best = kMasked ? __uint_as_float(0xff800000u) : -1.f;
    int best_j = -1;
    for (int j = tid; j < n; j += threads) {
      const float d = fminf(
          dist[j], sq_dist(pts[3 * j], pts[3 * j + 1], pts[3 * j + 2], cx,
                           cy, cz));
      dist[j] = d;
      if (d > best) {
        best = d;
        best_j = j;
      }
    }
    const int buf = (i & 1) * 32;
    unsigned max_key;
    const int g = warp_arg_max(
        kMasked ? masked_key(best) : (best < 0.f ? 0u : __float_as_uint(best)),
        best_j, max_key);
    if (lane == 0) own_slot[buf] = make_uint2(max_key, g);
    __syncthreads();
    const uint2 s = lane < n_warps ? read_slot[buf] : make_uint2(0u, ~0u);
    far = warp_arg_max(s.x, static_cast<int>(s.y), max_key);
  }
  if (staged) {
    __syncthreads();
    for (int e = tid; e < npoint; e += threads) {
      out[static_cast<size_t>(b) * npoint + e] = picks[e];
    }
  }
}

template <bool kMasked>
cudaError_t launch_large(const float* xyz, const int* start,
                         const unsigned char* mask, int b, int n, int npoint,
                         float* scratch, int* out, cudaStream_t stream) {
  const size_t staged = static_cast<size_t>(large_staged(npoint)) * 4;
  const size_t smem =
      staged + (scratch == nullptr ? static_cast<size_t>(n) * 4 : 0);
  static bool raised[kDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  bool unknown = false;
  bool& set = device < kDevices ? raised[device] : unknown;
  if (smem > 48 * 1024 && !set) {
    err = cudaFuncSetAttribute(fps_large_kernel<kMasked>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kLargeSmem));
    if (err != cudaSuccess) return err;
    set = true;
  }
  const int threads = std::min(kLargeThreads, (n + 31) / 32 * 32);
  fps_large_kernel<kMasked><<<b, threads, smem, stream>>>(
      xyz, start, mask, n, npoint, scratch, out);
  return cudaGetLastError();
}

}  // namespace

// xyz (b, n, 3) f32 contiguous, start (b,) int32 in [0, n) (checked on the
// device: a start outside traps), mask (b, n) bytes, 0 for an invalid point,
// or null (the unmasked mode) -> out (b, npoint) int32. Returns a
// cudaError_t as int (0 = launched). The register path, n <= kMaxPoints;
// fps_large_forward takes any n.
extern "C" int fps_forward(const float* xyz, const int* start,
                           const unsigned char* mask, int b, int n,
                           int npoint, int* out, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 || n > kMaxPoints) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#ifdef FPS_THREADS
  int threads = FPS_THREADS;
#else
  // 512 threads a cloud of more than 2048 points (10 points a thread at
  // sa1's 5120), else 256 (2 at sa2's 512): fewer threads each with more
  // points lengthen the local argmax chain, more add warps to the barrier
  // and to the issue of the per-warp reductions
  int threads = n > 2048 ? 512 : 256;
#endif
  // points a thread: the fewest of the instantiated counts that fit in
  // `threads` threads and in the count's register budget
  const int counts[] = {1, 2, 4, 5, 8, 10, 16, 20};
  int ppt = 0;
  for (int c : counts) {
    const int t = ((n + c - 1) / c + 31) / 32 * 32;
    if (t <= threads && t <= threads_for(c)) {
      ppt = c;
      threads = t;
      break;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ppt) {
#define MP_FPS_CASE(P)                                                    \
  case P:                                                                 \
    return static_cast<int>(                                              \
        mask == nullptr                                                   \
            ? launch<P, false>(xyz, start, mask, b, n, npoint, threads, out, \
                               s)                                         \
            : launch<P, true>(xyz, start, mask, b, n, npoint, threads, out, \
                              s));
    MP_FPS_CASE(1)
    MP_FPS_CASE(2)
    MP_FPS_CASE(4)
    MP_FPS_CASE(5)
    MP_FPS_CASE(8)
    MP_FPS_CASE(10)
    MP_FPS_CASE(16)
    MP_FPS_CASE(20)
#undef MP_FPS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Floats of scratch a cloud that the large path needs at (n, npoint): 0
// while its running distances fit in shared memory, else n.
extern "C" long long fps_large_scratch_floats(int n, int npoint) {
  return large_dist_shared(n, npoint) ? 0 : n;
}

// The large path at any n >= 1 (the wrapper's route above kMaxPoints
// points): fps_forward's arguments, with `scratch` b x
// fps_large_scratch_floats(n, npoint) floats of device memory, or null
// when that is 0.
extern "C" int fps_large_forward(const float* xyz, const int* start,
                                 const unsigned char* mask, int b, int n,
                                 int npoint, float* scratch, int* out,
                                 void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 ||
      (scratch == nullptr && !large_dist_shared(n, npoint))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      mask == nullptr
          ? launch_large<false>(xyz, start, mask, b, n, npoint, scratch, out, s)
          : launch_large<true>(xyz, start, mask, b, n, npoint, scratch, out,
                               s));
}
