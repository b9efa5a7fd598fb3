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
// Both take the selection from ball_select.cuh (select_first_k_warp), the
// code the fused SA forward uses, so that every neighbour list of the port
// is the same.
//
// What bounds it on this card. At sa2 of the flagship step (B 64, S 128,
// K 64, N 512, F 128) the bytes: 275 MB of output, 0.08 ms at 3.35 TB/s,
// beside 268 MB of feature rows gathered through L1 and L2. At sa1 (B 64,
// S 512, K 32, N 5120, no features) the scan: a query tests every point
// up to its K-th neighbour, 2200 of the 5120 on average on the windows-v2
// clouds, 72 M point tests a launch of about 15 instructions each (three
// loads of a point's coordinates, the fixed-order distance, a compare, a
// ballot), far above the 17 MB it writes. Each warp's scan is a chain of
// dependent steps, so the SM needs many warps in flight to hide it.
//
// What the design does about it:
// - Selection: a warp a query, several queries a block, all of one cloud
//   (grid (query chunks, B)). The warp scans 32 x kScanPer points a step
//   with ballots and no barrier (ball_select.cuh), so the block's warps
//   select, and then write, each at its own pace: a warp writes its
//   query's rows while the others still scan.
// - The cloud is staged in shared memory once a block (sa1 60 KB, sa2 6
//   KB; one barrier, before any scan), where a warp's load of 32 points'
//   coordinates (stride 12 bytes) is one conflict-free wavefront; from
//   device memory through L1 the same load touches three to four 128-byte
//   lines. A staged cloud of sa1's size leaves room for 3 blocks an SM,
//   so such blocks take 16 warps (48 an SM), the others 8; and a block
//   takes more queries when its cloud is large, so that the copy is
//   amortised (sa1: 32 queries a block, 1.9 KB staged a query), fewer
//   when that would leave SMs idle (batch 1). Clouds past
//   kStageMaxPoints, or builds with -DGG_NO_STAGE (a timing study), read
//   the cloud through L1 instead.
// - Writes: a query's K x (3 + F) values are contiguous in device memory;
//   the warp writes them as 16-byte vectors (4 floats, or 8 bf16 packed as
//   bf16 pairs in 32-bit words) from the first 16-byte boundary on, with
//   the ragged head and tail of the region stored value by value, so any
//   row width and alignment stays right (sa1's 96 and sa2's 8384 floats a
//   query start aligned). No value pays an integer division: a lane works
//   out its first (row, channel) once a query and then steps by a constant
//   (row, channel) stride, with compares.
// The values are exact copies of the source rows; the offsets are one
// __fsub_rn, as in the plain version (ops/group_gather.py::
// ball_group_plain). The TPU kernel's one-hot matrix extraction, hi/lo bf16
// split and float-coded indices exist because the TPU has no gather; here
// the rows are read straight from the tables.
//
// The single-pass variant (ball_group_single_forward) replaces the same
// kernel's single_pass=True, which bf16 models group with: every gathered
// channel lands rounded to bf16, the offsets as bf16(x) - q in float32,
// and the consumer, a bf16 MLP, rounds the row to bf16. Here the kernel
// writes that row itself, as bf16: bf16(bf16(x) - q) and bf16(f), each
// rounded to nearest even, which halves the bytes written (sa2: 138 MB
// at batch 64), the bound of this kernel.
//
// -DGG_NO_WRITE (timing studies only) leaves out the value writes: the
// selection and the indices alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "ball_select.cuh"

namespace {

constexpr int kScanPer = 4;  // points a lane tests a scan step
// warps a block, a query each at a time: 16 where a staged cloud of more
// than kSmallCloud bytes caps the blocks an SM holds, else 8
constexpr int kWarps = 8;
constexpr int kWarpsStaged = 16;
constexpr int kSmallCloud = 16 * 1024;
constexpr int kMaxQueriesPerWarp = 4;
// staged cloud bytes a query that a block's queries amortise
constexpr int kStagedBytesPerQuery = 2048;
constexpr int kStageMaxPoints = 12288;  // 144 KB of staged cloud
constexpr int kMaxSmem = 227 * 1024;    // a block's shared memory on sm_90
constexpr int kDevices = 16;            // devices whose attribute is set

#ifdef GG_NO_STAGE
constexpr bool kMayStage = false;
#else
constexpr bool kMayStage = true;
#endif
#ifdef GG_NO_WRITE
constexpr bool kWrite = false;
#else
constexpr bool kWrite = true;
#endif

// Out: float (the values) or __nv_bfloat16 (the single-pass row).
template <typename Out>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;  // values a 16-byte store
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  __device__ static float one(float v) { return v; }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static unsigned pair(float lo, float hi) {
    // low half: the lower address, as a (.., 2) bf16 row lays it out
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&p);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(pair(v[0], v[1]), pair(v[2], v[3]), pair(v[4], v[5]),
                      pair(v[6], v[7]));
  }
  __device__ static __nv_bfloat16 one(float v) {
    return __float2bfloat16_rn(v);
  }
};

// One query's K x cin output values, by one warp: value e of the region is
// row k = e / cin, channel c = e % cin of the output row [x - q ; f] of
// neighbour sel[k].
template <bool kStaged, typename Out>
__device__ __forceinline__ void write_rows(
    const float* __restrict__ cloud, const float* __restrict__ fb, int f,
    int k_nb, const int* sel, float qx, float qy, float qz, int step_k,
    int step_c, Out* __restrict__ out) {
  constexpr bool kSingle = !std::is_same<Out, float>::value;
  constexpr int kN = Vec<Out>::kN;
  const int lane = threadIdx.x & 31;
  const int cin = 3 + f;
  const int total = k_nb * cin;
  auto value = [&](int k, int c) -> float {
    const int j = sel[k];
    if (c < 3) {
      const float qc = c == 0 ? qx : (c == 1 ? qy : qz);
      float x;
      if constexpr (kStaged) {
        x = cloud[3 * j + c];
      } else {
        x = __ldg(cloud + 3 * j + c);
      }
      if (kSingle) x = __bfloat162float(__float2bfloat16_rn(x));
      return __fsub_rn(x, qc);
    }
    return __ldg(fb + static_cast<size_t>(j) * f + (c - 3));
  };
  // the ragged head, up to the first 16-byte boundary, and tail: fewer
  // than kN values each, a value a lane
  const int head = min(
      total, static_cast<int>(
                 ((16u - (reinterpret_cast<uintptr_t>(out) & 15u)) & 15u) /
                 sizeof(Out)));
  const int n_vec = (total - head) / kN;
  const int tail0 = head + n_vec * kN;
  if (lane < head + (total - tail0)) {
    const int at = lane < head ? lane : tail0 + (lane - head);
    const int k = at / cin;
    out[at] = Vec<Out>::one(value(k, at - k * cin));
  }
  // the 16-byte vectors: lane l takes vectors l, l + 32, ...
  uint4* vout = reinterpret_cast<uint4*>(out + head);
  int k = (head + lane * kN) / cin;
  int c = head + lane * kN - k * cin;
  // unrolled so that several vectors' loads are in flight before their
  // stores (a lone warp writes sa2's 33 KB a query)
#pragma unroll 4
  for (int v = lane; v < n_vec; v += 32) {
    float vals[kN];
    int kk = k, cc = c;
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      vals[m] = value(kk, cc);
      if (++cc == cin) {
        cc = 0;
        ++kk;
      }
    }
    vout[v] = Vec<Out>::pack(vals);
    k += step_k;  // the next vector of this lane: 32 kN values on
    c += step_c;
    if (c >= cin) {
      c -= cin;
      ++k;
    }
  }
}

template <bool kGather, bool kStaged, typename Out>
__global__ void __launch_bounds__(32 * kWarpsStaged)
    ball_group_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ new_xyz,
                      const float* __restrict__ feats, int n, int s, int f,
                      int k_nb, float radius2, int per_warp,
                      Out* __restrict__ grouped, int* __restrict__ idx_out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int b = blockIdx.y;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  const float* cloud = pts;
  int* sel_all = reinterpret_cast<int*>(smem);
  if constexpr (kStaged) {
    float* staged = smem;
    const int n3 = 3 * n;
    // 16-byte loads where the cloud is aligned, then the rest
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(pts) & 15u) == 0) {
      const float4* src = reinterpret_cast<const float4*>(pts);
      float4* dst = reinterpret_cast<float4*>(staged);
      for (int e = threadIdx.x; e < n3 / 4; e += blockDim.x) {
        dst[e] = __ldg(src + e);
      }
      done = n3 / 4 * 4;
    }
    for (int e = done + threadIdx.x; e < n3; e += blockDim.x) {
      staged[e] = __ldg(pts + e);
    }
    cloud = staged;
    // the selections after the cloud, 16-byte aligned
    sel_all = reinterpret_cast<int*>(smem + ((n3 + 3) & ~3));
    __syncthreads();  // the only barrier: before any scan
  }
  int* sel = sel_all + warp * k_nb;
  const int cin = 3 + f;
  constexpr int kN = Vec<Out>::kN;
  const int step_k = 32 * kN / cin;
  const int step_c = 32 * kN - step_k * cin;
  const int j0 = blockIdx.x * n_warps * per_warp + warp;
  for (int t = 0; t < per_warp; ++t) {
    const int j = j0 + t * n_warps;
    if (j >= s) break;
    const size_t query = static_cast<size_t>(b) * s + j;
    const float qx = new_xyz[3 * query];
    const float qy = new_xyz[3 * query + 1];
    const float qz = new_xyz[3 * query + 2];
    ball_select::select_first_k_warp<kScanPer, kStaged>(
        cloud, n, qx, qy, qz, radius2, k_nb, sel, idx_out + query * k_nb);
    if constexpr (kGather && kWrite) {
      write_rows<kStaged>(cloud,
                          f > 0 ? feats + static_cast<size_t>(b) * n * f
                                : nullptr,
                          f, k_nb, sel, qx, qy, qz, step_k, step_c,
                          grouped + query * k_nb * cin);
    }
    __syncwarp();  // sel is rewritten by the next query
  }
}

template <bool kGather, typename Out = float>
int launch(const float* xyz, const float* new_xyz, const float* feats, int b,
           int n, int s, int f, int k_nb, float radius2, Out* grouped,
           int* idx, void* stream) {
  if (b <= 0 || n <= 0 || s <= 0 || k_nb <= 0 || f < 0 || b > 65535 ||
      (f > 0 && feats == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t cloud_bytes = sizeof(float) * ((3 * static_cast<size_t>(n) +
                                               3) & ~static_cast<size_t>(3));
  const bool staged = kMayStage && n <= kStageMaxPoints &&
                      cloud_bytes + sizeof(int) * kWarpsStaged *
                                        static_cast<size_t>(k_nb) <=
                          kMaxSmem;
  const int warps =
      staged && cloud_bytes > kSmallCloud ? kWarpsStaged : kWarps;
  const size_t sel_bytes = sizeof(int) * warps * static_cast<size_t>(k_nb);
  const size_t smem = sel_bytes + (staged ? cloud_bytes : 0);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = staged ? ball_group_kernel<kGather, true, Out>
                       : ball_group_kernel<kGather, false, Out>;
  // the SM count, and the shared-memory limit raised, once per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int sms[kDevices] = {};
  static bool raised[kDevices][2] = {};
  int n_sm = device < kDevices ? sms[device] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kDevices) sms[device] = n_sm;
  }
  bool unknown = false;
  bool& set = device < kDevices ? raised[device][staged] : unknown;
  if (!set && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set = true;
  }
  // queries a warp: enough that a block's queries amortise its staged
  // cloud (one a warp without staging), but fewer while the grid would
  // leave SMs idle (batch 1)
  int per_warp = 1;
  if (staged) {
    const size_t want = (cloud_bytes + kStagedBytesPerQuery - 1) /
                        kStagedBytesPerQuery;  // queries a block
    per_warp = static_cast<int>(
        std::min<size_t>(kMaxQueriesPerWarp, (want + warps - 1) / warps));
    per_warp = std::max(per_warp, 1);
    auto blocks = [&](int w) {
      return static_cast<long long>(b) * ((s + warps * w - 1) / (warps * w));
    };
    while (per_warp > 1 && blocks(per_warp) < 2LL * n_sm) per_warp /= 2;
  }
  const int per_block = warps * per_warp;
  const dim3 grid((s + per_block - 1) / per_block, b);
  kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, feats, n, s, f, k_nb, radius2, per_warp, grouped, idx);
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
