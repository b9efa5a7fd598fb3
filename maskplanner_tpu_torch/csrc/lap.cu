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
// the n x n costs (1.9 KB at the flagship's 22 x 22). The problems run side
// by side, so a launch takes as long as its longest problem's chain of
// steps. The chain floor of one step of the warp path, counted from the
// instructions it cannot overlap (latencies on sm_90, in cycles):
//   the row's potential (shuffle, 24) in parallel with its cost (shared
//   load, 24) -> three dependent f32 adds (3 x 4) -> the compare and two
//   selects of the shortest distance (3 x 4) -> the order-preserving key
//   (2 x 4) -> redux.sync min (32) -> the compare with the minimum and
//   __ballot_sync (4 + 8) -> __ffs (8) -> the winner's row4col by shuffle
//   (24) -> the loop's test (4)
// = kStepCycles (136). chip_smoke.py reads it through lap_step_cycles() and
// bounds the launch below by the longest problem's steps x kStepCycles at
// the SM clock.
//
// What the design does about it:
// - n <= 32 (the flagship's 22), the warp path: a problem a warp, several
//   warps a block, and no __syncthreads. Lane j keeps column j's shortest
//   distance, path row, potential v and scanned flag, and row j's
//   potential u, col4row and row4col, all in registers: a row's u and a
//   column's row4col are read by __shfl_sync. The warp stages its costs in
//   shared memory once. A step's argmin is __reduce_min_sync (redux.sync)
//   on an order-preserving 32-bit key of each unscanned column's distance,
//   then __ballot_sync + __ffs for the lowest column among equal values:
//   ties go to the lowest column, as torch.argmin does in the plain
//   version. The path walk runs in registers and shuffles.
// - 33 <= n <= 128, the block path: one block a problem, one thread a
//   column; the costs in shared memory (64 KB at n = 128, its limit raised
//   once per device); the row potentials, col4row, row4col and the
//   scanned rows in shared memory; the argmin a warp-shuffle reduction and
//   one round through shared memory over the warps; one thread walks the
//   augmenting path. Its chain of one step, counted as the warp path's:
//   the row's cost and potential from shared memory in parallel (24) ->
//   the three adds (12) -> the shortest distance's compare and two selects
//   (12) -> the unscanned column's select (4) -> five shuffle-and-merge
//   rounds (5 x 40: two shuffles in parallel, 24, then the merge's
//   compares and selects, 16) -> with more than one warp, lane 0's stores,
//   the barrier and the load of warp 0's winner (64), then a shared load
//   and a merge for each further warp (40) -> the winner's row4col from
//   shared memory (24) and the next row's select (4) -> the step's closing
//   barrier (20) -> the loop's test (4): lap_block_step_cycles(n), 408 at
//   n = 44 (two warps).
// - n > 128 (emd's exact route: 200 predictions against 50 GT rows pad to
//   200 x 200), the large path, lap_large_kernel, with n bounded only by
//   the card's memory: one block a problem of up to 1024 threads, thread t
//   owning columns t, t + T, ...; each step reads row i's costs from
//   device memory (coalesced, L2-resident); u, v, the shortest distances,
//   the path rows, col4row, row4col and the scanned rows and columns
//   (26 bytes an index, LargeState) sit in dynamic shared memory while
//   they fit (kLargeSmem: about 8900 columns), else in a scratch buffer
//   the wrapper allocates (lap_large_scratch_bytes). A step's argmin is a
//   thread's own scan over its rising columns (strict '<'), a
//   warp-shuffle reduction and one round through shared memory (double
//   buffered by step, so one barrier a step), ties to the lowest column;
//   the owner of the winning column marks it scanned. Its chain of one
//   step, counted as above: the row's cost from L2 (200) -> the three adds
//   (12) -> the shortest distance's compare and selects (8) -> the
//   thread's scan, 8 a column it owns -> five shuffle-and-merge rounds
//   (5 x 40) -> the store, barrier and load of the warps' winners (64) ->
//   five more rounds (200) -> the winner's row4col (24 from shared memory,
//   200 from scratch) -> the loop's test (8): lap_large_step_cycles(n).
//   It is a simple kernel that is right; its time and bound are in
//   PERF.md.
// Every value is f32, formed in the plain version's order
// (ops/hungarian.py::lap_plain), so the two normally agree index for index.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxN = 128;
constexpr float kInf = 1e18f;
constexpr int kStepCycles = 136;
constexpr int kWarpProblems = 4;  // problems a block of the warp path
constexpr int kDevices = 16;      // devices whose attribute is set
constexpr int kLargeThreads = 1024;  // threads a problem of the large path
// dynamic shared memory the large path's state may take (of the 227 KB a
// block can use, the rest left to its static slots)
constexpr size_t kLargeSmem = 226 * 1024;

// -- the warp path (n <= 32) -------------------------------------------------

// An unsigned key that orders as the float does (-0 and +0 alike).
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.f));  // -0 -> +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(32 * kWarpProblems)
    lap_warp_kernel(const float* __restrict__ cost, int b, int n,
                    int* __restrict__ col4row_out) {
  extern __shared__ float c_all[];  // kWarpProblems x n x n costs
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int problem = blockIdx.x * kWarpProblems + warp;
  if (problem >= b) return;  // whole warps leave: no block barrier follows
  float* c = c_all + warp * n * n;
  const float* cb = cost + static_cast<size_t>(problem) * n * n;
  for (int e = lane; e < n * n; e += 32) c[e] = __ldg(cb + e);
  __syncwarp();

  const bool col = lane < n;  // lane j: column j and row j
  float u = 0.f, v = 0.f;
  int col4row = -1, row4col = -1;
  for (int cur = 0; cur < n; ++cur) {
    float shortest = kInf;
    int path = -1;
    bool scanned = false;
    bool scanned_row = false;
    int i = cur;  // the same in every lane
    int sink = 0;
    float minval = 0.f;
    // at most n steps: each scans a new column, and a free one ends the
    // search (the bound keeps non-finite costs from looping forever)
    for (int step = 0; step < n; ++step) {
      if (lane == i) scanned_row = true;
      const float ui = __shfl_sync(0xffffffffu, u, i);
      if (col && !scanned) {
        const float d =
            __fsub_rn(__fsub_rn(__fadd_rn(minval, c[i * n + lane]), ui), v);
        if (d < shortest) {
          shortest = d;
          path = i;
        }
      }
      // argmin over the columns: scanned ones count as kInf (the plain
      // version's mask), lanes past n never win
      const float cand = scanned ? kInf : shortest;
      const unsigned key = col ? order_key(cand) : 0xffffffffu;
      const unsigned best = __reduce_min_sync(0xffffffffu, key);
      const int jj = __ffs(__ballot_sync(0xffffffffu, key == best)) - 1;
      minval = __shfl_sync(0xffffffffu, cand, jj);
      if (lane == jj) scanned = true;
      const int nxt = __shfl_sync(0xffffffffu, row4col, jj);
      if (nxt < 0) {
        sink = jj;
        break;
      }
      i = nxt;
    }
    // potentials (scipy rectangular_lsap): lane j updates row j's, then
    // column j's
    const float short_cj =
        __shfl_sync(0xffffffffu, shortest, col4row < 0 ? 0 : col4row);
    if (col) {
      if (lane == cur) {
        u = __fadd_rn(u, minval);
      } else if (scanned_row) {
        u = __fadd_rn(u, __fsub_rn(minval, short_cj));
      }
      if (scanned) v = __fsub_rn(__fadd_rn(v, shortest), minval);
    }
    // augment along the alternating path that ends at the sink
    int j = sink;
    for (int t = 0; t < n; ++t) {
      const int r = __shfl_sync(0xffffffffu, path, j);
      const int prev = __shfl_sync(0xffffffffu, col4row, r);
      if (lane == j) row4col = r;
      if (lane == r) col4row = j;
      if (r == cur) break;
      j = prev;
    }
  }
  if (col) col4row_out[static_cast<size_t>(problem) * n + lane] = col4row;
}

// -- the block path (33 <= n <= 128) -----------------------------------------

// (v, j) beats (best_v, best_j) when smaller, or equal at a lower column.
__device__ __forceinline__ void arg_min_merge(float v, int j, float& best_v,
                                              int& best_j) {
  if (v < best_v || (v == best_v && j < best_j)) {
    best_v = v;
    best_j = j;
  }
}

__global__ void __launch_bounds__(kMaxN)
    lap_block_kernel(const float* __restrict__ cost, int n,
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
    for (int step = 0; sink < 0 && step < n; ++step) {
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
      for (int t = 0; t < n && jj >= 0; ++t) {
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


// -- the large path (any n; the wrapper's route above kMaxN) -----------------

// A problem's state on the large path: 26 bytes an index, 16-byte aligned
// arrays.
struct LargeState {
  float* u;
  float* v;
  float* shortest;
  int* path;
  int* col4row;
  int* row4col;
  unsigned char* s_rows;
  unsigned char* s_cols;
};

__host__ __device__ inline size_t large_words(int n) {
  return (static_cast<size_t>(n) * 4 + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t large_flags(int n) {
  return (static_cast<size_t>(n) + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t large_state_bytes(int n) {
  return 6 * large_words(n) + 2 * large_flags(n);
}

__device__ inline LargeState large_state(unsigned char* base, int n) {
  const size_t w = large_words(n);
  LargeState st;
  st.u = reinterpret_cast<float*>(base);
  st.v = reinterpret_cast<float*>(base + w);
  st.shortest = reinterpret_cast<float*>(base + 2 * w);
  st.path = reinterpret_cast<int*>(base + 3 * w);
  st.col4row = reinterpret_cast<int*>(base + 4 * w);
  st.row4col = reinterpret_cast<int*>(base + 5 * w);
  st.s_rows = base + 6 * w;
  st.s_cols = base + 6 * w + large_flags(n);
  return st;
}

__device__ __forceinline__ void warp_arg_min(float& best_v, int& best_j) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
    const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
    arg_min_merge(ov, oj, best_v, best_j);
  }
}

__global__ void __launch_bounds__(kLargeThreads)
    lap_large_kernel(const float* __restrict__ cost, int n,
                     unsigned char* __restrict__ scratch,
                     int* __restrict__ col4row_out,
                     int* __restrict__ steps_out) {
  extern __shared__ __align__(16) unsigned char smem_state[];
  __shared__ float warp_v[2][32];
  __shared__ int warp_j[2][32];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = blockDim.x >> 5;
  const int threads = blockDim.x;
  const size_t problem = blockIdx.x;
  const LargeState st = large_state(
      scratch == nullptr ? smem_state
                         : scratch + problem * large_state_bytes(n),
      n);
  const float* cb = cost + problem * n * n;
  for (int e = t; e < n; e += threads) {
    st.u[e] = 0.f;
    st.v[e] = 0.f;
    st.col4row[e] = -1;
    st.row4col[e] = -1;
  }
  int n_steps = 0;

  for (int cur = 0; cur < n; ++cur) {
    for (int e = t; e < n; e += threads) {
      st.shortest[e] = kInf;
      st.path[e] = -1;
      st.s_rows[e] = 0;
      st.s_cols[e] = 0;
    }
    __syncthreads();
    int i = cur;  // identical in every thread
    int sink = -1;
    float minval = 0.f;
    for (int step = 0; sink < 0 && step < n; ++step) {
      ++n_steps;
      if (t == 0) st.s_rows[i] = 1;
      const float ui = st.u[i];
      const float* ci = cb + static_cast<size_t>(i) * n;
      // this thread's columns, rising: a strict '<' keeps the lowest among
      // ties; scanned columns count as kInf (the plain version's mask)
      float best_v = INFINITY;
      int best_j = n;
      for (int j = t; j < n; j += threads) {
        const bool scanned = st.s_cols[j];
        float sh = st.shortest[j];
        if (!scanned) {
          const float d = ((minval + ci[j]) - ui) - st.v[j];
          if (d < sh) {
            sh = d;
            st.shortest[j] = d;
            st.path[j] = i;
          }
        }
        const float cand = scanned ? kInf : sh;
        if (cand < best_v) {
          best_v = cand;
          best_j = j;
        }
      }
      warp_arg_min(best_v, best_j);
      const int buf = step & 1;  // rewritten two steps later, past a barrier
      if (lane == 0) {
        warp_v[buf][warp] = best_v;
        warp_j[buf][warp] = best_j;
      }
      __syncthreads();
      best_v = lane < n_warps ? warp_v[buf][lane] : INFINITY;
      best_j = lane < n_warps ? warp_j[buf][lane] : n;
      warp_arg_min(best_v, best_j);
      minval = best_v;
      if (best_j % threads == t) st.s_cols[best_j] = 1;
      const int nxt = st.row4col[best_j];
      if (nxt < 0) {
        sink = best_j;
      } else {
        i = nxt;
      }
    }
    __syncthreads();  // every thread's shortest, s_rows and s_cols
    // potentials (scipy rectangular_lsap): row r's, then column r's
    for (int r = t; r < n; r += threads) {
      if (r == cur) {
        st.u[r] = st.u[r] + minval;
      } else if (st.s_rows[r]) {
        const int cj = st.col4row[r] < 0 ? 0 : st.col4row[r];
        st.u[r] = st.u[r] + (minval - st.shortest[cj]);
      }
      if (st.s_cols[r]) st.v[r] = (st.v[r] + st.shortest[r]) - minval;
    }
    __syncthreads();
    // augment along the alternating path that ends at the sink
    if (t == 0) {
      int jj = sink;
      for (int k = 0; k < n && jj >= 0; ++k) {
        const int r = st.path[jj];
        st.row4col[jj] = r;
        const int prev = st.col4row[r];
        st.col4row[r] = jj;
        if (r == cur) break;
        jj = prev;
      }
    }
    __syncthreads();
  }
  for (int e = t; e < n; e += threads) {
    col4row_out[problem * n + e] = st.col4row[e];
  }
  if (t == 0 && steps_out != nullptr) steps_out[problem] = n_steps;
}

inline bool large_state_shared(int n) {
  return large_state_bytes(n) <= kLargeSmem;
}

int launch_large(const float* cost, int b, int n, unsigned char* scratch,
                 int* col4row, int* steps, cudaStream_t stream) {
  const size_t smem = scratch == nullptr ? large_state_bytes(n) : 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool raised[kDevices] = {};
  bool unknown = false;
  bool& set = device < kDevices ? raised[device] : unknown;
  if (smem > 48 * 1024 && !set) {
    err = cudaFuncSetAttribute(lap_large_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kLargeSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    set = true;
  }
  const int threads = n < kLargeThreads ? (n + 31) / 32 * 32 : kLargeThreads;
  lap_large_kernel<<<b, threads, smem, stream>>>(cost, n, scratch, col4row,
                                                 steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cost (b, n, n) f32 contiguous, 1 <= n <= 128 (the warp and block paths;
// lap_large_forward takes any n). Writes col4row (b, n) int32. Returns a
// cudaError_t as int (0 = launched).
extern "C" int lap_forward(const float* cost, int b, int n, int* col4row,
                           void* stream) {
  if (b <= 0 || n <= 0 || n > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 32) {
    const size_t smem = sizeof(float) * kWarpProblems * n * n;  // <= 16 KB
    lap_warp_kernel<<<(b + kWarpProblems - 1) / kWarpProblems,
                      32 * kWarpProblems, smem, st>>>(cost, b, n, col4row);
    return static_cast<int>(cudaGetLastError());
  }
  // the block path's costs pass 48 KB above n = 110: the limit is raised to
  // n = 128's once per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool raised[kDevices] = {};
  bool unknown = false;
  bool& set = device < kDevices ? raised[device] : unknown;
  if (!set) {
    err = cudaFuncSetAttribute(lap_block_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(float) * kMaxN * kMaxN));
    if (err != cudaSuccess) return static_cast<int>(err);
    set = true;
  }
  const int threads = ((n + 31) / 32) * 32;
  const size_t smem = sizeof(float) * static_cast<size_t>(n) * n;
  lap_block_kernel<<<b, threads, smem, st>>>(cost, n, col4row);
  return static_cast<int>(cudaGetLastError());
}

// Cycles of one dependent Dijkstra step of the warp path (the chain floor
// in this file's note).
extern "C" int lap_step_cycles() { return kStepCycles; }

// Cycles of one dependent Dijkstra step of the block path (33 <= n <= 128)
// at n (the chain floor in this file's note): its fixed part, then the
// round over the warps' winners.
extern "C" int lap_block_step_cycles(int n) {
  const int warps = (n + 31) / 32;
  return 304 + (warps > 1 ? 64 + 40 * (warps - 1) : 0);
}

// Bytes of scratch a problem that the large path needs at n: 0 while its
// state fits in shared memory, else the state's 26 bytes an index.
extern "C" long long lap_large_scratch_bytes(int n) {
  return large_state_shared(n) ? 0 : static_cast<long long>(large_state_bytes(n));
}

// The large path at any n >= 1 (the wrapper's route above kMaxN):
// lap_forward's arguments, with `scratch` b x lap_large_scratch_bytes(n)
// bytes of device memory (16-byte aligned), or null when that is 0;
// `steps`, when not null, (b,) int32: each problem's Dijkstra steps.
extern "C" int lap_large_forward(const float* cost, int b, int n,
                                 int* col4row, void* scratch, int* steps,
                                 void* stream) {
  if (b <= 0 || n <= 0 || (scratch == nullptr && !large_state_shared(n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_large(cost, b, n, static_cast<unsigned char*>(scratch),
                      col4row, steps, static_cast<cudaStream_t>(stream));
}

// Cycles of one dependent Dijkstra step of the large path at n (the chain
// floor in this file's note): its fixed part, 8 a column a thread owns,
// and the winner's row4col from scratch past the shared-memory cut.
extern "C" int lap_large_step_cycles(int n) {
  const int threads = n < kLargeThreads ? (n + 31) / 32 * 32 : kLargeThreads;
  const int owned = (n + threads - 1) / threads;
  return 716 + 8 * owned + (large_state_shared(n) ? 0 : 176);
}
