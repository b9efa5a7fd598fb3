// Fused PointNet++ set-abstraction level, forward, bf16 mode, for Hopper
// (sm_90a): the level bf16 models serve with by default, and the forward
// of their training step.
//
// Replaces the forward Pallas kernel of
// maskplanner_tpu/ops/pallas/fused_sa_train.py (`_fsa_train_fwd_raw`, body
// `_fwd_kernel`) at precision="default": for every query q (an FPS
// centroid) take the first K source points in index order with
// |x - q|^2 <= r^2, gather the rows [x - q ; f], run the per-point MLP
// (Dense, then LayerNorm with eps 1e-6 or no norm, then ReLU) and take the
// max over the K neighbours. The rounding points are the JAX kernel's:
// the offsets x - q (formed in float32) and the feature rows are rounded to
// bf16 where they enter the first product; every layer product takes bf16
// x bf16 operands summed in float32 from the bias; the LayerNorm, the ReLU
// and the max run in float32. Writes pooled (B, S, C) f32 and the
// neighbour indices (B, S, K) int32, and, when asked (training), the
// winner of the max: for each (query, channel) the first k in [0, K) whose
// last activation is the max, which the backward (fused_sa_bwd.cu's bf16
// mode) routes the max-pool gradient to.
//
// What bounds it on this card: the bf16 products, 95.3 GFLOP at the
// flagship batch of 64 (sa1 26 + sa2 69), 0.1 ms at 989 TFLOP/s. The bytes
// are small: the clouds, the weights, pooled and the indices.
//
// What the design does about it (the usual shape of a fast Hopper kernel):
// - Resident weights: one persistent block an SM; every layer's bf16
//   weight in wgmma's K-major core-matrix layout (no swizzle: core matrices
//   of 8 rows x 16 bytes, each 128 contiguous bytes, so both the wgmma
//   reads and the producer's 16-byte stores are free of bank conflicts),
//   and the biases, gammas and betas, are packed into one image in device
//   memory by a small kernel the same call launches first
//   (fused_sa_pack_bf16_kernel), which each block copies into shared
//   memory once with one cp.async.bulk on an mbarrier. sa2 (131 inputs
//   padded to 144; 128, 128, 256 outputs) is 132 KB, sa1 26 KB.
// - A producer warpgroup (setmaxnreg.dec; two at sa1, whose scans take
//   longer than its products): each of its warps takes groups of queries
//   in turn, selects each query's neighbours with
//   ball_select.cuh::select_first_k_warp (a warp a query; it writes idx),
//   then gathers [x - q ; f] as bf16 rows (the features as float4 where
//   they allow) into a 64-row tile of a ring in shared memory, in the
//   core-matrix layout wgmma reads A from. A tile holds 64 / R queries,
//   R = K rounded up to 16, 32 or 64 (sa1: two of K 32; sa2: one of K
//   64); above K 64 a query spans ceil(K / 64) tiles.
//   Rows past a query's K repeat its first neighbour and are left out of
//   the max. Each warp owns its own slots of the ring; full and empty
//   mbarriers hand them to the consumers and back.
// - Two consumer warpgroups (setmaxnreg.inc), each on its own tile: layer
//   0 is wgmma m64nNk16 with A from the tile, the accumulators started from
//   the bias; the LayerNorm (centred two-pass statistics: a row's channels
//   lie on the four lanes of a quad, two shuffles a sum) and the ReLU run
//   on the accumulators in registers; rounded to bf16 there, the
//   accumulators of columns [16j, 16j + 16) are the A registers of k-step
//   j of the next layer's wgmma (the accumulator and A-fragment layouts
//   coincide), so no activation goes back to shared memory. The max over a
//   query's rows, and its first row, run in registers (a reduce-scatter of
//   shuffles over the 8 lanes that share a column, ties to the lower row),
//   then across the query's warps through shared memory. The slot goes
//   back to the producer as soon as layer 0 has read it.
// Widths: every layer output is padded to a multiple of 64 (one wgmma of
// n 64, 128, 192 or 256), at most 256; the gathered rows to a multiple of
// 16. sa1's and sa2's widths run as straight-line code with each layer's
// registers its own; any other level runs the same steps in a loop over
// its layers, slower (it spills). Only the order of the float32 sums
// differs from the plain version.
// Measured (PERF.md §6): the max-pool's shuffles, the LayerNorm and, at
// sa1, the producers' scans take most of the time, not the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "ball_select.cuh"
#include "fused_sa_bf16.cuh"
#include "fused_sa_common.cuh"
#include "wgmma_bf16.cuh"

// Timing studies only (bench_sa_backward.py --dtype bf16), each bit
// leaving out a part, the result then wrong; 0 in every real build: 128 the
// wgmma products (the accumulators keep the bias), 256 the register
// LayerNorm epilogue (ReLU alone), 512 the neighbour scan (the first K
// points), 1024 the producer's gather (the tiles keep what they held).

namespace {

using namespace fsa_bf16;

constexpr int kMaxStages = 8;  // tiles in the ring, at most
constexpr int kScanPer = 4;    // points a lane tests in a scan step
// A block: kP producer warpgroups (1 or 2), then two consumer warpgroups.
// Registers a thread after setmaxnreg: the producers give up what the
// consumers take, all the block holds from its launch (kP 1: 128 x 56 +
// 256 x 224 = 384 x 168; kP 2: 256 x 56 + 256 x 200 = 512 x 128).
constexpr int kConsumers = 2;
__host__ __device__ constexpr int threads_of(int kP) {
  return 128 * (kP + kConsumers);
}
constexpr int kProducerRegs = 56;
__host__ __device__ constexpr int consumer_regs(int kP) {
  return kP == 1 ? 224 : 200;
}

#ifdef FSA_PHASES
// Timing studies (bench_sa_backward.py --dtype bf16): the clock cycles of
// each phase, summed over the blocks by one thread of the first consumer
// warpgroup (0 waiting for a tile, 1 the layers, 2 the max) and one of the
// producer (3 the selection, 4 waiting for a slot, 5 the gather).
constexpr int kPhases = 6;
__device__ unsigned long long g_phase_cycles[kPhases];
#define FSA_PHASE(i)                                    \
  do {                                                  \
    if (timed) {                                        \
      const long long now = clock64();                  \
      cycles[i] += now - phase_t;                       \
      phase_t = now;                                    \
    }                                                   \
  } while (0)
#define FSA_PHASES_BEGIN(who)                           \
  const bool timed = static_cast<int>(threadIdx.x) == (who); \
  unsigned long long cycles[kPhases] = {};              \
  long long phase_t = clock64()
#define FSA_PHASES_END                                  \
  if (timed) {                                          \
    for (int i = 0; i < kPhases; ++i) {                 \
      atomicAdd(g_phase_cycles + i, cycles[i]);         \
    }                                                   \
  }
#else
#define FSA_PHASE(i) \
  do {               \
  } while (0)
#define FSA_PHASES_BEGIN(who) \
  do {                        \
  } while (0)
#define FSA_PHASES_END \
  do {                 \
  } while (0)
#endif

__device__ __forceinline__ void producer(
    const Level& lv, const float* __restrict__ xyz,
    const float* __restrict__ new_xyz, const float* __restrict__ feats,
    int n, int s, int f, int k_nb, float radius2, int n_queries,
    int g_begin, int n_local, uint8_t* smem, uint64_t* full,
    uint64_t* empty, int* __restrict__ idx_out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= lv.producers) return;
  int* sel = reinterpret_cast<int*>(smem + lv.off_sel) + warp * lv.sel_ints;
  FSA_PHASES_BEGIN(0);
  for (int gl = warp; gl < n_local; gl += lv.producers) {
    const int q0 = (g_begin + gl) * lv.queries;
    // -- selection: the first k_nb in-radius points in ascending index --
    for (int qi = 0; qi < lv.queries && q0 + qi < n_queries; ++qi) {
      const size_t query = static_cast<size_t>(q0 + qi);
      int* out = idx_out + query * k_nb;
      if (SA_BWD_SKIP & 512) {  // timing studies: the first K points
        for (int k = lane; k < k_nb; k += 32) {
          sel[qi * k_nb + k] = k % n;
          out[k] = k % n;
        }
        __syncwarp();
        continue;
      }
      ball_select::select_first_k_warp<kScanPer>(
          xyz + (query / s) * n * 3, n, new_xyz[3 * query],
          new_xyz[3 * query + 1], new_xyz[3 * query + 2], radius2, k_nb,
          sel + qi * k_nb, out);
    }
    FSA_PHASE(3);
    // -- the group's tiles into this warp's slots --
    for (int t = 0; t < lv.tiles; ++t) {
      int slot, round;
      slot_of(lv, gl, t, slot, round);
      mbar_wait(&empty[slot], (round & 1) ^ 1);
      FSA_PHASE(4);
      if (!(SA_BWD_SKIP & 1024)) {
        gather_tile(lv, xyz, new_xyz, feats, n, s, f, k_nb, n_queries, q0, t,
                    sel, smem + lv.off_ring + slot * lv.tile_bytes);
      }
      fence_proxy_async();
      mbar_arrive(&full[slot]);
      FSA_PHASE(5);
    }
    __syncwarp();  // the next group's selection overwrites sel
  }
  FSA_PHASES_END;
}

// -- the consumers: the MLP and the max ---------------------------------------

template <int kMaxN, int kMaxA>
__device__ __forceinline__ void products(float (&acc)[kMaxN / 2],
                                         const uint32_t (&a)[kMaxA / 16][4],
                                         bool from_tile, uint32_t a_addr,
                                         uint32_t w_addr, int np, int ksteps) {
  if (SA_BWD_SKIP & 128) return;
#define SA_LAYER(N)                                          \
  if constexpr (N <= kMaxN) {                                \
    if (from_tile) {                                         \
      layer_ss<N, kMaxN>(acc, a_addr, w_addr, ksteps);       \
    } else {                                                 \
      layer_rs<N, kMaxN, kMaxA>(acc, a, w_addr, ksteps);     \
    }                                                        \
  }
  switch (np) {
    case 64:
      SA_LAYER(64);
      break;
    case 128:
      SA_LAYER(128);
      break;
    case 192:
      SA_LAYER(192);
      break;
    default:
      SA_LAYER(256);
      break;
  }
#undef SA_LAYER
}

// The max over this warp's 16 rows (rows 16 wi + g8 and + 8 of the tile;
// each a row k0, k0 + 8 of its query, left out at or past K) of the last
// activations, and the lowest such row that reaches it, for each column,
// to the warp's slot of the partial maxima. A thread holds V = kMaxN / 4
// columns of two rows: first the larger of its two, then a reduce-scatter
// over the 8 lanes of a column group (lane bits 4, 3, 2 in turn, each
// halving the columns a lane keeps), so that each lane ends with V / 8
// columns' maxima after V - V / 8 shuffles of values and half as many of
// row pairs.
template <int kMaxN>
__device__ __forceinline__ void warp_max(const float (&acc)[kMaxN / 2],
                                         int np, bool ok0, bool ok1, int k0,
                                         int g8, int t4, float* part_v,
                                         short* part_k) {
  constexpr int V = kMaxN / 4;
  float v[V];
  int row[V];  // the winning row of the warp's 16, < 16
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = j >> 1;
    const int e = j & 1;
    const float v0 = ok0 ? acc[4 * i + e] : -INFINITY;
    const float v1 = ok1 ? acc[4 * i + 2 + e] : -INFINITY;
    v[j] = v1 > v0 ? v1 : v0;
    row[j] = v1 > v0 ? g8 + 8 : g8;
  }
#pragma unroll
  for (int step = 0; step < 3; ++step) {
    const int h = V >> (step + 1);         // columns kept after this step
    const int lanes = 16 >> step;          // the partner: lane ^ lanes
    const bool upper = (g8 >> (2 - step)) & 1;
#pragma unroll
    for (int j = 0; j < h; j += 2) {
      float keep[2], send[2];
      int keep_r[2], send_r[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        keep[u] = upper ? v[h + j + u] : v[j + u];
        send[u] = upper ? v[j + u] : v[h + j + u];
        keep_r[u] = upper ? row[h + j + u] : row[j + u];
        send_r[u] = upper ? row[j + u] : row[h + j + u];
      }
      const int got_r = __shfl_xor_sync(
          0xffffffffu, send_r[0] | (send_r[1] << 16), lanes);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float o = __shfl_xor_sync(0xffffffffu, send[u], lanes);
        const int o_r = (got_r >> (16 * u)) & 0xffff;
        const bool take = o > keep[u] || (o == keep[u] && o_r < keep_r[u]);
        v[j + u] = take ? o : keep[u];
        row[j + u] = take ? o_r : keep_r[u];
      }
    }
  }
  // this lane's V / 8 columns: j = its g8 bits' halves, then j'
  const int base = ((g8 >> 2) & 1) * (V / 2) + ((g8 >> 1) & 1) * (V / 4) +
                   (g8 & 1) * (V / 8);
#pragma unroll
  for (int jj = 0; jj < V / 8; ++jj) {
    const int j = base + jj;
    const int c = 8 * (j >> 1) + 2 * t4 + (j & 1);
    if (c < np) {  // the slot's columns (np <= kMaxN)
      part_v[c] = v[jj];
      part_k[c] = static_cast<short>(k0 - g8 + row[jj]);
    }
  }
}

// The max over each query's rows of the tile's last activations, and its
// first row, to pooled and winner; a query that spans tiles keeps its
// running max (earlier tiles hold its lower rows) until its last tile.
// The warps' partial maxima go through shared memory.
template <int kMaxN>
__device__ __forceinline__ void pool_tile(
    const Level& lv, const float (&acc)[kMaxN / 2], int k_nb, int n_queries,
    int q0, int t, int wg, float* part_v, short* part_k, float* run_v,
    int* run_k, float* __restrict__ pooled, void* __restrict__ winner,
    int win_bytes) {
  const int lane = threadIdx.x & 31;
  const int wi = (threadIdx.x >> 5) & 3;
  const int tid = threadIdx.x & 127;
  const int g8 = lane >> 2;
  const int npl = lv.np[lv.n_layers - 1];
  const int c_last = lv.c_last;
  const int m0 = 16 * wi + g8;
  const int k0 = lv.tiles == 1 ? m0 % lv.slot : kRows * t + m0;
  warp_max<kMaxN>(acc, npl, k0 < k_nb, k0 + 8 < k_nb, k0, g8, lane & 3,
                  part_v + wi * npl, part_k + wi * npl);
  named_sync(1 + wg, 128);
  const int nw = lv.tiles == 1 ? lv.slot / 16 : 4;  // warps of a query
  const int nq = lv.tiles == 1 ? lv.queries : 1;
  for (int e = tid; e < nq * c_last; e += 128) {
    const int qi = e / c_last;
    const int c = e - qi * c_last;
    const int w0 = qi * nw;
    float v = part_v[w0 * npl + c];
    int k = part_k[w0 * npl + c];
    for (int w = w0 + 1; w < w0 + nw; ++w) {  // later rows win only above
      const float ov = part_v[w * npl + c];
      if (ov > v) {
        v = ov;
        k = part_k[w * npl + c];
      }
    }
    if (lv.tiles > 1) {
      if (t > 0 && !(v > run_v[c])) {
        v = run_v[c];
        k = run_k[c];
      }
      if (t + 1 < lv.tiles) {
        run_v[c] = v;
        run_k[c] = k;
        continue;
      }
    }
    const int query = q0 + qi;
    if (query < n_queries) {
      const size_t at = static_cast<size_t>(query) * c_last + c;
      pooled[at] = v;
      if (winner != nullptr) {
        if (win_bytes == 1) {
          static_cast<uint8_t*>(winner)[at] = static_cast<uint8_t>(k);
        } else {
          static_cast<int*>(winner)[at] = k;
        }
      }
    }
  }
  named_sync(1 + wg, 128);  // the partial maxima may be rewritten
}

// One layer with A from registers, all of its widths known: the bias, the
// products, the epilogue.
template <int N, int K>
__device__ __forceinline__ void layer_fixed(float (&acc)[N / 2],
                                            const uint32_t (&a)[K / 16][4],
                                            const Level& lv, int l,
                                            const float* vecs,
                                            uint32_t w_base, int t4) {
  const float* vec = vecs + lv.v_off[l];
  init_bias<N>(acc, vec, N, t4);
  wgmma::fence();
  if (!(SA_BWD_SKIP & 128)) {
    layer_rs<N, N, K>(acc, a, w_base + lv.w_off[l], K / 16);
  }
  wgmma::commit();
  wgmma::wait_all();
  wgmma::fence_operands(acc);
  epilogue<N, true>(acc, vec, N, N, lv.layer_norm, t4);
}

// A tile through a level of three layers of widths N0, N1, N2, none
// padded (sa1: 64, 64, 128; sa2: 128, 128, 256): straight-line code, each
// layer's accumulators and A registers their own arrays, so that no
// register outlives its use. The tile's slot goes back to its producer
// after layer 0. -> acc2, the last activations.
template <int N0, int N1, int N2>
__device__ __forceinline__ void tile_fixed(const Level& lv,
                                           const float* vecs,
                                           uint32_t w_base, uint32_t a_addr,
                                           uint64_t* empty_slot, int t4,
                                           float (&acc2)[N2 / 2]) {
  uint32_t a1[N0 / 16][4];
  {
    float acc0[N0 / 2];
    const float* vec = vecs + lv.v_off[0];
    init_bias<N0>(acc0, vec, N0, t4);
    wgmma::fence();
    if (!(SA_BWD_SKIP & 128)) {
      layer_ss<N0, N0>(acc0, a_addr, w_base + lv.w_off[0], lv.kp[0] / 16);
    }
    wgmma::commit();
    wgmma::wait_all();
    wgmma::fence_operands(acc0);
    mbar_arrive(empty_slot);  // the tile has been read
    epilogue<N0, true>(acc0, vec, N0, N0, lv.layer_norm, t4);
    to_a<N0, N0>(acc0, a1, N0);
  }
  uint32_t a2[N1 / 16][4];
  {
    float acc1[N1 / 2];
    layer_fixed<N1, N0>(acc1, a1, lv, 1, vecs, w_base, t4);
    to_a<N1, N1>(acc1, a2, N1);
  }
  layer_fixed<N2, N1>(acc2, a2, lv, 2, vecs, w_base, t4);
}

// A tile through any level the kernel takes (widths known at run time,
// at most kMaxN, inputs from registers at most kMaxA): the same steps in a
// loop over the layers. -> acc, the last activations.
template <int kMaxN, int kMaxA>
__device__ __forceinline__ void tile_generic(const Level& lv,
                                             const float* vecs,
                                             uint32_t w_base, uint32_t a_addr,
                                             uint64_t* empty_slot, int t4,
                                             float (&acc)[kMaxN / 2]) {
  uint32_t a[kMaxA / 16][4] = {};
  for (int l = 0; l < lv.n_layers; ++l) {
    const int np = lv.np[l];
    const float* vec = vecs + lv.v_off[l];
    init_bias<kMaxN>(acc, vec, np, t4);
    wgmma::fence();
    products<kMaxN, kMaxA>(acc, a, l == 0, a_addr, w_base + lv.w_off[l], np,
                           lv.kp[l] / 16);
    wgmma::commit();
    wgmma::wait_all();
    wgmma::fence_operands(acc);
    if (l == 0) mbar_arrive(empty_slot);  // the tile has been read
    epilogue<kMaxN>(acc, vec, np, lv.co[l], lv.layer_norm, t4);
    if (l + 1 < lv.n_layers) to_a<kMaxN, kMaxA>(acc, a, np);
  }
}

// Consumer warpgroup wg (0 or 1). kMaxN, kMaxA: tile_generic's widths;
// N0 > 0: tile_fixed's.
template <int kMaxN, int kMaxA, int N0, int N1, int N2>
__device__ __forceinline__ void consumer(
    const Level& lv, int wg, int k_nb, int n_queries, int g_begin,
    int n_local, uint8_t* smem, uint64_t* full, uint64_t* empty,
    uint64_t* wbar, float* __restrict__ pooled, void* __restrict__ winner,
    int win_bytes) {
  const int t4 = threadIdx.x & 3;
  const int npl = lv.np[lv.n_layers - 1];
  const float* vecs = reinterpret_cast<const float*>(smem + lv.off_vec);
  // 4 warps' partial maxima a consumer: floats, then shorts
  float* part_v =
      reinterpret_cast<float*>(smem + lv.off_part) + wg * 4 * npl * 3 / 2;
  short* part_k = reinterpret_cast<short*>(part_v + 4 * npl);
  float* run_v = reinterpret_cast<float*>(smem + lv.off_run) + wg * 2 * npl;
  int* run_k = reinterpret_cast<int*>(run_v + npl);
  const uint32_t w_base = smem_addr(smem);
  const uint32_t ring = smem_addr(smem + lv.off_ring);
  FSA_PHASES_BEGIN(wg == 0 && (threadIdx.x & 127) == 0 ? threadIdx.x : -1);
  mbar_wait(wbar, 0);  // the weights and vectors have landed
  for (int gl = wg; gl < n_local; gl += kConsumers) {
    const int q0 = (g_begin + gl) * lv.queries;
    for (int t = 0; t < lv.tiles; ++t) {
      int slot, round;
      slot_of(lv, gl, t, slot, round);
      mbar_wait(&full[slot], round & 1);
      FSA_PHASE(0);
      const uint32_t a_addr = ring + slot * lv.tile_bytes;
      if constexpr (N0 > 0) {
        float acc[N2 / 2];
        tile_fixed<N0, N1, N2>(lv, vecs, w_base, a_addr, &empty[slot], t4,
                               acc);
        FSA_PHASE(1);
        pool_tile<N2>(lv, acc, k_nb, n_queries, q0, t, wg, part_v, part_k,
                      run_v, run_k, pooled, winner, win_bytes);
      } else {
        float acc[kMaxN / 2];
        tile_generic<kMaxN, kMaxA>(lv, vecs, w_base, a_addr, &empty[slot],
                                   t4, acc);
        FSA_PHASE(1);
        pool_tile<kMaxN>(lv, acc, k_nb, n_queries, q0, t, wg, part_v,
                         part_k, run_v, run_k, pooled, winner, win_bytes);
      }
      FSA_PHASE(2);
    }
  }
  FSA_PHASES_END;
}

template <int kMaxN, int kMaxA, int N0, int N1, int N2, int kP>
__global__ void __launch_bounds__(threads_of(kP), 1)
    fused_sa_fwd_bf16_kernel(const float* __restrict__ xyz,
                             const float* __restrict__ new_xyz,
                             const float* __restrict__ feats, int n, int s,
                             int f, int k_nb, float radius2, int n_queries,
                             int n_groups, Level lv,
                             float* __restrict__ pooled,
                             int* __restrict__ idx_out,
                             void* __restrict__ winner, int win_bytes) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int stages = lv.producers * lv.per_warp;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lv.off_bar);
  uint64_t* empty = full + stages;
  uint64_t* wbar = empty + stages;
  // a contiguous range of groups a block: its clouds stay in L1 for the
  // scans
  const int g_begin = static_cast<int>(
      static_cast<long long>(blockIdx.x) * n_groups / gridDim.x);
  const int g_end = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * n_groups / gridDim.x);

  // the ring zero (the chunks past the real channels are never written),
  // the barriers, then the weights and vectors on their way
  for (int e = threadIdx.x; e < stages * lv.tile_bytes / 16;
       e += blockDim.x) {
    reinterpret_cast<uint4*>(smem + lv.off_ring)[e] = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 32);    // a producer warp's lanes
      mbar_init(&empty[i], 128);  // a consumer warpgroup's threads
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(wbar, lv.image_bytes);
    bulk_copy(smem, lv.image, lv.image_bytes, wbar);
  }
  // the warpgroup's role, warp-uniform as the compiler can see
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role < kP) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    producer(lv, xyz, new_xyz, feats, n, s, f, k_nb, radius2, n_queries,
             g_begin, g_end - g_begin, smem, full, empty, idx_out);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        consumer_regs(kP)));
    consumer<kMaxN, kMaxA, N0, N1, N2>(
        lv, role - kP, k_nb, n_queries, g_begin, g_end - g_begin, smem, full,
        empty, wbar, pooled, winner, win_bytes);
  }
}

// The image the forward copies into shared memory: each layer's weight
// rounded to bf16 (to nearest even), zero-padded to (np, kp), in wgmma's
// K-major core-matrix layout (element (o, i) at ((i / 8) (np / 8) + o / 8)
// 64 + (o % 8) 8 + i % 8), at its w_off; then the vectors, f32, per layer
// the bias, then with LayerNorm the gamma and the beta, each zero-padded to
// np. ops/cuda/fused_sa.py::pack_image is its plain version.
__global__ void __launch_bounds__(256)
    fused_sa_pack_bf16_kernel(Level lv, Sources src, uint8_t* image) {
  const int stride = gridDim.x * blockDim.x;
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x;
  for (int l = 0; l < lv.n_layers; ++l) {
    const int np = lv.np[l];
    const int co = lv.co[l];
    const int ci = src.ci[l];
    const float* w = src.w[l];
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(image + lv.w_off[l]);
    for (int e = t0; e < lv.kp[l] * np; e += stride) {
      const int cm = e >> 6;  // the core matrix
      const int o = cm % (np >> 3) * 8 + ((e >> 3) & 7);
      const int i = cm / (np >> 3) * 8 + (e & 7);
      out[e] = __float2bfloat16_rn(o < co && i < ci ? w[o * ci + i] : 0.f);
    }
    float* vec = reinterpret_cast<float*>(image + lv.off_vec) + lv.v_off[l];
    for (int e = t0; e < np * (lv.layer_norm ? 3 : 1); e += stride) {
      const int k = e / np;
      const int c = e - k * np;
      vec[e] = c < co ? src.vec[l][k][c] : 0.f;
    }
  }
}

int launch_pack(const Level& lv, const Sources& src, void* image,
                cudaStream_t stream) {
  int most = 0;
  for (int l = 0; l < lv.n_layers; ++l) {
    most = std::max(most, lv.kp[l] * lv.np[l]);
  }
  const int blocks = std::min(64, (most + 255) / 256);
  fused_sa_pack_bf16_kernel<<<blocks, 256, 0, stream>>>(
      lv, src, static_cast<uint8_t*>(image));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The image of a level (see fused_sa_pack_bf16_kernel) into `image`
// (image_bytes bytes, 16-byte aligned, as fused_sa_forward_bf16 needs):
// layer_ptrs[4l .. 4l+3] = (w (co, ci), bias, gamma, beta) f32 contiguous,
// gamma and beta null without layer_norm; chans as fused_sa_forward_bf16's.
// Returns a cudaError_t as int (0 = launched).
extern "C" int fused_sa_pack_bf16(int n_layers, const int* chans,
                                  const void* const* layer_ptrs,
                                  int layer_norm, void* image,
                                  long long image_bytes, void* stream) {
  Level lv{};
  Sources src{};
  if (!image_layout(n_layers, chans, layer_norm, lv, &src, layer_ptrs) ||
      image_bytes != lv.image_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_pack(lv, src, image, static_cast<cudaStream_t>(stream));
}

// xyz (b, n, 3), new_xyz (b, s, 3), feats (b, n, f) or null when f == 0,
// all f32 contiguous. chans[l], chans[l + 1]: layer l's input and output
// widths (chans[0] == 3 + f; every output a multiple of 4 and at most 256).
// layer_ptrs as fused_sa_pack_bf16's; `image` (image_bytes bytes of device
// memory, 16-byte aligned) receives the level's image, which this call
// packs (fused_sa_pack_bf16_kernel) before the forward kernel reads it.
// Writes pooled (b, s, chans[n_layers]) f32, idx (b, s, k_nb) int32 and,
// unless winner is null, winner (b, s, chans[n_layers]) of win_bytes 1
// (uint8; k_nb <= 256) or 4 (int32). Returns a cudaError_t as int (0 =
// launched; cudaErrorInvalidValue for a shape it does not take: a width
// past 256, or weights that leave no room for a tile in shared memory).
extern "C" int fused_sa_forward_bf16(const float* xyz, const float* new_xyz,
                                     const float* feats, int b, int n, int s,
                                     int f, int k_nb, float radius2,
                                     int n_layers, const int* chans,
                                     const void* const* layer_ptrs,
                                     int layer_norm, void* image,
                                     long long image_bytes, float* pooled,
                                     int* idx, void* winner, int win_bytes,
                                     void* stream) {
  Level lv{};
  Sources src{};
  if (b <= 0 || n <= 0 || s <= 0 || k_nb <= 0 || k_nb > 32767 ||
      chans[0] != 3 + f ||
      (winner != nullptr && win_bytes != 4 &&
       !(win_bytes == 1 && k_nb <= 256)) ||
      !image_layout(n_layers, chans, layer_norm, lv, &src, layer_ptrs) ||
      image_bytes != lv.image_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lv.image = static_cast<const uint8_t*>(image);
  lv.vec4 = f >= 8 && f % 4 == 0 &&
            reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  size_t off = pad_to(lv.image_bytes, 128);
  const int npl = lv.np[n_layers - 1];
  if (k_nb <= 64) {
    lv.slot = k_nb <= 16 ? 16 : k_nb <= 32 ? 32 : 64;
    lv.queries = kRows / lv.slot;
    lv.tiles = 1;
  } else {
    lv.slot = kRows;
    lv.queries = 1;
    lv.tiles = (k_nb + kRows - 1) / kRows;
  }
  lv.tile_bytes = kRows * lv.kp[0] * 2;
  lv.sel_ints = std::max(kRows, k_nb);
  // the partial maxima (4 warps' floats and shorts a consumer), the running
  // maxima of a query that spans tiles, the producers' selections, the
  // barriers
  lv.off_part = static_cast<int>(off);
  off += pad_to(2 * 4 * npl * 6, 128);
  lv.off_run = static_cast<int>(off);
  if (lv.tiles > 1) off += pad_to(2 * 2 * npl * 4, 128);
  // sa1's and sa2's widths as straight-line code (sa1 with two producer
  // warpgroups: its scans take longer than its products), any other level
  // in the loop over its layers
  auto widths = [&](int n0, int n1, int n2) {
    return n_layers == 3 && lv.np[0] == n0 && lv.np[1] == n1 &&
           lv.np[2] == n2 && lv.co[0] == n0 && lv.co[1] == n1 &&
           lv.co[2] == n2;
  };
  const int variant = widths(64, 64, 128) ? 0 : widths(128, 128, 256) ? 1 : 2;
  const int n_p = variant == 0 ? 2 : 1;  // producer warpgroups
  lv.off_sel = static_cast<int>(off);
  off += pad_to(4 * n_p * lv.sel_ints * 4, 128);
  const size_t fixed = off + pad_to((2 * kMaxStages + 1) * 8, 128);
  if (fixed + lv.tile_bytes > kSmemPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int stages = static_cast<int>(std::min<size_t>(
      kMaxStages, (kSmemPerBlock - fixed) / lv.tile_bytes));
  lv.producers = std::min(4 * n_p, stages);
  lv.per_warp = stages / lv.producers;
  stages = lv.producers * lv.per_warp;
  lv.off_ring = static_cast<int>(off);
  off += static_cast<size_t>(stages) * lv.tile_bytes;
  lv.off_bar = static_cast<int>(off);
  off += (2 * stages + 1) * 8;
  const size_t smem = off;

  auto kernel =
      variant == 0   ? fused_sa_fwd_bf16_kernel<128, 64, 64, 64, 128, 2>
      : variant == 1 ? fused_sa_fwd_bf16_kernel<256, 128, 128, 128, 256, 1>
                     : fused_sa_fwd_bf16_kernel<kWidest, kWidest, 0, 0, 0, 1>;
  const int threads = threads_of(n_p);
  // per device and variant, once: the SM count; the register check (the
  // consumers' setmaxnreg.inc takes what the producers' .dec frees, so the
  // kernel must hold all the block's registers from its launch); and no
  // more shared memory than the block needs, the rest left to L1, which
  // holds the clouds the scans read (set again when it changes)
  constexpr int kDevices = 16;
  struct Setting {
    int n_sm = 0;
    size_t smem = 0;
  };
  static Setting settings[kDevices][3];
  Setting scratch;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Setting& set = device < kDevices ? settings[device][variant] : scratch;
  if (set.n_sm == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs * threads <
        128 * n_p * kProducerRegs + 128 * kConsumers * consumer_regs(n_p)) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    err = cudaDeviceGetAttribute(&set.n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (set.smem != smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          static_cast<int>((smem * 100 + kSmemPerBlock - 1) / kSmemPerBlock));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    set.smem = smem;
  }
  const int n_sm = set.n_sm;
  const int n_queries = b * s;
  const int n_groups = (n_queries + lv.queries - 1) / lv.queries;
  const int grid = std::max(1, std::min(n_groups, n_sm));
  const int packed =
      launch_pack(lv, src, image, static_cast<cudaStream_t>(stream));
  if (packed != 0) return packed;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, feats, n, s, f, k_nb, radius2, n_queries, n_groups, lv,
      pooled, idx, winner, win_bytes);
  return static_cast<int>(cudaGetLastError());
}

#ifdef FSA_PHASES
// The phase counters (kPhases of them) to host memory, then zeroed.
extern "C" int fsa_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                         sizeof(g_phase_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kPhases] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
}
#endif
