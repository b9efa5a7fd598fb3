// Fused PointNet++ set-abstraction level, backward, bf16 mode, for Hopper
// (sm_90a): the first of two kernels (K1) of the backward bf16 models train
// with. The second, sa_weight_grad.cu's bf16 mode (K2), forms the weight
// gradients from the rows this one writes.
//
// Together they replace the backward Pallas kernel of
// maskplanner_tpu/ops/pallas/fused_sa_train.py (`_fsa_train_bwd_raw`, body
// `_bwd_kernel`) at precision="default". For every query (an FPS centroid)
// K1 re-gathers its K neighbours [x - q ; f] from the indices the forward
// saved, recomputes every layer (Dense, LayerNorm with eps 1e-6 or no norm,
// ReLU), routes d_pooled[c] to the forward's winner of (query, channel)
// where the forward's pooled[c] > 0 (fused_sa_fwd_bf16.cu writes the
// winner: the first neighbour whose last activation is the max), and
// backpropagates through ReLU, LayerNorm and the Dense layers. The rounding
// points are the JAX kernel's: the gathered rows are rounded to bf16; the
// recompute's products take bf16 x bf16 operands summed in f32 from the
// bias; the LayerNorm, forward and backward, runs in f32; the input
// gradient is bf16(d_pre) . bf16(W) summed in f32 and stored through the
// previous activation's ReLU mask; db, dgamma and dbeta are f32 sums of
// unrounded values; the rows scattered to the source points (f32 atomics)
// are rounded to bf16 first, and d_new_xyz sums the unrounded rows. Per
// layer it writes, for every neighbour row, d_pre and the layer's input as
// bf16 scratch rows in pairs (element (r, c) of a (R', w) block at
// (r / 2) 2 w + 2 c + r % 2: a 32-bit word holds K2's fragment), and per
// query the sums over the query's rows of d_pre (db) and, with LayerNorm,
// of d_act xhat (dgamma) and d_act (dbeta). Only the order of the f32 sums
// differs from the plain version (ops/fused_sa.py::fused_sa_backward_plain
// with precision="bf16" and winner=).
//
// What bounds it on this card: the products of the recompute and of the
// input gradient, 0.35 ms at 989 TFLOP/s for sa1 + sa2 at the flagship
// batch of 64; with the bf16 scratch rows it writes for K2 (1.75 GB a
// step at 3.35 TB/s), 0.60 ms.
//
// What the design does about it (the shape of fused_sa_fwd_bf16.cu, whose
// device code it shares: fused_sa_bf16.cuh):
// - Resident weights, one copy read both ways: one persistent block an SM
//   copies the level's image (the bf16 forward's, packed once by its own
//   call: every layer's weight in wgmma's K-major core-matrix layout, then
//   the biases, gammas and betas; sa2 138 KB, sa1 26 KB) into shared memory
//   with one cp.async.bulk. The recompute reads W as the K-major B operand
//   (layer (o, i): 8 rows of o, each 8 consecutive i, a core matrix); the
//   input gradient d_pre . W reads the same bytes as an MN-major B operand
//   (wgmma's transpose of B: K' = o, N' = i, a core matrix 8 k-rows of 8
//   consecutive n), 128 bytes between the core matrices along K' and np x
//   16 along N'. No second copy: both would not fit at sa2.
// - A producer warpgroup (setmaxnreg.dec) whose warps take groups of
//   queries in turn: each loads its queries' indices, gathers [x - q ; f]
//   as bf16 rows into a 64-row tile of a ring in the layout wgmma reads A
//   from (fused_sa_bf16.cuh::gather_tile, the forward's), beside it the
//   queries' routing data (d_pooled where pooled > 0, the winner) and the
//   rows' source points, and writes layer 0's input scratch rows from the
//   tile (a lane a row pair, 32-byte stores). Full and empty mbarriers
//   hand the slots over. A tile holds 2 queries of K 32 at sa1 and 1 of K
//   64 at sa2; above K 64 a query spans several tiles; pad rows repeat the
//   first neighbour and get no gradient. The consumers hand each tile's
//   layer-0 input gradient back in its slot, rounded to bf16, and the
//   producer adds it to the source points before it refills the slot (f32
//   atomics, the features in 16-byte vectors): the L2's atomics, about 67
//   million adds at sa2, stay off the consumers' path.
// - Two consumer warpgroups (setmaxnreg.inc), each on its own tile. The
//   forward: layer 0 is wgmma from the tile, later layers take A from
//   registers, the LayerNorm and ReLU on the accumulators (the forward's
//   device code, so the activations are the forward's bits); each layer's
//   bf16 activations are the next layer's A registers and the next layer's
//   input scratch rows. The last layer's accumulators stay, centred, for
//   its backward. The backward, last layer first: the routed gradient, the
//   LayerNorm backward in registers (its two row means quad shuffles), the
//   column sums (a reduce-scatter of shuffles over the 8 lanes of a column,
//   then the query's warps through shared memory in a fixed order: no
//   atomic, so vec and K2's dW are the same bits from launch to launch),
//   d_pre rounded to bf16 in the A-fragment layout (the accumulator
//   layout), which is both the input gradient's A operand and, after two
//   shuffle exchanges, the scratch rows as 16-byte streaming stores
//   (st.global.cs: the 0.9 GB a step at sa2 would otherwise push the
//   scatter's lines out of L2), issued while the input gradient's wgmma
//   runs on the resident weight (the layers' input rows likewise during the
//   forward's products). The last layer's d_act has one term a column, so
//   its dgamma and dbeta are stored by the thread that holds the winner's
//   row, and only its db is reduced. A layer below the last recomputes its
//   h from its input (the bf16 activations kept in registers, or the tile
//   for layer 0) with its saved row mean and inverse std. sa2 cannot hold
//   f32 h of every layer (64 rows x 512 channels a tile): a consumer
//   thread keeps the last layer's centred accumulators (128 floats at
//   sa2), layer 0's activations as bf16 A registers (32) and the rows'
//   statistics (10), about 200 registers at its peak of 232; shared memory
//   holds the image, a ring of 4 slots of 19.8 KB (8 of 3.8 KB at sa1) and
//   3 KB a consumer for the column sums. (A third consumer warpgroup at
//   sa1, at 152 registers, was no faster.)
// Widths: sa1's and sa2's levels (LayerNorm, one tile a query group) run
// as straight-line code, each layer's registers its own; any other level
// (no norm, other K, any width up to 256 a multiple of 4) runs a loop over
// its layers that recomputes each layer from the tile, slower (it
// spills).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "fused_sa_bf16.cuh"
#include "fused_sa_common.cuh"
#include "wgmma_bf16.cuh"

// Timing studies only (bench_sa_backward.py --dtype bf16), each bit of
// SA_BWD_SKIP leaving out a part, the result then wrong; 0 in every real
// build: 1 the recompute's wgmma (forward and backward), 2 the scratch rows
// (the consumers' and the producer's), 4 the input gradient's wgmma, 8 the
// LayerNorm backward's arithmetic (d_pre = d_act), 16 the column sums, 32
// the scatter's atomics, 256 the register LayerNorm forward (ReLU alone),
// 1024 the producer's gather (the tiles keep what they held).
// SA_BWD_PHASES: clock cycles of each phase, summed over the blocks by one
// thread of the first consumer warpgroup and one of the first producer
// warp (kPhases counters, read by sa_bwd_phase_cycles).

namespace {

using namespace fsa_bf16;

constexpr int kConsumers = 2;
// a producer warpgroup, then the consumers
constexpr int kThreads = 128 * (1 + kConsumers);
// Registers a thread after setmaxnreg: the producer gives up what the
// consumers take, all the block holds from its launch (128 x 40 + 256 x
// 232 = 384 x 168).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxStages = 8;  // tiles in the ring, at most
constexpr int kNeedXyz = 1;
constexpr int kNeedNewXyz = 2;
constexpr int kNeedFeats = 4;
// the column sums go through shared memory 64 columns at a time: 4 warps x
// 3 sums x 64 floats a consumer
constexpr int kPartFloats = 4 * 3 * 64;
// the input gradient's B, MN-major: bytes between core matrices along K'
// (the layer's outputs); along N' (its inputs) np x 16
constexpr uint32_t kTransLbo = 128;

#ifdef SA_BWD_PHASES
constexpr int kPhases = 12;
__device__ unsigned long long g_phase_cycles[kPhases];
#endif

// The phase clock of one thread (timing studies, SA_BWD_PHASES): mark(i)
// adds the cycles since the last mark to counter i. Nothing otherwise.
struct Clock {
#ifdef SA_BWD_PHASES
  bool on;
  long long t;
  __device__ __forceinline__ explicit Clock(bool timed) : on(timed) {
    t = clock64();
  }
  __device__ __forceinline__ void mark(int i) {
    if (on) {
      const long long now = clock64();
      atomicAdd(g_phase_cycles + i, static_cast<unsigned long long>(now - t));
      t = now;
    }
  }
#else
  __device__ __forceinline__ explicit Clock(bool) {}
  __device__ __forceinline__ void mark(int) {}
#endif
};

struct Plan {
  Level lv;  // the image, the tiles and the ring (fused_sa_bf16.cuh)
  __nv_bfloat16* d16[kMaxLayers];   // scratch: a layer's d_pre rows
  __nv_bfloat16* in16[kMaxLayers];  // scratch: its input's rows
  int ci_pad[kMaxLayers];           // the input rows' width: ci up to 4
  int vec_off[kMaxLayers];          // a layer's db in a query's vec slot
  int n_vec;       // floats of a query's vec slot
  int k_nb;        // K
  int need;        // kNeedXyz | kNeedNewXyz | kNeedFeats
  int rows_fast;   // a tile's real rows are consecutive scratch rows from
                   // an even one (K is 16, 32 or 64, or a multiple of 64)
  int win_bytes;   // the forward's winner: 1 (uint8) or 4 (int32)
  int feats_v4;    // d_feats takes 16-byte vector atomics (f % 4 == 0)
  int handoff;     // the consumers leave layer 0's input gradient, rounded
                   // to bf16, in the tile's slot, and the producer adds it
                   // to d_xyz and d_feats (asked for either)
  int slot_bytes;  // a slot of the ring: the tile, then its side data
  int side_gdp;    // bytes into a slot: d_pooled where pooled > 0 (f32)
  int side_win;    // the winner (uint16)
  int side_pts;    // the rows' source points b n + j, -1 where not real
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  return __byte_perm(a, b, sel);
}

// A scratch row's 16 bytes, stored streaming (st.global.cs: evict first),
// so that the rows K2 reads later do not push the gradients the scatter's
// atomics add to out of L2.
__device__ __forceinline__ void store_stream(void* p, uint4 v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
}

// Four consecutive floats added atomically, 16-byte aligned.
__device__ __forceinline__ void red_add_v4(float* p, float a, float b,
                                           float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// -- the producer ---------------------------------------------------------

// Layer 0's input scratch rows from the gathered tile (bf16 already): with
// rows_fast a lane a row pair (rows 2p, 2p + 1, read as 32 bytes of one
// core matrix), 8 channels at a time interleaved into two 16-byte stores;
// else element by element, each real row to its own place.
__device__ __forceinline__ void input_rows(const Plan& p, const uint8_t* tile,
                                           const int* pts, size_t row_base,
                                           int q0, int t) {
  const Level& lv = p.lv;
  const int lane = threadIdx.x & 31;
  const int w = p.ci_pad[0];
  __nv_bfloat16* dst = p.in16[0];
  const int chunks = (w + 7) >> 3;
  if (p.rows_fast) {
    if (pts[2 * lane] < 0) return;
    __nv_bfloat16* out = dst + (row_base / 2 + lane) * 2 * w;
    const uint8_t* src = tile + (2 * lane / 8) * 128 + (2 * lane % 8) * 16;
    for (int kc = 0; kc < chunks; ++kc) {
      const uint4 lo = *reinterpret_cast<const uint4*>(src + kc * 8 * 128);
      const uint4 hi =
          *reinterpret_cast<const uint4*>(src + kc * 8 * 128 + 16);
      const int c = 8 * kc;
      if (c + 4 <= w) {
        store_stream(out + 2 * c,
                     make_uint4(prmt(lo.x, hi.x, 0x5410),
                                prmt(lo.x, hi.x, 0x7632),
                                prmt(lo.y, hi.y, 0x5410),
                                prmt(lo.y, hi.y, 0x7632)));
      }
      if (c + 8 <= w) {
        store_stream(out + 2 * c + 8,
                     make_uint4(prmt(lo.z, hi.z, 0x5410),
                                prmt(lo.z, hi.z, 0x7632),
                                prmt(lo.w, hi.w, 0x5410),
                                prmt(lo.w, hi.w, 0x7632)));
      }
    }
    return;
  }
  const __nv_bfloat16* tb = reinterpret_cast<const __nv_bfloat16*>(tile);
  for (int m = lane; m < kRows; m += 32) {
    if (pts[m] < 0) continue;
    const size_t r =
        lv.tiles == 1
            ? static_cast<size_t>(q0 + m / lv.slot) * p.k_nb + m % lv.slot
            : static_cast<size_t>(q0) * p.k_nb + kRows * t + m;
    __nv_bfloat16* out = dst + (r >> 1) * 2 * w + (r & 1);
    for (int c = 0; c < w; ++c) {
      out[2 * c] = tb[((c >> 3) * 8 + (m >> 3)) * 64 + (m & 7) * 8 + (c & 7)];
    }
  }
}

// The rows a consumer left in a slot (handoff): layer 0's input gradient,
// rounded to bf16, in the tile's layout, added to the source points by one
// warp, a row a lane: d_xyz, then the features in 16-byte quads (feature 4q
// in channel 4q + 3: each 8-channel chunk closes the quad the chunk before
// opened) or, unaligned, one by one.
__device__ __forceinline__ void scatter_slot(const Plan& p,
                                             const uint8_t* tile,
                                             const int* pts, int f,
                                             float* __restrict__ d_xyz,
                                             float* __restrict__ d_feats) {
  if (SA_BWD_SKIP & 32) return;
  const int lane = threadIdx.x & 31;
  const int cin = p.lv.cin;
  for (int m = lane; m < kRows; m += 32) {
    const int pt = pts[m];
    if (pt < 0) continue;
    const uint8_t* src = tile + (m >> 3) * 128 + (m & 7) * 16;
    float* row = d_feats + static_cast<size_t>(pt) * f;
    float prev = 0.f;
    for (int kc = 0; 8 * kc < cin; ++kc) {
      const uint4 w = *reinterpret_cast<const uint4*>(src + kc * 8 * 128);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      float v[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[2 * u] = __uint_as_float(words[u] << 16);
        v[2 * u + 1] = __uint_as_float(words[u] & 0xffff0000u);
      }
      if (kc == 0 && (p.need & kNeedXyz)) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          atomicAdd(d_xyz + static_cast<size_t>(pt) * 3 + c, v[c]);
        }
      }
      if (!(p.need & kNeedFeats)) continue;
      if (p.feats_v4) {
        if (kc > 0 && 8 * kc - 4 < f) {
          red_add_v4(row + 8 * kc - 4, prev, v[0], v[1], v[2]);
        }
        if (8 * kc < f) red_add_v4(row + 8 * kc, v[3], v[4], v[5], v[6]);
        prev = v[7];
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int c = 8 * kc + u;
          if (c >= 3 && c < cin) atomicAdd(row + (c - 3), v[u]);
        }
      }
    }
  }
}

__device__ __forceinline__ void producer(
    const Plan& p, const float* __restrict__ xyz,
    const float* __restrict__ new_xyz, const float* __restrict__ feats,
    const int* __restrict__ idx, const float* __restrict__ pooled,
    const float* __restrict__ d_pooled, const void* __restrict__ winner,
    int n, int s, int f, int n_queries, int g_begin, int n_local,
    uint8_t* smem, uint64_t* full, uint64_t* empty,
    float* __restrict__ d_xyz, float* __restrict__ d_feats) {
  const Level& lv = p.lv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= lv.producers) return;
  const int K = p.k_nb;
  const int npl = lv.np[lv.n_layers - 1];
  const int C = lv.c_last;
  const int nq = lv.tiles == 1 ? lv.queries : 1;  // queries a tile
  int* sel = reinterpret_cast<int*>(smem + lv.off_sel) + warp * lv.sel_ints;
  Clock clk(threadIdx.x == 0);
  for (int gl = warp; gl < n_local; gl += lv.producers) {
    const int q0 = (g_begin + gl) * lv.queries;
    for (int qi = 0; qi < lv.queries && q0 + qi < n_queries; ++qi) {
      const int* src = idx + static_cast<size_t>(q0 + qi) * K;
      for (int k = lane; k < K; k += 32) sel[qi * K + k] = src[k];
    }
    __syncwarp();
    clk.mark(8);
    for (int t = 0; t < lv.tiles; ++t) {
      int slot, round;
      slot_of(lv, gl, t, slot, round);
      mbar_wait(&empty[slot], (round & 1) ^ 1);
      clk.mark(9);
      uint8_t* tile = smem + lv.off_ring + slot * p.slot_bytes;
      int* pts = reinterpret_cast<int*>(tile + p.side_pts);
      if (p.handoff && round > 0) {  // the slot's last tile's gradient
        scatter_slot(p, tile, pts, f, d_xyz, d_feats);
        __syncwarp();  // the gather below overwrites it
        clk.mark(3);
      }
      if (!(SA_BWD_SKIP & 1024)) {
        gather_tile(lv, xyz, new_xyz, feats, n, s, f, K, n_queries, q0, t,
                    sel, tile);
      }
      clk.mark(10);
      float* gdp = reinterpret_cast<float*>(tile + p.side_gdp);
      uint16_t* win = reinterpret_cast<uint16_t*>(tile + p.side_win);
      for (int e = lane; e < nq * npl; e += 32) {
        const int qi = e / npl;
        const int c = e - qi * npl;
        const int query = q0 + qi;
        float g = 0.f;
        int wk = 0;
        if (query < n_queries && c < C) {
          const size_t at = static_cast<size_t>(query) * C + c;
          if (pooled[at] > 0.f) g = d_pooled[at];
          wk = p.win_bytes == 1 ? static_cast<const uint8_t*>(winner)[at]
                                : static_cast<const int*>(winner)[at];
        }
        gdp[e] = g;
        win[e] = static_cast<uint16_t>(wk);
      }
      for (int m = lane; m < kRows; m += 32) {
        const int qi = lv.tiles == 1 ? m / lv.slot : 0;
        const int k = lv.tiles == 1 ? m % lv.slot : kRows * t + m;
        const int query = q0 + qi;
        pts[m] = query < n_queries && k < K
                     ? (query / s) * n + sel[qi * K + k]
                     : -1;
      }
      __syncwarp();
      if (!(SA_BWD_SKIP & 2)) {
        const size_t row_base = static_cast<size_t>(q0) * K +
                                (lv.tiles == 1 ? 0 : kRows * t);
        input_rows(p, tile, pts, row_base, q0, t);
      }
      fence_proxy_async();
      mbar_arrive(&full[slot]);
      clk.mark(11);
    }
    __syncwarp();  // the next group's indices overwrite sel
  }
  if (!p.handoff) return;
  // each of this warp's slots holds its last tile's gradient once the
  // consumer releases it
  int fills = 0;
  for (int gl = warp; gl < n_local; gl += lv.producers) fills += lv.tiles;
  for (int sl = 0; sl < lv.per_warp && sl < fills; ++sl) {
    const int slot = warp * lv.per_warp + sl;
    const int rounds = (fills - sl + lv.per_warp - 1) / lv.per_warp;
    mbar_wait(&empty[slot], (rounds - 1) & 1);
    uint8_t* tile = smem + lv.off_ring + slot * p.slot_bytes;
    scatter_slot(p, tile, reinterpret_cast<const int*>(tile + p.side_pts), f,
                 d_xyz, d_feats);
  }
}

// -- the consumers --------------------------------------------------------

// What a consumer thread knows of the tile it works on: its warp's 16 rows
// belong to one query.
struct Tile {
  const float* gdp;      // the warp's query's routing data (npl columns)
  const uint16_t* win;
  int query;             // the warp's query
  bool live;             // query < n_queries
  int k0;                // neighbour index of the thread's row g (g + 8: +8)
  int pt[2];             // its rows' source points, -1 where not real
  size_t pair0;          // rows_fast: the scratch pair of the warp's row 0
  int qi;                // the warp's query in the tile
  int nw;                // the query's warps in the tile
  int nq;                // queries in the tile
  int q0;                // the tile's first query
  int t;                 // the tile of its query group
};

// Scratch rows from bf16 A registers (k-step j's: a[j][0], a[j][2] row g's
// columns 16j + 2 t4 (+1) and 16j + 8 + 2 t4 (+1), a[j][1], a[j][3] row
// g + 8's): width real columns, in row pairs. rows_fast: the rows pair up
// across lanes g, g ^ 1 (one shuffle), the pair's words interleave (byte
// permutes) and four columns gather across lanes t4, t4 ^ 1 (two shuffles),
// then one 16-byte store a lane a k-step; else element by element.
template <int NK>
__device__ __forceinline__ void store_rows(const Plan& p, const Tile& tl,
                                           const uint32_t (&a)[NK][4],
                                           int width,
                                           __nv_bfloat16* __restrict__ dst) {
  if (SA_BWD_SKIP & 2) return;
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  if (!p.rows_fast) {
    const int wi = (threadIdx.x >> 5) & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (tl.pt[r] < 0) continue;
      const int m = 16 * wi + g8 + 8 * r;
      const size_t row =
          p.lv.tiles == 1
              ? static_cast<size_t>(tl.q0 + m / p.lv.slot) * p.k_nb +
                    m % p.lv.slot
              : static_cast<size_t>(tl.q0) * p.k_nb + kRows * tl.t + m;
      __nv_bfloat16* out = dst + (row >> 1) * 2 * width + (row & 1);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 16 * j + 8 * h + 2 * t4;
          const uint32_t word = a[j][2 * h + r];
          if (c < width) {
            out[2 * c] = __ushort_as_bfloat16(word & 0xffffu);
            out[2 * c + 2] = __ushort_as_bfloat16(word >> 16);
          }
        }
      }
    }
    return;
  }
  // every lane shuffles (no lane leaves early: the shuffles stay plain),
  // a live warp stores
  const bool even = (g8 & 1) == 0;
  const bool te = (t4 & 1) == 0;
  const size_t pair = tl.pair0 + (even ? g8 / 2 : (g8 + 7) / 2);
  __nv_bfloat16* out = dst + pair * 2 * width;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    if (16 * j < width) {
      // the rows in pairs: an even g keeps row g and takes row g + 1, an
      // odd g keeps row g + 8 and takes row g + 7
      const uint32_t r0 =
          __shfl_xor_sync(0xffffffffu, even ? a[j][1] : a[j][0], 4);
      const uint32_t r2 =
          __shfl_xor_sync(0xffffffffu, even ? a[j][3] : a[j][2], 4);
      const uint32_t lo0 = even ? a[j][0] : r0;
      const uint32_t hi0 = even ? r0 : a[j][1];
      const uint32_t lo1 = even ? a[j][2] : r2;
      const uint32_t hi1 = even ? r2 : a[j][3];
      // one column's two rows a word
      const uint32_t w00 = prmt(lo0, hi0, 0x5410);
      const uint32_t w01 = prmt(lo0, hi0, 0x7632);
      const uint32_t w10 = prmt(lo1, hi1, 0x5410);
      const uint32_t w11 = prmt(lo1, hi1, 0x7632);
      // four columns a lane: an even t4 takes its neighbour's first two
      // words, an odd t4 its neighbour's last two
      const uint32_t y0 = __shfl_xor_sync(0xffffffffu, te ? w10 : w00, 1);
      const uint32_t y1 = __shfl_xor_sync(0xffffffffu, te ? w11 : w01, 1);
      const int c = te ? 16 * j + 2 * t4 : 16 * j + 8 + 2 * (t4 - 1);
      if (tl.live && c < width) {
        store_stream(out + 2 * c, te ? make_uint4(w00, w01, y0, y1)
                                     : make_uint4(y0, y1, w10, w11));
      }
    }
  }
}

// The sums over the thread's two rows v[s][j] (j = 2ii + e for the columns
// 8ii + 2 t4 + e of a 32-column block) over the 8 lanes that share t4: a
// reduce-scatter (lane bits 4, 3, 2 in turn, each halving the columns a
// lane keeps), after which v[s][0] holds column j = g8's sum of the warp,
// for the first S of the three sums.
template <int S>
__device__ __forceinline__ void reduce_scatter(float (&v)[3][8], int g8) {
#pragma unroll
  for (int step = 0; step < 3; ++step) {
    const int h = 4 >> step;         // values kept after this step
    const int lanes = 16 >> step;    // the partner: lane ^ lanes
    const bool upper = (g8 >> (2 - step)) & 1;
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int j = 0; j < h; ++j) {
        const float keep = upper ? v[s][h + j] : v[s][j];
        const float send = upper ? v[s][j] : v[s][h + j];
        v[s][j] = keep + __shfl_xor_sync(0xffffffffu, send, lanes);
      }
    }
  }
}

// The query totals of a 64-column round of column sums: the warps' partial
// sums (part[(warp 3 + s) 64 + c]) added over the query's warps in order,
// to vec (a query that spans tiles adds each tile's to the sum its earlier
// tiles left there: the same thread, in tile order). s < S: db, dgamma,
// dbeta.
__device__ __forceinline__ void sums_out(const Plan& p, const Tile& tl,
                                         int S, int col0, int co,
                                         int vec_off, const float* part,
                                         int n_queries,
                                         float* __restrict__ vec_out) {
  const int tid = threadIdx.x & 127;
  for (int e = tid; e < tl.nq * S * 64; e += 128) {
    const int qi = e / (S * 64);
    const int s = (e / 64) % S;
    const int c = e % 64;
    const int col = col0 + c;
    const int query = tl.q0 + qi;
    if (col >= co || query >= n_queries) continue;
    const int nw = tl.nw;
    float total = part[(qi * nw * 3 + s) * 64 + c];
    for (int w = 1; w < nw; ++w) {
      total += part[((qi * nw + w) * 3 + s) * 64 + c];
    }
    float* out = vec_out + static_cast<size_t>(query) * p.n_vec + vec_off +
                 s * co + col;
    if (tl.t > 0) total = *out + total;
    *out = total;
  }
}

// One layer's backward on the accumulators: acc holds its centred h (with
// LayerNorm: h - mu, inv the rows' inverse std; else h), din the input
// gradient of the layer above (`last`: none, the routed d_pooled instead),
// which the layer's ReLU masks here (its activation formed as the forward
// forms it). Then the LayerNorm backward in registers, d_pre = inv
// (dx - mean(dx) - xhat mean(dx xhat)), dx = d_act gamma (rows' means over
// the co real columns: the quad's lanes), into acc; and the query's column
// sums of d_pre (db) and, with LayerNorm, d_act xhat (dgamma) and d_act
// (dbeta), 64 columns a round. The last layer's d_act has one term a column
// (the winner's row), so its dgamma and dbeta are that row's, stored by the
// thread that holds it. Every consumer thread calls it.
template <int kMaxN, bool kFull>
__device__ __forceinline__ void layer_backward(
    const Plan& p, const Tile& tl, float (&acc)[kMaxN / 2],
    float (&din)[kMaxN / 2], const float* vec, int l, bool last,
    const float (&inv)[2], float* part, int n_queries,
    float* __restrict__ vec_out, int wg) {
  const Level& lv = p.lv;
  int np = lv.np[l];
  int co = lv.co[l];
  if constexpr (kFull) np = co = kMaxN;
  const bool ln = kFull || lv.layer_norm;  // the fixed levels have it
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int wi = (threadIdx.x >> 5) & 3;
  const float* gamma = vec + np;
  const float* beta = vec + 2 * np;
  constexpr int kChunks = kMaxN / kChunkN;
  // the gradient reaching the activation of (row r, column c)
  auto route = [&](int c, float2& g, uint32_t& w) {
    g = *reinterpret_cast<const float2*>(tl.gdp + c);
    w = *reinterpret_cast<const uint32_t*>(tl.win + c);
  };
  // -- the ReLU's mask, and the rows' means of dx and dx xhat --
  float m1[2] = {0.f, 0.f};
  float m2[2] = {0.f, 0.f};
  if (ln && !(SA_BWD_SKIP & 8)) {
    float s1[2][kChunks], s2[2][kChunks];
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      s1[0][ch] = s1[1][ch] = s2[0][ch] = s2[1][ch] = 0.f;
      if (ch * kChunkN < np) {
#pragma unroll
        for (int ii = 0; ii < kChunkN / 8; ++ii) {
          const int i = ch * (kChunkN / 8) + ii;
          const int c = 8 * i + 2 * t4;
          const float2 gm = *reinterpret_cast<const float2*>(gamma + c);
          float2 gd = make_float2(0.f, 0.f);
          uint32_t wk = 0xffffffffu;
          float2 bt = make_float2(0.f, 0.f);
          if (last) {
            route(c, gd, wk);
          } else {
            bt = *reinterpret_cast<const float2*>(beta + c);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int at = 4 * i + 2 * r + e;
              const float ge = e ? gm.y : gm.x;
              float d;
              if (last) {
                const int k = tl.k0 + 8 * r;
                d = k == static_cast<int>(e ? wk >> 16 : wk & 0xffffu)
                        ? (e ? gd.y : gd.x)
                        : 0.f;
              } else {
                const bool on =
                    ln_act(acc[at], inv[r], ge, e ? bt.y : bt.x) > 0.f;
                d = on ? din[at] : 0.f;
                din[at] = d;
              }
              const float dx = d * ge;
              s1[r][ch] += dx;
              s2[r][ch] = fmaf(dx, acc[at] * inv[r], s2[r][ch]);
            }
          }
        }
      }
    }
    const float inv_c = 1.f / static_cast<float>(co);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float a = chunk_total<kChunks>(s1[r]);
      float b = chunk_total<kChunks>(s2[r]);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      b += __shfl_xor_sync(0xffffffffu, b, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      b += __shfl_xor_sync(0xffffffffu, b, 2);
      m1[r] = a * inv_c;
      m2[r] = b * inv_c;
    }
  } else if (!last) {
    // the ReLU's mask alone
#pragma unroll
    for (int i = 0; i < kMaxN / 8; ++i) {
      if (8 * i < np) {
        const int c = 8 * i + 2 * t4;
        float2 gm = make_float2(1.f, 1.f);
        float2 bt = make_float2(0.f, 0.f);
        if (ln) {
          gm = *reinterpret_cast<const float2*>(gamma + c);
          bt = *reinterpret_cast<const float2*>(beta + c);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int at = 4 * i + 2 * r + e;
            const float act =
                ln ? ln_act(acc[at], inv[r], e ? gm.y : gm.x,
                            e ? bt.y : bt.x)
                   : acc[at];
            if (!(act > 0.f)) din[at] = 0.f;
          }
        }
      }
    }
  }
  // -- d_pre, and the column sums 64 columns a round --
  const int S = ln && !last ? 3 : 1;
  float* vq = vec_out + static_cast<size_t>(tl.query) * p.n_vec +
              p.vec_off[l];
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    if (ch * kChunkN < np) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[3][8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[0][j] = v[1][j] = v[2][j] = 0.f;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = ch * 8 + half * 4 + ii;
          const int c = 8 * i + 2 * t4;
          float2 gm = make_float2(0.f, 0.f);
          if (ln) gm = *reinterpret_cast<const float2*>(gamma + c);
          float2 gd = make_float2(0.f, 0.f);
          uint32_t wk = 0xffffffffu;
          if (last) route(c, gd, wk);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int at = 4 * i + 2 * r + e;
              float d;
              bool hit = false;
              if (last) {
                const int k = tl.k0 + 8 * r;
                hit = k == static_cast<int>(e ? wk >> 16 : wk & 0xffffu);
                d = hit ? (e ? gd.y : gd.x) : 0.f;
              } else {
                d = din[at];
              }
              float dp = d;
              float dxh = 0.f;
              if (ln) {
                const float xh = acc[at] * inv[r];
                dxh = d * xh;
                if (!(SA_BWD_SKIP & 8)) {
                  dp = inv[r] * (d * (e ? gm.y : gm.x) - m1[r] - xh * m2[r]);
                }
                if (last && hit && tl.live && (kFull || c + e < co) &&
                    !(SA_BWD_SKIP & 16)) {
                  vq[co + c + e] = dxh;
                  vq[2 * co + c + e] = d;
                }
              }
              if (!kFull && c + e >= co) dp = 0.f;
              acc[at] = dp;
              v[0][2 * ii + e] += dp;
              v[1][2 * ii + e] += dxh;
              v[2][2 * ii + e] += d;
            }
          }
        }
        if (!(SA_BWD_SKIP & 16)) {
          if (S == 3) {
            reduce_scatter<3>(v, g8);
          } else {
            reduce_scatter<1>(v, g8);
          }
          const int c = half * 32 + 8 * (g8 >> 1) + 2 * t4 + (g8 & 1);
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            if (s < S) part[(wi * 3 + s) * 64 + c] = v[s][0];
          }
        }
      }
      if (!(SA_BWD_SKIP & 16)) {
        named_sync(1 + wg, 128);
        sums_out(p, tl, S, ch * 64, co, p.vec_off[l], part, n_queries,
                 vec_out);
        named_sync(1 + wg, 128);  // the partial sums may be rewritten
      }
    }
  }
}

// acc <- acc - mu on the real columns: the recomputed h centred with the
// forward's row means (center's own subtraction).
template <int kMaxN, bool kFull>
__device__ __forceinline__ void recenter(float (&acc)[kMaxN / 2], int np,
                                         int co, int t4,
                                         const float (&mu)[2]) {
  if constexpr (kFull) co = np = kMaxN;
#pragma unroll
  for (int i = 0; i < kMaxN / 8; ++i) {
    if (8 * i < np && (kFull || 8 * i + 2 * t4 < co)) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[4 * i + 2 * r] = acc[4 * i + 2 * r] - mu[r];
        acc[4 * i + 2 * r + 1] = acc[4 * i + 2 * r + 1] - mu[r];
      }
    }
  }
}

// The input gradient's product, issued: out (64 rows x n_out columns of the
// layer's inputs from col0) = d_pre (A registers, ksteps k-steps: the
// layer's padded outputs) . W, W the layer's resident weight at w_addr (np
// outputs: its N' stride np x 16) read MN-major; n_out a multiple of 16,
// at most kMaxO. All columns one wgmma, or 64-column pieces one each and
// the rest 16 at a time. The caller may read a (to store it) before
// wgmma_wait(out).
template <int kMaxO, int kNK>
__device__ __forceinline__ void input_grad_issue(float (&out)[kMaxO / 2],
                                           const uint32_t (&a)[kNK][4],
                                           int ksteps, uint32_t w_addr,
                                           int np, int col0, int n_out) {
#pragma unroll
  for (int i = 0; i < kMaxO / 2; ++i) out[i] = 0.f;
  wgmma::fence();
  if (!(SA_BWD_SKIP & 4)) {
    const uint32_t sbo = np * 16;
#pragma unroll
    for (int j = 0; j < kNK; ++j) {
      if (j < ksteps) {
        const uint32_t base = w_addr + 256 * j + (col0 / 8) * sbo;
        if constexpr (kMaxO % 64 == 0 && kMaxO <= 256) {
          if (n_out == kMaxO) {  // one wgmma over every column
            wgmma::Wgmma<kMaxO>::template rs<1>(
                out, a[j], wgmma::desc(base, kTransLbo, sbo));
            continue;
          }
        }
#pragma unroll
        for (int q = 0; q < (kMaxO + 63) / 64; ++q) {
          if (64 * q + 64 <= kMaxO && 64 * q + 64 <= n_out) {
            wgmma::Wgmma<64>::rs<1>(
                *reinterpret_cast<float(*)[32]>(&out[32 * q]), a[j],
                wgmma::desc(base + 8 * q * sbo, kTransLbo, sbo));
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (64 * q + 16 * u + 16 <= kMaxO &&
                  64 * q + 16 * u < n_out) {
                wgmma::Wgmma<16>::rs<1>(
                    *reinterpret_cast<float(*)[8]>(&out[32 * q + 8 * u]),
                    a[j],
                    wgmma::desc(base + (8 * q + 2 * u) * sbo, kTransLbo,
                                sbo));
              }
            }
          }
        }
      }
    }
  }
  wgmma::commit();
}

// Until the issued products into acc have completed.
template <int M>
__device__ __forceinline__ void wgmma_wait(float (&acc)[M]) {
  wgmma::wait_all();
  wgmma::fence_operands(acc);
}

// d_new_xyz of the tile's queries from layer 0's input gradient (its first
// columns in dx): minus the sum of the query's rows' unrounded offset
// columns (pad rows hold 0), through shared memory, the warps in order; a
// query that spans tiles keeps its running sum there until its last tile.
// Every consumer thread calls it.
template <int kMaxO>
__device__ __forceinline__ void new_xyz(const Plan& p, const Tile& tl,
                                        const float (&dx)[kMaxO / 2],
                                        float* part, int n_queries,
                                        float* __restrict__ d_new_xyz,
                                        int wg) {
  if (!(p.need & kNeedNewXyz)) return;
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int wi = (threadIdx.x >> 5) & 3;
  // columns 2 t4 + e of lanes t4 0, 1: the offsets'
  float sum[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    sum[e] = dx[e] + dx[2 + e];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], off);
    }
  }
  if (g8 == 0 && t4 < 2) {
    part[wi * 4 + 2 * t4] = sum[0];
    part[wi * 4 + 2 * t4 + 1] = sum[1];
  }
  named_sync(1 + wg, 128);
  const int tid = threadIdx.x & 127;
  if (tid < tl.nq * 3) {
    const int qi = tid / 3;
    const int c = tid % 3;
    const int query = tl.q0 + qi;
    float total = part[(qi * tl.nw) * 4 + c];
    for (int w = 1; w < tl.nw; ++w) total += part[(qi * tl.nw + w) * 4 + c];
    if (query < n_queries) {
      float* out = d_new_xyz + 3 * static_cast<size_t>(query) + c;
      if (tl.t > 0) total = *out + total;
      *out = tl.t + 1 < p.lv.tiles ? total : -total;
    }
  }
  named_sync(1 + wg, 128);
}

// Layer 0's input gradient, columns col0 + [0, n_out) (accumulators
// `dx`), rounded to bf16 into the tile's slot, in the tile's layout
// (element (m, c) at byte ((c / 8) 8 + m / 8) 128 + (m % 8) 16 + (c % 8) 2:
// a warp's 32-bit stores fill whole core matrices), for the producer to
// scatter.
template <int kMaxO>
__device__ __forceinline__ void leave_rows(const float (&dx)[kMaxO / 2],
                                           int col0, int n_out,
                                           uint8_t* tile) {
  const int lane = threadIdx.x & 31;
  const int wi = (threadIdx.x >> 5) & 3;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < kMaxO / 8; ++i) {
    if (8 * i < n_out) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<uint32_t*>(
            tile + ((col0 / 8 + i) * 8 + 2 * wi + r) * 128 + g8 * 16 +
            4 * t4) = pack_bf16(dx[4 * i + 2 * r], dx[4 * i + 2 * r + 1]);
      }
    }
  }
}

// A layer's product into acc (started from its bias), for the loop over
// any level: from the tile (layer 0) or from the A registers a, on the
// resident weight of padded width np (64, 128, 192 or 256); the k-steps in
// a loop (their registers then live in memory: this path trades speed for
// code size).
template <int kNK>
__device__ __forceinline__ void product_loop(float (&acc)[kWidest / 2],
                                             const uint32_t (&a)[kNK][4],
                                             bool from_tile, uint32_t a_addr,
                                             uint32_t w_addr, int np,
                                             int ksteps) {
  wgmma::fence();
  if (!(SA_BWD_SKIP & 1)) {
#define SA_LAYER(N)                                                         \
  if (from_tile) {                                                          \
    _Pragma("unroll 1") for (int j = 0; j < ksteps; ++j) {                  \
      wgmma::Wgmma<N>::ss(acc, wgmma::desc(a_addr + j * 2 * 1024, 1024, 128), \
                          wgmma::desc(w_addr + j * 2 * N * 16, N * 16, 128)); \
    }                                                                       \
  } else {                                                                  \
    _Pragma("unroll 1") for (int j = 0; j < ksteps; ++j) {                  \
      const uint32_t aj[4] = {a[j][0], a[j][1], a[j][2], a[j][3]};          \
      wgmma::Wgmma<N>::rs(acc, aj,                                          \
                          wgmma::desc(w_addr + j * 2 * N * 16, N * 16, 128)); \
    }                                                                       \
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
  wgmma::commit();
  wgmma::wait_all();
  wgmma::fence_operands(acc);
}

// input_grad for the loop over any level: the k-steps in a loop.
template <int kMaxO, int kNK>
__device__ __forceinline__ void input_grad_loop(float (&out)[kMaxO / 2],
                                                const uint32_t (&a)[kNK][4],
                                                int ksteps, uint32_t w_addr,
                                                int np, int col0, int n_out) {
#pragma unroll
  for (int i = 0; i < kMaxO / 2; ++i) out[i] = 0.f;
  wgmma::fence();
  if (!(SA_BWD_SKIP & 4)) {
    const uint32_t sbo = np * 16;
#pragma unroll 1
    for (int j = 0; j < ksteps; ++j) {
      const uint32_t aj[4] = {a[j][0], a[j][1], a[j][2], a[j][3]};
      const uint32_t base = w_addr + 256 * j + (col0 / 8) * sbo;
#pragma unroll
      for (int q = 0; q < kMaxO / 64; ++q) {
        if (64 * q + 64 <= n_out) {
          wgmma::Wgmma<64>::rs<1>(
              *reinterpret_cast<float(*)[32]>(&out[32 * q]), aj,
              wgmma::desc(base + 8 * q * sbo, kTransLbo, sbo));
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (64 * q + 16 * u < n_out) {
              wgmma::Wgmma<16>::rs<1>(
                  *reinterpret_cast<float(*)[8]>(&out[32 * q + 8 * u]), aj,
                  wgmma::desc(base + (8 * q + 2 * u) * sbo, kTransLbo, sbo));
            }
          }
        }
      }
    }
  }
  wgmma::commit();
  wgmma::wait_all();
  wgmma::fence_operands(out);
}

// The forward's LayerNorm on a layer's accumulators: the rows' mean and
// inverse std, then the activations (SA_BWD_SKIP 256: ReLU alone).
template <int kMaxN, bool kFull>
__device__ __forceinline__ void forward_norm(float (&acc)[kMaxN / 2],
                                             const float* vec, int np, int co,
                                             int t4, float (&mu)[2],
                                             float (&inv)[2]) {
  if (SA_BWD_SKIP & 256) {
    mu[0] = mu[1] = 0.f;
    inv[0] = inv[1] = 1.f;
    relu<kMaxN>(acc, np);
    return;
  }
  center<kMaxN, kFull>(acc, np, co, t4, mu, inv);
  normalise<kMaxN, kFull>(acc, vec, np, co, inv, t4);
}

// The product of a layer of padded width N from the A registers a (K / 16
// k-steps), issued: straight-line, its widths known. The caller may read a
// (to store it) before wgmma_wait(acc).
template <int N, int K>
__device__ __forceinline__ void product_rs_issue(
    float (&acc)[N / 2], const uint32_t (&a)[K / 16][4], const float* vec,
    uint32_t w_addr, int t4) {
  init_bias<N>(acc, vec, N, t4);
  wgmma::fence();
  if (!(SA_BWD_SKIP & 1)) layer_rs<N, N, K>(acc, a, w_addr, K / 16);
  wgmma::commit();
}

template <int N>
__device__ __forceinline__ void product_ss(float (&acc)[N / 2],
                                           const float* vec, uint32_t a_addr,
                                           uint32_t w_addr, int ksteps,
                                           int t4) {
  init_bias<N>(acc, vec, N, t4);
  wgmma::fence();
  if (!(SA_BWD_SKIP & 1)) layer_ss<N, N>(acc, a_addr, w_addr, ksteps);
  wgmma::commit();
  wgmma::wait_all();
  wgmma::fence_operands(acc);
}

// A tile through a LayerNorm level of three layers of widths N0, N1, N2
// (none padded) from KP0 gathered channels: straight-line code. Each
// scratch row store runs while the wgmma that reads the same registers
// does.
template <int N0, int N1, int N2, int KP0>
__device__ __forceinline__ void tile_fixed(
    const Plan& p, const Tile& tl, const float* vecs, uint32_t w_base,
    uint32_t a_addr, uint8_t* tile, uint64_t* empty_slot, float* part,
    int n_queries, float* __restrict__ vec_out,
    float* __restrict__ d_new_xyz, int wg, Clock& clk) {
  const Level& lv = p.lv;
  const int t4 = threadIdx.x & 3;
  const float* vec0 = vecs + lv.v_off[0];
  const float* vec1 = vecs + lv.v_off[1];
  const float* vec2 = vecs + lv.v_off[2];
  const uint32_t w0 = w_base + lv.w_off[0];
  const uint32_t w1 = w_base + lv.w_off[1];
  const uint32_t w2 = w_base + lv.w_off[2];
  // -- the forward: layer 0's activations kept as bf16 A registers, the
  // last layer's centred h as accumulators, every row's statistics --
  uint32_t a0[N0 / 16][4];
  float mu0[2], inv0[2], mu1[2], inv1[2], inv2[2];
  float acc2[N2 / 2];
  {
    float acc0[N0 / 2];
    product_ss<N0>(acc0, vec0, a_addr, w0, KP0 / 16, t4);
    forward_norm<N0, true>(acc0, vec0, N0, N0, t4, mu0, inv0);
    to_a<N0, N0>(acc0, a0, N0);
  }
  {
    uint32_t a1[N1 / 16][4];
    {
      float acc1[N1 / 2];
      product_rs_issue<N1, N0>(acc1, a0, vec1, w1, t4);
      store_rows<N0 / 16>(p, tl, a0, N0, p.in16[1]);
      wgmma_wait(acc1);
      forward_norm<N1, true>(acc1, vec1, N1, N1, t4, mu1, inv1);
      to_a<N1, N1>(acc1, a1, N1);
    }
    product_rs_issue<N2, N1>(acc2, a1, vec2, w2, t4);
    store_rows<N1 / 16>(p, tl, a1, N1, p.in16[2]);
    wgmma_wait(acc2);
    float mu2[2];
    if (SA_BWD_SKIP & 256) {
      inv2[0] = inv2[1] = 1.f;
    } else {
      center<N2, true>(acc2, N2, N2, t4, mu2, inv2);
    }
  }
  clk.mark(1);
  // -- layer 2: the routed gradient, the LayerNorm backward, the sums --
  float din1[N1 / 2];
  {
    layer_backward<N2, true>(p, tl, acc2, acc2, vec2, 2, true, inv2, part,
                             n_queries, vec_out, wg);
    clk.mark(2);
    uint32_t d2[N2 / 16][4];
    to_a<N2, N2>(acc2, d2, N2);
    input_grad_issue<N1, N2 / 16>(din1, d2, N2 / 16, w2, N2, 0, N1);
    store_rows<N2 / 16>(p, tl, d2, N2, p.d16[2]);
    clk.mark(4);
    wgmma_wait(din1);
    clk.mark(5);
  }
  // -- layer 1: h recomputed from layer 0's activations --
  float din0[N0 / 2];
  {
    float acc1[N1 / 2];
    product_rs_issue<N1, N0>(acc1, a0, vec1, w1, t4);
    wgmma_wait(acc1);
    recenter<N1, true>(acc1, N1, N1, t4, mu1);
    clk.mark(6);
    layer_backward<N1, true>(p, tl, acc1, din1, vec1, 1, false, inv1, part,
                             n_queries, vec_out, wg);
    clk.mark(2);
    uint32_t d1[N1 / 16][4];
    to_a<N1, N1>(acc1, d1, N1);
    input_grad_issue<N0, N1 / 16>(din0, d1, N1 / 16, w1, N1, 0, N0);
    store_rows<N1 / 16>(p, tl, d1, N1, p.d16[1]);
    clk.mark(4);
    wgmma_wait(din0);
    clk.mark(5);
  }
  // -- layer 0: h recomputed from the tile; the slot goes back then, or,
  // with a scatter to do, once it holds the rows for the producer --
  float acc0[N0 / 2];
  product_ss<N0>(acc0, vec0, a_addr, w0, KP0 / 16, t4);
  if (!p.handoff) mbar_arrive(empty_slot);
  recenter<N0, true>(acc0, N0, N0, t4, mu0);
  clk.mark(6);
  layer_backward<N0, true>(p, tl, acc0, din0, vec0, 0, false, inv0, part,
                           n_queries, vec_out, wg);
  clk.mark(2);
  uint32_t d0[N0 / 16][4];
  to_a<N0, N0>(acc0, d0, N0);
  if (p.need) {
    float dx[KP0 / 2];
    input_grad_issue<KP0, N0 / 16>(dx, d0, N0 / 16, w0, N0, 0, KP0);
    store_rows<N0 / 16>(p, tl, d0, N0, p.d16[0]);
    clk.mark(4);
    wgmma_wait(dx);
    clk.mark(5);
    new_xyz<KP0>(p, tl, dx, part, n_queries, d_new_xyz, wg);
    if (p.handoff) {
      leave_rows<KP0>(dx, 0, KP0, tile);
      mbar_arrive(empty_slot);
    }
    clk.mark(7);
  } else {
    store_rows<N0 / 16>(p, tl, d0, N0, p.d16[0]);
    clk.mark(4);
  }
}

// A tile through any level the kernel takes (widths known at run time, at
// most kWidest), in one loop of 2 L - 1 steps over the layers: the first L
// - 1 form layer l's activations, layer l + 1's input rows; then, last
// layer first, each step recomputes layer l from the tile through the
// layers below it (kept nowhere: registers indexed by a run-time layer
// would spill all the more) and runs its backward as tile_fixed's. Every
// piece of code once, for its size.
__device__ __forceinline__ void tile_generic(
    const Plan& p, const Tile& tl, const float* vecs, uint32_t w_base,
    uint32_t a_addr, uint8_t* tile, uint64_t* empty_slot, float* part,
    int n_queries, float* __restrict__ vec_out,
    float* __restrict__ d_new_xyz, int wg) {
  constexpr int kN = kWidest;
  constexpr int kNK = kN / 16;
  const Level& lv = p.lv;
  const int t4 = threadIdx.x & 3;
  const int L = lv.n_layers;
  const bool ln = lv.layer_norm && !(SA_BWD_SKIP & 256);
  uint32_t a[kNK][4] = {};
  float acc[kN / 2];
  float din[kN / 2];
  float mu[2] = {0.f, 0.f};
  float inv[2] = {1.f, 1.f};
  for (int it = 0; it < 2 * L - 1; ++it) {
    const bool fwd = it + 1 < L;
    const int l = fwd ? it : 2 * L - 2 - it;
    for (int m = 0; m <= l; ++m) {
      const float* vec = vecs + lv.v_off[m];
      const int np = lv.np[m];
      init_bias<kN>(acc, vec, np, t4);
      product_loop<kNK>(acc, a, m == 0, a_addr, w_base + lv.w_off[m], np,
                        lv.kp[m] / 16);
      if (ln) center<kN, false>(acc, np, lv.co[m], t4, mu, inv);
      if (fwd || m < l) {  // the activations, the next layer's input
        if (ln) {
          normalise<kN, false>(acc, vec, np, lv.co[m], inv, t4);
        } else {
          relu<kN>(acc, np);
        }
        to_a<kN, kN>(acc, a, np);
      }
    }
    if (fwd) {
      store_rows<kNK>(p, tl, a, p.ci_pad[l + 1], p.in16[l + 1]);
      continue;
    }
    if (l == 0 && !p.handoff) mbar_arrive(empty_slot);
    layer_backward<kN, false>(p, tl, acc, din, vecs + lv.v_off[l], l,
                              l == L - 1, inv, part, n_queries, vec_out, wg);
    to_a<kN, kN>(acc, a, lv.np[l]);
    store_rows<kNK>(p, tl, a, lv.co[l], p.d16[l]);
    // the input gradient (layer 0's in windows of kN columns, left in the
    // slot for the producer's scatter)
    for (int col0 = 0; col0 < lv.kp[l] && (l > 0 || p.need); col0 += kN) {
      const int n_out = min(kN, lv.kp[l] - col0);
      input_grad_loop<kN, kNK>(din, a, lv.np[l] / 16, w_base + lv.w_off[l],
                               lv.np[l], col0, n_out);
      if (l == 0) {
        if (col0 == 0) new_xyz<kN>(p, tl, din, part, n_queries, d_new_xyz, wg);
        if (p.handoff) leave_rows<kN>(din, col0, n_out, tile);
      }
    }
    if (l == 0 && p.handoff) mbar_arrive(empty_slot);
  }
}

// Consumer warpgroup wg (0 or 1). N0 > 0: tile_fixed's widths; else the
// loop over any level.
template <int N0, int N1, int N2, int KP0>
__device__ __forceinline__ void consumer(
    const Plan& p, int wg, int n_queries, int g_begin, int n_local,
    uint8_t* smem, uint64_t* full, uint64_t* empty, uint64_t* wbar,
    float* __restrict__ vec_out, float* __restrict__ d_new_xyz) {
  const Level& lv = p.lv;
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2;
  const int wi = (threadIdx.x >> 5) & 3;
  const int npl = lv.np[lv.n_layers - 1];
  const float* vecs = reinterpret_cast<const float*>(smem + lv.off_vec);
  float* part = reinterpret_cast<float*>(smem + lv.off_part) + wg * kPartFloats;
  const uint32_t w_base = smem_addr(smem);
  const uint32_t ring = smem_addr(smem + lv.off_ring);
  Clock clk(wg == 0 && (threadIdx.x & 127) == 0);
  mbar_wait(wbar, 0);  // the weights and vectors have landed
  for (int gl = wg; gl < n_local; gl += kConsumers) {
    const int q0 = (g_begin + gl) * lv.queries;
    for (int t = 0; t < lv.tiles; ++t) {
      int slot, round;
      slot_of(lv, gl, t, slot, round);
      mbar_wait(&full[slot], round & 1);
      clk.mark(0);
      uint8_t* side = smem + lv.off_ring + slot * p.slot_bytes;
      Tile tl;
      tl.q0 = q0;
      tl.t = t;
      tl.nq = lv.tiles == 1 ? lv.queries : 1;
      tl.nw = lv.tiles == 1 ? lv.slot / 16 : 4;
      tl.qi = lv.tiles == 1 ? 16 * wi / lv.slot : 0;
      tl.query = q0 + tl.qi;
      tl.live = tl.query < n_queries;
      tl.k0 = lv.tiles == 1 ? (16 * wi + g8) % lv.slot
                            : kRows * t + 16 * wi + g8;
      tl.gdp = reinterpret_cast<const float*>(side + p.side_gdp) +
               tl.qi * npl;
      tl.win = reinterpret_cast<const uint16_t*>(side + p.side_win) +
               tl.qi * npl;
      const int* pts = reinterpret_cast<const int*>(side + p.side_pts);
      tl.pt[0] = pts[16 * wi + g8];
      tl.pt[1] = pts[16 * wi + g8 + 8];
      tl.pair0 = (static_cast<size_t>(q0) * p.k_nb +
                  (lv.tiles == 1 ? 0 : kRows * t) + 16 * wi) / 2;
      const uint32_t a_addr = ring + slot * p.slot_bytes;
      if constexpr (N0 > 0) {
        tile_fixed<N0, N1, N2, KP0>(p, tl, vecs, w_base, a_addr, side,
                                    &empty[slot], part, n_queries, vec_out,
                                    d_new_xyz, wg, clk);
      } else {
        tile_generic(p, tl, vecs, w_base, a_addr, side, &empty[slot], part,
                     n_queries, vec_out, d_new_xyz, wg);
      }
    }
  }
}

template <int N0, int N1, int N2, int KP0>
__global__ void __launch_bounds__(kThreads, 1)
    fused_sa_bwd_bf16_kernel(const float* __restrict__ xyz,
                             const float* __restrict__ new_xyz,
                             const float* __restrict__ feats,
                             const int* __restrict__ idx,
                             const float* __restrict__ pooled,
                             const float* __restrict__ d_pooled,
                             const void* __restrict__ winner, int n, int s,
                             int f, int n_queries, int n_groups, Plan p,
                             float* __restrict__ d_xyz,
                             float* __restrict__ d_feats,
                             float* __restrict__ d_new_xyz,
                             float* __restrict__ vec_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Level& lv = p.lv;
  const int stages = lv.producers * lv.per_warp;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lv.off_bar);
  uint64_t* empty = full + stages;
  uint64_t* wbar = empty + stages;
  // a contiguous range of groups a block
  const int g_begin = static_cast<int>(
      static_cast<long long>(blockIdx.x) * n_groups / gridDim.x);
  const int g_end = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * n_groups / gridDim.x);

  // the ring zero (the chunks past the real channels are never written),
  // the barriers, then the weights and vectors on their way
  for (int e = threadIdx.x; e < stages * p.slot_bytes / 16;
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
  if (role == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    producer(p, xyz, new_xyz, feats, idx, pooled, d_pooled, winner, n, s, f,
             n_queries, g_begin, g_end - g_begin, smem, full, empty, d_xyz,
             d_feats);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    consumer<N0, N1, N2, KP0>(p, role - 1, n_queries, g_begin,
                              g_end - g_begin, smem, full, empty, wbar,
                              vec_out, d_new_xyz);
  }
}

}  // namespace

// The bf16 backward's first kernel. xyz (b, n, 3), new_xyz (b, s, 3),
// feats (b, n, f) or null when f == 0, idx (b, s, k_nb) int32, pooled and
// d_pooled (b, s, C) f32, all contiguous: the bf16 forward's inputs and
// outputs (fused_sa_forward_bf16), with its winner (b, s, C) of win_bytes
// 1 (uint8; k_nb <= 256) or 4 (int32) an element: d_pooled[c] goes to row
// winner[c] where pooled[c] > 0. chans[l], chans[l + 1]: layer l's input
// and output widths (chans[0] == 3 + f; every output a multiple of 4 and
// at most 256). `image` (image_bytes bytes of device memory, 16-byte
// aligned): the level's image as fused_sa_pack_bf16 (or the bf16 forward)
// packs it from the layers' f32 weights and vectors. need: bit 0 d_xyz,
// bit 1 d_new_xyz, bit 2 d_feats; what is not asked may be null. The caller
// zeroes d_xyz (b, n, 3) and d_feats (b, n, f); d_new_xyz (b, s, 3) is
// written. Writes, with R = b s k_nb rows and R' = R rounded up to even:
//   scratch (bf16): per layer l in order, d_pre (R', co) then the layer's
//     input (R', ci_pad; ci rounded up to 4, pad zero), element (r, c) of a
//     (R', w) block at (r / 2) 2 w + 2 c + r % 2; the caller zeroes it when
//     R is odd;
//   vec (b s, n_vec): per query, per layer in order, db (co) then, with
//     LayerNorm, dgamma (co) and dbeta (co), each summed over the query's
//     rows.
// Returns a cudaError_t as int (0 = launched; cudaErrorInvalidValue for a
// shape it does not take: a width past 256, k_nb past 65535, or an image
// that leaves no room for a tile in shared memory).
extern "C" int fused_sa_backward_bf16(
    const float* xyz, const float* new_xyz, const float* feats,
    const int* idx, const float* pooled, const float* d_pooled,
    const void* winner, int win_bytes, int b, int n, int s, int f, int k_nb,
    int n_layers, const int* chans, int layer_norm, const void* image,
    long long image_bytes, int need, float* d_xyz, float* d_feats,
    float* d_new_xyz, void* scratch, float* vec, void* stream) {
  Plan p{};
  Level& lv = p.lv;
  if (b <= 0 || n <= 0 || s <= 0 || k_nb <= 0 || k_nb > 65535 ||
      chans[0] != 3 + f || winner == nullptr || image == nullptr ||
      (win_bytes != 4 && !(win_bytes == 1 && k_nb <= 256)) ||
      !image_layout(n_layers, chans, layer_norm, lv, nullptr, nullptr) ||
      image_bytes != lv.image_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lv.image = static_cast<const uint8_t*>(image);
  lv.vec4 = f >= 8 && f % 4 == 0 &&
            reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  p.feats_v4 = f % 4 == 0 && reinterpret_cast<uintptr_t>(d_feats) % 16 == 0;
  p.k_nb = k_nb;
  p.need = need;
  p.win_bytes = win_bytes;
  if (k_nb <= 64) {
    lv.slot = k_nb <= 16 ? 16 : k_nb <= 32 ? 32 : 64;
    lv.queries = kRows / lv.slot;
    lv.tiles = 1;
    p.rows_fast = k_nb == lv.slot;
  } else {
    lv.slot = kRows;
    lv.queries = 1;
    lv.tiles = (k_nb + kRows - 1) / kRows;
    p.rows_fast = k_nb % kRows == 0;
  }
  // the scratch blocks and the vec slot
  const size_t rows_all = static_cast<size_t>(b) * s * k_nb;
  const size_t rows_pad = (rows_all + 1) & ~size_t{1};
  __nv_bfloat16* p16 = static_cast<__nv_bfloat16*>(scratch);
  p.n_vec = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int ci = chans[l];
    const int co = chans[l + 1];
    p.ci_pad[l] = (ci + 3) & ~3;
    p.d16[l] = p16;
    p.in16[l] = p16 + rows_pad * co;
    p16 += rows_pad * (co + p.ci_pad[l]);
    p.vec_off[l] = p.n_vec;
    p.n_vec += co * (layer_norm ? 3 : 1);
  }
  // a slot: the tile, then its queries' routing data and its rows' points
  const int npl = lv.np[n_layers - 1];
  const int nq = lv.tiles == 1 ? lv.queries : 1;
  lv.tile_bytes = kRows * lv.kp[0] * 2;
  p.side_gdp = lv.tile_bytes;
  p.side_win = p.side_gdp + pad_to(nq * npl * 4, 16);
  p.side_pts = p.side_win + pad_to(nq * npl * 2, 16);
  p.slot_bytes = pad_to(p.side_pts + kRows * 4, 128);
  // sa1's and sa2's levels as straight-line code, any other in the loop
  auto widths = [&](int n0, int n1, int n2, int kp0) {
    return n_layers == 3 && layer_norm && lv.tiles == 1 &&
           lv.kp[0] == kp0 && lv.np[0] == n0 && lv.np[1] == n1 &&
           lv.np[2] == n2 && lv.co[0] == n0 && lv.co[1] == n1 &&
           lv.co[2] == n2;
  };
  const int variant = widths(64, 64, 128, 16)     ? 0
                      : widths(128, 128, 256, 144) ? 1
                                                   : 2;
  p.handoff = (need & (kNeedXyz | kNeedFeats)) != 0;
  lv.sel_ints = std::max(kRows, k_nb);
  size_t off = pad_to(lv.image_bytes, 128);
  lv.off_part = static_cast<int>(off);
  off += kConsumers * kPartFloats * 4;
  lv.off_sel = static_cast<int>(off);
  off += pad_to(4 * lv.sel_ints * 4, 128);
  const size_t fixed = off + pad_to((2 * kMaxStages + 1) * 8, 128);
  if (fixed + p.slot_bytes > kSmemPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int stages = static_cast<int>(std::min<size_t>(
      kMaxStages, (kSmemPerBlock - fixed) / p.slot_bytes));
  lv.producers = std::min(4, stages);
  lv.per_warp = stages / lv.producers;
  stages = lv.producers * lv.per_warp;
  lv.off_ring = static_cast<int>(off);
  off += static_cast<size_t>(stages) * p.slot_bytes;
  lv.off_bar = static_cast<int>(off);
  off += (2 * stages + 1) * 8;
  const size_t smem = off;

  auto kernel = variant == 0   ? fused_sa_bwd_bf16_kernel<64, 64, 128, 16>
                : variant == 1 ? fused_sa_bwd_bf16_kernel<128, 128, 256, 144>
                               : fused_sa_bwd_bf16_kernel<0, 0, 0, 0>;
  // per device and variant, once: the SM count and the register check (the
  // consumers' setmaxnreg.inc takes what the producer's .dec frees, so the
  // kernel must hold all the block's registers from its launch); the
  // shared memory whenever it changes
  constexpr int kDevices = 16;
  struct Setting {
    int n_sm = 0;
    size_t smem = 0;
  };
  static Setting settings[kDevices][3];
  Setting scratch_setting;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Setting& set =
      device < kDevices ? settings[device][variant] : scratch_setting;
  if (set.n_sm == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs * kThreads <
        128 * kProducerRegs + 128 * kConsumers * kConsumerRegs) {
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
    if (err != cudaSuccess) return static_cast<int>(err);
    set.smem = smem;
  }
  const int n_queries = b * s;
  const int n_groups = (n_queries + lv.queries - 1) / lv.queries;
  const int grid = std::max(1, std::min(n_groups, set.n_sm));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, feats, idx, pooled, d_pooled, winner, n, s, f, n_queries,
      n_groups, p, d_xyz, d_feats, d_new_xyz, vec);
  return static_cast<int>(cudaGetLastError());
}

#ifdef SA_BWD_PHASES
// The phase counters (kPhases of them) to host memory, then zeroed: a
// consumer's 0 waiting for a tile, 1 the forward (products, LayerNorm,
// input rows), 2 the LayerNorm backward with the routing and the column
// sums, 3 (unused), 4 d_pre to bf16 and its scratch rows, 5 the input
// gradient's products, 6 the recompute of a layer below the last, 7 the
// scatter; the producer's 8 the indices, 9 waiting for a slot, 10 the
// gather, 11 the routing data, the points and layer 0's input rows.
extern "C" int sa_bwd_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                         sizeof(g_phase_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kPhases] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
}
#endif
