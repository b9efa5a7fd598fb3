// Fused PointNet++ set-abstraction level, backward, for Hopper (sm_90a):
// the first of two kernels (K1). The second, sa_weight_grad.cu (K2), forms
// the weight gradients from the rows this one writes.
//
// Together they replace the backward Pallas kernel of
// maskplanner_tpu/ops/pallas/fused_sa_train.py (`_fsa_train_bwd_raw`, body
// `_bwd_kernel`). For every query (an FPS centroid) K1 re-gathers its K
// neighbours [x - q ; f] from the indices the forward saved, recomputes
// every layer's pre-norm value h, its LayerNorm mean and inverse std (eps
// 1e-6) and its activation, routes d_pooled[c] to the FIRST neighbour k
// whose last activation equals pooled[c] (later ties get nothing: ties come
// only from duplicated neighbours, so every accumulated gradient is the
// same either way), and backpropagates through ReLU, LayerNorm and the
// Dense layers. Per layer it writes, for every neighbour row, the layer's
// d_pre (the gradient of its Dense output) and its input to a scratch
// buffer, and per query the sums over the query's rows of d_pre (db) and,
// with LayerNorm, of d_act * xhat (dgamma) and d_act (dbeta). Only what the
// caller asks for is formed: layer 0's input gradient and the d_xyz /
// d_features scatter (f32 atomics) and d_new_xyz[b, s] =
// -sum_k d_in[k, :3] each only under their flag.
//
// Exactness of the routing: the recompute goes through the forward's own
// device functions (fused_sa_common.cuh: every layer ONE 3xTF32
// tensor-core product, mma_product, each output one accumulator from its
// bias over the k-steps of 8 zero-padded input channels in ascending
// order; then the same LayerNorm), so each activation is bit for bit the
// one the forward max-pooled, and the `>=` test finds the forward's
// winner.
//
// What bounds it on this card: the products of the recompute and of the
// input gradients (about 26 GFLOP each at sa1 and 69 at sa2 at the
// flagship batch of 64; both on the tensor cores in 3xTF32, tf32_mma.cuh),
// the LayerNorm forward and backward on the CUDA cores, and the scratch
// rows it writes (388 floats a row at sa1, 900 at sa2: 1.63 GB and 1.89
// GB).
//
// What the design does about it: persistent blocks of 512 threads, one an
// SM. A query's K rows go through shared memory in chunks of up to 32: per
// row the gathered input, each layer's pre-norm h (LayerNorm levels) and
// activation; per layer the row's mean and inverse std. Each query is a
// chain of short phases between barriers (gather, a product per layer,
// LayerNorms, routing, sums, scratch rows), too short to fill an SM alone,
// so a block holds as many independent thread groups as its shared memory
// allows, each on its own queries with its own named barrier. The weights
// sit in shared memory: at sa1 every layer's padded transposed weight (55
// KB, row stride 8 mod 32, columns swizzled: fused_sa_common.cuh) is
// resident for the whole kernel and read by both groups (the recompute's
// B fragments, and the input gradient's, which read it transposed; both
// split into TF32 parts as they are read); at sa2 (266 KB) one group
// streams them per chunk in tiles double-buffered with cp.async. The
// activations' row strides are 4 modulo 32 floats, so that the mma A
// fragment loads (8 rows x 4 neighbouring columns a warp) hit distinct
// banks.
// The max-pool routing, the column sums (db, dgamma, dbeta) and the
// LayerNorm backward spread their rows over all the group's threads, in a
// fixed order. A per-channel "not yet taken" flag carries the first-winner
// rule across chunks. Gradients overwrite the activations in place, layer
// by layer: the routed gradient replaces the last activation, the
// LayerNorm backward writes d_pre over it, and the input gradient d_pre · W
// overwrites the layer's input activation, masked by that activation's
// ReLU. No weight gradient is summed here and no f64 atomic remains: the
// per-query sums go to their own slot and K2 reduces every sum in a fixed
// order, so the weight gradients are the same bits from run to run.
//
// The bf16 mode (fused_sa_backward_bf16) replaces the same Pallas kernel's
// precision="default" (bf16 models train with it; `_bwd_kernel` with
// `_Gather(single=True)`). Its recompute is the forward's bf16 mode
// (fused_sa_fwd.cu) step for step: mma_product_bf16 on the weight as bf16 in
// the Dense layout, the A operand read from the float32 rows and rounded in
// registers, channels padded to 16 with zero pad rows and bias, the same
// layer_norm_rows; so the routing by bit equality holds against the bf16
// forward's pooled output too. The input gradient bf16(d_pre) · bf16(W) is
// the same product on the transposed weight (ci16, co16) bf16, with no bias,
// stored through the ReLU mask in place: one m16n8k16 mma a k-step of 16
// where the float32 mode splits d_pre into TF32 parts and runs three. Its
// sums stay float32, unrounded, as do the LayerNorm backward, db, dgamma and
// dbeta. The rows scattered to the source points are rounded to bf16 before
// the float32 atomics; d_new_xyz sums the unrounded offsets' gradient. The
// scratch rows are stored rounded to bf16 (K2's bf16 mode rounds them
// anyway): half the bytes, two neighbouring rows interleaved so that one
// 32-bit word holds K2's mma fragment (sa_weight_grad.cu). Weights resident
// where both orientations fit beside the groups (sa1: 58 KB), else streamed
// in k-tiles through a double buffer by one group (sa2).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "fused_sa_common.cuh"
#include "tf32_mma.cuh"

// Timing studies only (maskplanner_tpu_torch/bench_sa_backward.py): each
// bit of SA_BWD_SKIP (fused_sa_common.cuh) leaves out a part, and the
// result is then wrong. 1: the recompute's products, 2: the scratch rows,
// 4: the input-gradient products, 8: the LayerNorm backward, 16: the column
// sums of d_pre, 32: the input gradient's mma loop (its weight tiles still
// staged), 64: the streaming of the recompute's weight tiles (its products
// run on stale tiles), 128: the recompute's mma loop (its tiles still
// staged).
// SA_BWD_GROUPS: thread groups a block, instead of the most that fit.
#ifndef SA_BWD_GROUPS
#define SA_BWD_GROUPS 0
#endif
// SA_BWD_PHASES: thread 0 of every block sums the clock cycles of each
// phase of its first group into kPhases device counters, read by
// sa_bwd_phase_cycles.
#ifdef SA_BWD_PHASES
constexpr int kPhases = 9;
__device__ unsigned long long g_phase_cycles[kPhases];
#define PHASE(i)                              \
  do {                                        \
    if (threadIdx.x == 0) {                   \
      const long long now = clock64();        \
      phase_cycles[i] += now - phase_t;       \
      phase_t = now;                          \
    }                                         \
  } while (0)
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

namespace {

using fused_sa::kStorePlain;
using fused_sa::kStoreRelu;
using fused_sa::layer_norm_xhat;
using fused_sa::Threads;
using fused_sa::warp_sum;

constexpr int kThreads = 512;  // a block; one block an SM
constexpr int kMaxGroups = 2;  // thread groups a block, each on its queries
constexpr int kMaxLayers = 4;
constexpr int kMaxChunk = 32;  // neighbour rows per chunk, at most
constexpr int kMinChunk = 16;  // the mma's row tile
constexpr size_t kSmemPerBlock = 232448;  // bytes a block may have on Hopper
constexpr int kNeedXyz = 1;
constexpr int kNeedNewXyz = 2;
constexpr int kNeedFeats = 4;

struct Layer {
  const float* wt;     // (ci8, co8): the Dense weight transposed, padded
  const float* w_pad;  // (co, ci_pad): the Dense weight, zero-padded
  const __nv_bfloat16* w16;   // bf16: (cop, cip), the Dense weight, padded
  const __nv_bfloat16* wt16;  // bf16: (cip, cop), its transpose, padded
  const float* bias;   // (co,)
  const float* gamma;  // (co,) or null without LayerNorm
  const float* beta;   // (co,) or null without LayerNorm
  float* d_rows;       // scratch (rows, co): d_pre
  float* in_rows;      // scratch (rows, ci_pad): the layer's input
  __nv_bfloat16* d16;   // bf16: d_pre's scratch rows, in pairs
  __nv_bfloat16* in16;  // bf16: the input's scratch rows, in pairs
  int cip;     // bf16: ci rounded up to 16 (the mma's k)
  int cop;     // bf16: co rounded up to 16
  int tile16;  // bf16 streamed: columns of a w16 tile (the recompute)
  int tilet;   // bf16 streamed: columns of a wt16 tile (the input gradient)
  int res16;   // bf16 resident: offset of w16 in the weight buffer (floats)
  int res16t;  // bf16 resident: offset of wt16
  int ci;
  int co;
  int ci_pad;  // ci rounded up to a multiple of 4
  int ci8;     // ci rounded up to a multiple of 8 (the recompute's k)
  int co8;     // co rounded up to a multiple of 8
  int ld;      // row stride of this layer's h and activation buffers
  int vec;     // offset of this layer's db (dgamma, dbeta) in a vec slot
  int tile;    // input channels of a streamed weight tile, recompute
  int ld_wt;   // stride of wt's rows in shared memory (8 mod 32, swizzled)
  int tk;      // output channels of a streamed w_pad tile
  int ld_w;    // its row stride (8 mod 32: conflict-free B fragments)
  int res_wt;  // resident weights: offset of wt in the weight buffer
};

struct Mlp {
  Layer layer[kMaxLayers];
  int n_layers;
  int layer_norm;
  int ld_x;      // row stride of the gathered-input buffer
  int chunk;     // neighbour rows per chunk
  int n_vec;     // floats of a query's vec slot
  int n_wbuf;    // floats of the weight buffer
  int resident;  // every layer's wt stays in the weight buffer
  int ld_max;    // the widest layer's row stride
  int groups;    // thread groups in a block
  int state;     // floats of a group's own shared memory
};

// The least row stride of at least n floats that is r modulo 32.
int row_stride(int n, int r = 4) { return ((n - r + 31) & ~31) + r; }

// Floats of a group's shared memory before its row buffers: the chunk's
// indices, the "not yet taken" flags, the row statistics, the vec sums and
// a reduction area of 2 threads-a-group floats, rounded up to 4.
__host__ __device__ int head_floats(const Mlp& mlp, int c_last) {
  return (mlp.chunk * (1 + 2 * kMaxLayers) + c_last + mlp.n_vec +
          2 * (kThreads / mlp.groups) + 3) & ~3;
}

// v[c] += sum over rows k of d[k][c] (and, with xhat, v2[c] += sum of
// d[k][c] * xhat(k, c)), c < n, by the group: the rows are cut into
// groups, one a thread beside the other channels', and the row groups'
// sums are added in order, so the result is the same bits every time.
// part holds 2 th.n floats; n <= th.n. The caller synchronises before and
// after.
template <bool kXhat>
__device__ void column_sums(const Threads& th, const float* d,
                            const float* h, int ld, int n, int rows,
                            const float* mu, const float* inv, float* part,
                            float* v, float* v2) {
  const int groups = max(1, min(rows, th.n / n));
  const int per = (rows + groups - 1) / groups;
  const int c = th.tid % n;
  const int grp = th.tid / n;
  if (grp < groups) {
    float sb = 0.f;
    float sg = 0.f;
    const int k1 = min(rows, (grp + 1) * per);
    for (int k = grp * per; k < k1; ++k) {
      const float gk = d[k * ld + c];
      if (kXhat) {
        sg = fmaf(gk, layer_norm_xhat(h[k * ld + c], mu[k], inv[k]), sg);
      }
      sb += gk;
    }
    part[grp * n + c] = sb;
    if (kXhat) part[th.n + grp * n + c] = sg;
  }
  th.sync();
  for (int cc = th.tid; cc < n; cc += th.n) {
    float sb = 0.f;
    float sg = 0.f;
    for (int g = 0; g < groups; ++g) {
      sb += part[g * n + cc];
      if (kXhat) sg += part[th.n + g * n + cc];
    }
    v[cc] += sb;
    if (kXhat) v2[cc] += sg;
  }
}

// out[m][n] = sum_c d[m][c] w[c][n] for m < rows, n < ci, in 3xTF32 on the
// tensor cores, by the group's warps. d holds d's TF32 hi parts and d_lo
// its lo parts, in shared memory (stride ld_d, 4 mod 32: the A fragment
// loads, 8 rows x 4 neighbouring columns, hit 32 distinct banks; rows up to
// the next multiple of 16 are read and their results dropped). The weight
// comes either (from_wt) from the resident transposed copy wt (ci8 rows of
// stride ld_wt, 8 mod 32, swizzled: B[c][n] = wt[n][c], conflict-free too)
// or as
// w_pad's rows (co, ci_pad) through wbuf in tiles of tk rows (a multiple of
// 8), two buffers of stride ld_w (8 mod 32), the next copied (cp.async)
// while the warps work on the current one; either way split into its TF32
// parts as it is read.
// A warp takes 16 x 8 nj output tiles (nj m16n8k8 column tiles sharing the
// A fragment; nj = 2 when that still gives every warp a tile), up to two
// at a time, and keeps their sums in registers across the weight tiles.
// mask: store where the value already in out is > 0 and 0 elsewhere (a
// ReLU's backward, in place), else store plainly. The two choices are
// arguments, not template parameters: one copy of the code. Every thread
// of `th` must call it; the caller synchronises afterwards.
__device__ void input_grad(const Threads& th, bool mask, bool from_wt,
                           const float* d, const float* d_lo, int ld_d,
                           int rows, const Layer& L, float* out, int ld_out,
                           const float* wbuf) {
  const int ci = L.ci;
  const int co = L.co;
  const int lane = th.tid & 31;
  const int warp = th.tid >> 5;
  const int n_warps = th.n >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mt = (rows + 15) >> 4;
  const int nj = mt * ((ci + 15) >> 4) >= n_warps ? 2 : 1;
  const int tasks = mt * ((ci + 8 * nj - 1) / (8 * nj));
  const int tk = from_wt ? co : L.tk;
  const int n_tiles = (co + tk - 1) / tk;
  for (int base = 0; base < tasks; base += 2 * n_warps) {
    const int task[2] = {base + warp, base + warp + n_warps};
    float acc[2][2][4] = {};
    const bool stage = !from_wt && !(SA_BWD_SKIP & 64);
    if (stage) {
      fused_sa::stage_rows(th, L.w_pad, L.ci_pad, 0, min(tk, co),
                           const_cast<float*>(wbuf), L.ld_w, false);
    }
    for (int tt = 0; tt < n_tiles; ++tt) {
      const int k_base = tt * tk;
      if (!from_wt) {
        if (tt + 1 < n_tiles && stage) {
          fused_sa::stage_rows(
              th, L.w_pad, L.ci_pad, k_base + tk, min(tk, co - k_base - tk),
              const_cast<float*>(wbuf) + ((tt + 1) & 1) * tk * L.ld_w,
              L.ld_w, false);
          tf32::cp_async_wait<1>();
        } else {
          tf32::cp_async_wait<0>();
        }
        th.sync();
      }
      const float* wb = from_wt ? wbuf : wbuf + (tt & 1) * tk * L.ld_w;
      const int cnt = min(tk, co - k_base);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        // the same for the whole warp
        if (task[q] >= tasks || (SA_BWD_SKIP & 32)) continue;
        const int m0 = (task[q] % mt) << 4;
        const int n0 = (task[q] / mt) * 8 * nj;
        const int a0 = (m0 + g) * ld_d + k_base + t;
        for (int kk = 0; kk < cnt; kk += 8) {
          const int a_at[4] = {a0 + kk, a0 + kk + 8 * ld_d, a0 + kk + 4,
                               a0 + kk + 8 * ld_d + 4};
          uint32_t a_hi[4], a_lo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            a_hi[r] = __float_as_uint(d[a_at[r]]);
            a_lo[r] = __float_as_uint(d_lo[a_at[r]]);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j >= nj) break;
            const int n = n0 + 8 * j + g;
            const int k = kk + t;
            // B[k][n] and B[k + 4][n]; past the weight's rows or columns
            // (or the tile's rows) there is none
            float b0 = 0.f;
            float b1 = 0.f;
            if (from_wt) {
              const float* b = wb + n * L.ld_wt;
              if (n < ci && k < cnt) b0 = b[fused_sa::swizzled(n, k)];
              if (n < ci && k + 4 < cnt) b1 = b[fused_sa::swizzled(n, k + 4)];
            } else {
              const float* b = wb + k * L.ld_w + n;
              if (n < L.ci_pad && k < cnt) b0 = b[0];
              if (n < L.ci_pad && k + 4 < cnt) b1 = b[4 * L.ld_w];
            }
            uint32_t b_hi[2], b_lo[2];
            tf32::split(b0, b_hi[0], b_lo[0]);
            tf32::split(b1, b_hi[1], b_lo[1]);
            tf32::mma3(acc[q][j], a_hi, a_lo, b_hi[0], b_hi[1], b_lo[0],
                       b_lo[1]);
          }
        }
      }
      if (!from_wt) th.sync();  // the buffer is refilled two tiles on
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (task[q] >= tasks) continue;
      const int m0 = (task[q] % mt) << 4;
      const int n0 = (task[q] / mt) * 8 * nj;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j >= nj) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + g + (e >> 1) * 8;
          const int n = n0 + 8 * j + 2 * t + (e & 1);
          if (m < rows && n < ci) {
            float* o = out + m * ld_out + n;
            *o = mask ? (*o > 0.f ? acc[q][j][e] : 0.f) : acc[q][j][e];
          }
        }
      }
    }
  }
}

// The recompute's product: the forward's own (fused_sa_common.cuh), on
// the resident weight or streamed tiles of it.
__device__ void recompute(const Threads& th, int store, const float* in,
                          int ld_in, int rows, const Layer& L, float* out,
                          float* wbuf, bool resident) {
  fused_sa::mma_product(th, store, in, ld_in, rows, L.wt, L.bias, L.ci8, L.co,
                        L.co8, out, L.ld, resident ? wbuf + L.res_wt : wbuf,
                        L.ld_wt, L.tile, 2, resident);
}

// The rows [0, rows) x [0, n) of d split for the tensor cores, in place:
// d keeps its TF32 hi parts, lo gets the lo parts. One warp a row.
__device__ void split_rows(const Threads& th, float* d, float* lo, int ld,
                           int n, int rows) {
  for (int k = th.tid >> 5; k < rows; k += th.n >> 5) {
    for (int c = th.tid & 31; c < n; c += 32) {
      uint32_t hi, l;
      tf32::split(d[k * ld + c], hi, l);
      d[k * ld + c] = __uint_as_float(hi);
      lo[k * ld + c] = __uint_as_float(l);
    }
  }
}

// Rows [0, rows) of a shared buffer (stride ld, n real columns) to the
// scratch rows starting at dst (stride n_pad; columns n..n_pad zero). One
// warp a row.
__device__ void write_rows(const Threads& th, const float* src, int ld,
                           int n, int n_pad, int rows,
                           float* __restrict__ dst) {
  for (int k = th.tid >> 5; k < rows; k += th.n >> 5) {
    for (int c = th.tid & 31; c < n_pad; c += 32) {
      dst[k * n_pad + c] = c < n ? src[k * ld + c] : 0.f;
    }
  }
}

// As write_rows, rounded to bf16, the chunk's rows being rows row0.. of the
// scratch: rows 2p and 2p + 1 interleave, element (r, c) at
// (r / 2) 2 n_pad + 2 c + r % 2, so that a 32-bit word holds the two rows
// of one column (K2's bf16 fragments). Two rows a warp.
__device__ void write_rows_bf16(const Threads& th, const float* src, int ld,
                                int n, int n_pad, int rows, size_t row0,
                                __nv_bfloat16* __restrict__ dst) {
  for (int k = 2 * (th.tid >> 5); k < rows; k += 2 * (th.n >> 5)) {
    for (int c = th.tid & 31; c < n_pad; c += 32) {
      for (int j = 0; j < 2 && k + j < rows; ++j) {
        const size_t r = row0 + k + j;
        const float v = c < n ? src[(k + j) * ld + c] : 0.f;
        dst[(r >> 1) * 2 * n_pad + 2 * c + (r & 1)] = __float2bfloat16_rn(v);
      }
    }
  }
}

// The bf16 product on a weight resident at wbuf + res or streamed through
// wbuf (k-tiles of `tile` columns, a double buffer).
__device__ void product_bf16(const Threads& th, int store, const float* in,
                             int ld_in, int rows, const __nv_bfloat16* w,
                             const float* bias, int cip, int co, int cop,
                             float* out, int ld_out, float* wbuf, int res,
                             int tile, bool resident) {
  fused_sa::mma_product_bf16(
      th, store, in, ld_in, rows, w, bias, cip, co, cop, out, ld_out,
      reinterpret_cast<__nv_bfloat16*>(resident ? wbuf + res : wbuf), tile,
      2, resident);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    fused_sa_bwd_kernel(const float* __restrict__ xyz,
                        const float* __restrict__ new_xyz,
                        const float* __restrict__ feats,
                        const int* __restrict__ idx,
                        const float* __restrict__ pooled,
                        const float* __restrict__ d_pooled, int n, int s,
                        int f, int k_nb, int n_queries, Mlp mlp, int need,
                        float* __restrict__ d_xyz,
                        float* __restrict__ d_feats,
                        float* __restrict__ d_new_xyz,
                        float* __restrict__ vec_out) {
  extern __shared__ __align__(16) float smem[];
  const int n_layers = mlp.n_layers;
  const int c_last = mlp.layer[n_layers - 1].co;
  const int chunk = mlp.chunk;
  const bool resident = mlp.resident;
  const int group_size = kThreads / mlp.groups;
  const int group = threadIdx.x / group_size;
  const Threads th{static_cast<int>(threadIdx.x) % group_size, group_size,
                   mlp.groups == 1 ? 0 : 1 + group};
  // the group's own shared memory, then the weights every group reads
  float* own = smem + group * mlp.state;
  float* wbuf = smem + mlp.groups * mlp.state;  // n_wbuf
  int* sel = reinterpret_cast<int*>(own);                   // chunk
  int* avail = sel + chunk;                                 // c_last
  float* stats = reinterpret_cast<float*>(avail + c_last);  // 2 L chunk
  float* vec = stats + 2 * kMaxLayers * chunk;             // n_vec
  float* part = vec + mlp.n_vec;                            // 2 group_size
  float* x_buf = own + head_floats(mlp, c_last);            // chunk ld_x
  // Each layer's buffers as offsets from `own`, so that every pointer is
  // formed from the shared array where it is used: pointers kept in an
  // array indexed by the layer lose their address space, and every access
  // through them becomes a slower generic load or store.
  int h_off[kMaxLayers];   // pre-norm h (LayerNorm) or the activation
  int a_off[kMaxLayers];   // the activation
  int lo_off[kMaxLayers];  // the lo parts of d_pre, split for the mma
  {
    int p = head_floats(mlp, c_last) + chunk * mlp.ld_x;
    for (int l = 0; l < n_layers; ++l) {
      h_off[l] = p;
      if (mlp.layer_norm) p += chunk * mlp.layer[l].ld;
      a_off[l] = p;
      p += chunk * mlp.layer[l].ld;
    }
    // with LayerNorm, h is no longer needed when d_pre is split
    for (int l = 0; l < n_layers; ++l) {
      lo_off[l] = mlp.layer_norm ? h_off[l] : p;
    }
  }
  const int tid = th.tid;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = th.n >> 5;
  const int cin = 3 + f;
  const bool need_in = need != 0;
#ifdef SA_BWD_PHASES
  long long phase_t = clock64();
  unsigned long long phase_cycles[kPhases] = {};
#endif

  // every row buffer zero: padding columns, which the input gradient's
  // fragments read, are never written afterwards
  for (float* p = x_buf + tid; p < own + mlp.state; p += th.n) *p = 0.f;
  if (resident) {
    const Threads block{static_cast<int>(threadIdx.x), kThreads, 0};
    for (int l = 0; l < n_layers; ++l) {
      const Layer& L = mlp.layer[l];
      if constexpr (kBf16) {
        fused_sa::stage_cols_bf16(
            block, L.w16, L.cip, L.cop, 0, L.cip,
            reinterpret_cast<__nv_bfloat16*>(wbuf + L.res16), L.cip + 8);
        fused_sa::stage_cols_bf16(
            block, L.wt16, L.cop, L.cip, 0, L.cop,
            reinterpret_cast<__nv_bfloat16*>(wbuf + L.res16t), L.cop + 8);
      } else {
        fused_sa::stage_rows(block, L.wt, L.co8, 0, L.ci8, wbuf + L.res_wt,
                             L.ld_wt, true);
      }
    }
    tf32::cp_async_wait<0>();
  }
  __syncthreads();

  for (int query = blockIdx.x * mlp.groups + group; query < n_queries;
       query += gridDim.x * mlp.groups) {
    const int b = query / s;
    const float* pts = xyz + static_cast<size_t>(b) * n * 3;
    const float q[3] = {new_xyz[3 * static_cast<size_t>(query)],
                        new_xyz[3 * static_cast<size_t>(query) + 1],
                        new_xyz[3 * static_cast<size_t>(query) + 2]};
    const float* pooled_q = pooled + static_cast<size_t>(query) * c_last;
    const float* dp_q = d_pooled + static_cast<size_t>(query) * c_last;
    th.sync();  // the previous query's slot is written out
    PHASE(8);
    for (int c = tid; c < c_last; c += th.n) avail[c] = 1;
    for (int e = tid; e < mlp.n_vec; e += th.n) vec[e] = 0.f;
    float dq = 0.f;  // threads 0..2: -sum_k d_in[k][tid]

    for (int k0 = 0; k0 < k_nb; k0 += chunk) {
      const int rows = min(chunk, k_nb - k0);
      const size_t row0 = static_cast<size_t>(query) * k_nb + k0;
      th.sync();  // the previous chunk's buffers are no longer read
      PHASE(7);
      for (int k = tid; k < rows; k += th.n) sel[k] = idx[row0 + k];
      th.sync();
      // -- re-gather [x - q ; f] --------------------------------------------
      for (int e = tid; e < rows * cin; e += th.n) {
        const int k = e / cin;
        const int c = e - k * cin;
        const int j = sel[k];
        x_buf[k * mlp.ld_x + c] =
            c < 3 ? pts[3 * j + c] - q[c]
                  : feats[(static_cast<size_t>(b) * n + j) * f + (c - 3)];
      }
      th.sync();
      PHASE(0);
      // -- recompute the forward --------------------------------------------
      for (int l = 0; l < n_layers; ++l) {
        const Layer& L = mlp.layer[l];
        const float* in = l == 0 ? x_buf : own + a_off[l - 1];
        const int ld_in = l == 0 ? mlp.ld_x : mlp.layer[l - 1].ld;
        if (!(SA_BWD_SKIP & 1)) {
          // with LayerNorm the pre-norm h, else the activation
          const int store = mlp.layer_norm ? kStorePlain : kStoreRelu;
          float* out = own + (mlp.layer_norm ? h_off[l] : a_off[l]);
          if constexpr (kBf16) {
            product_bf16(th, store, in, ld_in, rows, L.w16, L.bias, L.cip,
                         L.co, L.cop, out, L.ld, wbuf, L.res16, L.tile16,
                         resident);
          } else {
            recompute(th, store, in, ld_in, rows, L, out, wbuf, resident);
          }
        }
        th.sync();
        PHASE(1);
        if (mlp.layer_norm) {
          float* mu_l = stats + 2 * l * chunk;
          fused_sa::layer_norm_rows(th, own + h_off[l], L.ld, rows, L.co,
                                    L.gamma, L.beta, own + a_off[l], L.ld,
                                    mu_l, mu_l + chunk);
          th.sync();
          PHASE(2);
        }
      }
      // -- max-pool backward: the first winner takes d_pooled -------------
      // The rows are cut into groups; each (row group, channel) finds its
      // first row whose activation reaches the pooled value, and the lowest
      // row group with one holds the chunk's winner, unless an earlier
      // chunk took it.
      {
        const Layer& L = mlp.layer[n_layers - 1];
        float* act = own + a_off[n_layers - 1];
        const int groups = max(1, min(rows, th.n / c_last));
        const int per = (rows + groups - 1) / groups;
        int* first = reinterpret_cast<int*>(part);  // groups x c_last
        int* win = first + th.n;                     // c_last
        for (int e = tid; e < groups * c_last; e += th.n) {
          const int c = e % c_last;
          const int grp = e / c_last;
          const float pc = pooled_q[c];
          const int k1 = min(rows, (grp + 1) * per);
          int fk = rows;
          for (int k = grp * per; k < k1; ++k) {
            if (act[k * L.ld + c] >= pc) {
              fk = k;
              break;
            }
          }
          first[grp * c_last + c] = fk;
        }
        th.sync();
        for (int c = tid; c < c_last; c += th.n) {
          int w = rows;
          for (int g = 0; g < groups && avail[c] && w == rows; ++g) {
            w = first[g * c_last + c];
          }
          win[c] = w;
          if (w < rows) avail[c] = 0;
        }
        th.sync();
        for (int e = tid; e < rows * c_last; e += th.n) {
          const int k = e / c_last;
          const int c = e - k * c_last;
          float* a = act + k * L.ld + c;
          // the ReLU's backward: nothing passes where the activation is 0
          *a = (k == win[c] && *a > 0.f) ? dp_q[c] : 0.f;
        }
      }
      th.sync();
      PHASE(3);
      // -- layers, last to first --------------------------------------------
      for (int l = n_layers - 1; l >= 0; --l) {
        const Layer& L = mlp.layer[l];
        float* d = own + a_off[l];  // d_act, ReLU-masked
        float* v = vec + L.vec;
        if (mlp.layer_norm && !(SA_BWD_SKIP & 8)) {
          const float* mu_l = stats + 2 * l * chunk;
          const float* inv_l = mu_l + chunk;
          const float* h = own + h_off[l];
          // dbeta = sum d_act, dgamma = sum d_act xhat
          column_sums<true>(th, d, h, L.ld, L.co, rows, mu_l, inv_l, part,
                            v + 2 * L.co, v + L.co);
          th.sync();  // the rows below are rewritten in place
          // d_h = inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), in
          // place of the gradient row, two rows a warp at a time
          const float inv_c = 1.f / static_cast<float>(L.co);
          for (int k0w = 2 * warp; k0w < rows; k0w += 2 * n_warps) {
            const int kk[2] = {k0w, min(k0w + 1, rows - 1)};
            float s1[2] = {0.f, 0.f};
            float s2[2] = {0.f, 0.f};
            for (int c = lane; c < L.co; c += 32) {
              const float gm = __ldg(L.gamma + c);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int k = kk[r];
                const float dx = d[k * L.ld + c] * gm;
                s1[r] += dx;
                s2[r] = fmaf(dx, layer_norm_xhat(h[k * L.ld + c], mu_l[k],
                                                 inv_l[k]),
                             s2[r]);
              }
            }
            float m1[2], m2[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              m1[r] = warp_sum(s1[r]) * inv_c;
              m2[r] = warp_sum(s2[r]) * inv_c;
            }
            // an odd last row is its own pair: written once
            const bool two = kk[1] != kk[0];
            for (int c = lane; c < L.co; c += 32) {
              const float gm = __ldg(L.gamma + c);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                if (r == 1 && !two) break;
                const int k = kk[r];
                const float xh =
                    layer_norm_xhat(h[k * L.ld + c], mu_l[k], inv_l[k]);
                const float dx = d[k * L.ld + c] * gm;
                d[k * L.ld + c] = inv_l[k] * (dx - m1[r] - xh * m2[r]);
              }
            }
          }
          th.sync();
          PHASE(4);
        }
        // d is now d_pre: its column sums, and the weight gradient's rows
        if (!(SA_BWD_SKIP & 16)) {
          column_sums<false>(th, d, nullptr, L.ld, L.co, rows, nullptr,
                             nullptr, part, v, nullptr);
        }
        const float* in = l == 0 ? x_buf : own + a_off[l - 1];
        const int ld_in = l == 0 ? mlp.ld_x : mlp.layer[l - 1].ld;
        if (!(SA_BWD_SKIP & 2)) {
          if constexpr (kBf16) {
            write_rows_bf16(th, d, L.ld, L.co, L.co, rows, row0, L.d16);
            write_rows_bf16(th, in, ld_in, L.ci, L.ci_pad, rows, row0,
                            L.in16);
          } else {
            write_rows(th, d, L.ld, L.co, L.co, rows,
                       L.d_rows + row0 * L.co);
            write_rows(th, in, ld_in, L.ci, L.ci_pad, rows,
                       L.in_rows + row0 * L.ci_pad);
          }
        }
        th.sync();
        PHASE(5);
        if ((SA_BWD_SKIP & 4) || (l == 0 && !need_in)) continue;
        float* d_in = l > 0 ? own + a_off[l - 1] : x_buf;
        if constexpr (kBf16) {
          // d_pre (rows, cop) · W: the transposed weight as a (cip, cop)
          // layer without bias
          product_bf16(th, l > 0 ? fused_sa::kStoreMask : kStorePlain, d,
                       L.ld, rows, L.wt16, nullptr, L.cop, 0, L.cip, d_in,
                       ld_in, wbuf, L.res16t, L.tilet, resident);
        } else {
          split_rows(th, d, own + lo_off[l], L.ld, L.co, rows);
          th.sync();
          input_grad(th, l > 0, resident, d, own + lo_off[l], L.ld, rows, L,
                     d_in, ld_in, resident ? wbuf + L.res_wt : wbuf);
        }
        th.sync();
        PHASE(6);
      }
      if (!need_in) continue;
      // -- scatter d_in to the source points --------------------------------
      for (int e = tid; e < rows * cin; e += th.n) {
        const int k = e / cin;
        const int c = e - k * cin;
        float g = x_buf[k * mlp.ld_x + c];
        // bf16: the row rounded, summed in float32
        if constexpr (kBf16) g = __bfloat162float(__float2bfloat16_rn(g));
        const size_t row = static_cast<size_t>(b) * n + sel[k];
        if (c < 3) {
          if (need & kNeedXyz) atomicAdd(d_xyz + row * 3 + c, g);
        } else if (need & kNeedFeats) {
          atomicAdd(d_feats + row * f + (c - 3), g);
        }
      }
      if (tid < 3) {
        for (int k = 0; k < rows; ++k) dq -= x_buf[k * mlp.ld_x + tid];
      }
    }
    if ((need & kNeedNewXyz) && tid < 3) {
      d_new_xyz[3 * static_cast<size_t>(query) + tid] = dq;
    }
    th.sync();
    float* vq = vec_out + static_cast<size_t>(query) * mlp.n_vec;
    for (int e = tid; e < mlp.n_vec; e += th.n) vq[e] = vec[e];
  }
#ifdef SA_BWD_PHASES
  if (threadIdx.x == 0) {
    for (int i = 0; i < kPhases; ++i) {
      atomicAdd(g_phase_cycles + i, phase_cycles[i]);
    }
  }
#endif
}

// The least row stride of at least n floats that is 8 modulo 16 (the bf16
// product's float2 A loads: a half-warp's 4 rows x 4 float2 hit 32 banks).
int stride16(int n) { return ((n - 8 + 15) & ~15) + 8; }

template <bool kBf16>
int launch(const float* xyz, const float* new_xyz, const float* feats,
           const int* idx, const float* pooled, const float* d_pooled, int b,
           int n, int s, int f, int k_nb, int n_layers, const int* chans,
           const void* const* layer_ptrs, int layer_norm, int need,
           float* d_xyz, float* d_feats, float* d_new_xyz, void* scratch,
           float* vec, void* stream) {
  if (b <= 0 || n <= 0 || s <= 0 || k_nb <= 0 || n_layers <= 0 ||
      n_layers > kMaxLayers || chans[0] != 3 + f) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Mlp mlp;
  mlp.n_layers = n_layers;
  mlp.layer_norm = layer_norm;
  // the gathered rows' channels zero-padded to the recompute's k (8; bf16:
  // 16), at a stride of 4 mod 8 (bf16: 8 mod 16), which keeps its A
  // fragments conflict-free too
  mlp.ld_x = kBf16 ? stride16((chans[0] + 15) & ~15)
                   : (((chans[0] + 7) & ~7) + 3) / 8 * 8 + 4;
  mlp.n_vec = 0;
  mlp.ld_max = 0;
  const size_t rows_all = static_cast<size_t>(b) * s * k_nb;
  // bf16 scratch rows go in pairs: an odd last row has a (zero) partner
  const size_t rows_pad = kBf16 ? (rows_all + 1) & ~size_t{1} : rows_all;
  float* p = static_cast<float*>(scratch);
  __nv_bfloat16* p16 = static_cast<__nv_bfloat16*>(scratch);
  int row_floats = mlp.ld_x;  // shared floats per neighbour row
  int w_resident = 0;         // floats of every layer's weights, resident
  int w_full = 0;             // floats of the largest layer, streamed
  int w_min = 0;              // floats of the smallest streamed tiles
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = mlp.layer[l];
    L.wt = nullptr;
    L.w_pad = nullptr;
    L.w16 = nullptr;
    L.wt16 = nullptr;
    if (kBf16) {
      L.w16 = static_cast<const __nv_bfloat16*>(layer_ptrs[5 * l]);
      L.wt16 = static_cast<const __nv_bfloat16*>(layer_ptrs[5 * l + 1]);
    } else {
      L.wt = static_cast<const float*>(layer_ptrs[5 * l]);
      L.w_pad = static_cast<const float*>(layer_ptrs[5 * l + 1]);
    }
    L.bias = static_cast<const float*>(layer_ptrs[5 * l + 2]);
    L.gamma = static_cast<const float*>(layer_ptrs[5 * l + 3]);
    L.beta = static_cast<const float*>(layer_ptrs[5 * l + 4]);
    L.ci = chans[l];
    L.co = chans[l + 1];
    if (L.co % 4 != 0 || L.co > kThreads / kMaxGroups) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    L.ci_pad = (L.ci + 3) & ~3;
    L.ci8 = (L.ci + 7) & ~7;
    L.co8 = (L.co + 7) & ~7;
    L.cip = (L.ci + 15) & ~15;
    L.cop = (L.co + 15) & ~15;
    L.ld = kBf16 ? stride16(L.cop) : row_stride(L.co8);
    L.ld_wt = row_stride(L.co8, 8);
    L.ld_w = row_stride(L.ci_pad, 8);
    L.vec = mlp.n_vec;
    L.d_rows = p;
    L.in_rows = p + rows_all * L.co;
    p += rows_all * (L.co + L.ci_pad);
    L.d16 = p16;
    L.in16 = p16 + rows_pad * L.co;
    p16 += rows_pad * (L.co + L.ci_pad);
    if (kBf16) {
      // both orientations, rows at a stride of k + 8 bf16 values
      L.res16 = w_resident;
      w_resident += L.cop * (L.cip + 8) / 2;
      L.res16t = w_resident;
      w_resident += L.cip * (L.cop + 8) / 2;
      w_full = std::max({w_full, L.cop * (L.cip + 8), L.cip * (L.cop + 8)});
      w_min = std::max({w_min, L.cop * 24, L.cip * 24});
    } else {
      L.res_wt = w_resident;
      w_resident += L.ci8 * L.ld_wt;
      w_full = std::max({w_full, 2 * L.ci8 * L.ld_wt, 2 * L.co8 * L.ld_w});
      w_min = std::max({w_min, 2 * 8 * L.ld_wt, 2 * 8 * L.ld_w});
    }
    mlp.n_vec += L.co * (layer_norm ? 3 : 1);
    mlp.ld_max = std::max(mlp.ld_max, L.ld);
    row_floats += L.ld * (layer_norm ? 2 : 1);
  }
  // the lo parts of d_pre (float32 only; with LayerNorm they take h's place)
  if (!layer_norm && !kBf16) row_floats += mlp.ld_max;
  // The shape: chunks of up to 32 rows; the weights resident (every
  // layer's) for as many thread groups as fit beside them, else one group
  // that streams them through the rest.
  const int limit = static_cast<int>(kSmemPerBlock / sizeof(float));
  const int chunk_max =
      std::min(kMaxChunk, std::max(kMinChunk, (k_nb + 15) & ~15));
  auto state_floats = [&](int groups, int chunk) {
    mlp.groups = groups;
    mlp.chunk = chunk;
    return head_floats(mlp, chans[n_layers]) + chunk * row_floats;
  };
  bool found = false;
  for (int groups = SA_BWD_GROUPS ? SA_BWD_GROUPS : kMaxGroups;
       groups >= 1 && !found; --groups) {
    for (int c = chunk_max; c >= kMinChunk && !found; c /= 2) {
      mlp.state = state_floats(groups, c);
      if (groups * mlp.state + w_resident <= limit) {
        mlp.resident = 1;
        mlp.n_wbuf = w_resident;
        found = true;
      } else if (groups == 1 && mlp.state + w_min <= limit) {
        mlp.resident = 0;
        mlp.n_wbuf = std::min(w_full, limit - mlp.state);
        found = true;
      }
    }
  }
  if (!found) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = mlp.layer[l];
    L.tile = std::min(L.ci8, (mlp.n_wbuf / (2 * L.ld_wt)) & ~7);
    L.tk = std::min((L.co + 7) & ~7, (mlp.n_wbuf / (2 * L.ld_w)) & ~7);
    // bf16: a stage of the double buffer holds n_wbuf bf16 values
    L.tile16 = std::min(L.cip, (mlp.n_wbuf / L.cop - 8) & ~15);
    L.tilet = std::min(L.cop, (mlp.n_wbuf / L.cip - 8) & ~15);
  }
  const size_t smem = sizeof(float) * (mlp.groups * mlp.state + mlp.n_wbuf);
  auto kernel = fused_sa_bwd_kernel<kBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent blocks, one an SM
  int device = 0;
  int n_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_queries = b * s;
  const int grid = std::max(
      1, std::min((n_queries + mlp.groups - 1) / mlp.groups, n_sm));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, feats, idx, pooled, d_pooled, n, s, f, k_nb, n_queries,
      mlp, need, d_xyz, d_feats, d_new_xyz, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs as fused_sa_forward, plus idx (b, s, k) int32 and pooled (b, s, C)
// from it and d_pooled (b, s, C), all contiguous. Layer l reads
// layer_ptrs[5l .. 5l+4] = (wt (ci8, co8), w_pad (co, ci_pad), bias, gamma,
// beta), with chans[l] = ci, chans[l + 1] = co, wt the Dense weight
// transposed and zero-padded to multiples of 8 as the forward takes it,
// ci_pad = ci rounded up to a multiple of 4 (w_pad's columns past ci
// zero); gamma and beta are null when
// layer_norm == 0. Every co is a multiple of 4 and at most 256; wt and w_pad
// are 16-byte aligned. need: bit 0 d_xyz, bit 1 d_new_xyz, bit 2 d_feats;
// what is not asked may be null. The caller zeroes d_xyz (b, n, 3) and
// d_feats (b, n, f); d_new_xyz (b, s, 3) is written. Writes, with R = b s k
// rows:
//   scratch (float32): per layer l in order, d_pre (R, co) then the layer's
//     input (R, ci_pad), pad zero;
//   vec (b s, n_vec): per query, per layer in order, db (co) then, with
//     LayerNorm, dgamma (co) and dbeta (co), each summed over the query's
//     rows.
// Returns a cudaError_t as int (0 = launched).
extern "C" int fused_sa_backward(const float* xyz, const float* new_xyz,
                                 const float* feats, const int* idx,
                                 const float* pooled, const float* d_pooled,
                                 int b, int n, int s, int f, int k_nb,
                                 int n_layers, const int* chans,
                                 const void* const* layer_ptrs, int layer_norm,
                                 int need, float* d_xyz, float* d_feats,
                                 float* d_new_xyz, void* scratch, float* vec,
                                 void* stream) {
  return launch<false>(xyz, new_xyz, feats, idx, pooled, d_pooled, b, n, s, f,
                       k_nb, n_layers, chans, layer_ptrs, layer_norm, need,
                       d_xyz, d_feats, d_new_xyz, scratch, vec, stream);
}

// The bf16 mode: as fused_sa_backward, but layer_ptrs[5l], [5l + 1] are the
// Dense weight (cop, cip) and its transpose (cip, cop), bf16 row-major,
// zero-padded to multiples of 16 (cip, cop: ci and co rounded up to 16),
// and scratch is bf16: per layer l in order, d_pre then the layer's input,
// each over R' = R rounded up to even rows, element (r, c) of a (R', w)
// block at (r / 2) 2 w + 2 c + r % 2 (w = co, then ci_pad); the caller
// zeroes it when R is odd. pooled is the bf16 forward's.
extern "C" int fused_sa_backward_bf16(
    const float* xyz, const float* new_xyz, const float* feats,
    const int* idx, const float* pooled, const float* d_pooled, int b, int n,
    int s, int f, int k_nb, int n_layers, const int* chans,
    const void* const* layer_ptrs, int layer_norm, int need, float* d_xyz,
    float* d_feats, float* d_new_xyz, void* scratch, float* vec,
    void* stream) {
  return launch<true>(xyz, new_xyz, feats, idx, pooled, d_pooled, b, n, s, f,
                      k_nb, n_layers, chans, layer_ptrs, layer_norm, need,
                      d_xyz, d_feats, d_new_xyz, scratch, vec, stream);
}

#ifdef SA_BWD_PHASES
// The phase counters (kPhases of them) to host memory, then zeroed.
extern "C" int sa_bwd_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                         sizeof(g_phase_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kPhases] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
}
#endif
