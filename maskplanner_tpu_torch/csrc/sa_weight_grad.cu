// Weight gradients of a fused PointNet++ set-abstraction level, for Hopper
// (sm_90a): the second of the level's two backward kernels (K2). With
// fused_sa_bwd.cu (K1) it replaces the backward Pallas kernel of
// maskplanner_tpu/ops/pallas/fused_sa_train.py (`_fsa_train_bwd_raw`),
// whose weight gradients the TPU sums in VMEM scratch over its sequential
// grid.
//
// From K1's scratch rows, for each layer: dW = sum_rows d_preᵀ · in
// (co x ci, over all R = B S K neighbour rows), and from K1's per-query
// slots db, dgamma and dbeta summed over the queries.
//
// What bounds it on this card: reading the scratch rows once (388 floats a
// row at sa1, 900 at sa2: 1.63 GB and 1.89 GB at the flagship batch of 64,
// about 0.5 ms each at 3.35 TB/s); the products (26 and 69 GFLOP, three
// TF32 passes each) are far below the tensor cores' rate.
//
// What the design does about it, and why the sums are the same bits from
// run to run: a split-K product in three launches, all from one call.
//   1. dw_partial: one block per (64 x 64 output tile of one layer, row
//      split). The rows are cut into a number of splits fixed by the
//      caller (ops/cuda/fused_sa.py: 8192 rows a split); a block runs over
//      its split in 32-row steps, the two operand tiles double-buffered in
//      shared memory by cp.async, and its 4 warps (32 x 32 each) accumulate
//      in registers with mma.sync m16n8k8 in 3xTF32 (tf32_mma.cuh),
//      splitting operands into their TF32 parts as they load them (split
//      once into shared memory instead, the kernel was slower); the
//      split's partial goes to its own slot. The tile index runs fastest, so the blocks of
//      one split, which read the same rows, run together and share them
//      through L2.
//   2. vec_partial: one thread per (vec column, split of the queries) sums
//      the queries' slots in order.
//   3. finish: every output is the sum of its partials in split order.
// No atomic, and the order of every addition is fixed by the shapes alone.
//
// The bf16 mode (sa_weight_grad_bf16) is the weight gradient of the Pallas
// kernel's precision="default": dW = sum_rows bf16(d_pre)ᵀ · bf16(in),
// summed in float32. K1's bf16 mode (fused_sa_bwd_bf16.cu) writes the rows
// already rounded, two rows interleaved (a 32-bit word holds rows 2p and
// 2p + 1 of one column), so a
// word staged in shared memory is an m16n8k16 bf16 fragment register as it
// is: dw_partial_bf16 is dw_partial with half the bytes to read, one bf16
// mma a k-step of 16 rows and no TF32 split, over the same splits in the
// same order, so its sums are the same bits from run to run too.

#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kMaxLayers = 4;
constexpr int kTile = 64;      // output tile (co x ci) of a block
constexpr int kStep = 32;      // rows a block stages at a time
constexpr int kLds = kTile + 8;  // 8 mod 32: conflict-free fragment loads
constexpr int kThreadsDw = 128;
constexpr int kThreadsVec = 128;

struct DwLayer {
  const float* d;   // (R, co): d_pre (bf16 mode: bf16 in row pairs)
  const float* x;   // (R, ci_pad): the layer's input (likewise)
  int co;
  int ci;
  int ci_pad;
  int mt;     // tiles along co
  int tile0;  // first tile of this layer in the level's tile list
  int out;    // offset of dW (co, ci) in an output slot
};

struct DwArgs {
  DwLayer layer[kMaxLayers];
  int n_layers;
  int n_tiles;
};

__global__ void __launch_bounds__(kThreadsDw)
    dw_partial(DwArgs args, long long rows, long long split_rows,
               float* __restrict__ part, int slot) {
  __shared__ __align__(16) float a_s[2][kStep][kLds];  // d rows: k x m
  __shared__ __align__(16) float b_s[2][kStep][kLds];  // x rows: k x n
  const int tile = blockIdx.x % args.n_tiles;
  const int split = blockIdx.x / args.n_tiles;
  int li = 0;
  while (li + 1 < args.n_layers && tile >= args.layer[li + 1].tile0) ++li;
  const DwLayer L = args.layer[li];
  const int m0 = ((tile - L.tile0) % L.mt) * kTile;
  const int n0 = ((tile - L.tile0) / L.mt) * kTile;
  const long long r_begin = split * split_rows;
  const long long r_end = min(rows, r_begin + split_rows);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp & 1) * 32;
  const int wn = (warp >> 1) * 32;

  auto stage = [&](int buf, long long r0) {
    for (int q = tid; q < kStep * (kTile / 4); q += kThreadsDw) {
      const int k = q / (kTile / 4);
      const int c = (q % (kTile / 4)) * 4;
      const long long r = r0 + k;
      const bool row_ok = r < r_end;
      const bool a_ok = row_ok && m0 + c < L.co;
      const bool b_ok = row_ok && n0 + c < L.ci_pad;
      tf32::cp_async16(&a_s[buf][k][c],
                       a_ok ? L.d + r * L.co + m0 + c : L.d, a_ok);
      tf32::cp_async16(&b_s[buf][k][c],
                       b_ok ? L.x + r * L.ci_pad + n0 + c : L.x, b_ok);
    }
    tf32::cp_async_commit();
  };

  float acc[2][4][4] = {};
  int buf = 0;
  if (r_begin < r_end) stage(0, r_begin);
  for (long long r0 = r_begin; r0 < r_end; r0 += kStep) {
    if (r0 + kStep < r_end) {
      stage(buf ^ 1, r0 + kStep);
      tf32::cp_async_wait<1>();
    } else {
      tf32::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kStep; k0 += 8) {
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm + 16 * i + g;
        tf32::split(a_s[buf][k0 + t][m], a_hi[i][0], a_lo[i][0]);
        tf32::split(a_s[buf][k0 + t][m + 8], a_hi[i][1], a_lo[i][1]);
        tf32::split(a_s[buf][k0 + t + 4][m], a_hi[i][2], a_lo[i][2]);
        tf32::split(a_s[buf][k0 + t + 4][m + 8], a_hi[i][3], a_lo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 8 * j + g;
        uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
        tf32::split(b_s[buf][k0 + t][n], b0_hi, b0_lo);
        tf32::split(b_s[buf][k0 + t + 4][n], b1_hi, b1_lo);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tf32::mma3(acc[i][j], a_hi[i], a_lo[i], b0_hi, b1_hi, b0_lo,
                     b1_lo);
        }
      }
    }
    __syncthreads();  // the buffer is refilled two steps on
    buf ^= 1;
  }

  float* out = part + static_cast<size_t>(split) * slot + L.out;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + 16 * i + g + (e >> 1) * 8;
        const int n = n0 + wn + 8 * j + 2 * t + (e & 1);
        if (m < L.co && n < L.ci) out[m * L.ci + n] = acc[i][j][e];
      }
    }
  }
}

// dw_partial on bf16 scratch rows: a (R', w) block of 32-bit words, word
// (p, c) holding rows 2p (low half) and 2p + 1 of column c. A step stages
// kStep rows, kStep / 2 words deep; the A fragment (m = co, k = rows) and
// the B fragment (k = rows, n = ci) are single words of the staged tiles.
__global__ void __launch_bounds__(kThreadsDw)
    dw_partial_bf16(DwArgs args, long long rows, long long split_rows,
                    float* __restrict__ part, int slot) {
  constexpr int kPairs = kStep / 2;
  __shared__ __align__(16) uint32_t a_s[2][kPairs][kLds];  // d: k x m
  __shared__ __align__(16) uint32_t b_s[2][kPairs][kLds];  // x: k x n
  const int tile = blockIdx.x % args.n_tiles;
  const int split = blockIdx.x / args.n_tiles;
  int li = 0;
  while (li + 1 < args.n_layers && tile >= args.layer[li + 1].tile0) ++li;
  const DwLayer L = args.layer[li];
  const uint32_t* d = reinterpret_cast<const uint32_t*>(L.d);
  const uint32_t* x = reinterpret_cast<const uint32_t*>(L.x);
  const int m0 = ((tile - L.tile0) % L.mt) * kTile;
  const int n0 = ((tile - L.tile0) / L.mt) * kTile;
  // pairs of rows; an odd last row's partner is zero
  const long long p_begin = split * split_rows / 2;
  const long long p_end = min((rows + 1) / 2, p_begin + split_rows / 2);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp & 1) * 32;
  const int wn = (warp >> 1) * 32;

  auto stage = [&](int buf, long long q0) {
    for (int q = tid; q < kPairs * (kTile / 4); q += kThreadsDw) {
      const int k = q / (kTile / 4);
      const int c = (q % (kTile / 4)) * 4;
      const long long pr = q0 + k;
      const bool row_ok = pr < p_end;
      const bool a_ok = row_ok && m0 + c < L.co;
      const bool b_ok = row_ok && n0 + c < L.ci_pad;
      tf32::cp_async16(&a_s[buf][k][c], a_ok ? d + pr * L.co + m0 + c : d,
                       a_ok);
      tf32::cp_async16(&b_s[buf][k][c],
                       b_ok ? x + pr * L.ci_pad + n0 + c : x, b_ok);
    }
    tf32::cp_async_commit();
  };

  float acc[2][4][4] = {};
  int buf = 0;
  if (p_begin < p_end) stage(0, p_begin);
  for (long long q0 = p_begin; q0 < p_end; q0 += kPairs) {
    if (q0 + kPairs < p_end) {
      stage(buf ^ 1, q0 + kPairs);
      tf32::cp_async_wait<1>();
    } else {
      tf32::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kPairs; k0 += 8) {  // k-steps of 16 rows
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm + 16 * i + g;
        a[i][0] = a_s[buf][k0 + t][m];
        a[i][1] = a_s[buf][k0 + t][m + 8];
        a[i][2] = a_s[buf][k0 + t + 4][m];
        a[i][3] = a_s[buf][k0 + t + 4][m + 8];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 8 * j + g;
        const uint32_t b0 = b_s[buf][k0 + t][n];
        const uint32_t b1 = b_s[buf][k0 + t + 4][n];
#pragma unroll
        for (int i = 0; i < 2; ++i) bf16::mma(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();  // the buffer is refilled two steps on
    buf ^= 1;
  }

  float* out = part + static_cast<size_t>(split) * slot + L.out;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + 16 * i + g + (e >> 1) * 8;
        const int n = n0 + wn + 8 * j + 2 * t + (e & 1);
        if (m < L.co && n < L.ci) out[m * L.ci + n] = acc[i][j][e];
      }
    }
  }
}

// part[split][vec_off + v] = sum over the split's queries, in order, of
// vec[q][v].
__global__ void __launch_bounds__(kThreadsVec)
    vec_partial(const float* __restrict__ vec, int queries, int n_vec,
                int split_queries, float* __restrict__ part, int slot,
                int vec_off) {
  const int v = blockIdx.x * kThreadsVec + threadIdx.x;
  if (v >= n_vec) return;
  const int q0 = blockIdx.y * split_queries;
  const int q1 = min(queries, q0 + split_queries);
  float s = 0.f;
  for (int q = q0; q < q1; ++q) s += vec[static_cast<size_t>(q) * n_vec + v];
  part[static_cast<size_t>(blockIdx.y) * slot + vec_off + v] = s;
}

// out[o] = sum over the splits, in order, of part[split][o].
__global__ void __launch_bounds__(256)
    finish(const float* __restrict__ part, int slot, int splits,
           float* __restrict__ out) {
  const int o = blockIdx.x * 256 + threadIdx.x;
  if (o >= slot) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += part[static_cast<size_t>(p) * slot + o];
  out[o] = s;
}

template <bool kBf16>
int launch(const void* scratch, const float* vec, long long rows, int queries,
           int n_layers, const int* chans, int layer_norm, int splits,
           float* part, float* out, void* stream) {
  if (rows <= 0 || queries <= 0 || n_layers <= 0 ||
      n_layers > kMaxLayers || splits <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  DwArgs args;
  args.n_layers = n_layers;
  args.n_tiles = 0;
  // a layer's block of rows: float32, or bf16 in pairs (halves of a float)
  const float* p = static_cast<const float*>(scratch);
  const long long block_rows = kBf16 ? (rows + 1) / 2 : rows;
  int slot = 0;
  int n_vec = 0;
  for (int l = 0; l < n_layers; ++l) {
    DwLayer& L = args.layer[l];
    L.co = chans[l + 1];
    L.ci = chans[l];
    L.ci_pad = (L.ci + 3) & ~3;
    if (L.co % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    L.d = p;
    p += block_rows * L.co;
    L.x = p;
    p += block_rows * L.ci_pad;
    L.mt = (L.co + kTile - 1) / kTile;
    L.tile0 = args.n_tiles;
    args.n_tiles += L.mt * ((L.ci_pad + kTile - 1) / kTile);
    L.out = slot;
    slot += L.co * L.ci;
    n_vec += L.co * (layer_norm ? 3 : 1);
  }
  const int vec_off = slot;
  slot += n_vec;
  const long long split_rows = ((rows + splits - 1) / splits + kStep - 1) /
                               kStep * kStep;
  const int split_queries = (queries + splits - 1) / splits;
  auto dw = kBf16 ? dw_partial_bf16 : dw_partial;
  dw<<<args.n_tiles * splits, kThreadsDw, 0, st>>>(args, rows, split_rows,
                                                    part, slot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  vec_partial<<<dim3((n_vec + kThreadsVec - 1) / kThreadsVec, splits),
                kThreadsVec, 0, st>>>(vec, queries, n_vec, split_queries,
                                      part, slot, vec_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish<<<(slot + 255) / 256, 256, 0, st>>>(part, slot, splits, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch and vec as fused_sa_backward writes them (rows = b s k
// neighbour rows, queries = b s); chans[0..n_layers] the level's widths.
// Writes out, one slot of floats: per layer in order dW (co, ci), then the
// vec columns (per layer db, and with LayerNorm dgamma, dbeta). part is
// workspace of splits x slot floats, splits >= 1; the rows are cut into
// splits of ceil(rows / splits) rounded up to 32, the queries into splits
// of ceil(queries / splits). Returns a cudaError_t as int (0 = launched).
extern "C" int sa_weight_grad(const void* scratch, const float* vec,
                              long long rows, int queries, int n_layers,
                              const int* chans, int layer_norm, int splits,
                              float* part, float* out, void* stream) {
  return launch<false>(scratch, vec, rows, queries, n_layers, chans,
                       layer_norm, splits, part, out, stream);
}

// The bf16 mode: scratch as fused_sa_backward_bf16 writes it (bf16 rows in
// pairs); dW sums the bf16 products in float32.
extern "C" int sa_weight_grad_bf16(const void* scratch, const float* vec,
                                   long long rows, int queries, int n_layers,
                                   const int* chans, int layer_norm,
                                   int splits, float* part, float* out,
                                   void* stream) {
  return launch<true>(scratch, vec, rows, queries, n_layers, chans,
                      layer_norm, splits, part, out, stream);
}
