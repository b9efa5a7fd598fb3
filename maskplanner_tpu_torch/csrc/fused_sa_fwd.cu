// Fused PointNet++ set-abstraction level, forward, for Hopper (sm_90a).
//
// Replaces the forward Pallas kernel of
// maskplanner_tpu/ops/pallas/fused_sa_train.py (`_fsa_train_fwd_raw`, body
// `_fwd_kernel`): for every query point q (an FPS centroid), take the first
// K source points in index order with |x - q|^2 <= r^2, gather the rows
// [x - q ; f] (offsets first, then features), run the shared per-point MLP
// (Dense, then LayerNorm with eps 1e-6 or no norm, then ReLU) on each
// neighbour, and max-pool over the K neighbours. Also writes the selected
// indices. No (B, S, K, C) tensor reaches device memory.
//
// Without the LayerNorm, on Dense weights with an eval-mode BatchNorm folded
// into them, the same kernel also replaces the inference kernel of
// maskplanner_tpu/ops/pallas/fused_sa.py (`_fused_sa_raw`): that kernel
// computes relu(W' h + b') per layer and the max over K, which is this
// kernel's no-norm function (ops/fused_sa.py::fused_set_abstraction).
//
// What bounds it on this card: the MLP's products. At the flagship batch of
// 64 they are about 26 GFLOP at sa1 (1.05 M neighbour rows x 12.5 K MAC)
// and 69 GFLOP at sa2 (0.52 M rows x 65.9 K MAC); on the tensor cores in
// 3xTF32 (three TF32 passes at 495 TFLOP/s) that is 0.16 + 0.42 ms, where
// f32 on the CUDA cores (67 TFLOP/s) needs 1.4 ms. The bytes are small
// (the clouds, the weights, the pooled output). A query's work is a chain
// of short dependent phases (scan, gather, a product and a LayerNorm per
// layer, the max), so latency, not a pipe, sets the time unless many
// queries are in flight.
//
// What the design does about it:
// - The products run on the tensor cores, in 3xTF32 mma.sync m16n8k8
//   (fused_sa_common.cuh::mma_product), as accurate as f32. The backward's
//   recompute (fused_sa_bwd.cu) calls the same device function, and both
//   take the same LayerNorm (layer_norm_rows), so every activation is the
//   same bits in both kernels: the backward routes the max-pool gradient
//   by equality with the pooled value written here. Every layer's input
//   channels are zero-padded to the mma's k of 8 (sa1's 3 to 8, sa2's 131
//   to 136), alike in both kernels.
// - Persistent blocks of 512 threads, one an SM, each on a contiguous range
//   of queries, split into thread groups with their own named barriers,
//   each on its own queries while the other groups are in other phases.
// - The weights sit in shared memory (the padded transpose, at a row
//   stride of 8 mod 32, columns swizzled: fused_sa_common.cuh), and so do
//   the biases, gammas and betas. Where every layer fits beside the groups
//   (sa1: 55 KB) the weights stay resident for the whole kernel, one copy
//   read by four groups of 128 threads, and the shared memory is no larger
//   than that needs, so that L1 keeps the cloud the scans read; else (sa2:
//   266 KB) one group of 512 threads takes two queries (128 rows) at a time
//   and streams the weights in k-tiles through a cp.async double buffer, so
//   that each tile serves both queries' rows.
// - Selection (ball_select.cuh::select_first_k_warp, the indices of
//   group_gather.cu's selection): a warp a query, so a group selects as
//   many queries at once as it has warps; each lane tests 4 points a step
//   with __ballot_sync + __popc, no barrier, the next step's points loaded
//   ahead, and the scan stops as soon as K points are found.
// - The gathered rows and every layer's activations stay in shared
//   memory, in two ping-pong buffers whose row stride is 4 mod 8, so that
//   the A fragments' loads (8 rows x 4 columns) hit distinct banks; the
//   LayerNorm takes 4 rows a warp at a time, in place.
// wgmma, TMA and clusters are later work here. The bf16 mode of the same
// Pallas kernel (precision="default") is fused_sa_fwd_bf16.cu.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>

#include "ball_select.cuh"
#include "fused_sa_common.cuh"

namespace {

using fused_sa::Threads;

constexpr int kThreads = 512;  // a block; one block an SM
constexpr int kMaxGroups = 4;  // thread groups a block, each on its queries
constexpr int kMaxQueries = 2;  // queries a streaming group takes at a time
constexpr int kScanPer = 4;  // points a lane tests in a scan step
constexpr int kMaxLayers = 4;
constexpr size_t kSmemPerBlock = 232448;  // bytes a block may have on Hopper

struct Layer {
  const float* wt;     // (ci8, co8): the Dense weight transposed and padded
  const float* bias;   // (co,)
  const float* gamma;  // (co,) or null without LayerNorm
  const float* beta;   // (co,) or null without LayerNorm
  int ci8;             // input channels, rounded up to the mma's k of 8
  int co;
  int co8;   // output channels, rounded up to 8
  int ldw;   // row stride of the weight in shared memory (8 mod 32)
  int tile;  // weight rows of a streamed tile
  int res;   // resident: the offset of this layer's weight in the buffer
  int vec;   // offset of its bias (co8, zero past co), gamma, beta (co)
};

struct Mlp {
  Layer layer[kMaxLayers];
  int n_layers;
  int layer_norm;
  int ld_a;      // row stride of buffer a (even layers' inputs)
  int ld_b;      // and of buffer b (odd layers' inputs)
  int q;         // queries a group runs through the MLP at a time
  int qs;        // queries a group selects at a time (a multiple of q)
  int rows16;    // q K rows, rounded up to 16
  int groups;    // thread groups a block
  int state;     // floats of a group's own shared memory
  int n_wbuf;    // floats of the weight buffer
  int n_vec;     // floats of the layers' bias, gamma and beta
  int resident;  // every layer's weight stays in the weight buffer
  int stages;    // streamed: tiles in the weight buffer's ring (2 or 3)
};

// Floats before a group's row buffers: qs K indices, rounded up to 4.
__host__ __device__ int head_floats(const Mlp& mlp, int k_nb) {
  return (mlp.qs * k_nb + 3) & ~3;
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
    fused_sa_fwd_kernel(const float* __restrict__ xyz,
                        const float* __restrict__ new_xyz,
                        const float* __restrict__ feats, int n, int s,
                        int f, int k_nb, float radius2, int n_queries,
                        Mlp mlp, float* __restrict__ pooled,
                        int* __restrict__ idx_out) {
  extern __shared__ __align__(16) float smem[];
  // a group is consecutive warps, spread over the SM's four schedulers
  // (one scheduler a group measured slower)
  const int group_size = kThreads / mlp.groups;
  const int group = threadIdx.x / group_size;
  const Threads th{static_cast<int>(threadIdx.x) % group_size, group_size,
                   mlp.groups == 1 ? 0 : 1 + group};
  // the weights every group reads, then each group's own shared memory
  float* wbuf = smem;
  float* vec = smem + mlp.n_wbuf;
  float* own = vec + mlp.n_vec + group * mlp.state;
  int* sel = reinterpret_cast<int*>(own);  // qs K
  const int a_off = head_floats(mlp, k_nb);       // buffer a
  const int b_off = a_off + mlp.rows16 * mlp.ld_a;  // buffer b
  const int tid = th.tid;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = th.n >> 5;
  const int cin = 3 + f;
  const int ci8 = mlp.layer[0].ci8;
  const int c_last = mlp.layer[mlp.n_layers - 1].co;
  // lanes a gathered row: its channels rounded up to a power of 2, at most 32
  int span = 1;
  while (span < 32 && span < ci8) span *= 2;
  constexpr bool resident = kResident;

  // the row buffers zero: the rows past q K up to the next 16, which the
  // products read, are never written afterwards; the layers' vectors and,
  // resident, the weights to shared memory
  for (int e = tid; e < mlp.state - a_off; e += th.n) own[a_off + e] = 0.f;
  for (int l = 0; l < mlp.n_layers; ++l) {
    const Layer& L = mlp.layer[l];
    for (int c = threadIdx.x; c < L.co8; c += kThreads) {
      vec[L.vec + c] = c < L.co ? L.bias[c] : 0.f;
      if (mlp.layer_norm && c < L.co) {
        vec[L.vec + L.co8 + c] = L.gamma[c];
        vec[L.vec + L.co8 + L.co + c] = L.beta[c];
      }
    }
  }
  if (resident) {
    const Threads block{static_cast<int>(threadIdx.x), kThreads, 0};
    for (int l = 0; l < mlp.n_layers; ++l) {
      const Layer& L = mlp.layer[l];
      fused_sa::stage_rows(block, L.wt, L.co8, 0, L.ci8, wbuf + L.res, L.ldw,
                           true);
    }
    tf32::cp_async_wait<0>();
  }
  __syncthreads();

  // a block takes a contiguous range of sets of qs queries, its groups in
  // turn: the groups work on the same cloud, which stays in L1 for the
  // scans
  const int n_sets = (n_queries + mlp.qs - 1) / mlp.qs;
  const int set_end = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * n_sets / gridDim.x);
  for (int set = static_cast<int>(static_cast<long long>(blockIdx.x) *
                                  n_sets / gridDim.x) + group;
       set < set_end; set += mlp.groups) {
    const int qs0 = set * mlp.qs;
    const int nqs = min(mlp.qs, n_queries - qs0);
    th.sync();  // the previous set's rows and indices are no longer read
    // -- selection: the first k_nb in-radius points in ascending index, a
    // warp a query ----------------------------------------------------------
    for (int j = warp; j < nqs; j += n_warps) {
      const size_t query = static_cast<size_t>(qs0 + j);
      if (SA_BWD_SKIP & 512) {  // timing studies: the first K points
        for (int k = lane; k < k_nb; k += 32) {
          sel[j * k_nb + k] = k % n;
          idx_out[query * k_nb + k] = k % n;
        }
        continue;
      }
      ball_select::select_first_k_warp<kScanPer>(
          xyz + (query / s) * n * 3, n, new_xyz[3 * query],
          new_xyz[3 * query + 1], new_xyz[3 * query + 2], radius2, k_nb,
          sel + j * k_nb, idx_out + query * k_nb);
    }
    th.sync();
    for (int j0 = 0; j0 < nqs; j0 += mlp.q) {
      const int q0 = qs0 + j0;
      const int nq = min(mlp.q, nqs - j0);
      const int rows = nq * k_nb;
      if (j0 > 0) th.sync();  // the previous queries' rows are pooled
      // -- gather [x - q ; f ; 0] into buffer a: `span` lanes a row, on
      // consecutive channels, so that a row's indices are worked out once
      for (int m = warp * (32 / span) + lane / span; m < rows;
           m += n_warps * (32 / span)) {
        const int query = q0 + m / k_nb;
        const size_t row = (static_cast<size_t>(query) / s) * n +
                           sel[j0 * k_nb + m];
        float* dst = own + a_off + m * mlp.ld_a;
        for (int c = lane % span; c < ci8; c += span) {
          float v = 0.f;
          if (c < 3) {
            v = xyz[row * 3 + c] -
                new_xyz[3 * static_cast<size_t>(query) + c];
          } else if (c < cin) {
            v = feats[row * f + (c - 3)];
          }
          dst[c] = v;
        }
      }
      th.sync();

      // -- the MLP, activations ping-ponging between buffers a and b -------
      int cur = a_off;
      int ld_cur = mlp.ld_a;
      int nxt = b_off;
      int ld_nxt = mlp.ld_b;
      for (int l = 0; l < mlp.n_layers; ++l) {
        const Layer& L = mlp.layer[l];
        const int store =
            mlp.layer_norm ? fused_sa::kStorePlain : fused_sa::kStoreRelu;
        float* w_at = resident ? wbuf + L.res : wbuf;
        fused_sa::mma_product(th, store, own + cur, ld_cur, rows, L.wt,
                              vec + L.vec, L.ci8, L.co, L.co8, own + nxt,
                              ld_nxt, w_at, L.ldw, L.tile, mlp.stages,
                              resident);
        th.sync();
        if (mlp.layer_norm && !(SA_BWD_SKIP & 256)) {
          fused_sa::layer_norm_rows(
              th, own + nxt, ld_nxt, rows, L.co, vec + L.vec + L.co8,
              vec + L.vec + L.co8 + L.co, own + nxt, ld_nxt, nullptr,
              nullptr);
          th.sync();
        }
        const int t_off = cur;
        cur = nxt;
        nxt = t_off;
        const int t_ld = ld_cur;
        ld_cur = ld_nxt;
        ld_nxt = t_ld;
      }

      // -- max over each query's neighbours --------------------------------
      for (int e = tid; e < nq * c_last; e += th.n) {
        const int j = e / c_last;
        const int c = e - j * c_last;
        const float* col = own + cur + j * k_nb * ld_cur + c;
        float m = -INFINITY;
        for (int k = 0; k < k_nb; ++k) m = fmaxf(m, col[k * ld_cur]);
        pooled[static_cast<size_t>(q0 + j) * c_last + c] = m;
      }
    }
  }
}

// The least stride of at least n floats that is r modulo `mod`.
int stride(int n, int r, int mod) { return (n - r + mod - 1) / mod * mod + r; }

int launch(const float* xyz, const float* new_xyz, const float* feats, int b,
           int n, int s, int f, int k_nb, float radius2, int n_layers,
           const int* chans, const void* const* layer_ptrs, int layer_norm,
           float* pooled, int* idx, void* stream) {
  if (b <= 0 || n <= 0 || s <= 0 || k_nb <= 0 || n_layers <= 0 ||
      n_layers > kMaxLayers || chans[0] != 3 + f) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the mma's k: channels pad to it, inputs and outputs alike
  constexpr int kPad = 8;
  auto pad = [](int c) { return (c + kPad - 1) / kPad * kPad; };
  // floats of a weight tile of k rows, and the widest tile that fits in
  // `floats`
  auto tile_floats = [](const Layer& L, int k) { return k * L.ldw; };
  auto tile_of = [](const Layer& L, int floats) {
    return (floats / L.ldw) & ~7;
  };
  Mlp mlp;
  mlp.n_layers = n_layers;
  mlp.layer_norm = layer_norm;
  // buffer a holds the inputs of even layers, buffer b those of odd ones
  int width_a = pad(chans[0]);
  int width_b = 0;
  int w_resident = 0;  // floats of every layer's weight, resident
  mlp.n_vec = 0;
  int tile_max = 0;  // floats of the largest tile of kPad rows or columns
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = mlp.layer[l];
    L.wt = static_cast<const float*>(layer_ptrs[4 * l]);
    L.bias = static_cast<const float*>(layer_ptrs[4 * l + 1]);
    L.gamma = static_cast<const float*>(layer_ptrs[4 * l + 2]);
    L.beta = static_cast<const float*>(layer_ptrs[4 * l + 3]);
    L.ci8 = pad(chans[l]);
    L.co = chans[l + 1];
    L.co8 = pad(L.co);
    if (L.co % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    L.ldw = stride(L.co8, 8, 32);
    L.res = w_resident;
    w_resident += tile_floats(L, L.ci8);
    L.vec = mlp.n_vec;
    mlp.n_vec += L.co8 + (layer_norm ? 2 * L.co : 0);
    tile_max = std::max(tile_max, tile_floats(L, kPad));
    int& width = l % 2 == 0 ? width_b : width_a;
    width = std::max(width, L.co8);
  }
  // the A fragments' loads (8 rows x 4 floats) hit distinct banks
  mlp.ld_a = stride(width_a, 4, 8);
  mlp.ld_b = stride(width_b, 4, 8);
  auto state_floats = [&](int q, int qs) {
    mlp.q = q;
    mlp.qs = qs;
    mlp.rows16 = (q * k_nb + 15) & ~15;
    return (head_floats(mlp, k_nb) +
            mlp.rows16 * (mlp.ld_a + mlp.ld_b) + 3) & ~3;
  };
  // persistent blocks, one an SM
  int device = 0;
  int n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_queries = b * s;
  // queries for each group of every block, at most (a small batch spreads
  // over the SMs before it fills their groups)
  const int per_group = std::max(1, n_queries / n_sm);
  // The shape: the weights resident for as many groups as fit beside them
  // (one query a group at a time through the MLP, up to one a warp
  // selected at a time), else one group that streams them and takes as
  // many queries at a time as fit beside two tiles of kPad rows.
  mlp.n_vec = (mlp.n_vec + 3) & ~3;
  const int limit =
      static_cast<int>(kSmemPerBlock / sizeof(float)) - mlp.n_vec;
  bool found = false;
  for (int groups = kMaxGroups; groups >= 1 && !found; groups /= 2) {
    mlp.groups = groups;
    // each warp of a group selects for its own query
    mlp.state = state_floats(
        1, std::min(kThreads / 32 / groups, std::max(1, per_group / groups)));
    if (w_resident + groups * mlp.state <= limit) {
      mlp.resident = 1;
      mlp.n_wbuf = w_resident;
      found = true;
    }
  }
  for (int q = std::min(kMaxQueries, per_group); q >= 1 && !found; --q) {
    mlp.groups = 1;
    mlp.state = state_floats(q, q);
    if (mlp.state + 2 * tile_max <= limit) {
      mlp.resident = 0;
      mlp.n_wbuf = limit - mlp.state;
      found = true;
    }
  }
  if (!found) return static_cast<int>(cudaErrorInvalidValue);
  // streamed: three tiles of at least kPad rows in flight where they fit
  mlp.stages = mlp.n_wbuf >= 3 * tile_max ? 3 : 2;
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = mlp.layer[l];
    L.tile = mlp.resident
                 ? L.ci8
                 : std::min(L.ci8, tile_of(L, mlp.n_wbuf / mlp.stages));
  }
  if (!mlp.resident) {  // the weight buffer as large as its largest use
    int used = 0;
    for (int l = 0; l < n_layers; ++l) {
      const Layer& L = mlp.layer[l];
      used = std::max(used, mlp.stages * tile_floats(L, L.tile));
    }
    mlp.n_wbuf = used;
  }
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(mlp.n_wbuf) + mlp.n_vec +
                       mlp.groups * mlp.state);
  auto kernel = mlp.resident ? fused_sa_fwd_kernel<true>
                             : fused_sa_fwd_kernel<false>;
  // no more shared memory than the block needs: the rest stays L1, which
  // holds the cloud that the groups' scans read again and again (set when
  // it changes: a call costs host time at small batches)
  constexpr int kDevices = 16;  // devices whose setting is remembered
  static size_t smem_set[kDevices][2] = {};
  size_t unknown = 0;
  size_t& set =
      device < kDevices ? smem_set[device][mlp.resident] : unknown;
  if (set != smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          static_cast<int>((smem * 100 + kSmemPerBlock - 1) /
                           kSmemPerBlock));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    set = smem;
  }
  const int n_sets = (n_queries + mlp.qs - 1) / mlp.qs;
  const int grid = std::max(
      1, std::min((n_sets + mlp.groups - 1) / mlp.groups, n_sm));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, feats, n, s, f, k_nb, radius2, n_queries, mlp, pooled,
      idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz (b, n, 3), new_xyz (b, s, 3), feats (b, n, f) or null when f == 0, all
// f32 contiguous. Layer l reads layer_ptrs[4l .. 4l+3] = (wt, bias, gamma,
// beta) with chans[l] = ci, chans[l + 1] = co: wt is (ci8, co8) row-major,
// the Dense weight transposed and zero-padded to multiples of 8 (16-byte
// aligned); gamma/beta are null when layer_norm == 0. Every co is a
// multiple of 4. Writes pooled (b, s, chans[n_layers]) f32 and idx (b, s, k)
// int32. Returns a cudaError_t as int (0 = launched).
extern "C" int fused_sa_forward(const float* xyz, const float* new_xyz,
                                const float* feats, int b, int n, int s,
                                int f, int k_nb, float radius2, int n_layers,
                                const int* chans, const void* const* layer_ptrs,
                                int layer_norm, float* pooled, int* idx,
                                void* stream) {
  return launch(xyz, new_xyz, feats, b, n, s, f, k_nb, radius2, n_layers,
                chans, layer_ptrs, layer_norm, pooled, idx, stream);
}
