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
// What bounds it on this card: f32 arithmetic on the CUDA cores. At the
// flagship batch of 64 the MLP costs about 26 GFLOP at sa1 (1.05 M
// neighbour rows x 12.5 K MAC) and 69 GFLOP at sa2 (0.52 M rows x 65.9 K
// MAC), against 67 TFLOP/s of f32 outside the tensor cores; the bytes are
// small (the clouds, the weights, the pooled output). The plain version
// instead writes about 0.5 GB of activations per level to device memory.
//
// What the design does about it: one block per query. Selection: each warp
// tests 32 consecutive points, __ballot_sync + __popc give every in-radius
// point its rank, the warps' ballots are summed in shared memory so the
// block takes 32 * warps points per round in index order, and the scan
// stops as soon as K points are found. The gathered rows and every layer's
// activations stay in shared memory, in two ping-pong buffers whose row
// stride is odd so that lanes reading different rows hit different banks.
// A thread computes a tile of 4 neighbours x 4 output channels, 16
// accumulators fed per input channel by 4 shared-memory reads and one
// float4 of weights; the weights are read transposed, (C_in, C_out),
// through the read-only path, and the lanes of a warp share few float4s
// (they differ mostly in the neighbour), so a load serves many lanes. The
// first cut, one neighbour x 4 channels a thread, ran sa2 at 20.7 ms, slower
// than the plain version (11.1 ms, H100 at 700 W). sa2's f32 weights
// (264 KB) do not fit in shared memory and are never staged there; one
// layer's weights stay in L1/L2 while the block runs it. The widest
// activation buffer (sa2: 64 x 257 floats) needs dynamic shared memory
// above 48 KB. Tensor cores (TF32/bf16 wgmma) and several queries per block
// are later work.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxLayers = 4;
constexpr int kThreads = 256;
constexpr int kRows = 4;  // neighbour rows per thread in the layer products
constexpr float kLayerNormEps = 1e-6f;

struct Layer {
  const float* wt;     // (ci, co) row-major: the Dense weight transposed
  const float* bias;   // (co,)
  const float* gamma;  // (co,) or null without LayerNorm
  const float* beta;   // (co,) or null without LayerNorm
  int ci;
  int co;
};

struct Mlp {
  Layer layer[kMaxLayers];
  int n_layers;
  int layer_norm;
};

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float x, float y, float z) {
  const float dx = __fsub_rn(qx, x);
  const float dy = __fsub_rn(qy, y);
  const float dz = __fsub_rn(qz, z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    fused_sa_fwd_kernel(const float* __restrict__ xyz,
                        const float* __restrict__ new_xyz,
                        const float* __restrict__ feats, int n, int s,
                        int f, int k_nb, float radius2, Mlp mlp, int ld_a,
                        int ld_b, float* __restrict__ pooled,
                        int* __restrict__ idx_out) {
  extern __shared__ float smem[];
  int* sel = reinterpret_cast<int*>(smem);               // k_nb
  unsigned* ballots = reinterpret_cast<unsigned*>(sel + k_nb);  // 32
  float* buf_a = reinterpret_cast<float*>(ballots + 32);  // k_nb * ld_a
  float* buf_b = buf_a + k_nb * ld_a;                     // k_nb * ld_b

  const int query = blockIdx.x;  // b * s + j
  const int b = query / s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  const float qx = new_xyz[3 * static_cast<size_t>(query)];
  const float qy = new_xyz[3 * static_cast<size_t>(query) + 1];
  const float qz = new_xyz[3 * static_cast<size_t>(query) + 2];

  // -- selection: first k_nb in-radius points, ascending index -----------
  int count = 0;  // identical in every thread (read from shared memory)
  for (int base = 0; base < n && count < k_nb; base += blockDim.x) {
    const int j = base + tid;
    const bool in = j < n && sq_dist(qx, qy, qz, pts[3 * j], pts[3 * j + 1],
                                     pts[3 * j + 2]) <= radius2;
    const unsigned m = __ballot_sync(0xffffffffu, in);
    if (lane == 0) ballots[warp] = m;
    __syncthreads();
    int rank = count;
    int total = 0;
    for (int w = 0; w < n_warps; ++w) {
      const int c = __popc(ballots[w]);
      if (w < warp) rank += c;
      total += c;
    }
    if (in) {
      rank += __popc(m & ((1u << lane) - 1u));
      if (rank < k_nb) sel[rank] = j;
    }
    count += total;
    __syncthreads();
  }
  // missing slots repeat the first neighbour; an empty ball gives index 0
  const int found = count < k_nb ? count : k_nb;
  const int first = found > 0 ? sel[0] : 0;
  __syncthreads();
  for (int k = tid; k < k_nb; k += blockDim.x) {
    const int v = k < found ? sel[k] : first;
    sel[k] = v;
    idx_out[static_cast<size_t>(query) * k_nb + k] = v;
  }
  __syncthreads();

  // -- gather [x - q ; f] into buf_a ---------------------------------------
  const int cin = 3 + f;
  for (int e = tid; e < k_nb * cin; e += blockDim.x) {
    const int k = e / cin;
    const int c = e - k * cin;
    const int j = sel[k];
    float v;
    if (c < 3) {
      const float qc = c == 0 ? qx : (c == 1 ? qy : qz);
      v = pts[3 * j + c] - qc;
    } else {
      v = feats[(static_cast<size_t>(b) * n + j) * f + (c - 3)];
    }
    buf_a[k * ld_a + c] = v;
  }
  __syncthreads();

  // -- MLP, activations ping-ponging between buf_a and buf_b ---------------
  float* cur = buf_a;
  int ld_cur = ld_a;
  float* nxt = buf_b;
  int ld_nxt = ld_b;
  const int kq = (k_nb + kRows - 1) / kRows;  // rows kg, kg + kq, ...
  for (int l = 0; l < mlp.n_layers; ++l) {
    const Layer L = mlp.layer[l];
    const int co4 = L.co >> 2;
    const float4* wt4 = reinterpret_cast<const float4*>(L.wt);
    // a thread computes a kRows x 4 tile: rows kg + r * kq (neighbouring
    // lanes take neighbouring rows, odd stride: no bank conflict) and
    // output channels 4 og .. 4 og + 3 (one float4 of weights per input
    // channel, shared by the lanes of the same og)
    for (int e = tid; e < kq * co4; e += blockDim.x) {
      const int kg = e % kq;
      const int og = e / kq;
      const float* h[kRows];
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int k = kg + r * kq;
        h[r] = cur + (k < k_nb ? k : kg) * ld_cur;  // rows past K: unused
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = __ldg(L.bias + 4 * og + c);
      }
      for (int i = 0; i < L.ci; ++i) {
        const float4 w = __ldg(wt4 + static_cast<size_t>(i) * co4 + og);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hv = h[r][i];
          acc[r][0] = fmaf(w.x, hv, acc[r][0]);
          acc[r][1] = fmaf(w.y, hv, acc[r][1]);
          acc[r][2] = fmaf(w.z, hv, acc[r][2]);
          acc[r][3] = fmaf(w.w, hv, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int k = kg + r * kq;
        if (k >= k_nb) continue;
        float* o = nxt + k * ld_nxt + 4 * og;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          o[c] = mlp.layer_norm ? acc[r][c] : fmaxf(acc[r][c], 0.f);
        }
      }
    }
    __syncthreads();
    if (mlp.layer_norm) {
      // one warp per neighbour row: centred two-pass mean / variance
      const float inv_c = 1.f / static_cast<float>(L.co);
      for (int k = warp; k < k_nb; k += n_warps) {
        float* row = nxt + k * ld_nxt;
        float sum = 0.f;
        for (int c = lane; c < L.co; c += 32) sum += row[c];
        const float mu = warp_sum(sum) * inv_c;
        float sq = 0.f;
        for (int c = lane; c < L.co; c += 32) {
          const float d = row[c] - mu;
          sq = fmaf(d, d, sq);
        }
        const float inv = rsqrtf(warp_sum(sq) * inv_c + kLayerNormEps);
        for (int c = lane; c < L.co; c += 32) {
          const float y = (row[c] - mu) * inv;
          row[c] = fmaxf(fmaf(y, __ldg(L.gamma + c), __ldg(L.beta + c)), 0.f);
        }
      }
      __syncthreads();
    }
    float* t = cur;
    cur = nxt;
    nxt = t;
    const int tl = ld_cur;
    ld_cur = ld_nxt;
    ld_nxt = tl;
  }

  // -- max over the neighbours ---------------------------------------------
  const int c_last = mlp.layer[mlp.n_layers - 1].co;
  for (int c = tid; c < c_last; c += blockDim.x) {
    float m = -INFINITY;
    for (int k = 0; k < k_nb; ++k) m = fmaxf(m, cur[k * ld_cur + c]);
    pooled[static_cast<size_t>(query) * c_last + c] = m;
  }
}

}  // namespace

// xyz (b, n, 3), new_xyz (b, s, 3), feats (b, n, f) or null when f == 0, all
// f32 contiguous. Layer l reads layer_ptrs[4l .. 4l+3] = (wt (ci, co), bias,
// gamma, beta) with chans[l] = ci, chans[l + 1] = co; gamma/beta are null
// when layer_norm == 0. Every co is a multiple of 4 and every wt is 16-byte
// aligned. Writes pooled (b, s, chans[n_layers]) f32 and idx (b, s, k)
// int32. Returns a cudaError_t as int (0 = launched).
extern "C" int fused_sa_forward(const float* xyz, const float* new_xyz,
                                const float* feats, int b, int n, int s,
                                int f, int k_nb, float radius2, int n_layers,
                                const int* chans, const void* const* layer_ptrs,
                                int layer_norm, float* pooled, int* idx,
                                void* stream) {
  if (b <= 0 || n <= 0 || s <= 0 || k_nb <= 0 || n_layers <= 0 ||
      n_layers > kMaxLayers || chans[0] != 3 + f) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Mlp mlp;
  mlp.n_layers = n_layers;
  mlp.layer_norm = layer_norm;
  // buf_a holds the layer inputs of even layers, buf_b those of odd ones
  int width_a = chans[0];
  int width_b = 0;
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = mlp.layer[l];
    L.wt = static_cast<const float*>(layer_ptrs[4 * l]);
    L.bias = static_cast<const float*>(layer_ptrs[4 * l + 1]);
    L.gamma = static_cast<const float*>(layer_ptrs[4 * l + 2]);
    L.beta = static_cast<const float*>(layer_ptrs[4 * l + 3]);
    L.ci = chans[l];
    L.co = chans[l + 1];
    if (L.co % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (l % 2 == 0) {
      width_b = L.co > width_b ? L.co : width_b;
    } else {
      width_a = L.co > width_a ? L.co : width_a;
    }
  }
  const int ld_a = width_a | 1;  // odd strides: conflict-free row reads
  const int ld_b = width_b | 1;
  const size_t smem =
      sizeof(int) * k_nb + sizeof(unsigned) * 32 +
      sizeof(float) * (static_cast<size_t>(k_nb) * ld_a +
                       static_cast<size_t>(k_nb) * ld_b);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sa_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_sa_fwd_kernel<<<b * s, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, feats, n, s, f, k_nb, radius2, mlp, ld_a, ld_b, pooled,
      idx);
  return static_cast<int>(cudaGetLastError());
}
