// Fused PointNet++ set-abstraction level, backward, for Hopper (sm_90a).
//
// Replaces the backward Pallas kernel of
// maskplanner_tpu/ops/pallas/fused_sa_train.py (`_fsa_train_bwd_raw`, body
// `_bwd_kernel`): for every query (an FPS centroid) re-gather its K
// neighbours [x - q ; f] from the indices the forward saved, recompute every
// layer's pre-norm value h, its LayerNorm mean and inverse std (eps 1e-6)
// and its activation, route d_pooled[c] to the FIRST neighbour k whose last
// activation equals pooled[c] (later ties get nothing: ties come only from
// duplicated neighbours, so every accumulated gradient is the same either
// way), and backpropagate through ReLU, LayerNorm and the Dense layers:
// dW, db, dgamma, dbeta summed over all B*S*K rows, d_features and d_xyz
// scattered to the source points, d_new_xyz[b, s] = -sum_k d_in[k, :3].
//
// Exactness of the routing: the recompute goes through the same device
// functions as the forward kernel (fused_sa_common.cuh), so each activation
// is bit for bit the one the forward max-pooled, and the `>=` test finds the
// forward's winner.
//
// What bounds it on this card: f32 arithmetic on the CUDA cores, about 3x
// the forward's operations (the recompute, then per layer the weight
// gradient and the input gradient): about 78 GFLOP at sa1 and 207 GFLOP at
// sa2 at the flagship batch of 64, 1.2 ms + 3.1 ms at 67 TFLOP/s.
//
// What the design does about it: one block per query, 256 threads, the
// whole level's per-row state in shared memory. A query's K rows go in
// chunks in index order: per row the gathered input, each layer's pre-norm
// h (LayerNorm levels) and activation, and per layer the row's mean and
// inverse std, 515 floats a row at sa1 and 1163 at sa2. The chunk is the
// largest of 32, 16, 8 rows that leaves room for two blocks on an SM: 32 at
// sa1 (68 KB), 16 at sa2 (77 KB; with 32 rows, 151 KB and one block an SM,
// chip_smoke.py timed sa2 at 36.1 ms instead of 19.9, H100 at 700 W). sa2's
// weights (264 KB) are read through L1/L2. A per-channel "not yet taken"
// flag carries the first-winner rule across chunks. Gradients then overwrite the activations
// in place, layer by layer: the routed gradient replaces the last
// activation, the LayerNorm backward writes d_h over h's row, and the input
// gradient d_pre @ W overwrites the layer's input activation, masked by
// that activation's ReLU. The products are the forward's tiled layer
// product (4 rows x 4 channels a thread); the weight gradient is a 4 x 4
// tile a thread over (C_out, C_in), summed over the chunk's rows.
//
// The cross-block reductions are atomics. Each block sums its chunk's dW,
// db, dgamma and dbeta in f32 and adds them with one f64 atomicAdd per
// element; the wrapper rounds the f64 sums to f32 once. The order of the
// 32768 additions (chunks) per element then moves a sum by far less than
// an f32 ulp, so the weight gradients come out the same from run to run
// but for rare rounding-boundary cases. Each block scatters its rows'
// d_features and d_xyz with one f32 atomicAdd per element (a few dozen adds
// per source point), whose order, and so whose last bits, change from run
// to run. Per-block partial sums reduced in a fixed order, and a batched
// product for dW on the tensor cores, are later work.

#include <cuda_runtime.h>

#include "fused_sa_common.cuh"

namespace {

using fused_sa::kStoreMaskByOut;
using fused_sa::kStorePlain;
using fused_sa::kStoreRelu;
using fused_sa::kThreads;
using fused_sa::layer_norm_act;
using fused_sa::layer_norm_stats;
using fused_sa::layer_norm_xhat;
using fused_sa::layer_product;
using fused_sa::warp_sum;

constexpr int kMaxLayers = 4;
constexpr int kMaxChunk = 32;  // neighbour rows per chunk, at most
constexpr size_t kSmemPerSm = 232448;  // bytes a block may have on Hopper

struct Layer {
  const float* wt;     // (ci, co): the Dense weight transposed (recompute)
  const float* w_pad;  // (co, ci_pad): the Dense weight, columns zero-padded
  const float* bias;   // (co,)
  const float* gamma;  // (co,) or null without LayerNorm
  const float* beta;   // (co,) or null without LayerNorm
  double* dw;          // (co, ci), summed over all blocks in f64
  double* db;          // (co,)
  double* dgamma;      // (co,) or null
  double* dbeta;       // (co,) or null
  int ci;
  int co;
  int ci_pad;  // ci rounded up to a multiple of 4
  int ld;      // row stride of this layer's h and activation buffers
};

struct Mlp {
  Layer layer[kMaxLayers];
  int n_layers;
  int layer_norm;
  int ld_x;   // row stride of the gathered-input buffer
  int chunk;  // neighbour rows per chunk
};

// dW[c][i] += sum_k d[k][c] * in[k][i]; db[c] += sum_k d[k][c]. A thread
// sums a 4 x 4 tile: inputs ig + r * iq (neighbouring lanes, neighbouring
// addresses) and outputs cg + r * cq (shared by a warp's lanes).
__device__ void weight_grads(const float* d, int ld_d, const float* in,
                             int ld_in, int rows, const Layer& L) {
  const int iq = (L.ci + 3) / 4;
  const int cq = (L.co + 3) / 4;
  for (int e = threadIdx.x; e < iq * cq; e += blockDim.x) {
    const int ig = e % iq;
    const int cg = e / iq;
    float acc[4][4] = {};
    for (int k = 0; k < rows; ++k) {
      float dv[4];
      float iv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = cg + r * cq;
        const int i = ig + r * iq;
        dv[r] = c < L.co ? d[k * ld_d + c] : 0.f;
        iv[r] = i < L.ci ? in[k * ld_in + i] : 0.f;
      }
#pragma unroll
      for (int rc = 0; rc < 4; ++rc) {
#pragma unroll
        for (int ri = 0; ri < 4; ++ri) {
          acc[rc][ri] = fmaf(dv[rc], iv[ri], acc[rc][ri]);
        }
      }
    }
#pragma unroll
    for (int rc = 0; rc < 4; ++rc) {
      const int c = cg + rc * cq;
      if (c >= L.co) continue;
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const int i = ig + ri * iq;
        if (i < L.ci) {
          atomicAdd(L.dw + static_cast<size_t>(c) * L.ci + i,
                    static_cast<double>(acc[rc][ri]));
        }
      }
    }
  }
  for (int c = threadIdx.x; c < L.co; c += blockDim.x) {
    float sb = 0.f;
    for (int k = 0; k < rows; ++k) sb += d[k * ld_d + c];
    atomicAdd(L.db + c, static_cast<double>(sb));
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_sa_bwd_kernel(const float* __restrict__ xyz,
                        const float* __restrict__ new_xyz,
                        const float* __restrict__ feats,
                        const int* __restrict__ idx,
                        const float* __restrict__ pooled,
                        const float* __restrict__ d_pooled, int n, int s,
                        int f, int k_nb, Mlp mlp, float* __restrict__ d_xyz,
                        float* __restrict__ d_feats,
                        float* __restrict__ d_new_xyz) {
  extern __shared__ float smem[];
  const int n_layers = mlp.n_layers;
  const int c_last = mlp.layer[n_layers - 1].co;
  const int chunk = mlp.chunk;
  int* sel = reinterpret_cast<int*>(smem);                  // chunk
  int* avail = sel + chunk;                                 // c_last
  float* stats = reinterpret_cast<float*>(avail + c_last);  // 2 L chunk
  float* x_buf = stats + 2 * kMaxLayers * chunk;           // chunk ld_x
  float* h_buf[kMaxLayers];
  float* a_buf[kMaxLayers];
  {
    float* p = x_buf + chunk * mlp.ld_x;
    for (int l = 0; l < n_layers; ++l) {
      h_buf[l] = p;
      if (mlp.layer_norm) p += chunk * mlp.layer[l].ld;
      a_buf[l] = p;
      p += chunk * mlp.layer[l].ld;
    }
  }

  const int query = blockIdx.x;  // b * s + j
  const int b = query / s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int cin = 3 + f;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  const float q[3] = {new_xyz[3 * static_cast<size_t>(query)],
                      new_xyz[3 * static_cast<size_t>(query) + 1],
                      new_xyz[3 * static_cast<size_t>(query) + 2]};
  const float* pooled_q = pooled + static_cast<size_t>(query) * c_last;
  const float* dp_q = d_pooled + static_cast<size_t>(query) * c_last;
  for (int c = tid; c < c_last; c += blockDim.x) avail[c] = 1;
  float dq = 0.f;  // threads 0..2: -sum_k d_in[k][tid]

  for (int k0 = 0; k0 < k_nb; k0 += chunk) {
    const int rows = min(chunk, k_nb - k0);
    __syncthreads();  // the previous chunk's buffers are no longer read
    for (int k = tid; k < rows; k += blockDim.x) {
      sel[k] = idx[static_cast<size_t>(query) * k_nb + k0 + k];
    }
    __syncthreads();
    // -- re-gather [x - q ; f] ----------------------------------------------
    for (int e = tid; e < rows * cin; e += blockDim.x) {
      const int k = e / cin;
      const int c = e - k * cin;
      const int j = sel[k];
      x_buf[k * mlp.ld_x + c] =
          c < 3 ? pts[3 * j + c] - q[c]
                : feats[(static_cast<size_t>(b) * n + j) * f + (c - 3)];
    }
    __syncthreads();
    // -- recompute the forward ----------------------------------------------
    for (int l = 0; l < n_layers; ++l) {
      const Layer& L = mlp.layer[l];
      const float* in = l == 0 ? x_buf : a_buf[l - 1];
      const int ld_in = l == 0 ? mlp.ld_x : mlp.layer[l - 1].ld;
      const float4* w4 = reinterpret_cast<const float4*>(L.wt);
      if (mlp.layer_norm) {
        layer_product<kStorePlain>(in, ld_in, L.ci, rows, w4, L.bias, L.co,
                                   h_buf[l], L.ld);
      } else {
        layer_product<kStoreRelu>(in, ld_in, L.ci, rows, w4, L.bias, L.co,
                                  a_buf[l], L.ld);
      }
      __syncthreads();
      if (mlp.layer_norm) {
        float* mu_l = stats + 2 * l * chunk;
        float* inv_l = mu_l + chunk;
        for (int k = warp; k < rows; k += n_warps) {
          const float* row = h_buf[l] + k * L.ld;
          float mu, inv;
          layer_norm_stats(row, L.co, lane, mu, inv);
          for (int c = lane; c < L.co; c += 32) {
            a_buf[l][k * L.ld + c] =
                layer_norm_act(layer_norm_xhat(row[c], mu, inv),
                               __ldg(L.gamma + c), __ldg(L.beta + c));
          }
          if (lane == 0) {
            mu_l[k] = mu;
            inv_l[k] = inv;
          }
        }
        __syncthreads();
      }
    }
    // -- max-pool backward: the first winner takes d_pooled ---------------
    {
      const Layer& L = mlp.layer[n_layers - 1];
      for (int c = tid; c < c_last; c += blockDim.x) {
        const float pc = pooled_q[c];
        const float dc = dp_q[c];
        int free = avail[c];
        for (int k = 0; k < rows; ++k) {
          float* a = a_buf[n_layers - 1] + k * L.ld + c;
          const bool win = free && *a >= pc;
          if (win) free = 0;
          // the ReLU's backward: nothing passes where the activation is 0
          *a = (win && *a > 0.f) ? dc : 0.f;
        }
        avail[c] = free;
      }
    }
    __syncthreads();
    // -- layers, last to first ----------------------------------------------
    for (int l = n_layers - 1; l >= 0; --l) {
      const Layer& L = mlp.layer[l];
      float* d = a_buf[l];  // d_act, ReLU-masked
      if (mlp.layer_norm) {
        const float* mu_l = stats + 2 * l * chunk;
        const float* inv_l = mu_l + chunk;
        const float* h = h_buf[l];
        for (int c = tid; c < L.co; c += blockDim.x) {
          float sg = 0.f;
          float sb = 0.f;
          for (int k = 0; k < rows; ++k) {
            const float g = d[k * L.ld + c];
            sg = fmaf(g, layer_norm_xhat(h[k * L.ld + c], mu_l[k], inv_l[k]),
                      sg);
            sb += g;
          }
          atomicAdd(L.dgamma + c, static_cast<double>(sg));
          atomicAdd(L.dbeta + c, static_cast<double>(sb));
        }
        __syncthreads();  // the rows below are rewritten in place
        // d_h = inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), in place
        // of the gradient row, one warp per row
        const float inv_c = 1.f / static_cast<float>(L.co);
        for (int k = warp; k < rows; k += n_warps) {
          float* drow = d + k * L.ld;
          const float* hrow = h + k * L.ld;
          float s1 = 0.f;
          float s2 = 0.f;
          for (int c = lane; c < L.co; c += 32) {
            const float dx = drow[c] * __ldg(L.gamma + c);
            s1 += dx;
            s2 = fmaf(dx, layer_norm_xhat(hrow[c], mu_l[k], inv_l[k]), s2);
          }
          const float m1 = warp_sum(s1) * inv_c;
          const float m2 = warp_sum(s2) * inv_c;
          for (int c = lane; c < L.co; c += 32) {
            const float xh = layer_norm_xhat(hrow[c], mu_l[k], inv_l[k]);
            const float dx = drow[c] * __ldg(L.gamma + c);
            drow[c] = inv_l[k] * (dx - m1 - xh * m2);
          }
        }
        __syncthreads();
      }
      // d is now d_pre: weight and bias gradients, then the input gradient
      const float* in = l == 0 ? x_buf : a_buf[l - 1];
      const int ld_in = l == 0 ? mlp.ld_x : mlp.layer[l - 1].ld;
      weight_grads(d, L.ld, in, ld_in, rows, L);
      __syncthreads();
      const float4* wp4 = reinterpret_cast<const float4*>(L.w_pad);
      if (l == 0) {
        layer_product<kStorePlain>(d, L.ld, L.co, rows, wp4, nullptr,
                                   L.ci_pad, x_buf, ld_in);
      } else {
        layer_product<kStoreMaskByOut>(d, L.ld, L.co, rows, wp4, nullptr,
                                       L.ci_pad, a_buf[l - 1], ld_in);
      }
      __syncthreads();
    }
    // -- scatter d_in to the source points ----------------------------------
    for (int e = tid; e < rows * cin; e += blockDim.x) {
      const int k = e / cin;
      const int c = e - k * cin;
      const float g = x_buf[k * mlp.ld_x + c];
      const size_t row = static_cast<size_t>(b) * n + sel[k];
      if (c < 3) {
        atomicAdd(d_xyz + row * 3 + c, g);
      } else {
        atomicAdd(d_feats + row * f + (c - 3), g);
      }
    }
    if (tid < 3) {
      for (int k = 0; k < rows; ++k) dq -= x_buf[k * mlp.ld_x + tid];
    }
  }
  if (tid < 3) d_new_xyz[3 * static_cast<size_t>(query) + tid] = dq;
}

}  // namespace

// Inputs as fused_sa_forward, plus idx (b, s, k) int32 and pooled (b, s, C)
// from it and d_pooled (b, s, C), all contiguous. Layer l reads
// layer_ptrs[5l .. 5l+4] = (wt (ci, co), w_pad (co, ci_pad), bias, gamma,
// beta) and accumulates into grad_ptrs[4l .. 4l+3] = (dw (co, ci), db,
// dgamma, dbeta), f64, with chans[l] = ci, chans[l + 1] = co; gamma, beta,
// dgamma and dbeta are null when layer_norm == 0. Every co is a multiple of
// 4; ci_pad is ci rounded up to one; wt and w_pad are 16-byte aligned. The
// caller zeroes the weight gradients, d_xyz (b, n, 3) and d_feats
// (b, n, f); d_new_xyz (b, s, 3) is written. Returns a cudaError_t as int
// (0 = launched).
extern "C" int fused_sa_backward(const float* xyz, const float* new_xyz,
                                 const float* feats, const int* idx,
                                 const float* pooled, const float* d_pooled,
                                 int b, int n, int s, int f, int k_nb,
                                 int n_layers, const int* chans,
                                 const void* const* layer_ptrs,
                                 void* const* grad_ptrs, int layer_norm,
                                 float* d_xyz, float* d_feats,
                                 float* d_new_xyz, void* stream) {
  if (b <= 0 || n <= 0 || s <= 0 || k_nb <= 0 || n_layers <= 0 ||
      n_layers > kMaxLayers || chans[0] != 3 + f) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Mlp mlp;
  mlp.n_layers = n_layers;
  mlp.layer_norm = layer_norm;
  const int ci_pad0 = (chans[0] + 3) & ~3;
  mlp.ld_x = ci_pad0 | 1;  // odd strides: conflict-free row reads
  size_t row_floats = mlp.ld_x;  // shared floats per neighbour row
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = mlp.layer[l];
    L.wt = static_cast<const float*>(layer_ptrs[5 * l]);
    L.w_pad = static_cast<const float*>(layer_ptrs[5 * l + 1]);
    L.bias = static_cast<const float*>(layer_ptrs[5 * l + 2]);
    L.gamma = static_cast<const float*>(layer_ptrs[5 * l + 3]);
    L.beta = static_cast<const float*>(layer_ptrs[5 * l + 4]);
    L.dw = static_cast<double*>(grad_ptrs[4 * l]);
    L.db = static_cast<double*>(grad_ptrs[4 * l + 1]);
    L.dgamma = static_cast<double*>(grad_ptrs[4 * l + 2]);
    L.dbeta = static_cast<double*>(grad_ptrs[4 * l + 3]);
    L.ci = chans[l];
    L.co = chans[l + 1];
    L.ci_pad = (L.ci + 3) & ~3;
    L.ld = L.co | 1;
    if (L.co % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    row_floats += static_cast<size_t>(L.ld) * (layer_norm ? 2 : 1);
  }
  // the largest chunk that leaves room for two blocks on an SM (see the
  // note at the top)
  auto smem_floats = [&](int chunk) {
    return chunk + chans[n_layers] + 2 * kMaxLayers * chunk +
           chunk * row_floats;
  };
  mlp.chunk = kMaxChunk;
  while (mlp.chunk > 8 &&
         sizeof(float) * smem_floats(mlp.chunk) > kSmemPerSm / 2) {
    mlp.chunk /= 2;
  }
  const size_t floats = smem_floats(mlp.chunk);
  const size_t smem = sizeof(float) * floats;
  cudaError_t err = cudaFuncSetAttribute(
      fused_sa_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_sa_bwd_kernel<<<b * s, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, feats, idx, pooled, d_pooled, n, s, f, k_nb, mlp, d_xyz,
      d_feats, d_new_xyz);
  return static_cast<int>(cudaGetLastError());
}
