// Device functions shared by the fused set-abstraction forward
// (fused_sa_fwd.cu) and backward (fused_sa_bwd.cu). The bf16 modes are
// kernels of their own (fused_sa_fwd_bf16.cu, fused_sa_bwd_bf16.cu, sharing
// fused_sa_bf16.cuh): the forward writes the max-pool's winner for the
// backward to route by.
//
// In float32 the backward recomputes the forward's activations and routes
// the max-pool gradient to the first neighbour whose activation EQUALS the
// pooled value the forward wrote. So both kernels must form every
// activation bit for bit alike: they share the selection distance, the
// layer product (mma_product: ONE 3xTF32 tensor-core product, the same
// k-steps in the same order from the same bias) and the LayerNorm below,
// and nothing else computes them.

#pragma once

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

// Timing studies only (bench_sa_backward.py), each bit leaving out a part,
// the result then wrong; 0 in every real build. fused_sa_bwd.cu documents
// its bits; mma_product reads 64 (no streaming of weight tiles) and 128 (no
// mma loop), in both kernels; the forward reads 256 (no LayerNorm) and 512
// (no scan: the first K points); fused_sa_fwd_bf16.cu documents its own.
#ifndef SA_BWD_SKIP
#define SA_BWD_SKIP 0
#endif

namespace fused_sa {

constexpr int kThreads = 256;
constexpr float kLayerNormEps = 1e-6f;
// The warp tile of mma_product, at most: kMaxMT x kMaxNT m16n8 tiles.
constexpr int kMaxMT = 2;
constexpr int kMaxNT = 4;

// What mma_product stores: the sum, or max(sum, 0).
enum Store { kStorePlain, kStoreRelu };

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

// A group of n consecutive threads of the block (whole warps) that works
// and synchronises on its own: barrier `bar` (0: the whole block).
struct Threads {
  int tid;  // the thread's index in the group
  int n;    // threads in the group
  int bar;  // its named barrier

  __device__ __forceinline__ void sync() const {
    if (bar == 0) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(n) : "memory");
    }
  }
};

// The column at which a layer's weight keeps column o of row i in shared
// memory: o ^ (i & 4), at a row stride of 8 mod 32. The forward's B
// fragments (rows t and t + 4, columns g: see tf32_mma.cuh) and the
// backward's input-gradient fragments, which read the same copy
// transposed (rows g, columns t), both hit 32 distinct banks; no plain
// stride serves both.
__device__ __forceinline__ int swizzled(int i, int o) { return o ^ (i & 4); }

// Copy rows [i0, i0 + cnt) of a row-major (n, n_out) weight in device
// memory (16-byte aligned rows, n_out a multiple of 4) into shared memory
// at stride ldw, asynchronously (cp.async), by the threads of `th`, the
// columns swizzled (see `swizzled`; i0 a multiple of 8) or not; commits
// one group of copies.
__device__ __forceinline__ void stage_rows(const Threads& th,
                                           const float* __restrict__ w,
                                           int n_out, int i0, int cnt,
                                           float* dst, int ldw,
                                           bool swizzle) {
  const int o4 = n_out >> 2;
  for (int e = th.tid; e < cnt * o4; e += th.n) {
    const int i = e / o4;
    const int c = (e - i * o4) << 2;
    tf32::cp_async16(dst + i * ldw + (swizzle ? swizzled(i, c) : c),
                     w + static_cast<size_t>(i0 + i) * n_out + c, true);
  }
  tf32::cp_async_commit();
}

// The product's passes over its tasks for a warp tile of WM x WN m16n8
// tiles: straight-line code (no branch between the tiles), so that the
// independent tiles' mma interleave.
template <int WM, int WN>
__device__ __forceinline__ void mma_tiles(
    const Threads& th, int store, const float* in, int ld_in, int rows,
    int mt, int tm, int tasks, const float* __restrict__ w, const float* bias,
    int ci8, int co, int co8, float* out, int ld_out, float* wbuf, int ldw,
    int tile, int stages, bool resident) {
  const int lane = th.tid & 31;
  const int warp = th.tid >> 5;
  const int n_warps = th.n >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_tiles = (ci8 + tile - 1) / tile;
  const bool stage = !resident && !(SA_BWD_SKIP & 64);
  for (int base = 0; base < tasks; base += n_warps) {
    const int task = base + warp;  // the same for the whole warp
    const bool active = task < tasks;
    const int m0 = (task % tm) * WM;  // the warp's first m16 tile
    const int n0 = (task / tm) * WN;  // and first n8 tile
    float acc[WM][WN][4];
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      const int o = (n0 + j) * 8 + 2 * t;
      const float b0 = active && o < co ? bias[o] : 0.f;
      const float b1 = active && o + 1 < co ? bias[o + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        acc[i][j][0] = b0;
        acc[i][j][1] = b1;
        acc[i][j][2] = b0;
        acc[i][j][3] = b1;
      }
    }
    // B[k][o] = w[k_base + kk + k][o] at rows t and t + 4 of each step: as
    // kk is a multiple of 8, their columns are swizzled by 0 and 4. Past
    // the weight's columns there is none; past the last m16 tile a warp
    // reads that tile again and stores nothing.
    int b_at[WN];
    bool b_in[WN];
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      const int o = (n0 + j) * 8 + g;
      b_in[j] = o < co8;
      b_at[j] = t * ldw + o;
    }
    const float* a_row[WM];
#pragma unroll
    for (int i = 0; i < WM; ++i) {
      a_row[i] = in + (min(m0 + i, mt - 1) * 16 + g) * ld_in + t;
    }
    // the first stages - 1 tiles in flight
    for (int p = 0; stage && p < stages - 1 && p < n_tiles; ++p) {
      stage_rows(th, w, co8, p * tile, min(tile, ci8 - p * tile),
                 wbuf + p * tile * ldw, ldw, true);
    }
    for (int tt = 0; tt < n_tiles; ++tt) {
      const int k_base = tt * tile;
      if (!resident) {
        // tile tt has landed when at most the copies issued after it wait
        if (min(stages - 2, n_tiles - 1 - tt) >= 1) {
          tf32::cp_async_wait<1>();
        } else {
          tf32::cp_async_wait<0>();
        }
        th.sync();  // tile tt seen by all; tile tt - 1's buffer free
        const int next = tt + stages - 1;
        if (stage && next < n_tiles) {
          stage_rows(th, w, co8, next * tile, min(tile, ci8 - next * tile),
                     wbuf + (next % stages) * tile * ldw, ldw, true);
        }
      }
      const float* wb =
          resident ? wbuf : wbuf + (tt % stages) * tile * ldw;
      const int cnt = min(tile, ci8 - k_base);
      if (active && !(SA_BWD_SKIP & 128)) {
        for (int kk = 0; kk < cnt; kk += 8) {
          const float* wk = wb + kk * ldw;
          uint32_t b_hi[WN][2], b_lo[WN][2];
#pragma unroll
          for (int j = 0; j < WN; ++j) {
            const float v0 = b_in[j] ? wk[b_at[j]] : 0.f;
            const float v1 = b_in[j] ? wk[(b_at[j] + 4 * ldw) ^ 4] : 0.f;
            tf32::split(v0, b_hi[j][0], b_lo[j][0]);
            tf32::split(v1, b_hi[j][1], b_lo[j][1]);
          }
          uint32_t a_hi[WM][4], a_lo[WM][4];
#pragma unroll
          for (int i = 0; i < WM; ++i) {
            const float* a = a_row[i] + k_base + kk;
            const float av[4] = {a[0], a[8 * ld_in], a[4], a[8 * ld_in + 4]};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              tf32::split(av[r], a_hi[i][r], a_lo[i][r]);
            }
          }
          // tf32::mma3's three passes (lo·hi, hi·lo, hi·hi) on every tile
          // in turn: a tile's dependent mma lie WM WN apart
#pragma unroll
          for (int i = 0; i < WM; ++i) {
#pragma unroll
            for (int j = 0; j < WN; ++j) {
              tf32::mma(acc[i][j], a_lo[i], b_hi[j][0], b_hi[j][1]);
            }
          }
#pragma unroll
          for (int i = 0; i < WM; ++i) {
#pragma unroll
            for (int j = 0; j < WN; ++j) {
              tf32::mma(acc[i][j], a_hi[i], b_lo[j][0], b_lo[j][1]);
            }
          }
#pragma unroll
          for (int i = 0; i < WM; ++i) {
#pragma unroll
            for (int j = 0; j < WN; ++j) {
              tf32::mma(acc[i][j], a_hi[i], b_hi[j][0], b_hi[j][1]);
            }
          }
        }
      }
    }
    if (!resident) th.sync();  // the next pass refills the buffers
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int j = 0; j < WN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = (m0 + i) * 16 + g + (e >> 1) * 8;
          const int o = (n0 + j) * 8 + 2 * t + (e & 1);
          if (m < rows && o < co8) {
            const float v = acc[i][j][e];
            out[m * ld_out + o] = store == kStoreRelu ? fmaxf(v, 0.f) : v;
          }
        }
      }
    }
  }
}

// The layer product of both kernels: out[m][o] = bias[o] + sum_i in[m][i]
// * w[i][o] for m < rows and o < co8, on the tensor cores in 3xTF32
// (tf32_mma.cuh), by the warps of `th`.
//
// The weight is the Dense weight transposed and zero-padded, w (ci8, co8)
// row-major in device memory, ci8 and co8 the layer's widths rounded up to
// the mma's 8 (its pad rows and columns zero). In shared memory it sits at
// stride ldw (8 mod 32, at least co8) with swizzled columns: either all
// its rows already at wbuf (resident), or streamed through wbuf in tiles
// of `tile` rows (a multiple of 8), a ring of `stages` (2 or 3) buffers,
// the next stages - 1 tiles copied (cp.async) while the warps work on the
// current one, with one barrier a tile. `in` holds the layer's input rows
// at stride ld_in (4 mod 8: the A fragments' 8 rows x 4 columns hit 32
// distinct banks), its columns ci..ci8 zero, and rows up to the next
// multiple of 16 readable (finite; their results are dropped).
//
// Exactness: every output is ONE accumulator, started from its bias (0
// past co), that takes the k-steps of 8 input channels in ascending order,
// each as mma3 on the tf32::split parts of its own row of `in` and its own
// column of w (lo·hi, hi·lo, hi·hi). In an mma an output depends only on
// its row of A, its column of B, its C and the k order, so its bits do not
// depend on the warp tiling, on which rows share a tile, on the number of
// rows, or on the tiling of the weight: the forward's product and the
// backward's recompute of the same row give the same bits, which the
// backward's first-winner routing needs.
//
// A warp takes wm x wn m16n8 tiles (at most kMaxMT x kMaxNT, smaller while
// that leaves warps idle; each shape its own straight-line code, mma_tiles)
// and keeps their sums in registers across the weight tiles; above one
// task a warp the group makes several passes, streaming the weight again.
// store is a Store. Every thread of `th` must call it; the caller
// synchronises afterwards.
__device__ void mma_product(const Threads& th, int store, const float* in,
                            int ld_in, int rows,
                            const float* __restrict__ w,
                            const float* bias, int ci8, int co,
                            int co8, float* out, int ld_out, float* wbuf,
                            int ldw, int tile, int stages, bool resident) {
  const int n_warps = th.n >> 5;
  const int mt = (rows + 15) >> 4;
  const int nt = co8 >> 3;
  // the largest warp tile that still leaves no warp idle
  int wm = kMaxMT;
  int wn = kMaxNT;
  auto tasks_of = [&](int a, int b) {
    return ((mt + a - 1) / a) * ((nt + b - 1) / b);
  };
  while (wm > 1 && tasks_of(wm, wn) < n_warps) wm >>= 1;
  while (wn > 1 && tasks_of(wm, wn) < n_warps) wn >>= 1;
  const int tm = (mt + wm - 1) / wm;
  const int tasks = tasks_of(wm, wn);
  if (resident) tile = ci8;
#define SA_MMA_TILES(WM, WN)                                                  \
  mma_tiles<WM, WN>(th, store, in, ld_in, rows, mt, tm, tasks, w, bias, ci8, \
                    co, co8, out, ld_out, wbuf, ldw, tile, stages, resident)
  if (wm == 2) {
    if (wn == 4) {
      SA_MMA_TILES(2, 4);
    } else if (wn == 2) {
      SA_MMA_TILES(2, 2);
    } else {
      SA_MMA_TILES(2, 1);
    }
  } else if (wn == 4) {
    SA_MMA_TILES(1, 4);
  } else if (wn == 2) {
    SA_MMA_TILES(1, 2);
  } else {
    SA_MMA_TILES(1, 1);
  }
#undef SA_MMA_TILES
}

// LayerNorm statistics of R rows of n channels, by one warp: centred
// two-pass mean and variance. The R rows are interleaved for independent
// work in flight; each row's sums take the same order whatever R, so its
// statistics are the same bits. Every lane returns the same mu and inv.
template <int R>
__device__ __forceinline__ void layer_norm_stats(const float* const (&row)[R],
                                                 int n, int lane,
                                                 float (&mu)[R],
                                                 float (&inv)[R]) {
  const float inv_c = 1.f / static_cast<float>(n);
  float sum[R];
  float sq[R];
#pragma unroll
  for (int r = 0; r < R; ++r) sum[r] = 0.f;
  for (int c = lane; c < n; c += 32) {
#pragma unroll
    for (int r = 0; r < R; ++r) sum[r] += row[r][c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mu[r] = sum[r] * inv_c;
    sq[r] = 0.f;
  }
  for (int c = lane; c < n; c += 32) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float d = row[r][c] - mu[r];
      sq[r] = fmaf(d, d, sq[r]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sq[r] += __shfl_xor_sync(0xffffffffu, sq[r], off);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    inv[r] = rsqrtf(sq[r] * inv_c + kLayerNormEps);
  }
}

__device__ __forceinline__ float layer_norm_xhat(float h, float mu,
                                                 float inv) {
  return (h - mu) * inv;
}

// The activation after LayerNorm: relu(gamma * xhat + beta).
__device__ __forceinline__ float layer_norm_act(float xhat, float gamma,
                                                float beta) {
  return fmaxf(fmaf(xhat, gamma, beta), 0.f);
}

// The LayerNorm forward of both kernels: out[k][c] = relu(gamma[c] *
// xhat[k][c] + beta[c]) for rows k < rows of h (stride ld, n channels), by
// the warps of `th`, kLayerNormRows rows a warp at a time. out (stride
// ld_out) may be h itself. mu and inv, when not null, get each row's
// statistics. The caller synchronises afterwards.
constexpr int kLayerNormRows = 4;
__device__ void layer_norm_rows(const Threads& th, const float* h, int ld,
                                int rows, int n, const float* gamma,
                                const float* beta, float* out,
                                int ld_out, float* mu, float* inv) {
  constexpr int R = kLayerNormRows;
  const int lane = th.tid & 31;
  const int n_warps = th.n >> 5;
  for (int k0 = (th.tid >> 5) * R; k0 < rows; k0 += n_warps * R) {
    int k[R];
    const float* row[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      k[r] = min(k0 + r, rows - 1);  // past the last row: its repeat
      row[r] = h + k[r] * ld;
    }
    float m[R], iv[R];
    layer_norm_stats<R>(row, n, lane, m, iv);
    for (int c = lane; c < n; c += 32) {
      const float g = gamma[c];
      const float b = beta[c];
      float v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[r] = layer_norm_act(layer_norm_xhat(row[r][c], m[r], iv[r]), g, b);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (k0 + r < rows) out[k[r] * ld_out + c] = v[r];
      }
    }
    if (lane == 0 && mu != nullptr) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (k0 + r < rows) {
          mu[k0 + r] = m[r];
          inv[k0 + r] = iv[r];
        }
      }
    }
  }
}

}  // namespace fused_sa
