// Device code shared by the fused set-abstraction level's two bf16 kernels
// for Hopper (sm_90a): the forward (fused_sa_fwd_bf16.cu) and the first
// kernel of the backward (fused_sa_bwd_bf16.cu). Both keep a level's image
// (every layer's bf16 weight in wgmma's K-major core-matrix layout, then
// the biases, gammas and betas; fused_sa_fwd_bf16.cu packs it) resident in
// shared memory, gather 64-row tiles of [x - q ; f] in a producer warp and
// run the layers on them in consumer warpgroups: the barriers, the gather,
// the layer products and the register LayerNorm below are the forward's,
// so the backward's recompute forms the forward's activations bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "fused_sa_common.cuh"
#include "wgmma_bf16.cuh"

namespace fsa_bf16 {

constexpr int kRows = 64;      // rows of a tile: wgmma's m
constexpr int kMaxLayers = 4;
constexpr int kWidest = 256;   // the widest layer output (wgmma's n)
constexpr int kChunkN = 64;    // layer outputs pad to a multiple of this

constexpr size_t kSmemPerBlock = 232448;  // bytes a block may have on Hopper
// a wait that outlasts this many polls traps instead of hanging the card
constexpr long long kMaxPolls = 1ll << 24;

struct Level {
  // the weights and vectors as shared memory holds them, packed by
  // fused_sa_pack_bf16_kernel: image_bytes bytes, copied in one piece
  const uint8_t* image;
  int image_bytes;
  int kp[kMaxLayers];         // a layer's input width, padded (wgmma's k)
  int np[kMaxLayers];         // its output width, padded to kChunkN
  int co[kMaxLayers];         // its real output width
  int w_off[kMaxLayers];      // bytes: its weight in the image
  int v_off[kMaxLayers];      // floats: its vectors in the vector area
  int n_layers;
  int layer_norm;
  int cin;        // 3 + f
  int c_last;     // the last layer's real width
  int slot;       // rows a query takes in a tile: 16, 32 or 64
  int queries;    // queries a group (of tiles): 64 / slot, or 1 above K 64
  int tiles;      // tiles a group: ceil(K / 64), 1 up to K 64
  int producers;  // producer warps that gather
  int per_warp;   // slots of the ring each owns
  int tile_bytes;
  int sel_ints;   // a producer warp's selection buffer
  int vec4;       // the features load as float4 (f % 4 == 0, 16-byte rows)
  // byte offsets in shared memory
  int off_vec, off_ring, off_part, off_run, off_sel, off_bar;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  long long polls = 0;
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (++polls > kMaxPolls) __trap();
  }
}

// Generic-proxy writes to shared memory before the wgmma (async proxy)
// reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A group's tile t, in the ring: the slot and the round of its owner's
// slot (the owner: producer warp gl % producers, which takes its groups in
// turn and fills its own per_warp slots in order).
__device__ __forceinline__ void slot_of(const Level& lv, int gl, int t,
                                        int& slot, int& round) {
  const int j = gl / lv.producers * lv.tiles + t;
  slot = gl % lv.producers * lv.per_warp + j % lv.per_warp;
  round = j / lv.per_warp;
}

// -- the gather ----------------------------------------------------------------

// Tile t of the group whose first query is q0: its 64 rows [x - q ; f ; 0]
// as bf16, in the core-matrix layout (element (m, c) at byte
// (c / 8 * 8 + m / 8) * 128 + m % 8 * 16 + c % 8 * 2), by one warp, a row
// a lane, chunk by chunk (the chunks' 16-byte stores of 32 rows fill four
// whole core matrices). Only the 8-channel chunks that hold a real channel
// are written; the others stay zero from the start.
__device__ __forceinline__ void gather_tile(
    const Level& lv, const float* __restrict__ xyz,
    const float* __restrict__ new_xyz, const float* __restrict__ feats,
    int n, int s, int f, int k_nb, int n_queries, int q0, int t,
    const int* sel, uint8_t* tile) {
  const int lane = threadIdx.x & 31;
  const int chunks = (lv.cin + 7) >> 3;
  for (int half = 0; half < 2; ++half) {
    const int m = lane + 32 * half;
    int qi = 0;
    int k = kRows * t + m;
    if (lv.tiles == 1) {
      qi = m / lv.slot;
      k = m % lv.slot;
    }
    const int query = q0 + qi;
    const bool real = query < n_queries;
    size_t row = 0;
    float q[3] = {0.f, 0.f, 0.f};
    if (real) {
      const int j = sel[qi * k_nb + (k < k_nb ? k : 0)];
      row = static_cast<size_t>(query / s) * n + j;
      q[0] = new_xyz[3 * static_cast<size_t>(query)];
      q[1] = new_xyz[3 * static_cast<size_t>(query) + 1];
      q[2] = new_xyz[3 * static_cast<size_t>(query) + 2];
    }
    uint8_t* dst = tile + (m >> 3) * 128 + (m & 7) * 16;
    if (real && lv.vec4) {
      // the features as float4 (f a multiple of 4, rows 16-byte aligned):
      // chunk kc > 0 holds features 8kc - 3 .. 8kc + 4, the last three of
      // float4 2kc - 1, float4 2kc, the first of float4 2kc + 1
      const float4* fr = reinterpret_cast<const float4*>(feats + row * f);
      const int n4 = f >> 2;
      auto load = [&](int i) {
        return i < n4 ? __ldg(fr + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      };
      float4 prev = load(1);
      const float4 first = load(0);
      const float* x = xyz + row * 3;
      *reinterpret_cast<uint4*>(dst) = make_uint4(
          pack_bf16(__ldg(x) - q[0], __ldg(x + 1) - q[1]),
          pack_bf16(__ldg(x + 2) - q[2], first.x),
          pack_bf16(first.y, first.z), pack_bf16(first.w, prev.x));
#pragma unroll 4
      for (int kc = 1; kc < chunks; ++kc) {
        const float4 cur = load(2 * kc);
        const float4 next = load(2 * kc + 1);
        *reinterpret_cast<uint4*>(dst + kc * 8 * 128) = make_uint4(
            pack_bf16(prev.y, prev.z), pack_bf16(prev.w, cur.x),
            pack_bf16(cur.y, cur.z), pack_bf16(cur.w, next.x));
        prev = next;
      }
      continue;
    }
#pragma unroll 2
    for (int kc = 0; kc < chunks; ++kc) {
      float v[8];
      if (!real) {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      } else if (kc > 0 && 8 * kc + 8 <= lv.cin) {
        const float* p = feats + row * f + 8 * kc - 3;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = __ldg(p + i);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = 8 * kc + i;
          if (i < 3 && kc == 0) {
            v[i] = __ldg(xyz + row * 3 + i) - q[i];
          } else {
            v[i] = c < lv.cin ? __ldg(feats + row * f + (c - 3)) : 0.f;
          }
        }
      }
      *reinterpret_cast<uint4*>(dst + kc * 8 * 128) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
  }
}

// -- the layers ------------------------------------------------------------

// acc <- the bias of each column (rows g and g + 8 alike). kMaxN: the
// widest layer the kernel takes, kMaxA the widest input it takes from
// registers (each a multiple of 64).
template <int kMaxN>
__device__ __forceinline__ void init_bias(float (&acc)[kMaxN / 2],
                                          const float* bias, int np, int t4) {
#pragma unroll
  for (int ch = 0; ch < kMaxN / kChunkN; ++ch) {
    if (ch * kChunkN < np) {
#pragma unroll
      for (int ii = 0; ii < kChunkN / 8; ++ii) {
        const int i = ch * (kChunkN / 8) + ii;
        const float2 b =
            *reinterpret_cast<const float2*>(bias + 8 * i + 2 * t4);
        acc[4 * i] = b.x;
        acc[4 * i + 1] = b.y;
        acc[4 * i + 2] = b.x;
        acc[4 * i + 3] = b.y;
      }
    }
  }
}

// The layer's products with A from registers: ksteps k-steps of 16, k-step
// j's A the registers a[j], B the layer's resident weight (np columns; its
// k-step j at 2j core-matrix columns of np / 8 core matrices each).
template <int N, int kMaxN, int kMaxA>
__device__ __forceinline__ void layer_rs(float (&acc)[kMaxN / 2],
                                         const uint32_t (&a)[kMaxA / 16][4],
                                         uint32_t w_addr, int ksteps) {
#pragma unroll
  for (int j = 0; j < kMaxA / 16; ++j) {
    if (j < ksteps) {
      wgmma::Wgmma<N>::rs(
          acc, a[j], wgmma::desc(w_addr + j * 2 * N * 16, N * 16, 128));
    }
  }
}

// Layer 0's products with A from the gathered tile (64 rows; its k-step j
// at 2j core-matrix columns of 8 core matrices each).
template <int N, int kMaxN>
__device__ __forceinline__ void layer_ss(float (&acc)[kMaxN / 2],
                                         uint32_t a_addr, uint32_t w_addr,
                                         int ksteps) {
  for (int j = 0; j < ksteps; ++j) {
    wgmma::Wgmma<N>::ss(acc, wgmma::desc(a_addr + j * 2 * 1024, 1024, 128),
                        wgmma::desc(w_addr + j * 2 * N * 16, N * 16, 128));
  }
}

// The sum of n partial sums, pairwise.
template <int n>
__device__ __forceinline__ float chunk_total(const float (&p)[n]) {
  if constexpr (n == 1) {
    return p[0];
  } else if constexpr (n == 2) {
    return p[0] + p[1];
  } else {
    static_assert(n == 4, "two or four chunks");
    return (p[0] + p[1]) + (p[2] + p[3]);
  }
}

// With LayerNorm, each row's mean and inverse std over the co real columns
// of the accumulators (centred two-pass, the four lanes of a quad holding a
// row's columns; rows g and g + 8 of the thread), the real columns
// centred in place (acc <- h - mu; padded columns keep h). kFull: co == np
// == kMaxN, no column to leave out.
template <int kMaxN, bool kFull = false>
__device__ __forceinline__ void center(float (&acc)[kMaxN / 2], int np,
                                       int co, int t4, float (&mu)[2],
                                       float (&inv)[2]) {
  if constexpr (kFull) co = np = kMaxN;  // every column real
  // each row's sums: pairs of columns, eight pairs a 64-column chunk in
  // turn, then the chunks' partial sums pairwise, then the quad's lanes
  constexpr int kChunks = kMaxN / kChunkN;
  float part[2][kChunks];
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    part[0][ch] = part[1][ch] = 0.f;
    if (ch * kChunkN < np) {
#pragma unroll
      for (int ii = 0; ii < kChunkN / 8; ++ii) {
        const int i = ch * (kChunkN / 8) + ii;
        if (kFull || 8 * i + 2 * t4 < co) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            part[r][ch] += acc[4 * i + 2 * r] + acc[4 * i + 2 * r + 1];
          }
        }
      }
    }
  }
  const float inv_c = 1.f / static_cast<float>(co);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = chunk_total<kChunks>(part[r]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    mu[r] = sum * inv_c;
  }
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    part[0][ch] = part[1][ch] = 0.f;
    if (ch * kChunkN < np) {
#pragma unroll
      for (int ii = 0; ii < kChunkN / 8; ++ii) {
        const int i = ch * (kChunkN / 8) + ii;
        if (kFull || 8 * i + 2 * t4 < co) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // h - mu, kept for the output
            const float d0 = acc[4 * i + 2 * r] - mu[r];
            const float d1 = acc[4 * i + 2 * r + 1] - mu[r];
            acc[4 * i + 2 * r] = d0;
            acc[4 * i + 2 * r + 1] = d1;
            part[r][ch] += fmaf(d0, d0, d1 * d1);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sq = chunk_total<kChunks>(part[r]);
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    inv[r] = rsqrtf(sq * inv_c + fused_sa::kLayerNormEps);
  }
}

// The activation of a centred column: relu(gamma (h - mu) inv + beta),
// xhat = (h - mu) inv formed as the forward forms it.
__device__ __forceinline__ float ln_act(float v, float inv, float g,
                                        float b) {
  return fmaxf(fmaf(v * inv, g, b), 0.f);
}

// After center: acc <- relu(gamma (h - mu) inv + beta) over the co real
// columns (gamma and beta in vec, after the bias: the image's vectors), 0
// on padded columns.
template <int kMaxN, bool kFull = false>
__device__ __forceinline__ void normalise(float (&acc)[kMaxN / 2],
                                          const float* vec, int np, int co,
                                          const float (&inv)[2], int t4) {
  if constexpr (kFull) co = np = kMaxN;  // every column real
  const float* gamma = vec + np;
  const float* beta = vec + 2 * np;
#pragma unroll
  for (int ch = 0; ch < kMaxN / kChunkN; ++ch) {
    if (ch * kChunkN < np) {
#pragma unroll
      for (int ii = 0; ii < kChunkN / 8; ++ii) {
        const int i = ch * (kChunkN / 8) + ii;
        const int c = 8 * i + 2 * t4;
        const float2 g = *reinterpret_cast<const float2*>(gamma + c);
        const float2 b = *reinterpret_cast<const float2*>(beta + c);
        const bool real = kFull || c < co;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& v0 = acc[4 * i + 2 * r];
          float& v1 = acc[4 * i + 2 * r + 1];
          v0 = real ? ln_act(v0, inv[r], g.x, b.x) : 0.f;
          v1 = real ? ln_act(v1, inv[r], g.y, b.y) : 0.f;
        }
      }
    }
  }
}

// relu(h) on the accumulators (a level without LayerNorm).
template <int kMaxN>
__device__ __forceinline__ void relu(float (&acc)[kMaxN / 2], int np) {
#pragma unroll
  for (int ch = 0; ch < kMaxN / kChunkN; ++ch) {
    if (ch * kChunkN < np) {
#pragma unroll
      for (int e = 0; e < 4 * kChunkN / 8; ++e) {
        float& v = acc[ch * (kChunkN / 2) + e];
        v = fmaxf(v, 0.f);
      }
    }
  }
}

// The layer's epilogue on the accumulators, in place: with LayerNorm,
// relu(gamma (h - mu) inv + beta) over the co real columns (center, then
// normalise), else relu(h); padded columns come out 0. kFull: co == np ==
// kMaxN, no column to leave out.
template <int kMaxN, bool kFull = false>
__device__ __forceinline__ void epilogue(float (&acc)[kMaxN / 2],
                                         const float* vec, int np, int co,
                                         bool layer_norm, int t4) {
  if (!layer_norm || (SA_BWD_SKIP & 256)) {
    relu<kMaxN>(acc, np);
    return;
  }
  float mu[2], inv[2];
  center<kMaxN, kFull>(acc, np, co, t4, mu, inv);
  normalise<kMaxN, kFull>(acc, vec, np, co, inv, t4);
}

// The activations of columns [16j, 16j + 16) as the A registers of k-step
// j of the next layer, rounded to bf16.
template <int kMaxN, int kMaxA>
__device__ __forceinline__ void to_a(const float (&acc)[kMaxN / 2],
                                     uint32_t (&a)[kMaxA / 16][4], int np) {
#pragma unroll
  for (int ch = 0; ch < kMaxA / kChunkN; ++ch) {
    if (ch * kChunkN < np) {
#pragma unroll
      for (int jj = 0; jj < kChunkN / 16; ++jj) {
        const int j = ch * (kChunkN / 16) + jj;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[j][r] = pack_bf16(acc[8 * j + 2 * r], acc[8 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// The level's Dense weights (co, ci) f32 and vectors, where they lie.
struct Sources {
  const float* w[kMaxLayers];
  const float* vec[kMaxLayers][3];  // bias, gamma, beta
  int ci[kMaxLayers];
};

inline int pad_to(int c, int m) { return (c + m - 1) / m * m; }

// The padded widths and the image's layout of a level: kp[0] = chans[0]
// rounded up to 16; np[l] = chans[l + 1] rounded up to 64; kp[l] = np[l -
// 1] for l > 0; each weight at a multiple of 128 bytes, the vectors after
// them. false for a level the kernel does not take.
inline bool image_layout(int n_layers, const int* chans, int layer_norm, Level& lv,
                  Sources* src, const void* const* layer_ptrs) {
  if (n_layers <= 0 || n_layers > kMaxLayers) return false;
  lv.n_layers = n_layers;
  lv.layer_norm = layer_norm;
  lv.cin = chans[0];
  lv.c_last = chans[n_layers];
  int off = 0;
  int v_off = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int co = chans[l + 1];
    if (co <= 0 || co % 4 != 0 || co > kWidest) return false;
    lv.co[l] = co;
    lv.np[l] = pad_to(co, kChunkN);
    lv.kp[l] = l == 0 ? pad_to(chans[0], 16) : lv.np[l - 1];
    lv.w_off[l] = off;
    off += pad_to(lv.kp[l] * lv.np[l] * 2, 128);
    lv.v_off[l] = v_off;
    v_off += lv.np[l] * (layer_norm ? 3 : 1);
    if (src != nullptr) {
      src->w[l] = static_cast<const float*>(layer_ptrs[4 * l]);
      for (int k = 0; k < 3; ++k) {
        src->vec[l][k] = static_cast<const float*>(layer_ptrs[4 * l + 1 + k]);
      }
      src->ci[l] = chans[l];
    }
  }
  lv.off_vec = off;
  lv.image_bytes = off + v_off * 4;
  return true;
}

}  // namespace fsa_bf16
