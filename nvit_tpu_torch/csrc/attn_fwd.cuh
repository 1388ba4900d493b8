// The flash-attention forward tile loop — Hopper (sm_90a), on hopper.cuh —
// shared by K1/K5 (qknorm_attn_fwd.cu) and K7 (flash_attn_fwd.cu).  Per
// (b, h) and 64-query block:
//
//   S = Q Kᵀ (fp32)   P = exp(S − m)   O = (bf16(P) V) / Σ P   lse = m + log Σ P
//
// The template argument PLAIN says how the Q and K operands arrive:
//
//   QK-norm (PLAIN = false, K1/K5): Q = q̂_s and K = k̂, bf16 scratch from the
//     projection prologue (qknorm_project.cu); m by `mode` — the row max (K1),
//     K5's constant per-head bound, or "auto" between the two (decided here on
//     the card from sqk_eff);
//   plain (PLAIN = true, K7): Q is the raw q tile, multiplied once per block in
//     shared memory by the bf16-rounded softmax scale and rounded to bf16
//     (≙ the TPU kernel's weak-typed `q_ref[0] * scale`); K is the raw k; m is
//     the row max.  The Q tile lands once per block, so the fold is one 64 × D
//     pass and needs no launch of its own.
//
// What bounds it on the H100: at the flagship shape (T = 784, D = 64) the
// two products are 4·T²·D flops per (b, h) against ~4·T·D·2 bytes — above
// the bf16 ridge, so the tensor cores and the exp work bound it, not memory.
// Only wgmma reaches the tensor-core rate, so the design is wgmma's:
//
// * One block is one warpgroup (4 warps, 128 threads) and takes 64 query
//   rows (wgmma's M) of one (b, h), walking 64-key tiles with an online
//   softmax (running max m and sum l per row, O rescaled by exp(m_old −
//   m_new)).  K5's arm starts m at the constant bound and never moves it.
// * S = Q Kᵀ is four (D = 32: two) m64n64k16 wgmmas from the swizzled Q and
//   K tiles, into 32 fp32 registers a thread.  The softmax runs on those
//   registers (row max and sum across the quad of lanes that share a row,
//   exp2 with log2 e folded into one multiply), P is rounded to bf16 in
//   registers and is the A operand of O += P V (m64nDk16, V read MN-major
//   from its [key][d] tile).  O accumulates in registers.  S, P and O never
//   touch shared memory.
// * K/V tiles come through cp.async in a ring of two stages: tile n + 1 is
//   in flight while tile n is multiplied.  One barrier per tile.  The copies
//   are cp.async (16 bytes a thread, zero-filled past T) with the swizzle
//   applied by hand (hopper.cuh), not TMA: the strided (batch, head, token)
//   views of the fused QKV buffer and the ragged last tile need no tensor
//   map, and the build links no libcuda (no -lcuda added to the build).
//
// Ragged T (784 = 12·64 + 16): the loads zero-fill rows past T; key columns
// past T are masked (−inf before the max, P = 0 in the bounded arm) on the
// last tile only; query rows past T are computed on zeros and not stored.
//
// Numerics: the online rescale rounds P to bf16 relative to the running max
// instead of the final row max, a difference of at most one bf16 rounding of
// P; exp2 of the folded argument differs from exp by float rounding only.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace attn_fwd {

using namespace hopper;

constexpr int BLOCK = TILE_ROWS;  // query rows per block, keys per tile
constexpr int NUM_THREADS = WG_THREADS;
constexpr int NUM_WARPS = NUM_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
// softmax stabilizer modes of the QK-norm arm (ops/flash_attention.py MODES)
constexpr int MODE_ROWMAX = 0;
constexpr int MODE_BOUNDED = 1;
constexpr int MODE_AUTO = 2;
constexpr float BOUND_GATE = 20.0f;          // ≙ flash_attention.py _BOUND_GATE
constexpr float BOUNDED_EXP_FLOOR = -60.0f;  // ≙ _BOUNDED_EXP_FLOOR

// max_i s[i]² over n fp32 values, the same in every thread of the block
__device__ __forceinline__ float block_max_sq(const float* __restrict__ s, int n, float* red) {
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += NUM_THREADS) m = fmaxf(m, s[i] * s[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  __syncthreads();  // red is free: an earlier call's readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NUM_WARPS; ++w) m = fmaxf(m, red[w]);
  return m;
}

// (batch, head, token) element strides of q, k, v and o
struct Strides {
  int64_t q[3], k[3], v[3], o[3];
};

// byte offsets in the block's 1024-aligned dynamic shared memory
template <int D>
struct Layout {
  static constexpr int TILE = BLOCK * D * 2;  // one swizzled 64-row bf16 tile
  static constexpr int Q = 0;
  static constexpr int KV = TILE;             // stage s: K at KV + 2·s·TILE, v after it
  static constexpr int BYTES = KV + 2 * 2 * TILE + 1024;  // + alignment slack
};

// the quad's max / sum of a value each of its four lanes holds
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// bf16(x · scale) in place for the 16-byte chunks of a swizzled tile that
// this thread's load_tile copied — its own cp.async writes, visible to it
// after its wait, so no barrier is needed before the pass
template <int D>
__device__ __forceinline__ void scale_own_chunks(unsigned char* tile, float scale) {
  constexpr int CPR = D / 8;
#pragma unroll
  for (int i = 0; i < TILE_ROWS * CPR / WG_THREADS; ++i) {
    const int c = threadIdx.x + i * WG_THREADS;
    uint4* p = reinterpret_cast<uint4*>(tile + swizzle<2 * D>(c / CPR, c % CPR));
    uint4 raw = *p;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(e[j]);
      e[j] = __floats2bfloat162_rn(x.x * scale, x.y * scale);
    }
    *p = raw;
  }
}

// The whole block's work: the tile walk and the store of its O rows (and
// lse rows when lse is not null).  QK-norm: sqk_eff [H, D] fp32 and `mode`
// pick the stabilizer, `scale` enters only K5's bound; plain: sqk and mode
// are not read, `scale` is the bf16-rounded softmax scale folded into Q.
// smem_raw: the kernel's dynamic shared memory (Layout<D>::BYTES); red: a
// NUM_WARPS float scratch in shared memory.
template <int D, bool PLAIN>
__device__ __forceinline__ void tile_loop(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                          const bf16* __restrict__ v, const float* __restrict__ sqk,
                                          bf16* __restrict__ o, float* __restrict__ lse, int H, int T,
                                          float scale, int mode, const Strides& st,
                                          unsigned char* smem_raw, float* red) {
  using L = Layout<D>;
  constexpr int ROW = 2 * D;  // bytes per tile row
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int m0 = blockIdx.x * BLOCK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // K5: the stabilizer is a per-head constant, from the RAW s (not s·scale)
  bool bounded = false;
  float bound = 0.f;
  if constexpr (!PLAIN) {
    const float* s_vec = sqk + h * D;  // sqk_eff[h]: no [B·H, D] broadcast needed
    bounded = mode == MODE_BOUNDED;
    if (mode == MODE_AUTO) bounded = scale * block_max_sq(sqk, H * D, red) < BOUND_GATE;
    bound = bounded ? scale * block_max_sq(s_vec, D, red) : 0.f;
  }

  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* vb = v + b * st.v[0] + h * st.v[1];
  const int n_tiles = (T + BLOCK - 1) / BLOCK;
  load_tile<D>(base + L::Q, q + b * st.q[0] + h * st.q[1], st.q[2], m0, T);
  load_tile<D>(base + L::KV, kb, st.k[2], 0, T);
  load_tile<D>(base + L::KV + L::TILE, vb, st.v[2], 0, T);
  cp_async_commit();

  // this thread's rows r_i = 16·warp + lane/4 + 8·i and its columns
  // 8·j + c0 + c of every accumulator (hopper.cuh)
  const int c0 = 2 * (lane & 3);
  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  float m_i[2] = {bounded ? bound : -INFINITY, bounded ? bound : -INFINITY};
  float l_i[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<0>();  // tile n has landed (the only group in flight)
    if constexpr (PLAIN) {
      if (n == 0) scale_own_chunks<D>(smem_raw + (base - raw) + L::Q, scale);  // Q = bf16(q·scale)
    }
    fence_proxy_async();
    __syncthreads();     // ... for every thread; and tile n − 1's stage is free
    if (n + 1 < n_tiles) {
      const uint32_t nxt = base + L::KV + ((n + 1) & 1) * 2 * L::TILE;
      load_tile<D>(nxt, kb, st.k[2], (n + 1) * BLOCK, T);
      load_tile<D>(nxt + L::TILE, vb, st.v[2], (n + 1) * BLOCK, T);
    }
    cp_async_commit();
    const uint32_t ks = base + L::KV + (n & 1) * 2 * L::TILE;
    const uint32_t vs = ks + L::TILE;

    float s[32];  // S[64 queries, 64 keys] of this tile
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, smem_desc<ROW>(base + L::Q + kk * 32), smem_desc<ROW>(ks + kk * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    const int n0 = n * BLOCK;
    const bool ragged = n0 + BLOCK > T;  // the last tile holds keys past T
    if (bounded) {  // K5: exp(max(s − bound, −60)) against the constant bound, α = 1
#pragma unroll
      for (int j = 0; j < BLOCK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool live = !ragged || n0 + 8 * j + c0 + c < T;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float& x = s[4 * j + 2 * i + c];
            x = live ? exp2f(fmaxf(x - bound, BOUNDED_EXP_FLOOR) * LOG2E) : 0.f;
            l_i[i] += x;
          }
        }
    } else {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BLOCK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool live = !ragged || n0 + 8 * j + c0 + c < T;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float& x = s[4 * j + 2 * i + c];
            if (!live) x = -INFINITY;
            mx[i] = fmaxf(mx[i], x);
          }
        }
      float neg[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m_i[i], quad_max(mx[i]));  // finite: every tile holds a live key
        alpha[i] = exp2f((m_i[i] - m_new) * LOG2E);           // 0 on the first tile
        m_i[i] = m_new;
        neg[i] = -m_new * LOG2E;
        l_i[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < BLOCK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[4 * j + 2 * i + c];
            x = exp2f(fmaf(x, LOG2E, neg[i]));
            l_i[i] += x;
          }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc_o[4 * j + 2 * i] *= alpha[i];
          acc_o[4 * j + 2 * i + 1] *= alpha[i];
        }
    }

    // O[64, D] += bf16(P) · V, P from registers
    uint32_t pa[BLOCK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) pack_a(pa[kk], s, kk);
    fence_operands(acc_o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) wgmma_rs(acc_o, pa[kk], smem_desc<ROW>(vs + kk * 16 * ROW));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc_o);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_i[i]);
    const int t = m0 + warp * 16 + (lane >> 2) + 8 * i;
    if (t < T) {
      bf16* og = o + b * st.o[0] + h * st.o[1] + (int64_t)t * st.o[2] + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(og + 8 * j) =
            __floats2bfloat162_rn(acc_o[4 * j + 2 * i] / l, acc_o[4 * j + 2 * i + 1] / l);
      if (lse != nullptr && (lane & 3) == 0) lse[(int64_t)bh * T + t] = m_i[i] + logf(l);
    }
  }
}

// Launch `kernel` (a __global__ whose body is tile_loop<D, ·>) over
// (64-query blocks, B·H) with Layout<D>'s dynamic shared memory.
template <int D, typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int B, int H, int T, cudaStream_t stream, Args... args) {
  const int smem = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BLOCK - 1) / BLOCK, B * H);
  kernel<<<grid, NUM_THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

// (batch, head, token) strides = {q_sb, q_sh, q_st, k_.., v_.., o_..}
inline Strides unpack_strides(const int64_t* strides) {
  Strides st;
  int64_t* dst[4] = {st.q, st.k, st.v, st.o};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  return st;
}

}  // namespace attn_fwd
