// The flash-attention backward tile walks — Hopper (sm_90a), on hopper.cuh —
// shared by K2/K5 and K10 (qknorm_attn_bwd.cu) and K8/K9 (flash_attn_bwd.cu).  Given
// the forward's lse, dO, Δ = rowsum(dO ∘ O) and the bf16 operands, per (b, h):
//
//   S = Q Kᵀ   P = exp(S − lse)   dP = dO Vᵀ   dS = P ⊙ (dP − Δ)
//   dV = bf16(P)ᵀ dO    dK' = bf16(dS)ᵀ Q    dQ' = bf16(dS) K2          (fp32)
//
// (K5: P = exp(max(S − bound, −60) + (bound − lse)), the forward's clamped
// softmax).  What the operands are, and what the epilogue makes of dK' and
// dQ', is the instantiating kernel's:
//
//   QK-norm (K2/K5): Q = q̂_s, K = k̂, K2 = k̂_s, all bf16 scratch from the
//     projection prologue; the epilogues apply the justnorm VJP and write the
//     dsqk partials;
//   plain K8: Q = qs = bf16(q·scale) (prologue scratch), K = the raw k, K2 =
//     ks = bf16(k·scale) (prologue scratch); dK = bf16(dK'), dQ = bf16(dQ');
//   plain K9: Q = qs, K = K2 = the raw k — one key operand, so its stages
//     hold two tiles, not three; dQ = bf16(dQ'·scale), scaled in fp32.
//
// What bounds it on the H100: seven T×T×D products per (b, h) in this design
// (five in the function), against ~8·T·D bf16 values of traffic — far above
// the bf16 ridge: the tensor cores and the exp/ALU work of the [T, T] tiles
// bound it, not memory.  Only wgmma reaches the tensor-core rate.
//
// Design: the TPU kernels keep whole [T, T] fp32 tiles in VMEM (2.4 MB each at
// T = 784); a Hopper block has 227 KB of shared memory.  So the math runs on
// FlashAttention-2's backward structure, two walks after a prologue that
// rounds the operands once per call and pads lse and Δ to whole 64-row tiles,
// all deterministic (no atomics):
//
// * dK/dV (dkv_walk) — one block (one warpgroup) per (b·h, 64-key tile).  K
//   and V stay in shared memory; each 64-query tile's Q, dO, lse and Δ come
//   through a two-stage cp.async ring.  Sᵀ = K Qᵀ and dPᵀ = V dOᵀ are
//   m64n64k16 wgmmas into registers; Pᵀ is formed while dPᵀ's wgmma runs;
//   Pᵀ and dSᵀ are rounded to bf16 in registers and are the A operands of
//   dV += Pᵀ dO and dK' += dSᵀ Q, whose B operand is the query tile read
//   MN-major (no transposed copy).  dV and dK' accumulate in registers.
// * dQ (dq_walk) — one block per (b·h, 64-query tile), walking the key tiles
//   (K, K2 unless it is K, V) the same way, query-major, into dQ' in
//   registers; K2 is read MN-major.
// The two walks each recompute S and dP (7 products instead of 5): the price
// of keeping dQ out of atomics.  S, dP, P, dS and the gradients never touch
// shared memory.
// K10 runs dkv_walk alone, over its q sub-tiles' chunks (Chunks) instead of
// whole 64-row tiles, with a fifth product (a dq strategy, SplitDq): dSᵀ is
// stored once as a bf16 tile that dK' and that key tile's share of dq̂ read;
// the shares are summed over the key tiles outside the walk.
//
// Ragged T: query columns past T get P = 0 (their dO and Δ rows are zero
// too); key rows past T are computed on zero-filled tiles and never stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace attn_bwd {

using namespace hopper;

constexpr int BLOCK = 64;  // rows per tile, queries or keys
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float BOUNDED_EXP_FLOOR = -60.0f;  // ≙ flash_attention.py _BOUNDED_EXP_FLOOR

// (batch, head, token) element strides of the seven [B, H, T, D] operands
struct Strides {
  int64_t q[3], k[3], v[3], dO[3], dq[3], dk[3], dv[3];
};

// The recomputed softmax entry exp(s − lse), or K5's clamped form
// exp(max(s − bound, −60) + (bound − lse)), as exp2 with log2 e folded in:
// c = −lse·log2 e (K2) or (bound − lse)·log2 e (K5), b2 = bound·log2 e
template <bool BOUNDED>
__device__ __forceinline__ float recompute_p2(float s, float c, float b2) {
  if constexpr (BOUNDED) return exp2f(fmaxf(fmaf(s, LOG2E, -b2), BOUNDED_EXP_FLOOR * LOG2E) + c);
  return exp2f(fmaf(s, LOG2E, c));
}

// byte offsets in the dK/dV block's 1024-aligned dynamic shared memory;
// SPLIT_DQ (K10) adds K2's tile (the dq̂ product's B) and the bf16 dSᵀ tile
// (the A of dK' and of the dq̂ product) beside K and V
template <int D, bool SPLIT_DQ = false>
struct LayoutKV {
  static constexpr int TILE = BLOCK * D * 2;  // one swizzled 64-row bf16 tile
  static constexpr int KH = 0, V = TILE;      // this block's K and V, the whole walk
  static constexpr int K2 = 2 * TILE;         // SPLIT_DQ: this block's K2, the whole walk
  static constexpr int DS = 3 * TILE;         // SPLIT_DQ: bf16 dSᵀ [64 keys][64 queries]
  static constexpr int STAGES = SPLIT_DQ ? 3 * TILE + BLOCK * BLOCK * 2 : 2 * TILE;
  // stage s at STAGES + s·STAGE: Q, dO, lse, Δ
  static constexpr int STAGE = (2 * TILE + 2 * BLOCK * 4 + 1023) / 1024 * 1024;
  static constexpr int BYTES = STAGES + 2 * STAGE + 1024;  // + alignment slack
};

// The query walks of dkv_walk.  A walk is a sequence of query tiles of at
// most 64 rows; tile m holds rows [start(m), start(m) + 64) of which those
// below end(m) are live, the rest zero-filled with P = 0.
//
// WholeT (K2/K5, K8, K9): every 64-row tile of [0, T), rows past T dead.
struct WholeT {
  int T, n;  // rows, tiles
  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ int start(int m) const { return m * BLOCK; }
  __device__ __forceinline__ int end(int) const { return T; }
  static constexpr bool GUARD_STATS = false;  // the padded lse/Δ rows are read whole
};

// Chunks (K10): the q sub-tiles in order, each cut into chunks of at most 64
// rows that never cross a sub-tile's end; chunk m is rows [start[m],
// start[m + 1]), every start a multiple of 16 — a table the host builds
// (flash_attention.py::subtile_chunks) and the kernel takes by value.  A
// chunk's lse/Δ rows past its end are zero-filled, not read: the last chunk
// may start 16 rows before T_pad.
constexpr int MAX_CHUNKS = 1024;
struct Chunks {
  int n;
  int16_t starts[MAX_CHUNKS + 1];  // starts[n] = T
  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ int start(int m) const { return starts[m]; }
  __device__ __forceinline__ int end(int m) const { return starts[m + 1]; }
  static constexpr bool GUARD_STATS = true;
};

// dkv_walk's dq strategy.  NoDq: none (K2/K5, K8, K9 take dq in a walk of
// their own).  A strategy gets load(base) once, beside K and V, before the
// walk; then per query tile m: prepare() before the products are issued;
// issue() right after the dV/dK' products, inside the same wgmma group —
// with SPLIT_DQ the tile's bf16 dSᵀ is then in LayoutKV's DS tile; and
// finish(m) once that group has completed.
struct NoDq {
  __device__ __forceinline__ void load(uint32_t) {}
  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ void issue() {}
  __device__ __forceinline__ void finish(int) {}
};

// one query tile's Q (bf16 [T, D] scratch rows), dO and [lse, Δ] rows into a
// dK/dV stage; Q and dO rows from `lim` on are zero-filled, and with
// GUARD_STATS the lse/Δ rows too
template <int D, bool GUARD_STATS>
__device__ __forceinline__ void load_query_stage(uint32_t stage, const bf16* __restrict__ qb,
                                                 const bf16* __restrict__ dOb, int64_t dO_st,
                                                 const float* __restrict__ lseb,
                                                 const float* __restrict__ deltab, int m0, int lim) {
  using L = LayoutKV<D>;
  hopper::load_tile<D>(stage, qb, D, m0, lim);
  hopper::load_tile<D>(stage + L::TILE, dOb, dO_st, m0, lim);
  if (threadIdx.x < 2 * BLOCK / 4) {  // 16 chunks of lse, 16 of Δ: padded rows, in range
    const int c = threadIdx.x % (BLOCK / 4);
    const bool ok = !GUARD_STATS || m0 + 4 * c < lim;
    const float* src = (threadIdx.x < BLOCK / 4 ? lseb : deltab) + (ok ? m0 + 4 * c : 0);
    hopper::cp_async16(stage + 2 * L::TILE + threadIdx.x * 16, src, ok);
  }
}

// The dK/dV walk of one block, keys n0 .. n0 + 63: K (rows of `kb`, `k_st`
// apart) and V stay in shared memory while every query tile of `walk` — Q
// (bf16 [T, D] scratch rows), dO and the padded lse/Δ rows — passes through
// the ring → dV and dK' in hopper.cuh's accumulator layout; `dq` is the dq
// strategy (K10's adds a fifth product per tile).  `base`: the block's
// 1024-aligned shared memory (LayoutKV<D, SPLIT_DQ>::BYTES); `bound`: K5's
// per-head bound when BOUNDED.
template <int D, bool BOUNDED, bool SPLIT_DQ, class Walk, class Dq>
__device__ __forceinline__ void dkv_walk(float (&acc_dv)[D / 2], float (&acc_dk)[D / 2], uint32_t base,
                                         unsigned char* sp, const bf16* __restrict__ kb, int64_t k_st,
                                         const bf16* __restrict__ vb, int64_t v_st,
                                         const bf16* __restrict__ qb, const bf16* __restrict__ dOb,
                                         int64_t dO_st, const float* __restrict__ lseb,
                                         const float* __restrict__ deltab, int n0, int T, const Walk& walk,
                                         float bound, Dq& dq) {
  using L = LayoutKV<D, SPLIT_DQ>;
  constexpr int ROW = 2 * D;
  const int lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);  // this thread's columns 8·j + c0 + c (hopper.cuh)
  const float b2 = bound * LOG2E;

  load_tile<D>(base + L::KH, kb, k_st, n0, T);
  load_tile<D>(base + L::V, vb, v_st, n0, T);
  dq.load(base);
  load_query_stage<D, Walk::GUARD_STATS>(base + L::STAGES, qb, dOb, dO_st, lseb, deltab, walk.start(0),
                                         walk.end(0));
  cp_async_commit();

#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dv[i] = acc_dk[i] = 0.f;
  const int n_tiles = walk.count();
  for (int m = 0; m < n_tiles; ++m) {
    cp_async_wait<0>();  // query tile m has landed
    fence_proxy_async();
    __syncthreads();     // ... for every thread; and tile m − 1's stage is free
    if (m + 1 < n_tiles)
      load_query_stage<D, Walk::GUARD_STATS>(base + L::STAGES + ((m + 1) & 1) * L::STAGE, qb, dOb, dO_st, lseb,
                                             deltab, walk.start(m + 1), walk.end(m + 1));
    cp_async_commit();
    const uint32_t q_s = base + L::STAGES + (m & 1) * L::STAGE;
    const uint32_t do_s = q_s + L::TILE;
    const float* lse_s = reinterpret_cast<const float*>(sp + (q_s - base) + 2 * L::TILE);
    const float* delta_s = lse_s + BLOCK;

    // Sᵀ and dPᵀ [64 keys, 64 queries]
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_operands(s);
    fence_operands(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, smem_desc<ROW>(base + L::KH + kk * 32), smem_desc<ROW>(q_s + kk * 32), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, smem_desc<ROW>(base + L::V + kk * 32), smem_desc<ROW>(do_s + kk * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // Sᵀ is in; dPᵀ still runs while Pᵀ is formed
    fence_operands(s);

    // Pᵀ = exp(Sᵀ − lse[query]) (K5: clamped) and dSᵀ = Pᵀ ⊙ (dPᵀ − Δ[query]);
    // P = 0 for queries past the tile's end
    const int m0 = walk.start(m), lim = walk.end(m);
    const bool ragged = m0 + BLOCK > lim;
#pragma unroll
    for (int j = 0; j < BLOCK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + c0 + c;
        const bool live = !ragged || m0 + col < lim;
        const float cl = BOUNDED ? (bound - lse_s[col]) * LOG2E : -lse_s[col] * LOG2E;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 4 * j + 2 * i + c;
          s[r] = live ? recompute_p2<BOUNDED>(s[r], cl, b2) : 0.f;
        }
      }
    wgmma_wait<0>();
    fence_operands(dp);
#pragma unroll
    for (int j = 0; j < BLOCK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float dl = delta_s[8 * j + c0 + c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 4 * j + 2 * i + c;
          dp[r] = s[r] * (dp[r] - dl);
        }
      }
    uint32_t pa[BLOCK / 16][4], da[BLOCK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) {
      pack_a(pa[kk], s, kk);
      pack_a(da[kk], dp, kk);
    }
    if constexpr (SPLIT_DQ) {  // bf16 dSᵀ into the DS tile, for dK' and the dq strategy
      store_a_tile(base + L::DS, da);
      fence_proxy_async();
      __syncthreads();
    }
    dq.prepare();
    fence_operands(acc_dv);
    fence_operands(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) wgmma_rs(acc_dv, pa[kk], smem_desc<ROW>(do_s + kk * 16 * ROW));
    if constexpr (SPLIT_DQ) {  // A = the DS tile, K-major: da dies before the products
#pragma unroll
      for (int kk = 0; kk < BLOCK / 16; ++kk)
        wgmma_ss_bmn<0>(acc_dk, smem_desc<2 * BLOCK>(base + L::DS + kk * 32),
                        smem_desc<ROW>(q_s + kk * 16 * ROW), 1);
    } else {
#pragma unroll
      for (int kk = 0; kk < BLOCK / 16; ++kk) wgmma_rs(acc_dk, da[kk], smem_desc<ROW>(q_s + kk * 16 * ROW));
    }
    dq.issue();
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc_dv);
    fence_operands(acc_dk);
    dq.finish(m);
  }
}

// K2/K5, K8 and K9's dK/dV walk: every 64-row query tile of [0, T), no dq
template <int D, bool BOUNDED>
__device__ __forceinline__ void dkv_walk(float (&acc_dv)[D / 2], float (&acc_dk)[D / 2], uint32_t base,
                                         unsigned char* sp, const bf16* __restrict__ kb, int64_t k_st,
                                         const bf16* __restrict__ vb, int64_t v_st,
                                         const bf16* __restrict__ qb, const bf16* __restrict__ dOb,
                                         int64_t dO_st, const float* __restrict__ lseb,
                                         const float* __restrict__ deltab, int n0, int T, int T_pad,
                                         float bound) {
  NoDq none;
  dkv_walk<D, BOUNDED, false>(acc_dv, acc_dk, base, sp, kb, k_st, vb, v_st, qb, dOb, dO_st, lseb, deltab, n0, T,
                              WholeT{T, T_pad / BLOCK}, bound, none);
}

// byte offsets in the dQ block's 1024-aligned dynamic shared memory; a stage
// holds the key tiles K, K2 (when TWO_KEYS) and V
template <int D, bool TWO_KEYS>
struct LayoutQ {
  static constexpr int TILE = BLOCK * D * 2;
  static constexpr int Q = 0, DO = TILE;   // this block's Q and dO, the whole walk
  static constexpr int STAGES = 2 * TILE;  // stage s at STAGES + s·STAGE
  static constexpr int K2 = TWO_KEYS ? TILE : 0;  // dQ's key operand, in the stage
  static constexpr int V = TWO_KEYS ? 2 * TILE : TILE;
  static constexpr int STAGE = V + TILE;
  static constexpr int BYTES = STAGES + 2 * STAGE + 1024;
};

template <int D, bool TWO_KEYS>
__device__ __forceinline__ void load_key_stage(uint32_t stage, const bf16* __restrict__ kb, int64_t k_st,
                                               const bf16* __restrict__ k2b,
                                               const bf16* __restrict__ vb, int64_t v_st, int n0,
                                               int T) {
  using L = LayoutQ<D, TWO_KEYS>;
  hopper::load_tile<D>(stage, kb, k_st, n0, T);
  if constexpr (TWO_KEYS) hopper::load_tile<D>(stage + L::K2, k2b, D, n0, T);
  hopper::load_tile<D>(stage + L::V, vb, v_st, n0, T);
}

// The dQ walk of one block, queries m0 .. m0 + 63: Q (bf16 [T, D] scratch
// rows) and dO stay in shared memory while every key tile of K (rows `k_st`
// apart), K2 (bf16 [T, D] scratch rows; TWO_KEYS only, else K serves) and V
// passes through the ring → dQ' in hopper.cuh's accumulator layout.  `base`:
// the block's 1024-aligned shared memory (LayoutQ<D, TWO_KEYS>::BYTES).
template <int D, bool BOUNDED, bool TWO_KEYS>
__device__ __forceinline__ void dq_walk(float (&acc_dq)[D / 2], uint32_t base, const bf16* __restrict__ qb,
                                        const bf16* __restrict__ dOb, int64_t dO_st,
                                        const bf16* __restrict__ kb, int64_t k_st,
                                        const bf16* __restrict__ k2b, const bf16* __restrict__ vb,
                                        int64_t v_st, const float* __restrict__ lseb,
                                        const float* __restrict__ deltab, int m0, int T, int n_tiles,
                                        float bound) {
  using L = LayoutQ<D, TWO_KEYS>;
  constexpr int ROW = 2 * D;
  const int lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
  const float b2 = bound * LOG2E;

  load_tile<D>(base + L::Q, qb, D, m0, T);
  load_tile<D>(base + L::DO, dOb, dO_st, m0, T);
  load_key_stage<D, TWO_KEYS>(base + L::STAGES, kb, k_st, k2b, vb, v_st, 0, T);
  cp_async_commit();

  // this thread's query rows r_i = 16·warp + lane/4 + 8·i: lse and Δ (zero past T)
  float cl[2], delta_r[2];  // recompute_p2's c
  bool row_live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = m0 + (threadIdx.x >> 5) * 16 + (lane >> 2) + 8 * i;
    row_live[i] = t < T;
    const float l = lseb[t];
    cl[i] = BOUNDED ? (bound - l) * LOG2E : -l * LOG2E;
    delta_r[i] = deltab[t];
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (n + 1 < n_tiles)
      load_key_stage<D, TWO_KEYS>(base + L::STAGES + ((n + 1) & 1) * L::STAGE, kb, k_st, k2b, vb, v_st,
                                  (n + 1) * BLOCK, T);
    cp_async_commit();
    const uint32_t k_s = base + L::STAGES + (n & 1) * L::STAGE;
    const uint32_t k2_s = k_s + L::K2, v_s = k_s + L::V;

    // S and dP [64 queries, 64 keys]
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_operands(s);
    fence_operands(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, smem_desc<ROW>(base + L::Q + kk * 32), smem_desc<ROW>(k_s + kk * 32), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, smem_desc<ROW>(base + L::DO + kk * 32), smem_desc<ROW>(v_s + kk * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S is in; dP still runs while P is formed
    fence_operands(s);

    // dS = P ⊙ (dP − Δ) with P = exp(S − lse) (K5: clamped); zero for keys
    // and queries past T
    const int n0 = n * BLOCK;
    const bool ragged = n0 + BLOCK > T;
#pragma unroll
    for (int j = 0; j < BLOCK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool key_live = !ragged || n0 + 8 * j + c0 + c < T;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 4 * j + 2 * i + c;
          s[r] = key_live && row_live[i] ? recompute_p2<BOUNDED>(s[r], cl[i], b2) : 0.f;
        }
      }
    wgmma_wait<0>();
    fence_operands(dp);
#pragma unroll
    for (int r = 0; r < 32; ++r) dp[r] = s[r] * (dp[r] - delta_r[(r >> 1) & 1]);
    uint32_t da[BLOCK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) pack_a(da[kk], dp, kk);
    fence_operands(acc_dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) wgmma_rs(acc_dq, da[kk], smem_desc<ROW>(k2_s + kk * 16 * ROW));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc_dq);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace attn_bwd
