// QK-norm flash attention, backward — hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel nvit_tpu/ops/flash_attention.py::
// _bwd_fused_qknorm_kernel, launched by _bwd_qknorm: K2 is its plain recompute
// (bounded=False: the "rowmax" and "auto" modes), K5's backward its clamped
// recompute (bounded=True: the static "bounded" mode only).  Given the
// forward's o and lse (qknorm_attn_fwd.cu) and dO, per (b, h):
//
//   qn = q/max(‖q‖, 1e-30)   kn = k/max(‖k‖, 1e-30)          (fp32)
//   q̂_s = bf16((s·scale) ⊙ qn)   k̂ = bf16(s ⊙ kn)   k̂_s = bf16((s·scale) ⊙ kn)
//   S = q̂_s k̂ᵀ   P = exp(S − lse)   Δ = rowsum(dO ∘ O)   dP = dO Vᵀ
//     (K5: P = exp(max(S − bound, −60) + (bound − lse)), bound = scale·max_d(s_d²),
//      so P reproduces the forward's clamped softmax; a row the floor clamps
//      whole keeps the TPU kernel's approximate cotangent: dS is not zeroed)
//   dS = P ⊙ (dP − Δ)
//   dV = bf16(P)ᵀ dO    dk̂ = bf16(dS)ᵀ q̂_s    dq̂ = bf16(dS) k̂_s        (fp32)
//   dq = (s⊙dq̂ − qn·Σ(qn ⊙ s⊙dq̂))/‖q‖,  likewise dk        (justnorm VJP)
//   dsqk[b, h] = Σ_t (dq̂ ⊙ qn + dk̂ ⊙ kn)
//
// with s = sqk_eff[h] (fp32 [H, D]) and the TPU kernel's rounding points.
// q̂_s, k̂ and k̂_s come from the projection prologue (qknorm_project.cu) in
// exactly K1's multiply order, so S and P reproduce the forward softmax.
//
// What bounds it on the H100: seven T×T×D products per (b, h) in this
// design (five in the function), against ~8·T·D bf16 values of traffic —
// far above the bf16 ridge: the tensor cores and the exp/ALU work of the
// [T, T] tiles bound it, not memory.  Only wgmma reaches the tensor-core
// rate.
//
// Design: the TPU kernel is ONE program per (b, h) holding whole [T, T] fp32
// s, p, dp and ds tiles in VMEM (2.4 MB each at T = 784); a Hopper block has
// 227 KB of shared memory.  So the math is ported on FlashAttention-2's
// backward structure, in three launches on one stream, all deterministic:
//
// 1. the prologue (qknorm_project.cu) — q̂_s, k̂, k̂_s once per call as bf16
//    scratch, Δ = Σ_d dO·O in fp32 and lse, both padded to whole 64-row tiles.
// 2. dK/dV — one block (one warpgroup) per (b·h, 64-key tile).  k̂ and v stay
//    in shared memory; each 64-query tile's q̂_s, dO, lse and Δ come through
//    a two-stage cp.async ring.  Sᵀ = k̂ q̂_sᵀ and dPᵀ = v dOᵀ are m64n64k16
//    wgmmas into registers; Pᵀ and dSᵀ are formed there, rounded to bf16 in
//    registers and are the A operands of dV += Pᵀ dO and dk̂ += dSᵀ q̂_s, whose
//    B operand is the query tile read MN-major (no transposed copy).  dV and
//    dk̂ accumulate in registers across the walk.  The epilogue applies the
//    justnorm VJP to dk̂ and writes this tile's Σ_t dk̂ ⊙ kn.
// 3. dQ — one block per (b·h, 64-query tile), walking the key tiles (k̂, k̂_s,
//    v) the same way, query-major, accumulating dq̂ in registers; its
//    epilogue applies the VJP to dq̂ and writes the tile's Σ_t dq̂ ⊙ qn.
// The per-tile dsqk partials go to a [B·H, 2·n_tiles, D] fp32 buffer that
// the wrapper sums in a fixed order — no atomics anywhere.  The dK/dV and dQ
// passes each recompute S and dP (7 products instead of 5): the price of
// keeping dq out of atomics.  Sᵀ, dPᵀ, Pᵀ, dSᵀ, dV and dk̂ never touch shared
// memory; only the epilogues stage fp32 rows there for the row-wise VJP.
//
// K10 (nvit_qknorm_attn_bwd_subtiled) replaces scripts/attn_bwd_split_bench.py::
// _bwd_split_kernel: K2's function in its plain-recompute arm, restructured on
// the TPU into nsplit independent query sub-tiles (≙ _split_bounds: 16-aligned
// rows, the last taking the rest), with Δ taken per sub-tile inside the
// program, dq̂ complete per sub-tile and dV, dk̂ accumulated across them in
// fp32 — one pass, five products, no Δ pass.  It lives here because it shares
// K2's math, helpers and layout.  The same [T, D] fp32 accumulators per (b, h)
// do not fit a block, so it runs one pass per key tile with a split-K dq, in
// two launches, deterministic and without atomics:
//
// 1. One block per (b·h, 64-key tile), four warps.  The block projects its
//    keys once (k̂ and k̂_s) and walks the sub-tiles in order, each in chunks
//    of ≤ 64 query rows (every chunk is a multiple of 16 rows: 112 = 64 + 48).
//    Per chunk it forms the chunk's Δ from dO and O, then Sᵀ, Pᵀ, dPᵀ and dSᵀ
//    once (key-major, as K2's dK/dV pass), adds to dV and dk̂ in register
//    fragments, and writes this key tile's dq̂ share bf16(dS) k̂_s to an fp32
//    partial buffer [B·H, n_tiles, T, D].  Its epilogue (dkv_epilogue) is K2's
//    math: the justnorm VJP of dk̂ and the tile's dsqk partial.
// 2. One block per (b·h, 64-query tile) sums the dq̂ shares over the key tiles
//    in tile order, applies the justnorm VJP and writes dq and the tile's
//    Σ_t dq̂ ⊙ qn.
// Five products instead of K2's seven and two launches instead of three; the
// price is the partial buffer, 4·n_tiles·T·D bytes per (b, h) written once and
// read once (0.93 GiB at [384, 784, 64], ~0.6 ms of traffic at 3.35 TB/s).
//
// K10's kernels keep nvcuda::wmma with every intermediate in shared memory;
// K2's above are the wgmma redesign (hopper.cuh).
//
// Ragged T (784 = 12·64 + 16): query columns past T get P = 0 (their dO and
// Δ rows are zero too); key rows past T are computed on zero-filled k/v (the
// 1e-30 floor keeps them finite), never stored and masked out of dsqk.
// q, k, v, o, dO and the three outputs are addressed through (batch, head,
// token) strides with a contiguous head dim, so q/k/v can stay views of the
// fused QKV projection and dq/dk/dv can land in one [B, T, 3, H, D] buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BLOCK = 64;  // rows per tile, queries or keys
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr float NORM_EPS = 1e-30f;  // ≙ flash_attention.py _NORM_EPS
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float BOUNDED_EXP_FLOOR = -60.0f;  // ≙ flash_attention.py _BOUNDED_EXP_FLOOR

// (batch, head, token) element strides of the eight [B, H, T, D] operands;
// o is read by K10 alone (K2's Δ comes from the prologue)
struct Strides {
  int64_t q[3], k[3], v[3], o[3], dO[3], dq[3], dk[3], dv[3];
};

template <int D>
struct Pitch {
  // padded off a multiple of 128 bytes against bank conflicts; each stays a
  // multiple of 16 bytes (vector stores) and of wmma's ldm unit
  static constexpr int H = D + 8;      // bf16 [., D] rows
  static constexpr int S = BLOCK + 4;  // fp32 [., 64] rows
  static constexpr int P = BLOCK + 8;  // bf16 [., 64] rows
};

// Row t of one head as fp32, half a row (D/2 values) per thread; zeros past T.
template <int D>
__device__ __forceinline__ void load_half_row(float* x, const bf16* __restrict__ head, int64_t st,
                                              int t, int T, int half) {
  constexpr int HALF = D / 2;
  if (t < T) {
    const uint4* g = reinterpret_cast<const uint4*>(head + (int64_t)t * st + half * HALF);
#pragma unroll
    for (int i = 0; i < HALF / 8; ++i) {
      const uint4 raw = g[i];
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) x[i * 8 + j] = __bfloat162float(e[j]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < HALF; ++i) x[i] = 0.f;
  }
}

// max(‖row‖, eps) of the row whose halves sit in lanes 2r and 2r + 1
template <int D>
__device__ __forceinline__ float row_norm(const float* x) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) ss += x[i] * x[i];
  ss += __shfl_xor_sync(FULL, ss, 1);
  return fmaxf(sqrtf(ss), NORM_EPS);
}

// bf16((s·scale) ⊙ (x/norm)) of half a row — K1's multiply order exactly
template <int D>
__device__ __forceinline__ void store_projected(bf16* dst, const float* x, float norm,
                                                const float* __restrict__ s_vec, float scale,
                                                int half) {
  constexpr int HALF = D / 2;
#pragma unroll
  for (int i = 0; i < HALF / 8; ++i) {
    uint4 packed;
    bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = half * HALF + i * 8 + j;
      e[j] = __float2bfloat16((s_vec[d] * scale) * (x[i * 8 + j] / norm));
    }
    reinterpret_cast<uint4*>(dst)[i] = packed;
  }
}

// raw copy of half of row t (zeros past T)
template <int D>
__device__ __forceinline__ void copy_half_row(bf16* dst, const bf16* __restrict__ head, int64_t st,
                                              int t, int T, int half) {
  constexpr int HALF = D / 2;
  uint4* out = reinterpret_cast<uint4*>(dst);
  const uint4* g = reinterpret_cast<const uint4*>(head + (int64_t)t * st + half * HALF);
#pragma unroll
  for (int i = 0; i < HALF / 8; ++i) out[i] = t < T ? g[i] : make_uint4(0u, 0u, 0u, 0u);
}

// half a row of fp32 values → bf16 in device memory
template <int D>
__device__ __forceinline__ void store_half_row_bf16(bf16* dst, const float* x) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    uint4 packed;
    bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(x[i * 8 + j]);
    reinterpret_cast<uint4*>(dst)[i] = packed;
  }
}

// Epilogue shared by both passes, for the row whose halves sit in lanes 2r and
// 2r + 1: from the fp32 gradient g = dx̂ (half row in shared memory) and the
// raw input row t, write dx = (s⊙g − xn·Σ(xn ⊙ s⊙g))/‖x‖ to `out` (half row
// t of the output) and overwrite g in place with its dsqk contribution
// g ⊙ xn (zero past T).
template <int D>
__device__ __forceinline__ void justnorm_vjp_row(float* g, const bf16* __restrict__ head, int64_t st,
                                                 bf16* __restrict__ out, int t, int T, int half,
                                                 const float* __restrict__ s_vec) {
  constexpr int HALF = D / 2;
  float x[HALF];
  load_half_row<D>(x, head, st, t, T, half);
  const float norm = row_norm<D>(x);
  float dxn[HALF];
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const int d = half * HALF + i;
    x[i] = x[i] / norm;  // xn
    dxn[i] = s_vec[d] * g[i];
    dot += x[i] * dxn[i];
  }
  dot += __shfl_xor_sync(FULL, dot, 1);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float part = t < T ? g[i] * x[i] : 0.f;
    dxn[i] = (dxn[i] - x[i] * dot) / norm;
    g[i] = part;
  }
  if (t < T) store_half_row_bf16<D>(out, dxn);
}

// K5's per-head bound scale·max_d(s_d²), the same in every thread of the block
// and bit-equal to the forward's (a max is exact in any order)
template <int D>
__device__ __forceinline__ float head_bound(const float* __restrict__ s_vec, float scale,
                                            float* red) {
  float m = 0.f;
  for (int d = threadIdx.x; d < D; d += NUM_THREADS) m = fmaxf(m, s_vec[d] * s_vec[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NUM_WARPS; ++w) m = fmaxf(m, red[w]);
  return scale * m;
}

// Fixed-order column sums of the 64 × D dsqk contributions → one partial row.
template <int D>
__device__ __forceinline__ void write_dsqk_partial(const float* contrib, float* __restrict__ dst) {
  for (int d = threadIdx.x; d < D; d += NUM_THREADS) {
    float acc = 0.f;
    for (int r = 0; r < BLOCK; ++r) acc += contrib[r * Pitch<D>::S + d];
    dst[d] = acc;
  }
}

// ------------------------------------------------------------------ K10's walk
template <int D>
struct SmemKV {
  bf16 k[BLOCK * Pitch<D>::H];   // k̂ of this block's keys
  bf16 v[BLOCK * Pitch<D>::H];   // raw v of this block's keys
  bf16 q[BLOCK * Pitch<D>::H];   // q̂_s of the current query tile
  bf16 dO[BLOCK * Pitch<D>::H];  // dO of the current query tile
  float s[BLOCK * Pitch<D>::S];  // Sᵀ; dV then dk̂ in the epilogue
  float dp[BLOCK * Pitch<D>::S];  // dPᵀ
  bf16 p[BLOCK * Pitch<D>::P];   // bf16 Pᵀ
  bf16 ds[BLOCK * Pitch<D>::P];  // bf16 dSᵀ
  float lse[BLOCK];
  float delta[BLOCK];
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragAcc;

// K10's key-major walk, on nvcuda::wmma.  Four warps, 16 keys each, so
// every product is warp-local.
//
// Prologue: this block's keys as k̂ (and k̂_s into `ks` when given) in K1's
// multiply order and raw v, then each warp's 16 keys as A operands.
template <int D>
__device__ __forceinline__ void load_key_tile(SmemKV<D>& sm, bf16* ks, FragA (&a_k)[D / 16],
                                              FragA (&a_v)[D / 16], const bf16* __restrict__ kb,
                                              int64_t k_st, const bf16* __restrict__ vb, int64_t v_st,
                                              int n0, int T, const float* __restrict__ s_vec,
                                              float scale) {
  using P = Pitch<D>;
  const int lr = threadIdx.x >> 1;  // two threads per tile row
  const int lh = threadIdx.x & 1;
  const int warp = threadIdx.x >> 5;
  {
    float x[D / 2];
    load_half_row<D>(x, kb, k_st, n0 + lr, T, lh);
    const float norm = row_norm<D>(x);
    store_projected<D>(sm.k + lr * P::H + lh * (D / 2), x, norm, s_vec, 1.0f, lh);
    if (ks != nullptr) store_projected<D>(ks + lr * P::H + lh * (D / 2), x, norm, s_vec, scale, lh);
    copy_half_row<D>(sm.v + lr * P::H + lh * (D / 2), vb, v_st, n0 + lr, T, lh);
  }
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(a_k[kk], sm.k + warp * 16 * P::H + kk * 16, P::H);
    wmma::load_matrix_sync(a_v[kk], sm.v + warp * 16 * P::H + kk * 16, P::H);
  }
}

// Sᵀ = k̂ q̂_sᵀ and dPᵀ = v dOᵀ for this warp's 16 keys × the 64 query
// columns in sm.q / sm.dO (stored [query][d] row-major = [d][query]
// column-major), into this warp's rows of sm.s / sm.dp
template <int D>
__device__ __forceinline__ void key_major_scores(SmemKV<D>& sm, const FragA (&a_k)[D / 16],
                                                 const FragA (&a_v)[D / 16], int warp) {
  using P = Pitch<D>;
#pragma unroll
  for (int j = 0; j < BLOCK / 16; ++j) {
    FragAcc acc_s, acc_p;
    wmma::fill_fragment(acc_s, 0.f);
    wmma::fill_fragment(acc_p, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bq, bo;
      wmma::load_matrix_sync(bq, sm.q + j * 16 * P::H + kk * 16, P::H);
      wmma::load_matrix_sync(bo, sm.dO + j * 16 * P::H + kk * 16, P::H);
      wmma::mma_sync(acc_s, a_k[kk], bq, acc_s);
      wmma::mma_sync(acc_p, a_v[kk], bo, acc_p);
    }
    wmma::store_matrix_sync(sm.s + warp * 16 * P::S + j * 16, acc_s, P::S, wmma::mem_row_major);
    wmma::store_matrix_sync(sm.dp + warp * 16 * P::S + j * 16, acc_p, P::S, wmma::mem_row_major);
  }
}

// dV += bf16(Pᵀ) dO and dk̂ += bf16(dSᵀ) q̂_s for this warp's 16 keys
template <int D>
__device__ __forceinline__ void accumulate_dv_dk(const SmemKV<D>& sm, FragAcc (&acc_dv)[D / 16],
                                                 FragAcc (&acc_dk)[D / 16], int warp) {
  using P = Pitch<D>;
#pragma unroll
  for (int kk = 0; kk < BLOCK / 16; ++kk) {
    FragA ap, ad;
    wmma::load_matrix_sync(ap, sm.p + warp * 16 * P::P + kk * 16, P::P);
    wmma::load_matrix_sync(ad, sm.ds + warp * 16 * P::P + kk * 16, P::P);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bo, bq;
      wmma::load_matrix_sync(bo, sm.dO + kk * 16 * P::H + j * 16, P::H);
      wmma::load_matrix_sync(bq, sm.q + kk * 16 * P::H + j * 16, P::H);
      wmma::mma_sync(acc_dv[j], ap, bo, acc_dv[j]);
      wmma::mma_sync(acc_dk[j], ad, bq, acc_dk[j]);
    }
  }
}

// Epilogue: dV straight out; dk̂ through the justnorm VJP (warp-local rows);
// then this key tile's Σ_t dk̂ ⊙ kn into its dsqk partial slot
template <int D>
__device__ __forceinline__ void dkv_epilogue(SmemKV<D>& sm, const FragAcc (&acc_dv)[D / 16],
                                             const FragAcc (&acc_dk)[D / 16],
                                             const bf16* __restrict__ kb, int64_t k_st,
                                             bf16* __restrict__ dk_head, int64_t dk_st,
                                             bf16* __restrict__ dv_head, int64_t dv_st, int n0,
                                             int T, const float* __restrict__ s_vec,
                                             float* __restrict__ dsqk_slot) {
  using P = Pitch<D>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int t = n0 + row;
  float* grow = sm.s + row * P::S + half * (D / 2);
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(sm.s + warp * 16 * P::S + j * 16, acc_dv[j], P::S, wmma::mem_row_major);
  __syncwarp();
  if (t < T) store_half_row_bf16<D>(dv_head + (int64_t)t * dv_st + half * (D / 2), grow);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(sm.s + warp * 16 * P::S + j * 16, acc_dk[j], P::S, wmma::mem_row_major);
  __syncwarp();
  justnorm_vjp_row<D>(grow, kb, k_st, dk_head + (int64_t)t * dk_st + half * (D / 2), t, T, half,
                      s_vec);
  __syncthreads();
  write_dsqk_partial<D>(sm.s, dsqk_slot);
}

// ------------------------------------------------------------------ K2 / K5
// The recomputed softmax entry exp(s − lse), or K5's clamped form
// exp(max(s − bound, −60) + (bound − lse)), as exp2 with log2 e folded in:
// c = −lse·log2 e (K2) or (bound − lse)·log2 e (K5), b2 = bound·log2 e
template <bool BOUNDED>
__device__ __forceinline__ float recompute_p2(float s, float c, float b2) {
  if constexpr (BOUNDED) return exp2f(fmaxf(fmaf(s, LOG2E, -b2), BOUNDED_EXP_FLOOR * LOG2E) + c);
  return exp2f(fmaf(s, LOG2E, c));
}

// An fp32 64 × D accumulator (hopper.cuh's layout) → rows of `g` (pitch
// Pitch<D>::S), for the row-wise epilogues
template <int D>
__device__ __forceinline__ void dump_acc(float* g, const float (&acc)[D / 2]) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(g + (r0 + 8 * i) * Pitch<D>::S + 8 * j + c0) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
}

// byte offsets in the dK/dV block's 1024-aligned dynamic shared memory
template <int D>
struct LayoutKV {
  static constexpr int TILE = BLOCK * D * 2;  // one swizzled 64-row bf16 tile
  static constexpr int KH = 0, V = TILE;      // this block's k̂ and v, the whole walk
  static constexpr int STAGES = 2 * TILE;     // stage s at STAGES + s·STAGE: q̂_s, dO, lse, Δ
  static constexpr int STAGE = (2 * TILE + 2 * BLOCK * 4 + 1023) / 1024 * 1024;
  static constexpr int BYTES = STAGES + 2 * STAGE + 1024;  // + alignment slack
  // the epilogue's fp32 [64, D] rows reuse the stages
  static_assert(2 * STAGE >= BLOCK * Pitch<D>::S * 4, "epilogue tile");
};

// one query tile's q̂_s, dO and [lse, Δ] rows into a dK/dV stage
template <int D>
__device__ __forceinline__ void load_query_stage(uint32_t stage, const bf16* __restrict__ qb,
                                                 const bf16* __restrict__ dOb, int64_t dO_st,
                                                 const float* __restrict__ lseb,
                                                 const float* __restrict__ deltab, int m0, int T) {
  using L = LayoutKV<D>;
  hopper::load_tile<D>(stage, qb, D, m0, T);
  hopper::load_tile<D>(stage + L::TILE, dOb, dO_st, m0, T);
  if (threadIdx.x < 2 * BLOCK / 4) {  // 16 chunks of lse, 16 of Δ: padded rows, always in range
    const int c = threadIdx.x % (BLOCK / 4);
    const float* src = (threadIdx.x < BLOCK / 4 ? lseb : deltab) + m0 + 4 * c;
    hopper::cp_async16(stage + 2 * L::TILE + threadIdx.x * 16, src, true);
  }
}

// dK/dV pass: one block (one warpgroup) per (b·h, 64-key tile).  k̂ and v
// stay in shared memory; each query tile's q̂_s, dO, lse and Δ arrive in a
// two-stage cp.async ring.  Sᵀ = k̂ q̂_sᵀ and dPᵀ = v dOᵀ are wgmmas into
// registers; Pᵀ and dSᵀ are formed there, rounded to bf16 and fed from
// registers to dV += Pᵀ dO and dk̂ += dSᵀ q̂_s, whose B operands are the
// query tile read MN-major.  dV and dk̂ stay in registers across the walk.
template <int D, bool BOUNDED>
__global__ void __launch_bounds__(NUM_THREADS)
qknorm_attn_bwd_dkv_kernel(const bf16* __restrict__ k, const float* __restrict__ sqk,
                           const bf16* __restrict__ qs, const bf16* __restrict__ kh,
                           const bf16* __restrict__ v, const bf16* __restrict__ dO,
                           const float* __restrict__ lse_pad, const float* __restrict__ delta_pad,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           float* __restrict__ dsqk_part, int H, int T, int T_pad, int n_slots,
                           float scale, Strides st) {
  using namespace hopper;
  using L = LayoutKV<D>;
  constexpr int ROW = 2 * D;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[NUM_WARPS];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sp = smem_raw + (base - raw);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int n0 = blockIdx.x * BLOCK;
  const int lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);  // this thread's columns 8·j + c0 + c (hopper.cuh)
  const float* s_vec = sqk + h * D;
  const float bound = BOUNDED ? head_bound<D>(s_vec, scale, red) : 0.f;
  const float b2 = bound * LOG2E;
  const bf16* qb = qs + (int64_t)bh * T * D;
  const bf16* dOb = dO + b * st.dO[0] + h * st.dO[1];
  const float* lseb = lse_pad + (int64_t)bh * T_pad;
  const float* deltab = delta_pad + (int64_t)bh * T_pad;

  load_tile<D>(base + L::KH, kh + (int64_t)bh * T * D, D, n0, T);
  load_tile<D>(base + L::V, v + b * st.v[0] + h * st.v[1], st.v[2], n0, T);
  load_query_stage<D>(base + L::STAGES, qb, dOb, st.dO[2], lseb, deltab, 0, T);
  cp_async_commit();

  float acc_dv[D / 2], acc_dk[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dv[i] = acc_dk[i] = 0.f;
  const int n_tiles = T_pad / BLOCK;
  for (int m = 0; m < n_tiles; ++m) {
    cp_async_wait<0>();  // query tile m has landed
    fence_proxy_async();
    __syncthreads();     // ... for every thread; and tile m − 1's stage is free
    if (m + 1 < n_tiles)
      load_query_stage<D>(base + L::STAGES + ((m + 1) & 1) * L::STAGE, qb, dOb, st.dO[2], lseb,
                          deltab, (m + 1) * BLOCK, T);
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
    // P = 0 for queries past T
    const int m0 = m * BLOCK;
    const bool ragged = m0 + BLOCK > T;
#pragma unroll
    for (int j = 0; j < BLOCK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + c0 + c;
        const bool live = !ragged || m0 + col < T;
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
    fence_operands(acc_dv);
    fence_operands(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) wgmma_rs(acc_dv, pa[kk], smem_desc<ROW>(do_s + kk * 16 * ROW));
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) wgmma_rs(acc_dk, da[kk], smem_desc<ROW>(q_s + kk * 16 * ROW));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc_dv);
    fence_operands(acc_dk);
  }

  // epilogue (≙ dkv_epilogue): dV straight out; dk̂ through the justnorm VJP;
  // this key tile's Σ_t dk̂ ⊙ kn into its dsqk partial slot
  __syncthreads();  // every wgmma is done with the stages
  float* g = reinterpret_cast<float*>(sp + L::STAGES);
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;  // two threads per key row
  const int t = n0 + row;
  float* grow = g + row * Pitch<D>::S + half * (D / 2);
  dump_acc<D>(g, acc_dv);
  __syncthreads();
  if (t < T) store_half_row_bf16<D>(dv + b * st.dv[0] + h * st.dv[1] + (int64_t)t * st.dv[2] + half * (D / 2), grow);
  __syncthreads();
  dump_acc<D>(g, acc_dk);
  __syncthreads();
  justnorm_vjp_row<D>(grow, k + b * st.k[0] + h * st.k[1], st.k[2],
                      dk + b * st.dk[0] + h * st.dk[1] + (int64_t)t * st.dk[2] + half * (D / 2), t, T,
                      half, s_vec);
  __syncthreads();
  write_dsqk_partial<D>(g, dsqk_part + ((int64_t)bh * n_slots + blockIdx.x) * D);
}

// byte offsets in the dQ block's 1024-aligned dynamic shared memory
template <int D>
struct LayoutQ {
  static constexpr int TILE = BLOCK * D * 2;
  static constexpr int Q = 0, DO = TILE;   // this block's q̂_s and dO, the whole walk
  static constexpr int STAGES = 2 * TILE;  // stage s at STAGES + s·STAGE: k̂, k̂_s, v
  static constexpr int STAGE = 3 * TILE;
  static constexpr int BYTES = STAGES + 2 * STAGE + 1024;
  static_assert(2 * STAGE >= BLOCK * Pitch<D>::S * 4, "epilogue tile");
};

template <int D>
__device__ __forceinline__ void load_key_stage(uint32_t stage, const bf16* __restrict__ khb,
                                               const bf16* __restrict__ ksb,
                                               const bf16* __restrict__ vb, int64_t v_st, int n0,
                                               int T) {
  constexpr int TILE = LayoutQ<D>::TILE;
  hopper::load_tile<D>(stage, khb, D, n0, T);
  hopper::load_tile<D>(stage + TILE, ksb, D, n0, T);
  hopper::load_tile<D>(stage + 2 * TILE, vb, v_st, n0, T);
}

// dQ pass: one block per (b·h, 64-query tile), query-major, walking the key
// tiles (k̂, k̂_s, v) in a two-stage cp.async ring: S = q̂_s k̂ᵀ and dP = dO vᵀ
// into registers, dS formed there and fed from registers to dq̂ += dS k̂_s
// (k̂_s read MN-major); dq̂ stays in registers.
template <int D, bool BOUNDED>
__global__ void __launch_bounds__(NUM_THREADS)
qknorm_attn_bwd_dq_kernel(const bf16* __restrict__ q, const float* __restrict__ sqk,
                          const bf16* __restrict__ qs, const bf16* __restrict__ kh,
                          const bf16* __restrict__ ks, const bf16* __restrict__ v,
                          const bf16* __restrict__ dO, const float* __restrict__ lse_pad,
                          const float* __restrict__ delta_pad, bf16* __restrict__ dq,
                          float* __restrict__ dsqk_part, int H, int T, int T_pad, int n_slots,
                          int n_tiles, float scale, Strides st) {
  using namespace hopper;
  using L = LayoutQ<D>;
  constexpr int ROW = 2 * D;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[NUM_WARPS];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sp = smem_raw + (base - raw);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * BLOCK;
  const int lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
  const float* s_vec = sqk + h * D;
  const float bound = BOUNDED ? head_bound<D>(s_vec, scale, red) : 0.f;
  const float b2 = bound * LOG2E;
  const int64_t head = (int64_t)bh * T * D;
  const bf16* vb = v + b * st.v[0] + h * st.v[1];

  load_tile<D>(base + L::Q, qs + head, D, m0, T);
  load_tile<D>(base + L::DO, dO + b * st.dO[0] + h * st.dO[1], st.dO[2], m0, T);
  load_key_stage<D>(base + L::STAGES, kh + head, ks + head, vb, st.v[2], 0, T);
  cp_async_commit();

  // this thread's query rows r_i = 16·warp + lane/4 + 8·i: lse and Δ (zero past T)
  float cl[2], delta_r[2];  // recompute_p2's c
  bool row_live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = m0 + (threadIdx.x >> 5) * 16 + (lane >> 2) + 8 * i;
    row_live[i] = t < T;
    const float l = lse_pad[(int64_t)bh * T_pad + t];
    cl[i] = BOUNDED ? (bound - l) * LOG2E : -l * LOG2E;
    delta_r[i] = delta_pad[(int64_t)bh * T_pad + t];
  }
  float acc_dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (n + 1 < n_tiles)
      load_key_stage<D>(base + L::STAGES + ((n + 1) & 1) * L::STAGE, kh + head, ks + head, vb,
                        st.v[2], (n + 1) * BLOCK, T);
    cp_async_commit();
    const uint32_t kh_s = base + L::STAGES + (n & 1) * L::STAGE;
    const uint32_t ks_s = kh_s + L::TILE, v_s = kh_s + 2 * L::TILE;

    // S and dP [64 queries, 64 keys]
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_operands(s);
    fence_operands(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, smem_desc<ROW>(base + L::Q + kk * 32), smem_desc<ROW>(kh_s + kk * 32), kk > 0);
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
    for (int kk = 0; kk < BLOCK / 16; ++kk) wgmma_rs(acc_dq, da[kk], smem_desc<ROW>(ks_s + kk * 16 * ROW));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc_dq);
  }

  // epilogue: dq̂ through the justnorm VJP → dq, and the tile's Σ_t dq̂ ⊙ qn
  __syncthreads();
  float* g = reinterpret_cast<float*>(sp + L::STAGES);
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int t = m0 + row;
  dump_acc<D>(g, acc_dq);
  __syncthreads();
  justnorm_vjp_row<D>(g + row * Pitch<D>::S + half * (D / 2), q + b * st.q[0] + h * st.q[1], st.q[2],
                      dq + b * st.dq[0] + h * st.dq[1] + (int64_t)t * st.dq[2] + half * (D / 2), t,
                      T, half, s_vec);
  __syncthreads();
  write_dsqk_partial<D>(g, dsqk_part + ((int64_t)bh * n_slots + n_tiles + blockIdx.x) * D);
}

// ------------------------------------------------------------------ K10
// One pass per 64-key tile over the q sub-tiles: S, P, dP and dS are formed
// once per (query chunk, key tile); dV and dk̂ stay in registers, and this key
// tile's share of dq̂ goes to an fp32 partial buffer [B·H, n_tiles, T, D].
template <int D>
struct SmemSub {
  SmemKV<D> kv;                  // K2's dK/dV tiles, the query tile being a chunk
  bf16 ks[BLOCK * Pitch<D>::H];  // k̂_s of this block's keys
};

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
qknorm_attn_bwd_subtiled_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const float* __restrict__ sqk,
                                const bf16* __restrict__ o, const bf16* __restrict__ dO,
                                const float* __restrict__ lse, bf16* __restrict__ dk,
                                bf16* __restrict__ dv, float* __restrict__ dq_part,
                                float* __restrict__ dsqk_part, int H, int T, int nsplit,
                                int n_slots, float scale, Strides st) {
  using P = Pitch<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemSub<D>& sub = *reinterpret_cast<SmemSub<D>*>(smem_raw);
  SmemKV<D>& sm = sub.kv;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int n0 = blockIdx.x * BLOCK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lr = threadIdx.x >> 1;  // block-wide loads: two threads per tile row
  const int lh = threadIdx.x & 1;
  const float* s_vec = sqk + h * D;
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* ob = o + b * st.o[0] + h * st.o[1];
  const bf16* dOb = dO + b * st.dO[0] + h * st.dO[1];
  float* dq_tile = dq_part + ((int64_t)bh * gridDim.x + blockIdx.x) * T * D;

  FragA a_k[D / 16], a_v[D / 16];  // this warp's 16 keys, fixed across the query walk
  load_key_tile<D>(sm, sub.ks, a_k, a_v, kb, st.k[2], v + b * st.v[0] + h * st.v[1], st.v[2], n0,
                   T, s_vec, scale);
  FragAcc acc_dv[D / 16], acc_dk[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(acc_dv[j], 0.f);
    wmma::fill_fragment(acc_dk[j], 0.f);
  }

  const int row = warp * 16 + (lane >> 1);  // elementwise: this lane's key row
  const int half = lane & 1;                // ... and half of the 64 query columns
  const bool key_live = n0 + row < T;
  const int step = ((T / nsplit) / 16) * 16;  // ≙ _split_bounds
  for (int part = 0; part < nsplit; ++part) {
    const int a = part * step;
    const int e = part == nsplit - 1 ? T : a + step;
    for (int m0 = a; m0 < e; m0 += BLOCK) {
      const int m1 = min(m0 + BLOCK, e);  // this chunk's query rows: [m0, m1), a multiple of 16
      __syncthreads();  // every warp is done with the previous chunk
      {
        float x[D / 2], y[D / 2];
        load_half_row<D>(x, qb, st.q[2], m0 + lr, m1, lh);
        store_projected<D>(sm.q + lr * P::H + lh * (D / 2), x, row_norm<D>(x), s_vec, scale, lh);
        copy_half_row<D>(sm.dO + lr * P::H + lh * (D / 2), dOb, st.dO[2], m0 + lr, m1, lh);
        // Δ = Σ_d dO·O of this chunk's rows, in fp32 (zero past the chunk)
        load_half_row<D>(x, dOb, st.dO[2], m0 + lr, m1, lh);
        load_half_row<D>(y, ob, st.o[2], m0 + lr, m1, lh);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc += x[i] * y[i];
        acc += __shfl_xor_sync(FULL, acc, 1);
        if (lh == 0) {
          sm.delta[lr] = acc;
          sm.lse[lr] = m0 + lr < m1 ? lse[(int64_t)bh * T + m0 + lr] : 0.f;
        }
      }
      __syncthreads();
      key_major_scores<D>(sm, a_k, a_v, warp);
      __syncwarp();

      // Pᵀ = exp(Sᵀ − lse[query]) and dSᵀ = Pᵀ ⊙ (dPᵀ − Δ[query]); P = 0 for
      // queries past the chunk and keys past T
      {
        constexpr int HN = BLOCK / 2;
        const float* srow = sm.s + row * P::S + half * HN;
        const float* dprow = sm.dp + row * P::S + half * HN;
        bf16* prow = sm.p + row * P::P + half * HN;
        bf16* dsrow = sm.ds + row * P::P + half * HN;
#pragma unroll 8
        for (int c = 0; c < HN; ++c) {
          const int col = half * HN + c;
          const float pv = key_live && m0 + col < m1 ? expf(srow[c] - sm.lse[col]) : 0.f;
          prow[c] = __float2bfloat16(pv);
          dsrow[c] = __float2bfloat16(pv * (dprow[c] - sm.delta[col]));
        }
      }
      __syncwarp();
      accumulate_dv_dk<D>(sm, acc_dv, acc_dk, warp);
      __syncthreads();  // every warp's dSᵀ rows are in

      // this key tile's dq̂ of the chunk, bf16(dS) k̂_s: warp w takes queries
      // m0 + 16w .. + 15 against all 64 keys; dS is dSᵀ read column-major
      if (m0 + warp * 16 < m1) {
        FragAcc acc_q[D / 16];
#pragma unroll
        for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc_q[j], 0.f);
#pragma unroll
        for (int kk = 0; kk < BLOCK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ad;
          wmma::load_matrix_sync(ad, sm.ds + kk * 16 * P::P + warp * 16, P::P);
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk;
            wmma::load_matrix_sync(bk, sub.ks + kk * 16 * P::H + j * 16, P::H);
            wmma::mma_sync(acc_q[j], ad, bk, acc_q[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          wmma::store_matrix_sync(dq_tile + (int64_t)(m0 + warp * 16) * D + j * 16, acc_q[j], D,
                                  wmma::mem_row_major);
      }
    }
  }

  dkv_epilogue<D>(sm, acc_dv, acc_dk, kb, st.k[2], dk + b * st.dk[0] + h * st.dk[1], st.dk[2],
                  dv + b * st.dv[0] + h * st.dv[1], st.dv[2], n0, T, s_vec,
                  dsqk_part + ((int64_t)bh * n_slots + blockIdx.x) * D);
}

// One block per (b·h, 64-query tile): dq̂ = Σ over key tiles, in tile order,
// of the partials; then the justnorm VJP → dq and the tile's Σ_t dq̂ ⊙ qn.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
qknorm_attn_bwd_subtiled_dq_kernel(const bf16* __restrict__ q, const float* __restrict__ sqk,
                                   const float* __restrict__ dq_part, bf16* __restrict__ dq,
                                   float* __restrict__ dsqk_part, int H, int T, int n_slots,
                                   Strides st) {
  using P = Pitch<D>;
  constexpr int ROW4 = D / 4;                           // float4s per row
  constexpr int PER = BLOCK * ROW4 / NUM_THREADS;       // float4s per thread
  __shared__ __align__(16) float g[BLOCK * P::S];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * BLOCK;
  const int n_tiles = gridDim.x;
  const int rows = min(BLOCK, T - m0);
  float4 acc[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < n_tiles; ++j) {
    const float4* src = reinterpret_cast<const float4*>(dq_part + (((int64_t)bh * n_tiles + j) * T + m0) * D);
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int f = threadIdx.x + r * NUM_THREADS;
      if (f / ROW4 < rows) {
        const float4 x = src[f];
        acc[r].x += x.x;
        acc[r].y += x.y;
        acc[r].z += x.z;
        acc[r].w += x.w;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int f = threadIdx.x + r * NUM_THREADS;
    *reinterpret_cast<float4*>(g + (f / ROW4) * P::S + (f % ROW4) * 4) = acc[r];
  }
  __syncthreads();

  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int t = m0 + row;
  justnorm_vjp_row<D>(g + row * P::S + half * (D / 2), q + b * st.q[0] + h * st.q[1], st.q[2],
                      dq + b * st.dq[0] + h * st.dq[1] + (int64_t)t * st.dq[2] + half * (D / 2), t,
                      T, half, sqk + h * D);
  __syncthreads();
  write_dsqk_partial<D>(g, dsqk_part + ((int64_t)bh * n_slots + n_tiles + blockIdx.x) * D);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, bool BOUNDED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* sqk, const void* qs,
                   const void* kh, const void* ks, const void* lse_pad, const void* delta_pad,
                   const void* dO, void* dq, void* dk, void* dv, void* dsqk_part, int B, int H,
                   int T, float scale, const Strides& st, cudaStream_t stream) {
  const int n_tiles = (T + BLOCK - 1) / BLOCK;
  const int n_slots = 2 * n_tiles;
  const int T_pad = n_tiles * BLOCK;
  const dim3 grid(n_tiles, B * H);
  cudaError_t err;
  const int smem_kv = LayoutKV<D>::BYTES;
  if ((err = allow_smem(qknorm_attn_bwd_dkv_kernel<D, BOUNDED>, smem_kv)) != cudaSuccess) return err;
  qknorm_attn_bwd_dkv_kernel<D, BOUNDED><<<grid, NUM_THREADS, smem_kv, stream>>>(
      static_cast<const bf16*>(k), static_cast<const float*>(sqk), static_cast<const bf16*>(qs),
      static_cast<const bf16*>(kh), static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
      static_cast<const float*>(lse_pad), static_cast<const float*>(delta_pad), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dsqk_part), H, T, T_pad, n_slots, scale, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int smem_q = LayoutQ<D>::BYTES;
  if ((err = allow_smem(qknorm_attn_bwd_dq_kernel<D, BOUNDED>, smem_q)) != cudaSuccess) return err;
  qknorm_attn_bwd_dq_kernel<D, BOUNDED><<<grid, NUM_THREADS, smem_q, stream>>>(
      static_cast<const bf16*>(q), static_cast<const float*>(sqk), static_cast<const bf16*>(qs),
      static_cast<const bf16*>(kh), static_cast<const bf16*>(ks), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), static_cast<const float*>(lse_pad),
      static_cast<const float*>(delta_pad), static_cast<bf16*>(dq), static_cast<float*>(dsqk_part), H,
      T, T_pad, n_slots, n_tiles, scale, st);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_subtiled(const void* q, const void* k, const void* v, const void* sqk,
                            const void* o, const void* lse, const void* dO, void* dq, void* dk,
                            void* dv, void* dq_part, void* dsqk_part, int B, int H, int T,
                            float scale, int nsplit, const Strides& st, cudaStream_t stream) {
  const int n_tiles = (T + BLOCK - 1) / BLOCK;
  const int n_slots = 2 * n_tiles;
  const dim3 grid(n_tiles, B * H);
  cudaError_t err;
  const size_t smem = sizeof(SmemSub<D>);
  if ((err = allow_smem(qknorm_attn_bwd_subtiled_kernel<D>, smem)) != cudaSuccess) return err;
  qknorm_attn_bwd_subtiled_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(sqk), static_cast<const bf16*>(o), static_cast<const bf16*>(dO),
      static_cast<const float*>(lse), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dq_part), static_cast<float*>(dsqk_part), H, T, nsplit, n_slots, scale, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  qknorm_attn_bwd_subtiled_dq_kernel<D><<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const float*>(sqk),
      static_cast<const float*>(dq_part), static_cast<bf16*>(dq), static_cast<float*>(dsqk_part),
      H, T, n_slots, st);
  return cudaGetLastError();
}

// strides = {q_sb, q_sh, q_st, k_.., v_.., [o_..,] dO_.., dq_.., dk_.., dv_..},
// o's three only with_o
Strides unpack_strides(const int64_t* strides, bool with_o) {
  Strides st{};
  int64_t* dst[8] = {st.q, st.k, st.v, st.o, st.dO, st.dq, st.dk, st.dv};
  for (int i = 0, n = 0; i < 8; ++i) {
    if (i == 3 && !with_o) continue;
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * n + j];
    ++n;
  }
  return st;
}

}  // namespace

// q, k, v, dO: bf16 [B, H, T, D] addressed through (batch, head, token)
// element strides, head dim contiguous; sqk: fp32 [H, D]; qs, kh, ks: bf16
// [B·H, T, D] and lse_pad, delta_pad: fp32 [B·H, 64·ceil(T/64)], all from
// nvit_qknorm_project.  Outputs dq, dk, dv: bf16, addressed as q; dsqk_part:
// fp32 [B·H, 2·ceil(T/64), D] per-tile partial sums; bounded: 1 for K5's
// clamped recompute, 0 for K2's.
// strides = {q_sb, q_sh, q_st, k_.., v_.., dO_.., dq_.., dk_.., dv_..}.
extern "C" cudaError_t nvit_qknorm_attn_bwd(const void* q, const void* k, const void* v,
                                            const void* sqk, const void* qs, const void* kh,
                                            const void* ks, const void* lse_pad,
                                            const void* delta_pad, const void* dO, void* dq,
                                            void* dk, void* dv, void* dsqk_part, int B, int H,
                                            int T, int D, float scale, int bounded,
                                            const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
  const Strides st = unpack_strides(strides, false);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel_launch) {
    return kernel_launch(q, k, v, sqk, qs, kh, ks, lse_pad, delta_pad, dO, dq, dk, dv, dsqk_part, B, H,
                         T, scale, st, s);
  };
  if (D == 64) return bounded ? go(launch<64, true>) : go(launch<64, false>);
  if (D == 32) return bounded ? go(launch<32, true>) : go(launch<32, false>);
  return cudaErrorInvalidValue;
}

// K10: q, k, v, o, dO, sqk, lse and the outputs dq, dk, dv as for
// nvit_qknorm_attn_bwd; dq_part: fp32 scratch [B·H, ceil(T/64), T, D], each
// key tile's share of dq̂; dsqk_part: fp32 [B·H, 2·ceil(T/64), D] per-tile
// partial sums.  The query rows are walked in nsplit sub-tiles of
// ((T/nsplit)/16)·16 rows, the last taking the rest (≙ _split_bounds): T must
// be a multiple of 16 and every sub-tile non-empty.  P = exp(S − lse), no clamp.
extern "C" cudaError_t nvit_qknorm_attn_bwd_subtiled(const void* q, const void* k, const void* v,
                                                     const void* sqk, const void* o,
                                                     const void* lse, const void* dO, void* dq,
                                                     void* dk, void* dv, void* dq_part,
                                                     void* dsqk_part, int B, int H, int T, int D,
                                                     float scale, int nsplit,
                                                     const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % 16 || nsplit < 1 || (T / nsplit) / 16 < 1)
    return cudaErrorInvalidValue;
  const Strides st = unpack_strides(strides, true);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_subtiled<64>(q, k, v, sqk, o, lse, dO, dq, dk, dv, dq_part, dsqk_part, B, H, T,
                               scale, nsplit, st, s);
  if (D == 32)
    return launch_subtiled<32>(q, k, v, sqk, o, lse, dO, dq, dk, dv, dq_part, dsqk_part, B, H, T,
                               scale, nsplit, st, s);
  return cudaErrorInvalidValue;
}
