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
// q̂_s and k̂ are recomputed in exactly K1's multiply order, so S and P
// reproduce the forward softmax.
//
// What bounds it on the H100: five T×T×D products per (b, h), 10·T²·D flops,
// against 8·T·D bf16 values of traffic — ~600 flops per byte at T = 784,
// D = 64, above the bf16 ridge (~295): the tensor cores and the exp/ALU
// work of the [T, T] tiles bound it, not memory.
//
// Design: the TPU kernel is ONE program per (b, h) holding whole [T, T] fp32
// s, p, dp and ds tiles in VMEM (2.4 MB each at T = 784); a Hopper block has
// 227 KB of shared memory.  So the math is ported on FlashAttention-2's
// backward structure, in three launches on one stream, all deterministic:
//
// 1. delta — Δ[b·h, t] = Σ_d dO·O in fp32 (two threads per row).
// 2. dK/dV — one block per (b·h, 64-key tile).  The block projects its keys
//    once (k̂ in shared memory) and walks every 64-query tile: it recomputes
//    q̂_s, forms Sᵀ, Pᵀ, dPᵀ and dSᵀ key-major (four warps, 16 keys each, so
//    every product is warp-local), and accumulates dV and dk̂ in wmma fp32
//    fragments that live in registers across the walk.  The epilogue applies
//    the justnorm VJP to dk̂ and writes this tile's Σ_t dk̂ ⊙ kn.
// 3. dQ — one block per (b·h, 64-query tile), walking the key tiles and
//    accumulating dq̂ the same way; its epilogue applies the VJP to dq̂ and
//    writes the tile's Σ_t dq̂ ⊙ qn.
// The per-tile dsqk partials go to a [B·H, 2·n_tiles, D] fp32 buffer that
// the wrapper sums in a fixed order — no atomics anywhere.  The dK/dV and dQ
// passes each recompute S and dP (7 products instead of 5): the price of
// keeping dq out of atomics.  Products use nvcuda::wmma bf16 16×16×16 with
// fp32 accumulation; wgmma/TMA pipelining is later work.
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
//    partial buffer [B·H, n_tiles, T, D].  The epilogue is K2's dK/dV one.
// 2. One block per (b·h, 64-query tile) sums the dq̂ shares over the key tiles
//    in tile order, applies the justnorm VJP and writes dq and the tile's
//    Σ_t dq̂ ⊙ qn.
// Five products instead of K2's seven and two launches instead of three; the
// price is the partial buffer, 4·n_tiles·T·D bytes per (b, h) written once and
// read once (0.93 GiB at [384, 784, 64], ~0.6 ms of traffic at 3.35 TB/s).
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

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BLOCK = 64;  // rows per tile, queries or keys
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr float NORM_EPS = 1e-30f;  // ≙ flash_attention.py _NORM_EPS
constexpr unsigned FULL = 0xffffffffu;
constexpr float BOUNDED_EXP_FLOOR = -60.0f;  // ≙ flash_attention.py _BOUNDED_EXP_FLOOR

// (batch, head, token) element strides of the eight [B, H, T, D] operands
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

// The recomputed softmax entry: exp(s − lse), or K5's clamped form
__device__ __forceinline__ float recompute_p(float s, float lse, bool bounded, float bound) {
  return bounded ? expf(fmaxf(s - bound, BOUNDED_EXP_FLOOR) + (bound - lse)) : expf(s - lse);
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

// ------------------------------------------------------------------ delta
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
qknorm_attn_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                             float* __restrict__ delta, int H, int T, Strides st) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int t = blockIdx.x * BLOCK + (threadIdx.x >> 1);
  const int half = threadIdx.x & 1;
  float a[D / 2], g[D / 2];
  load_half_row<D>(a, o + b * st.o[0] + h * st.o[1], st.o[2], t, T, half);
  load_half_row<D>(g, dO + b * st.dO[0] + h * st.dO[1], st.dO[2], t, T, half);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc += g[i] * a[i];
  acc += __shfl_xor_sync(FULL, acc, 1);
  if (t < T && half == 0) delta[(int64_t)bh * T + t] = acc;
}

// ------------------------------------------------------------------ dK / dV
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

// The key-major walk shared by K2's dK/dV pass and K10.  Four warps, 16 keys
// each, so every product is warp-local.
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

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
qknorm_attn_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ sqk,
                           const bf16* __restrict__ dO, const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, float* __restrict__ dsqk_part, int H, int T,
                           int n_slots, float scale, int bounded, Strides st) {
  using P = Pitch<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemKV<D>& sm = *reinterpret_cast<SmemKV<D>*>(smem_raw);
  __shared__ float red[NUM_WARPS];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int n0 = blockIdx.x * BLOCK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lr = threadIdx.x >> 1;  // block-wide loads: two threads per tile row
  const int lh = threadIdx.x & 1;
  const float* s_vec = sqk + h * D;
  const float bound = bounded ? head_bound<D>(s_vec, scale, red) : 0.f;
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* dOb = dO + b * st.dO[0] + h * st.dO[1];

  FragA a_k[D / 16], a_v[D / 16];  // this warp's 16 keys, fixed across the query walk
  load_key_tile<D>(sm, nullptr, a_k, a_v, kb, st.k[2], v + b * st.v[0] + h * st.v[1], st.v[2], n0,
                   T, s_vec, 1.0f);
  FragAcc acc_dv[D / 16], acc_dk[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(acc_dv[j], 0.f);
    wmma::fill_fragment(acc_dk[j], 0.f);
  }

  const int row = warp * 16 + (lane >> 1);  // elementwise: this lane's key row
  const int half = lane & 1;                // ... and half of the 64 query columns
  for (int m0 = 0; m0 < T; m0 += BLOCK) {
    __syncthreads();  // every warp is done with the previous query tile
    {
      float x[D / 2];
      load_half_row<D>(x, qb, st.q[2], m0 + lr, T, lh);
      store_projected<D>(sm.q + lr * P::H + lh * (D / 2), x, row_norm<D>(x), s_vec, scale, lh);
      copy_half_row<D>(sm.dO + lr * P::H + lh * (D / 2), dOb, st.dO[2], m0 + lr, T, lh);
      if (threadIdx.x < BLOCK) {
        const int t = m0 + threadIdx.x;
        sm.lse[threadIdx.x] = t < T ? lse[(int64_t)bh * T + t] : 0.f;
        sm.delta[threadIdx.x] = t < T ? delta[(int64_t)bh * T + t] : 0.f;
      }
    }
    __syncthreads();
    key_major_scores<D>(sm, a_k, a_v, warp);
    __syncwarp();

    // Pᵀ = exp(Sᵀ − lse[query]) (K5: clamped) and dSᵀ = Pᵀ ⊙ (dPᵀ − Δ[query]);
    // P = 0 past T
    {
      constexpr int HN = BLOCK / 2;
      const float* srow = sm.s + row * P::S + half * HN;
      const float* dprow = sm.dp + row * P::S + half * HN;
      bf16* prow = sm.p + row * P::P + half * HN;
      bf16* dsrow = sm.ds + row * P::P + half * HN;
#pragma unroll 8
      for (int c = 0; c < HN; ++c) {
        const int col = half * HN + c;
        const float pv = m0 + col < T ? recompute_p(srow[c], sm.lse[col], bounded, bound) : 0.f;
        prow[c] = __float2bfloat16(pv);
        dsrow[c] = __float2bfloat16(pv * (dprow[c] - sm.delta[col]));
      }
    }
    __syncwarp();
    accumulate_dv_dk<D>(sm, acc_dv, acc_dk, warp);
  }

  dkv_epilogue<D>(sm, acc_dv, acc_dk, kb, st.k[2], dk + b * st.dk[0] + h * st.dk[1], st.dk[2],
                  dv + b * st.dv[0] + h * st.dv[1], st.dv[2], n0, T, s_vec,
                  dsqk_part + ((int64_t)bh * n_slots + blockIdx.x) * D);
}

// ------------------------------------------------------------------ dQ
template <int D>
struct SmemQ {
  bf16 q[BLOCK * Pitch<D>::H];   // q̂_s of this block's queries
  bf16 dO[BLOCK * Pitch<D>::H];  // dO of this block's queries
  bf16 k[BLOCK * Pitch<D>::H];   // k̂ of the current key tile
  bf16 ks[BLOCK * Pitch<D>::H];  // k̂_s of the current key tile
  bf16 v[BLOCK * Pitch<D>::H];   // raw v of the current key tile
  float s[BLOCK * Pitch<D>::S];  // S; dq̂ in the epilogue
  float dp[BLOCK * Pitch<D>::S];  // dP
  bf16 ds[BLOCK * Pitch<D>::P];  // bf16 dS
};

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
qknorm_attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ sqk,
                          const bf16* __restrict__ dO, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dq,
                          float* __restrict__ dsqk_part, int H, int T, int n_slots, int n_tiles,
                          float scale, int bounded, Strides st) {
  using P = Pitch<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemQ<D>& sm = *reinterpret_cast<SmemQ<D>*>(smem_raw);
  __shared__ float red[NUM_WARPS];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * BLOCK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lr = threadIdx.x >> 1;
  const int lh = threadIdx.x & 1;
  const float* s_vec = sqk + h * D;
  const float bound = bounded ? head_bound<D>(s_vec, scale, red) : 0.f;
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* vb = v + b * st.v[0] + h * st.v[1];

  {
    float x[D / 2];
    load_half_row<D>(x, qb, st.q[2], m0 + lr, T, lh);
    store_projected<D>(sm.q + lr * P::H + lh * (D / 2), x, row_norm<D>(x), s_vec, scale, lh);
    copy_half_row<D>(sm.dO + lr * P::H + lh * (D / 2), dO + b * st.dO[0] + h * st.dO[1], st.dO[2],
                     m0 + lr, T, lh);
  }
  const int row = warp * 16 + (lane >> 1);  // elementwise: this lane's query row
  const int half = lane & 1;                // ... and half of the 64 key columns
  const int t = m0 + row;
  const float lse_r = t < T ? lse[(int64_t)bh * T + t] : 0.f;
  const float delta_r = t < T ? delta[(int64_t)bh * T + t] : 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a_q[D / 16], a_o[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(a_q[kk], sm.q + warp * 16 * P::H + kk * 16, P::H);
    wmma::load_matrix_sync(a_o[kk], sm.dO + warp * 16 * P::H + kk * 16, P::H);
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_dq[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc_dq[j], 0.f);

  for (int n0 = 0; n0 < T; n0 += BLOCK) {
    __syncthreads();  // every warp is done with the previous key tile
    {
      float x[D / 2];
      load_half_row<D>(x, kb, st.k[2], n0 + lr, T, lh);
      const float norm = row_norm<D>(x);
      store_projected<D>(sm.k + lr * P::H + lh * (D / 2), x, norm, s_vec, 1.0f, lh);
      store_projected<D>(sm.ks + lr * P::H + lh * (D / 2), x, norm, s_vec, scale, lh);
      copy_half_row<D>(sm.v + lr * P::H + lh * (D / 2), vb, st.v[2], n0 + lr, T, lh);
    }
    __syncthreads();

    // S = q̂_s k̂ᵀ and dP = dO vᵀ for this warp's 16 queries × 64 keys
#pragma unroll
    for (int j = 0; j < BLOCK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_s, acc_p;
      wmma::fill_fragment(acc_s, 0.f);
      wmma::fill_fragment(acc_p, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk, bv;
        wmma::load_matrix_sync(bk, sm.k + j * 16 * P::H + kk * 16, P::H);
        wmma::load_matrix_sync(bv, sm.v + j * 16 * P::H + kk * 16, P::H);
        wmma::mma_sync(acc_s, a_q[kk], bk, acc_s);
        wmma::mma_sync(acc_p, a_o[kk], bv, acc_p);
      }
      wmma::store_matrix_sync(sm.s + warp * 16 * P::S + j * 16, acc_s, P::S, wmma::mem_row_major);
      wmma::store_matrix_sync(sm.dp + warp * 16 * P::S + j * 16, acc_p, P::S, wmma::mem_row_major);
    }
    __syncwarp();

    // dS = P ⊙ (dP − Δ) with P = exp(S − lse) (K5: clamped); zero for keys and
    // queries past T
    {
      constexpr int HN = BLOCK / 2;
      const float* srow = sm.s + row * P::S + half * HN;
      const float* dprow = sm.dp + row * P::S + half * HN;
      bf16* dsrow = sm.ds + row * P::P + half * HN;
#pragma unroll 8
      for (int c = 0; c < HN; ++c) {
        const bool live = t < T && n0 + half * HN + c < T;
        const float pv = live ? recompute_p(srow[c], lse_r, bounded, bound) : 0.f;
        dsrow[c] = __float2bfloat16(pv * (dprow[c] - delta_r));
      }
    }
    __syncwarp();

    // dq̂ += bf16(dS) k̂_s
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ad;
      wmma::load_matrix_sync(ad, sm.ds + warp * 16 * P::P + kk * 16, P::P);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk;
        wmma::load_matrix_sync(bk, sm.ks + kk * 16 * P::H + j * 16, P::H);
        wmma::mma_sync(acc_dq[j], ad, bk, acc_dq[j]);
      }
    }
  }

  float* grow = sm.s + row * P::S + half * (D / 2);
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(sm.s + warp * 16 * P::S + j * 16, acc_dq[j], P::S, wmma::mem_row_major);
  __syncwarp();
  justnorm_vjp_row<D>(grow, qb, st.q[2],
                      dq + b * st.dq[0] + h * st.dq[1] + (int64_t)t * st.dq[2] + half * (D / 2), t,
                      T, half, s_vec);
  __syncthreads();
  write_dsqk_partial<D>(sm.s, dsqk_part + ((int64_t)bh * n_slots + n_tiles + blockIdx.x) * D);
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

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* sqk, const void* o,
                   const void* lse, const void* dO, void* dq, void* dk, void* dv, void* delta,
                   void* dsqk_part, int B, int H, int T, float scale, int bounded,
                   const Strides& st, cudaStream_t stream) {
  const int n_tiles = (T + BLOCK - 1) / BLOCK;
  const int n_slots = 2 * n_tiles;
  const dim3 grid(n_tiles, B * H);
  cudaError_t err;
  qknorm_attn_bwd_delta_kernel<D><<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dO), static_cast<float*>(delta), H, T, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_kv = sizeof(SmemKV<D>);
  if ((err = allow_smem(qknorm_attn_bwd_dkv_kernel<D>, smem_kv)) != cudaSuccess) return err;
  qknorm_attn_bwd_dkv_kernel<D><<<grid, NUM_THREADS, smem_kv, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(sqk), static_cast<const bf16*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dsqk_part), H, T, n_slots, scale, bounded, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_q = sizeof(SmemQ<D>);
  if ((err = allow_smem(qknorm_attn_bwd_dq_kernel<D>, smem_q)) != cudaSuccess) return err;
  qknorm_attn_bwd_dq_kernel<D><<<grid, NUM_THREADS, smem_q, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(sqk), static_cast<const bf16*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), static_cast<float*>(dsqk_part), H,
      T, n_slots, n_tiles, scale, bounded, st);
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

Strides unpack_strides(const int64_t* strides) {
  Strides st;
  int64_t* dst[8] = {st.q, st.k, st.v, st.o, st.dO, st.dq, st.dk, st.dv};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  return st;
}

}  // namespace

// q, k, v, o, dO: bf16 [B, H, T, D] addressed through (batch, head, token)
// element strides, head dim contiguous; sqk: fp32 [H, D]; lse: fp32 [B·H, T]
// from K1.  Outputs dq, dk, dv: bf16, same addressing; delta: fp32 scratch
// [B·H, T]; dsqk_part: fp32 [B·H, 2·ceil(T/64), D] per-tile partial sums;
// bounded: 1 for K5's clamped recompute, 0 for K2's.
// strides = {q_sb, q_sh, q_st, k_.., v_.., o_.., dO_.., dq_.., dk_.., dv_..}.
extern "C" cudaError_t nvit_qknorm_attn_bwd(const void* q, const void* k, const void* v,
                                            const void* sqk, const void* o, const void* lse,
                                            const void* dO, void* dq, void* dk, void* dv,
                                            void* delta, void* dsqk_part, int B, int H, int T,
                                            int D, float scale, int bounded,
                                            const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
  const Strides st = unpack_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, sqk, o, lse, dO, dq, dk, dv, delta, dsqk_part, B, H, T, scale,
                      bounded, st, s);
  if (D == 32)
    return launch<32>(q, k, v, sqk, o, lse, dO, dq, dk, dv, delta, dsqk_part, B, H, T, scale,
                      bounded, st, s);
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
  const Strides st = unpack_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_subtiled<64>(q, k, v, sqk, o, lse, dO, dq, dk, dv, dq_part, dsqk_part, B, H, T,
                               scale, nsplit, st, s);
  if (D == 32)
    return launch_subtiled<32>(q, k, v, sqk, o, lse, dO, dq, dk, dv, dq_part, dsqk_part, B, H, T,
                               scale, nsplit, st, s);
  return cudaErrorInvalidValue;
}
