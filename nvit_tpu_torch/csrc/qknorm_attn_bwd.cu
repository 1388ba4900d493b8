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
// What bounds it on the H100 (the tensor cores and the exp/ALU work of the
// [T, T] tiles, not memory) and the design that answers it are the backward
// walks of attn_bwd.cuh, shared with K8/K9 (flash_attn_bwd.cu): three
// launches on one stream, all deterministic:
//
// 1. the prologue (qknorm_project.cu) — q̂_s, k̂, k̂_s once per call as bf16
//    scratch, Δ = Σ_d dO·O in fp32 and lse, both padded to whole 64-row tiles.
// 2. dK/dV — one block (one warpgroup) per (b·h, 64-key tile): the walk with
//    K = k̂ and Q = q̂_s on wgmma, dV and dk̂ in registers.  The epilogue
//    applies the justnorm VJP to dk̂ and writes this tile's Σ_t dk̂ ⊙ kn.
// 3. dQ — one block per (b·h, 64-query tile), walking the key tiles (k̂, k̂_s,
//    v), dq̂ in registers; its epilogue applies the VJP to dq̂ and writes the
//    tile's Σ_t dq̂ ⊙ qn.
// The per-tile dsqk partials go to a [B·H, 2·n_tiles, D] fp32 buffer that
// the wrapper sums in a fixed order — no atomics anywhere.  Only the
// epilogues stage fp32 rows in shared memory, for the row-wise VJP.
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
// K2's above run on the wgmma walks (attn_bwd.cuh, hopper.cuh).
//
// Ragged T (784 = 12·64 + 16): query columns past T get P = 0 (their dO and
// Δ rows are zero too); key rows past T are computed on zero-filled k/v (the
// 1e-30 floor keeps them finite), never stored and masked out of dsqk.
// q, k, v, o, dO and the three outputs are addressed through (batch, head,
// token) strides with a contiguous head dim, so q/k/v can stay views of the
// fused QKV projection and dq/dk/dv can land in one [B, T, 3, H, D] buffer.

#include <mma.h>

#include "attn_bwd.cuh"

using namespace nvcuda;

namespace {

using namespace attn_bwd;

constexpr float NORM_EPS = 1e-30f;  // ≙ flash_attention.py _NORM_EPS

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

// the epilogues' fp32 [64, D] rows reuse the walks' two stages
template <int D>
constexpr bool epilogue_fits(int stage) { return 2 * stage >= BLOCK * Pitch<D>::S * 4; }
static_assert(epilogue_fits<64>(LayoutKV<64>::STAGE) && epilogue_fits<32>(LayoutKV<32>::STAGE), "epilogue tile");
static_assert(epilogue_fits<64>(LayoutQ<64, true>::STAGE) && epilogue_fits<32>(LayoutQ<32, true>::STAGE),
              "epilogue tile");

// dK/dV pass: one block (one warpgroup) per (b·h, 64-key tile), attn_bwd.cuh's
// walk with K = k̂ and Q = q̂_s.  Epilogue (≙ dkv_epilogue): dV straight out;
// dk̂ through the justnorm VJP; this key tile's Σ_t dk̂ ⊙ kn into its dsqk
// partial slot.
template <int D, bool BOUNDED>
__global__ void __launch_bounds__(NUM_THREADS)
qknorm_attn_bwd_dkv_kernel(const bf16* __restrict__ k, const float* __restrict__ sqk,
                           const bf16* __restrict__ qs, const bf16* __restrict__ kh,
                           const bf16* __restrict__ v, const bf16* __restrict__ dO,
                           const float* __restrict__ lse_pad, const float* __restrict__ delta_pad,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           float* __restrict__ dsqk_part, int H, int T, int T_pad, int n_slots,
                           float scale, Strides st) {
  using L = LayoutKV<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[NUM_WARPS];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sp = smem_raw + (base - raw);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int n0 = blockIdx.x * BLOCK;
  const float* s_vec = sqk + h * D;
  const float bound = BOUNDED ? head_bound<D>(s_vec, scale, red) : 0.f;
  float acc_dv[D / 2], acc_dk[D / 2];
  dkv_walk<D, BOUNDED>(acc_dv, acc_dk, base, sp, kh + (int64_t)bh * T * D, D, v + b * st.v[0] + h * st.v[1],
                       st.v[2], qs + (int64_t)bh * T * D, dO + b * st.dO[0] + h * st.dO[1], st.dO[2],
                       lse_pad + (int64_t)bh * T_pad, delta_pad + (int64_t)bh * T_pad, n0, T, T_pad, bound);

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

// dQ pass: one block per (b·h, 64-query tile), attn_bwd.cuh's walk over the
// key tiles k̂, k̂_s and v.  Epilogue: dq̂ through the justnorm VJP → dq, and
// the tile's Σ_t dq̂ ⊙ qn.
template <int D, bool BOUNDED>
__global__ void __launch_bounds__(NUM_THREADS)
qknorm_attn_bwd_dq_kernel(const bf16* __restrict__ q, const float* __restrict__ sqk,
                          const bf16* __restrict__ qs, const bf16* __restrict__ kh,
                          const bf16* __restrict__ ks, const bf16* __restrict__ v,
                          const bf16* __restrict__ dO, const float* __restrict__ lse_pad,
                          const float* __restrict__ delta_pad, bf16* __restrict__ dq,
                          float* __restrict__ dsqk_part, int H, int T, int T_pad, int n_slots,
                          int n_tiles, float scale, Strides st) {
  using L = LayoutQ<D, true>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[NUM_WARPS];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sp = smem_raw + (base - raw);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * BLOCK;
  const float* s_vec = sqk + h * D;
  const float bound = BOUNDED ? head_bound<D>(s_vec, scale, red) : 0.f;
  const int64_t head = (int64_t)bh * T * D;
  float acc_dq[D / 2];
  dq_walk<D, BOUNDED, true>(acc_dq, base, qs + head, dO + b * st.dO[0] + h * st.dO[1], st.dO[2], kh + head, D,
                            ks + head, v + b * st.v[0] + h * st.v[1], st.v[2], lse_pad + (int64_t)bh * T_pad,
                            delta_pad + (int64_t)bh * T_pad, m0, T, n_tiles, bound);

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

  const int smem_q = LayoutQ<D, true>::BYTES;
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
