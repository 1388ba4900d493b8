// Flash attention, backward — hand-written for Hopper (sm_90a).
//
// Replaces BOTH backwards of nvit_tpu/ops/flash_attention.py::_bwd (baseline
// mode's attention), given the forward's o and lse (flash_attn_fwd.cu) and dO:
//
//   K8  _bwd_fused_kernel (T_pad ≤ 1024):  Δ = rowsum(dO ∘ O) inside;
//       qs = bf16(q·scale), ks = bf16(k·scale); S = qs kᵀ; P = exp(S − lse);
//       dS = P ⊙ (dO Vᵀ − Δ);  dV = bf16(P)ᵀ dO,  dK = bf16(dS)ᵀ qs,
//       dQ = bf16(dS) ks                                   (fp32 products)
//   K9  _dq_kernel + _dkv_kernel (T_pad > 1024): Δ given (computed outside);
//       the same dV and dK;  dQ = (bf16(dS) k) · scale, scaled in fp32.
//
// The `split` flag picks K9's Δ source and dQ rounding; the wrapper sets it
// from T exactly where _bwd switches, so each TPU kernel keeps an exact twin.
// q·scale and k·scale use the scale rounded to bf16 (`qk_scale`, the TPU
// kernels' weak-typed `q_ref[0] * scale`); K9's fp32 dQ scale is the exact
// `dq_scale`.
//
// What bounds it on the H100: five T×T×D products per (b, h), 10·T²·D flops,
// against 8·T·D bf16 values of traffic — ~600 flops per byte at T = 784,
// D = 64, above the bf16 ridge (~295): the tensor cores and the exp/ALU work
// of the [T, T] tiles bound it, not memory.
//
// Design: K8 on the TPU is ONE program per (b, h) holding whole [T, T] fp32
// s, p, dp and ds tiles in VMEM (2.4 MB each at T = 784); a Hopper block has
// 227 KB of shared memory.  So K8 cannot be ported as one pass: it is split
// into FlashAttention-2's passes, which are exactly K9's two kernels, so one
// design serves both.  Three launches on one stream, all deterministic (no
// atomics), the structure of K2 (qknorm_attn_bwd.cu) without its QK-norm
// prologue and dsqk epilogue:
//
// 1. delta — Δ[b·h, t] = Σ_d dO·O in fp32 (two threads per row); skipped for
//    K9, whose Δ is given.
// 2. dK/dV (≙ _dkv_kernel) — one block per (b·h, 64-key tile).  The block
//    walks every 64-query tile: it loads qs, forms Sᵀ, Pᵀ, dPᵀ and dSᵀ
//    key-major (four warps, 16 keys each, so every product is warp-local),
//    and accumulates dV and dK in wmma fp32 fragments that live in registers
//    across the walk.
// 3. dQ (≙ _dq_kernel) — one block per (b·h, 64-query tile), walking the key
//    tiles and accumulating dQ the same way.
// Each pass recomputes S and dP (7 products instead of K8's 5): the price of
// keeping dQ out of atomics.  Products use nvcuda::wmma bf16 16×16×16 with
// fp32 accumulation; wgmma/TMA pipelining is later work.
//
// Ragged T: the TPU kernels pad T; K8 zeroes padded query ROWS of P (their
// lse is garbage) and K9's dK/dV zeroes padded query COLUMNS of Pᵀ — the
// same entries.  Here nothing is padded in device memory: P = 0 for queries
// past T (their dO and Δ are zero too) and for keys past T; key rows past T
// are computed on zero-filled k/v and never stored.  q, k, v, o, dO and the
// three outputs are addressed through (batch, head, token) strides with a
// contiguous head dim, so q/k/v can stay views of the fused QKV projection
// and dq/dk/dv can land in one [B, T, 3, H, D] buffer.

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
constexpr unsigned FULL = 0xffffffffu;

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

// Half of row t of one head (D/2 values) into shared memory, as bf16(x·scale)
// when `scaled` (scale bf16-exact) else raw; zeros past T.
template <int D, bool scaled>
__device__ __forceinline__ void copy_half_row(bf16* dst, const bf16* __restrict__ head, int64_t st,
                                              int t, int T, int half, float scale) {
  constexpr int HALF = D / 2;
  uint4* out = reinterpret_cast<uint4*>(dst);
  const uint4* g = reinterpret_cast<const uint4*>(head + (int64_t)t * st + half * HALF);
#pragma unroll
  for (int i = 0; i < HALF / 8; ++i) {
    uint4 raw = t < T ? g[i] : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (scaled) {
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    }
    out[i] = raw;
  }
}

// half a row of fp32 values (times `mul`) → bf16 in device memory
template <int D>
__device__ __forceinline__ void store_half_row_bf16(bf16* dst, const float* x, float mul) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    uint4 packed;
    bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(x[i * 8 + j] * mul);
    reinterpret_cast<uint4*>(dst)[i] = packed;
  }
}

// ------------------------------------------------------------------ delta
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_attn_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                            float* __restrict__ delta, int H, int T, Strides st) {
  constexpr int HALF = D / 2;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int t = blockIdx.x * BLOCK + (threadIdx.x >> 1);
  const int half = threadIdx.x & 1;
  float acc = 0.f;
  if (t < T) {
    const uint4* go = reinterpret_cast<const uint4*>(o + b * st.o[0] + h * st.o[1] +
                                                     (int64_t)t * st.o[2] + half * HALF);
    const uint4* gd = reinterpret_cast<const uint4*>(dO + b * st.dO[0] + h * st.dO[1] +
                                                     (int64_t)t * st.dO[2] + half * HALF);
#pragma unroll
    for (int i = 0; i < HALF / 8; ++i) {
      const uint4 ro = go[i], rd = gd[i];
      const bf16* eo = reinterpret_cast<const bf16*>(&ro);
      const bf16* ed = reinterpret_cast<const bf16*>(&rd);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += __bfloat162float(ed[j]) * __bfloat162float(eo[j]);
    }
  }
  acc += __shfl_xor_sync(FULL, acc, 1);
  if (t < T && half == 0) delta[(int64_t)bh * T + t] = acc;
}

// ------------------------------------------------------------------ dK / dV
template <int D>
struct SmemKV {
  bf16 k[BLOCK * Pitch<D>::H];   // raw k of this block's keys
  bf16 v[BLOCK * Pitch<D>::H];   // raw v of this block's keys
  bf16 q[BLOCK * Pitch<D>::H];   // qs of the current query tile
  bf16 dO[BLOCK * Pitch<D>::H];  // dO of the current query tile
  float s[BLOCK * Pitch<D>::S];  // Sᵀ; dV then dK in the epilogue
  float dp[BLOCK * Pitch<D>::S];  // dPᵀ
  bf16 p[BLOCK * Pitch<D>::P];   // bf16 Pᵀ
  bf16 ds[BLOCK * Pitch<D>::P];  // bf16 dSᵀ
  float lse[BLOCK];
  float delta[BLOCK];
};

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_attn_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dO,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T,
                          float qk_scale, Strides st) {
  using P = Pitch<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemKV<D>& sm = *reinterpret_cast<SmemKV<D>*>(smem_raw);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int n0 = blockIdx.x * BLOCK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lr = threadIdx.x >> 1;  // block-wide loads: two threads per tile row
  const int lh = threadIdx.x & 1;
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* dOb = dO + b * st.dO[0] + h * st.dO[1];

  copy_half_row<D, false>(sm.k + lr * P::H + lh * (D / 2), k + b * st.k[0] + h * st.k[1], st.k[2],
                          n0 + lr, T, lh, 1.0f);
  copy_half_row<D, false>(sm.v + lr * P::H + lh * (D / 2), v + b * st.v[0] + h * st.v[1], st.v[2],
                          n0 + lr, T, lh, 1.0f);
  __syncthreads();

  // this warp's 16 keys as A operands, fixed across the query walk
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a_k[D / 16], a_v[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(a_k[kk], sm.k + warp * 16 * P::H + kk * 16, P::H);
    wmma::load_matrix_sync(a_v[kk], sm.v + warp * 16 * P::H + kk * 16, P::H);
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_dv[D / 16], acc_dk[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(acc_dv[j], 0.f);
    wmma::fill_fragment(acc_dk[j], 0.f);
  }

  const int row = warp * 16 + (lane >> 1);  // elementwise: this lane's key row
  const int half = lane & 1;                // ... and half of the 64 query columns
  for (int m0 = 0; m0 < T; m0 += BLOCK) {
    __syncthreads();  // every warp is done with the previous query tile
    copy_half_row<D, true>(sm.q + lr * P::H + lh * (D / 2), qb, st.q[2], m0 + lr, T, lh, qk_scale);
    copy_half_row<D, false>(sm.dO + lr * P::H + lh * (D / 2), dOb, st.dO[2], m0 + lr, T, lh, 1.0f);
    if (threadIdx.x < BLOCK) {
      const int t = m0 + threadIdx.x;
      sm.lse[threadIdx.x] = t < T ? lse[(int64_t)bh * T + t] : 0.f;
      sm.delta[threadIdx.x] = t < T ? delta[(int64_t)bh * T + t] : 0.f;
    }
    __syncthreads();

    // Sᵀ = k qsᵀ and dPᵀ = v dOᵀ for this warp's 16 keys × 64 queries; qs
    // and dO are stored [query][d] row-major = [d][query] column-major
#pragma unroll
    for (int j = 0; j < BLOCK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_s, acc_p;
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
    __syncwarp();

    // Pᵀ = exp(Sᵀ − lse[query]) and dSᵀ = Pᵀ ⊙ (dPᵀ − Δ[query]); P = 0 for
    // queries past T (≙ K8's zeroed padded rows, K9's zeroed padded columns)
    {
      constexpr int HN = BLOCK / 2;
      const float* srow = sm.s + row * P::S + half * HN;
      const float* dprow = sm.dp + row * P::S + half * HN;
      bf16* prow = sm.p + row * P::P + half * HN;
      bf16* dsrow = sm.ds + row * P::P + half * HN;
#pragma unroll 8
      for (int c = 0; c < HN; ++c) {
        const int col = half * HN + c;
        const float pv = m0 + col < T ? expf(srow[c] - sm.lse[col]) : 0.f;
        prow[c] = __float2bfloat16(pv);
        dsrow[c] = __float2bfloat16(pv * (dprow[c] - sm.delta[col]));
      }
    }
    __syncwarp();

    // dV += bf16(Pᵀ) dO and dK += bf16(dSᵀ) qs
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ap, ad;
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

  // epilogue: this warp's rows of dV, then dK, through shared memory
  const int t = n0 + row;
  const float* grow = sm.s + row * P::S + half * (D / 2);
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(sm.s + warp * 16 * P::S + j * 16, acc_dv[j], P::S, wmma::mem_row_major);
  __syncwarp();
  if (t < T)
    store_half_row_bf16<D>(dv + b * st.dv[0] + h * st.dv[1] + (int64_t)t * st.dv[2] + half * (D / 2),
                           grow, 1.0f);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(sm.s + warp * 16 * P::S + j * 16, acc_dk[j], P::S, wmma::mem_row_major);
  __syncwarp();
  if (t < T)
    store_half_row_bf16<D>(dk + b * st.dk[0] + h * st.dk[1] + (int64_t)t * st.dk[2] + half * (D / 2),
                           grow, 1.0f);
}

// ------------------------------------------------------------------ dQ
template <int D>
struct SmemQ {
  bf16 q[BLOCK * Pitch<D>::H];   // qs of this block's queries
  bf16 dO[BLOCK * Pitch<D>::H];  // dO of this block's queries
  bf16 k[BLOCK * Pitch<D>::H];   // raw k of the current key tile
  bf16 ks[BLOCK * Pitch<D>::H];  // ks = bf16(k·scale) of the tile (K8 only)
  bf16 v[BLOCK * Pitch<D>::H];   // raw v of the current key tile
  float s[BLOCK * Pitch<D>::S];  // S; dQ in the epilogue
  float dp[BLOCK * Pitch<D>::S];  // dP
  bf16 ds[BLOCK * Pitch<D>::P];  // bf16 dS
};

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dO,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int H, int T, float qk_scale, float dq_scale,
                         int split, Strides st) {
  using P = Pitch<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemQ<D>& sm = *reinterpret_cast<SmemQ<D>*>(smem_raw);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * BLOCK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lr = threadIdx.x >> 1;
  const int lh = threadIdx.x & 1;
  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* vb = v + b * st.v[0] + h * st.v[1];
  // K8 multiplies dS by ks; K9 by the raw k, scaling the fp32 product after
  const bf16* dq_b = split ? sm.k : sm.ks;

  copy_half_row<D, true>(sm.q + lr * P::H + lh * (D / 2), q + b * st.q[0] + h * st.q[1], st.q[2],
                         m0 + lr, T, lh, qk_scale);
  copy_half_row<D, false>(sm.dO + lr * P::H + lh * (D / 2), dO + b * st.dO[0] + h * st.dO[1],
                          st.dO[2], m0 + lr, T, lh, 1.0f);
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
    copy_half_row<D, false>(sm.k + lr * P::H + lh * (D / 2), kb, st.k[2], n0 + lr, T, lh, 1.0f);
    if (!split)
      copy_half_row<D, true>(sm.ks + lr * P::H + lh * (D / 2), kb, st.k[2], n0 + lr, T, lh, qk_scale);
    copy_half_row<D, false>(sm.v + lr * P::H + lh * (D / 2), vb, st.v[2], n0 + lr, T, lh, 1.0f);
    __syncthreads();

    // S = qs kᵀ and dP = dO vᵀ for this warp's 16 queries × 64 keys
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

    // dS = P ⊙ (dP − Δ) with P = exp(S − lse); zero for keys and queries past T
    {
      constexpr int HN = BLOCK / 2;
      const float* srow = sm.s + row * P::S + half * HN;
      const float* dprow = sm.dp + row * P::S + half * HN;
      bf16* dsrow = sm.ds + row * P::P + half * HN;
#pragma unroll 8
      for (int c = 0; c < HN; ++c) {
        const bool live = t < T && n0 + half * HN + c < T;
        const float pv = live ? expf(srow[c] - lse_r) : 0.f;
        dsrow[c] = __float2bfloat16(pv * (dprow[c] - delta_r));
      }
    }
    __syncwarp();

    // dQ += bf16(dS) ks   (K9: bf16(dS) k)
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ad;
      wmma::load_matrix_sync(ad, sm.ds + warp * 16 * P::P + kk * 16, P::P);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk;
        wmma::load_matrix_sync(bk, dq_b + kk * 16 * P::H + j * 16, P::H);
        wmma::mma_sync(acc_dq[j], ad, bk, acc_dq[j]);
      }
    }
  }

  const float* grow = sm.s + row * P::S + half * (D / 2);
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(sm.s + warp * 16 * P::S + j * 16, acc_dq[j], P::S, wmma::mem_row_major);
  __syncwarp();
  if (t < T)
    store_half_row_bf16<D>(dq + b * st.dq[0] + h * st.dq[1] + (int64_t)t * st.dq[2] + half * (D / 2),
                           grow, split ? dq_scale : 1.0f);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
                   const void* dO, void* dq, void* dk, void* dv, void* delta, int B, int H, int T,
                   float qk_scale, float dq_scale, int split, const Strides& st,
                   cudaStream_t stream) {
  const dim3 grid((T + BLOCK - 1) / BLOCK, B * H);
  cudaError_t err;
  if (!split) {
    flash_attn_bwd_delta_kernel<D><<<grid, NUM_THREADS, 0, stream>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dO), static_cast<float*>(delta), H,
        T, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  const size_t smem_kv = sizeof(SmemKV<D>);
  if ((err = allow_smem(flash_attn_bwd_dkv_kernel<D>, smem_kv)) != cudaSuccess) return err;
  flash_attn_bwd_dkv_kernel<D><<<grid, NUM_THREADS, smem_kv, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T, qk_scale, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_q = sizeof(SmemQ<D>);
  if ((err = allow_smem(flash_attn_bwd_dq_kernel<D>, smem_q)) != cudaSuccess) return err;
  flash_attn_bwd_dq_kernel<D><<<grid, NUM_THREADS, smem_q, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, T, qk_scale, dq_scale, split, st);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, dO: bf16 [B, H, T, D] addressed through (batch, head, token)
// element strides, head dim contiguous; lse: fp32 [B·H, T] from the forward.
// Outputs dq, dk, dv: bf16, same addressing.  delta: fp32 [B·H, T] — scratch
// written by the first pass when split = 0 (K8; o is read), given when
// split = 1 (K9; o is not read).  qk_scale: the softmax scale rounded to
// bf16; dq_scale: the exact scale K9 applies to the fp32 dQ.
// strides = {q_sb, q_sh, q_st, k_.., v_.., o_.., dO_.., dq_.., dk_.., dv_..}.
extern "C" cudaError_t nvit_flash_attn_bwd(const void* q, const void* k, const void* v,
                                           const void* o, const void* lse, const void* dO,
                                           void* dq, void* dk, void* dv, void* delta, int B,
                                           int H, int T, int D, float qk_scale, float dq_scale,
                                           int split, const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
  Strides st;
  int64_t* dst[8] = {st.q, st.k, st.v, st.o, st.dO, st.dq, st.dk, st.dv};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, lse, dO, dq, dk, dv, delta, B, H, T, qk_scale, dq_scale, split,
                      st, s);
  if (D == 32)
    return launch<32>(q, k, v, o, lse, dO, dq, dk, dv, delta, B, H, T, qk_scale, dq_scale, split,
                      st, s);
  return cudaErrorInvalidValue;
}
