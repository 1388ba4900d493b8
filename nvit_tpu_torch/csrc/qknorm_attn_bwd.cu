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
// the TPU into nsplit query sub-tiles (≙ _split_bounds: 16-aligned rows, the
// last taking the rest), dq̂ complete per sub-tile and dV, dk̂ accumulated
// across them in fp32 — one pass, five products.  The [T, D] fp32
// accumulators of a (b, h) do not fit a block, so K10 is K2's prologue and
// dK/dV walk with a fifth product, and a split-K dq̂ summed in a second pass:
//
// 1. the prologue, as in K2's call.
// 2. One block (one warpgroup) per (b·h, 64-key tile) walks the sub-tiles in
//    order, each cut into chunks of ≤ 64 query rows that never cross a
//    sub-tile's end (112 = 64 + 48; attn_bwd.cuh's Chunks, a table the host
//    builds).  Per chunk it runs K2's dK/dV step — Sᵀ and dPᵀ on wgmma, Pᵀ
//    and dSᵀ in registers, dV and dk̂ accumulated in registers — then stores
//    bf16(dSᵀ) once into a swizzled shared tile and takes this key tile's
//    share of the chunk's dq̂, bf16(dS)·k̂_s, as m64n{D}k16 wgmmas that read
//    that tile and the block's resident k̂_s, both MN-major; the share goes
//    to this (key tile, chunk)'s slot of an fp32 buffer.  The walk's
//    epilogue is K2's dK/dV epilogue.
// 3. One block per (b·h, chunk) sums the key tiles' shares in tile order,
//    applies the justnorm VJP and writes dq and the chunk's Σ_t dq̂ ⊙ qn.
// No atomics: two calls give the same bytes.
//
// What bounds K10: its five products are K2's tensor-core and exp/ALU work
// less two products, but the split-K dq̂ moves 2·4·ceil(T/64)·64·D bytes per
// (b·h, chunk) through device memory — 1.0 GiB written and read at
// [384, 784, 64], ~0.6 ms at 3.35 TB/s, of which the second pass's read
// (~0.39 ms on the H100) does not overlap any product.  Summing the shares
// in tile order inside the walk instead (key tile j adding to one running
// sum per chunk after tile j − 1, behind a counter) kept that traffic in L2
// but stalled the walk longer than the second pass takes (PERF.md §6).
//
// Ragged T (784 = 12·64 + 16): query columns past T get P = 0 (their dO and
// Δ rows are zero too); key rows past T are computed on zero-filled k/v (the
// 1e-30 floor keeps them finite), never stored and masked out of dsqk.
// q, k, v, dO and the three outputs are addressed through (batch, head,
// token) strides with a contiguous head dim, so q/k/v can stay views of the
// fused QKV projection and dq/dk/dv can land in one [B, T, 3, H, D] buffer.

#include "attn_bwd.cuh"

namespace {

using namespace attn_bwd;

constexpr float NORM_EPS = 1e-30f;  // ≙ flash_attention.py _NORM_EPS

template <int D>
struct Pitch {
  // fp32 [., D] staging rows, padded off a multiple of 128 bytes against
  // bank conflicts, a multiple of 16 bytes (vector stores)
  static constexpr int S = D + 4;
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

// The epilogues' row step, for the row whose halves sit in lanes 2r and
// 2r + 1: from the fp32 gradient g = dx̂ (half row in shared memory) and the
// raw input row t, write dx = (s⊙g − xn·Σ(xn ⊙ s⊙g))/‖x‖ to `out` (half row
// t of the output) and overwrite g in place with its dsqk contribution
// g ⊙ xn (zero from T on).
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

// the walks' epilogues' fp32 [64, D] rows reuse their two stages
template <int D>
constexpr bool epilogue_fits(int stage) { return 2 * stage >= BLOCK * Pitch<D>::S * 4; }
static_assert(epilogue_fits<64>(LayoutKV<64>::STAGE) && epilogue_fits<32>(LayoutKV<32>::STAGE), "epilogue tile");
static_assert(epilogue_fits<64>(LayoutQ<64, true>::STAGE) && epilogue_fits<32>(LayoutQ<32, true>::STAGE),
              "epilogue tile");

// The dK/dV walks' epilogue (K2/K5 and K10): dV straight out; dk̂ through the
// justnorm VJP; this key tile's Σ_t dk̂ ⊙ kn into its dsqk partial slot.
// `g`: fp32 [64, Pitch<D>::S] staging, free once every wgmma is done.
template <int D>
__device__ __forceinline__ void dkv_epilogue(float* g, const float (&acc_dv)[D / 2], const float (&acc_dk)[D / 2],
                                             const bf16* __restrict__ kb, int64_t k_st, bf16* __restrict__ dkb,
                                             int64_t dk_st, bf16* __restrict__ dvb, int64_t dv_st, int n0, int T,
                                             const float* __restrict__ s_vec, float* __restrict__ slot) {
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;  // two threads per key row
  const int t = n0 + row;
  float* grow = g + row * Pitch<D>::S + half * (D / 2);
  dump_acc<D>(g, acc_dv);
  __syncthreads();
  if (t < T) store_half_row_bf16<D>(dvb + (int64_t)t * dv_st + half * (D / 2), grow);
  __syncthreads();
  dump_acc<D>(g, acc_dk);
  __syncthreads();
  justnorm_vjp_row<D>(grow, kb, k_st, dkb + (int64_t)t * dk_st + half * (D / 2), t, T, half, s_vec);
  __syncthreads();
  write_dsqk_partial<D>(g, slot);
}

// ------------------------------------------------------------------ K2 / K5
// dK/dV pass: one block (one warpgroup) per (b·h, 64-key tile), attn_bwd.cuh's
// walk with K = k̂ and Q = q̂_s, then dkv_epilogue.
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
  dkv_epilogue<D>(reinterpret_cast<float*>(sp + L::STAGES), acc_dv, acc_dk, k + b * st.k[0] + h * st.k[1],
                  st.k[2], dk + b * st.dk[0] + h * st.dk[1], st.dk[2], dv + b * st.dv[0] + h * st.dv[1],
                  st.dv[2], n0, T, s_vec, dsqk_part + ((int64_t)bh * n_slots + blockIdx.x) * D);
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
// A chunk's dq̂ rows [m0, end) (rows from `end` on are zero) in the
// accumulator layout → the justnorm VJP → dq rows, and the chunk's
// Σ_t dq̂ ⊙ qn into `slot`.  `g`: fp32 [64, Pitch<D>::S] staging.
template <int D>
__device__ __forceinline__ void dq_epilogue(float* g, const float (&acc)[D / 2], const bf16* __restrict__ qb,
                                            int64_t q_st, bf16* __restrict__ dqb, int64_t dq_st, int m0, int end,
                                            const float* __restrict__ s_vec, float* __restrict__ slot) {
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int t = m0 + row;
  dump_acc<D>(g, acc);
  __syncthreads();
  justnorm_vjp_row<D>(g + row * Pitch<D>::S + half * (D / 2), qb, q_st, dqb + (int64_t)t * dq_st + half * (D / 2),
                      t, end, half, s_vec);
  __syncthreads();
  write_dsqk_partial<D>(g, slot);
}

// One chunk's dq̂ share in device memory: each thread's D/2 accumulator
// registers as D/8 float4s, thread-fastest ("register image"), so a
// warpgroup moves 64·D fp32 values in whole 2 KB runs.
template <int D>
__device__ __forceinline__ void store_share(float* __restrict__ dst, const float (&acc)[D / 2]) {
  float4* p = reinterpret_cast<float4*>(dst) + threadIdx.x;
#pragma unroll
  for (int f = 0; f < D / 8; ++f)
    __stcg(p + f * NUM_THREADS, make_float4(acc[4 * f], acc[4 * f + 1], acc[4 * f + 2], acc[4 * f + 3]));
}
// acc = share + acc, elementwise (the running sum first: tile order)
template <int D>
__device__ __forceinline__ void add_share(float (&acc)[D / 2], const float* __restrict__ src) {
  const float4* p = reinterpret_cast<const float4*>(src) + threadIdx.x;
#pragma unroll
  for (int f = 0; f < D / 8; ++f) {
    const float4 x = __ldcg(p + f * NUM_THREADS);  // streamed once: not kept in L1
    acc[4 * f] = x.x + acc[4 * f];
    acc[4 * f + 1] = x.y + acc[4 * f + 1];
    acc[4 * f + 2] = x.z + acc[4 * f + 2];
    acc[4 * f + 3] = x.w + acc[4 * f + 3];
  }
}

// K10's dq strategy on dkv_walk (attn_bwd.cuh): per chunk, this key tile's
// share dq̂ = dS·k̂_s [64 queries, D] as wgmmas reading the walk's bf16 dSᵀ
// tile and the block's k̂_s tile, both MN-major, then the share into this
// key tile's slot of the partial buffer, which
// qknorm_attn_bwd_subtiled_dq_kernel sums over the key tiles.
template <int D>
struct SplitDq {
  using L = LayoutKV<D, true>;
  float acc[D / 2];
  uint32_t base;
  const bf16* ks;  // this head's k̂_s rows
  int n0, T;
  float* shares;   // this key tile's [n_chunks][64·D] slots

  __device__ __forceinline__ void load(uint32_t b) {
    base = b;
    load_tile<D>(base + L::K2, ks, D, n0, T);
  }

  __device__ __forceinline__ void prepare() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    fence_operands(acc);
  }

  // dq̂ [64 queries, D] = dS [queries, keys] · k̂_s [keys, D]: A is the DS tile
  // read MN-major (queries contiguous), B the k̂_s tile read MN-major
  __device__ __forceinline__ void issue() {
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk)
      wgmma_ss_bmn<1>(acc, smem_desc<2 * BLOCK>(base + L::DS + kk * 16 * 2 * BLOCK),
                      smem_desc<2 * D>(base + L::K2 + kk * 16 * 2 * D), kk > 0);
  }

  __device__ __forceinline__ void finish(int m) {
    fence_operands(acc);
    store_share<D>(shares + (int64_t)m * BLOCK * D, acc);
  }
};

// One block per (b·h, 64-key tile): the sub-tiles' chunks through dkv_walk
// with SplitDq, then dkv_epilogue.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
qknorm_attn_bwd_subtiled_kernel(const bf16* __restrict__ k, const float* __restrict__ sqk,
                                const bf16* __restrict__ qs, const bf16* __restrict__ kh,
                                const bf16* __restrict__ ks, const bf16* __restrict__ v,
                                const bf16* __restrict__ dO, const float* __restrict__ lse_pad,
                                const float* __restrict__ delta_pad, bf16* __restrict__ dk,
                                bf16* __restrict__ dv, float* __restrict__ shares, float* __restrict__ dsqk_part,
                                int H, int T, int T_pad, int n_slots, const __grid_constant__ Chunks ch,
                                Strides st) {
  using L = LayoutKV<D, true>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sp = smem_raw + (base - raw);

  const int bh = blockIdx.y, j = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int n0 = j * BLOCK;
  const int64_t head = (int64_t)bh * T * D;
  SplitDq<D> split;
  split.ks = ks + head;
  split.n0 = n0;
  split.T = T;
  split.shares = shares + ((int64_t)bh * gridDim.x + j) * ch.n * BLOCK * D;

  float acc_dv[D / 2], acc_dk[D / 2];
  dkv_walk<D, false, true>(acc_dv, acc_dk, base, sp, kh + head, D, v + b * st.v[0] + h * st.v[1], st.v[2],
                           qs + head, dO + b * st.dO[0] + h * st.dO[1], st.dO[2], lse_pad + (int64_t)bh * T_pad,
                           delta_pad + (int64_t)bh * T_pad, n0, T, ch, 0.f, split);

  __syncthreads();  // every wgmma is done with the stages
  dkv_epilogue<D>(reinterpret_cast<float*>(sp + L::STAGES), acc_dv, acc_dk, k + b * st.k[0] + h * st.k[1],
                  st.k[2], dk + b * st.dk[0] + h * st.dk[1], st.dk[2], dv + b * st.dv[0] + h * st.dv[1],
                  st.dv[2], n0, T, sqk + h * D, dsqk_part + ((int64_t)bh * n_slots + j) * D);
}

// One block per (b·h, chunk): the key tiles' shares summed in tile order,
// then dq_epilogue.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
qknorm_attn_bwd_subtiled_dq_kernel(const bf16* __restrict__ q, const float* __restrict__ sqk,
                                   const float* __restrict__ shares, bf16* __restrict__ dq,
                                   float* __restrict__ dsqk_part, int H, int n_tiles, int n_slots,
                                   const __grid_constant__ Chunks ch, Strides st) {
  __shared__ __align__(16) float g[BLOCK * Pitch<D>::S];
  const int bh = blockIdx.y, m = blockIdx.x;
  const int b = bh / H, h = bh % H;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < n_tiles; ++j)
    add_share<D>(acc, shares + (((int64_t)bh * n_tiles + j) * ch.n + m) * BLOCK * D);
  dq_epilogue<D>(g, acc, q + b * st.q[0] + h * st.q[1], st.q[2], dq + b * st.dq[0] + h * st.dq[1], st.dq[2],
                 ch.start(m), ch.end(m), sqk + h * D, dsqk_part + ((int64_t)bh * n_slots + n_tiles + m) * D);
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
cudaError_t launch_subtiled(const void* q, const void* k, const void* v, const void* sqk, const void* qs,
                            const void* kh, const void* ks, const void* lse_pad, const void* delta_pad,
                            const void* dO, void* dq, void* dk, void* dv, void* shares, void* dsqk_part, int B,
                            int H, int T, const Chunks& ch, const Strides& st, cudaStream_t stream) {
  const int n_tiles = (T + BLOCK - 1) / BLOCK;
  const int n_slots = n_tiles + ch.n;
  const int T_pad = n_tiles * BLOCK;
  cudaError_t err;
  const int smem = LayoutKV<D, true>::BYTES;
  if ((err = allow_smem(qknorm_attn_bwd_subtiled_kernel<D>, smem)) != cudaSuccess) return err;
  qknorm_attn_bwd_subtiled_kernel<D><<<dim3(n_tiles, B * H), NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(k), static_cast<const float*>(sqk), static_cast<const bf16*>(qs),
      static_cast<const bf16*>(kh), static_cast<const bf16*>(ks), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), static_cast<const float*>(lse_pad), static_cast<const float*>(delta_pad),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(shares), static_cast<float*>(dsqk_part),
      H, T, T_pad, n_slots, ch, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  qknorm_attn_bwd_subtiled_dq_kernel<D><<<dim3(ch.n, B * H), NUM_THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const float*>(sqk), static_cast<const float*>(shares),
      static_cast<bf16*>(dq), static_cast<float*>(dsqk_part), H, n_tiles, n_slots, ch, st);
  return cudaGetLastError();
}

// strides = {q_sb, q_sh, q_st, k_.., v_.., dO_.., dq_.., dk_.., dv_..}
Strides unpack_strides(const int64_t* strides) {
  Strides st{};
  int64_t* dst[7] = {st.q, st.k, st.v, st.dO, st.dq, st.dk, st.dv};
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
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
  const Strides st = unpack_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel_launch) {
    return kernel_launch(q, k, v, sqk, qs, kh, ks, lse_pad, delta_pad, dO, dq, dk, dv, dsqk_part, B, H,
                         T, scale, st, s);
  };
  if (D == 64) return bounded ? go(launch<64, true>) : go(launch<64, false>);
  if (D == 32) return bounded ? go(launch<32, true>) : go(launch<32, false>);
  return cudaErrorInvalidValue;
}

// K10: q, k, v, dO, sqk, the prologue's qs, kh, ks, lse_pad, delta_pad and
// the outputs dq, dk, dv as for nvit_qknorm_attn_bwd (P = exp(S − lse), no
// clamp).  starts: the n_chunks + 1 row bounds of the query chunks
// (flash_attention.py::subtile_chunks; starts[n_chunks] = T), each chunk 1 to
// 64 rows from a multiple of 16.  shares: fp32 scratch [B·H, ceil(T/64),
// n_chunks, 64·D], each key tile's share of each chunk's dq̂; dsqk_part: fp32
// [B·H, ceil(T/64) + n_chunks, D], per-key-tile and per-chunk partial sums.
extern "C" cudaError_t nvit_qknorm_attn_bwd_subtiled(const void* q, const void* k, const void* v,
                                                     const void* sqk, const void* qs, const void* kh,
                                                     const void* ks, const void* lse_pad,
                                                     const void* delta_pad, const void* dO, void* dq,
                                                     void* dk, void* dv, void* shares, void* dsqk_part, int B,
                                                     int H, int T, int D, const int32_t* starts, int n_chunks,
                                                     const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T > INT16_MAX || n_chunks < 1 || n_chunks > MAX_CHUNKS ||
      starts[0] != 0 || starts[n_chunks] != T)
    return cudaErrorInvalidValue;
  Chunks ch{};
  ch.n = n_chunks;
  for (int m = 0; m <= n_chunks; ++m) {
    if (m < n_chunks && (starts[m] % 16 || starts[m + 1] <= starts[m] || starts[m + 1] - starts[m] > BLOCK))
      return cudaErrorInvalidValue;
    ch.starts[m] = static_cast<int16_t>(starts[m]);
  }
  const Strides st = unpack_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel_launch) {
    return kernel_launch(q, k, v, sqk, qs, kh, ks, lse_pad, delta_pad, dO, dq, dk, dv, shares, dsqk_part, B, H, T,
                         ch, st, s);
  };
  if (D == 64) return go(launch_subtiled<64>);
  if (D == 32) return go(launch_subtiled<32>);
  return cudaErrorInvalidValue;
}
