// QK-norm projection prologue — hand-written for Hopper (sm_90a).
//
// The part of the TPU kernels nvit_tpu/ops/flash_attention.py::
// _fwd_qknorm_kernel and _bwd_fused_qknorm_kernel that projects q and k onto
// the hypersphere, taken out of the attention loops: per (b, h) and token t,
//
//   q̂_s = bf16((s·scale) ⊙ q/max(‖q‖, 1e-30))    k̂ = bf16(s ⊙ k/max(‖k‖, 1e-30))
//   k̂_s = bf16((s·scale) ⊙ k/max(‖k‖, 1e-30))   (backward only)
//
// in fp32 and K1's multiply order, with s = sqk_eff[h] — so the rounded
// values are the ones the fused TPU kernel computes inside its tiles.  The
// backward's call also writes Δ = Σ_d dO·O (fp32, ≙ _bwd_qknorm's
// rowsum(dO ∘ O)) and copies lse, both into [B·H, T_pad] rows zero-filled
// past T, so the attention kernels load whole 64-row stat tiles with aligned
// asynchronous copies.
//
// Why a launch of its own: the attention kernels (qknorm_attn_fwd.cu,
// qknorm_attn_bwd.cu) walk every key tile once per 64-query block, so a
// projection inside the walk is repeated ⌈T/64⌉ times (13 at T = 784) on
// CUDA cores — a third of a tile's ideal tensor-core time.  Here each row
// is projected once and written as bf16 [B·H, T, D] scratch that the walks
// read with cp.async.  What bounds it: bytes — two bf16 rows in and two out
// per token and head in the forward's call (154 MB, 46 µs at 3.35 TB/s at
// [32, 12, 784, 64]), four in and three out in the backward's — so it is a
// plain kernel of 16-byte loads and stores, one chunk of each row per
// thread, every load in flight before the first sum.
//
// Its plain mode (flash_project_kernel, nvit_flash_project) is the prologue
// of the baseline backward (K8/K9, flash_attn_bwd.cu), for the same reason:
// qs = bf16(q · scale) and, for K8, ks = bf16(k · scale), with the softmax
// scale rounded to bf16 (the TPU kernels' weak-typed `q_ref[0] * scale`),
// and the padded lse and Δ — Σ_d dO·O for K8 (≙ _bwd_fused_kernel's),
// the given one for K9 (≙ _bwd's, computed outside the kernels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROWS = 64;  // tokens per block
constexpr float NORM_EPS = 1e-30f;  // ≙ flash_attention.py _NORM_EPS
constexpr unsigned FULL = 0xffffffffu;

// (batch, head, token) element strides of q, k, o, dO
struct Strides {
  int64_t q[3], k[3], o[3], dO[3];
};

// 16-byte chunk j (8 values) of row t of one head, zeros past T
__device__ __forceinline__ uint4 load_chunk(const bf16* __restrict__ head, int64_t st, int t, int T,
                                            int j) {
  return t < T ? reinterpret_cast<const uint4*>(head + (int64_t)t * st)[j] : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void to_float(float (&x)[8], uint4 raw) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(e[i]);
}

// Σ over the row's CPR lanes (neighbours in one warp), the same in each:
// a butterfly, so the sum is ((c0 + c1) + (c2 + c3)) + ... in every lane
template <int CPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < CPR; off <<= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// bf16((s·scale) ⊙ (x/norm)) of chunk j — K1's multiply order
__device__ __forceinline__ uint4 project_chunk(const float (&x)[8], float norm,
                                               const float* __restrict__ s_vec, float scale, int j) {
  uint4 packed;
  bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16((s_vec[8 * j + i] * scale) * (x[i] / norm));
  return packed;
}

// Δ = Σ_d dO·O of row t (fp32; the chunks ro, rg of o and dO, summed over
// the row's CPR lanes) and lse into the padded [B·H, T_pad] stat rows, zero
// past T; lane j = 0 of the row writes
template <int CPR>
__device__ __forceinline__ void write_stats(uint4 ro, uint4 rg, const float* __restrict__ lse,
                                            float* __restrict__ lse_pad, float* __restrict__ delta_pad,
                                            int bh, int t, int T, int T_pad, int j) {
  float xo[8], xg[8];
  to_float(xo, ro);
  to_float(xg, rg);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc += xg[i] * xo[i];
  acc = row_sum<CPR>(acc);
  if (j == 0) {  // t < T_pad: the grid covers the padded rows exactly
    delta_pad[(int64_t)bh * T_pad + t] = t < T ? acc : 0.f;
    lse_pad[(int64_t)bh * T_pad + t] = t < T ? lse[(int64_t)bh * T + t] : 0.f;
  }
}

// One block per (64 tokens, b·h); D/8 threads per token, one 16-byte chunk
// of each row each, so every load of the block is in flight at once.
// BWD: the backward's call, with k̂_s, Δ and the padded lse.
template <int D, bool BWD>
__global__ void __launch_bounds__(ROWS * D / 8)
qknorm_project_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const float* __restrict__ sqk, bf16* __restrict__ qs, bf16* __restrict__ kh,
                      bf16* __restrict__ ks, const bf16* __restrict__ o, const bf16* __restrict__ dO,
                      const float* __restrict__ lse, float* __restrict__ lse_pad,
                      float* __restrict__ delta_pad, int H, int T, int T_pad, float scale,
                      Strides st) {
  constexpr int CPR = D / 8;  // chunks (threads) per row
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int t = blockIdx.x * ROWS + threadIdx.x / CPR;
  const int j = threadIdx.x % CPR;
  const float* s_vec = sqk + h * D;

  const uint4 rq = load_chunk(q + b * st.q[0] + h * st.q[1], st.q[2], t, T, j);
  const uint4 rk = load_chunk(k + b * st.k[0] + h * st.k[1], st.k[2], t, T, j);
  uint4 ro, rg;
  if constexpr (BWD) {
    ro = load_chunk(o + b * st.o[0] + h * st.o[1], st.o[2], t, T, j);
    rg = load_chunk(dO + b * st.dO[0] + h * st.dO[1], st.dO[2], t, T, j);
  }
  float xq[8], xk[8];
  to_float(xq, rq);
  to_float(xk, rk);
  float sq = 0.f, sk = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sq += xq[i] * xq[i];
    sk += xk[i] * xk[i];
  }
  const float nq = fmaxf(sqrtf(row_sum<CPR>(sq)), NORM_EPS);
  const float nk = fmaxf(sqrtf(row_sum<CPR>(sk)), NORM_EPS);
  const int64_t out = ((int64_t)bh * T + t) * D + 8 * j;  // scratch [B·H, T, D]
  if (t < T) {
    *reinterpret_cast<uint4*>(qs + out) = project_chunk(xq, nq, s_vec, scale, j);
    *reinterpret_cast<uint4*>(kh + out) = project_chunk(xk, nk, s_vec, 1.0f, j);
    if constexpr (BWD) *reinterpret_cast<uint4*>(ks + out) = project_chunk(xk, nk, s_vec, scale, j);
  }
  if constexpr (BWD) write_stats<CPR>(ro, rg, lse, lse_pad, delta_pad, bh, t, T, T_pad, j);
}

// bf16(x · scale) of chunk j, rounded once (scale bf16-exact)
__device__ __forceinline__ uint4 scale_chunk(uint4 raw, float scale) {
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(e[i]);
    e[i] = __floats2bfloat162_rn(x.x * scale, x.y * scale);
  }
  return raw;
}

// The baseline backward's prologue: one block per (64 tokens, b·h), D/8
// threads per token, as qknorm_project_kernel.  K8 (SPLIT false): qs, ks and
// Δ = Σ_d dO·O; K9 (SPLIT true): qs, and the given Δ copied.  Both pad lse
// and Δ to T_pad rows.
template <int D, bool SPLIT>
__global__ void __launch_bounds__(ROWS * D / 8)
flash_project_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, bf16* __restrict__ qs,
                     bf16* __restrict__ ks, const bf16* __restrict__ o, const bf16* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ lse_pad, float* __restrict__ delta_pad, int H, int T,
                     int T_pad, float scale, Strides st) {
  constexpr int CPR = D / 8;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int t = blockIdx.x * ROWS + threadIdx.x / CPR;
  const int j = threadIdx.x % CPR;

  const uint4 rq = load_chunk(q + b * st.q[0] + h * st.q[1], st.q[2], t, T, j);
  uint4 rk, ro, rg;
  if constexpr (!SPLIT) {
    rk = load_chunk(k + b * st.k[0] + h * st.k[1], st.k[2], t, T, j);
    ro = load_chunk(o + b * st.o[0] + h * st.o[1], st.o[2], t, T, j);
    rg = load_chunk(dO + b * st.dO[0] + h * st.dO[1], st.dO[2], t, T, j);
  }
  const int64_t out = ((int64_t)bh * T + t) * D + 8 * j;  // scratch [B·H, T, D]
  if (t < T) {
    *reinterpret_cast<uint4*>(qs + out) = scale_chunk(rq, scale);
    if constexpr (!SPLIT) *reinterpret_cast<uint4*>(ks + out) = scale_chunk(rk, scale);
  }
  if constexpr (SPLIT) {
    if (j == 0) {  // t < T_pad: the grid covers the padded rows exactly
      delta_pad[(int64_t)bh * T_pad + t] = t < T ? delta[(int64_t)bh * T + t] : 0.f;
      lse_pad[(int64_t)bh * T_pad + t] = t < T ? lse[(int64_t)bh * T + t] : 0.f;
    }
  } else {
    write_stats<CPR>(ro, rg, lse, lse_pad, delta_pad, bh, t, T, T_pad, j);
  }
}

template <int D, bool BWD>
cudaError_t launch(const void* q, const void* k, const void* sqk, void* qs, void* kh, void* ks,
                   const void* o, const void* dO, const void* lse, void* lse_pad, void* delta_pad,
                   int B, int H, int T, float scale, const Strides& st, cudaStream_t stream) {
  const int n_tiles = (T + ROWS - 1) / ROWS;
  qknorm_project_kernel<D, BWD><<<dim3(n_tiles, B * H), ROWS * D / 8, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const float*>(sqk),
      static_cast<bf16*>(qs), static_cast<bf16*>(kh), static_cast<bf16*>(ks),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dO), static_cast<const float*>(lse),
      static_cast<float*>(lse_pad), static_cast<float*>(delta_pad), H, T, n_tiles * ROWS, scale, st);
  return cudaGetLastError();
}

}  // namespace

// q, k (and o, dO): bf16 [B, H, T, D] addressed through (batch, head, token)
// element strides, head dim contiguous; sqk: fp32 [H, D].  Writes qs and kh
// as bf16 [B·H, T, D].  The backward's call (delta_pad not null) also writes
// ks, same shape, and delta_pad and lse_pad, fp32 [B·H, T_pad] with
// T_pad = 64·ceil(T/64), from o, dO and lse (fp32 [B·H, T]).
// strides = {q_sb, q_sh, q_st, k_.., o_.., dO_..}.
extern "C" cudaError_t nvit_qknorm_project(const void* q, const void* k, const void* sqk, void* qs,
                                           void* kh, void* ks, const void* o, const void* dO,
                                           const void* lse, void* lse_pad, void* delta_pad, int B,
                                           int H, int T, int D, float scale,
                                           const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
  Strides st;
  int64_t* dst[4] = {st.q, st.k, st.o, st.dO};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bwd = delta_pad != nullptr;
  if (bwd && (ks == nullptr || o == nullptr || dO == nullptr || lse == nullptr || lse_pad == nullptr))
    return cudaErrorInvalidValue;
  if (D == 64)
    return bwd ? launch<64, true>(q, k, sqk, qs, kh, ks, o, dO, lse, lse_pad, delta_pad, B, H, T, scale, st, s)
               : launch<64, false>(q, k, sqk, qs, kh, ks, o, dO, lse, lse_pad, delta_pad, B, H, T, scale, st, s);
  if (D == 32)
    return bwd ? launch<32, true>(q, k, sqk, qs, kh, ks, o, dO, lse, lse_pad, delta_pad, B, H, T, scale, st, s)
               : launch<32, false>(q, k, sqk, qs, kh, ks, o, dO, lse, lse_pad, delta_pad, B, H, T, scale, st, s);
  return cudaErrorInvalidValue;
}

// The baseline backward's prologue.  q, k, o, dO: bf16 [B, H, T, D]
// addressed through (batch, head, token) element strides, head dim
// contiguous; lse (and delta, for K9): fp32 [B·H, T].  Writes qs (and ks for
// K8) as bf16 [B·H, T, D], and lse_pad and delta_pad, fp32 [B·H, T_pad] with
// T_pad = 64·ceil(T/64).  delta null: K8 (k, o and dO read, ks written,
// Δ = Σ_d dO·O); delta given: K9 (k, o, dO and ks not touched).  scale: the
// softmax scale already rounded to bf16.
// strides = {q_sb, q_sh, q_st, k_.., o_.., dO_..}.
extern "C" cudaError_t nvit_flash_project(const void* q, const void* k, void* qs, void* ks, const void* o,
                                          const void* dO, const void* lse, const void* delta, void* lse_pad,
                                          void* delta_pad, int B, int H, int T, int D, float scale,
                                          const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || lse_pad == nullptr || delta_pad == nullptr) return cudaErrorInvalidValue;
  const bool split = delta != nullptr;
  if (!split && (k == nullptr || ks == nullptr || o == nullptr || dO == nullptr)) return cudaErrorInvalidValue;
  Strides st;
  int64_t* dst[4] = {st.q, st.k, st.o, st.dO};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  const int n_tiles = (T + ROWS - 1) / ROWS;
  const dim3 grid(n_tiles, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel, int threads) {
    kernel<<<grid, threads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<bf16*>(qs), static_cast<bf16*>(ks),
        static_cast<const bf16*>(o), static_cast<const bf16*>(dO), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(lse_pad), static_cast<float*>(delta_pad), H, T,
        n_tiles * ROWS, scale, st);
    return cudaGetLastError();
  };
  if (D == 64) return split ? go(flash_project_kernel<64, true>, ROWS * 8) : go(flash_project_kernel<64, false>, ROWS * 8);
  if (D == 32) return split ? go(flash_project_kernel<32, true>, ROWS * 4) : go(flash_project_kernel<32, false>, ROWS * 4);
  return cudaErrorInvalidValue;
}
