// Flash attention, backward — hand-written for Hopper (sm_90a).
//
// Replaces BOTH backwards of nvit_tpu/ops/flash_attention.py::_bwd (baseline
// mode's attention), given the forward's lse (flash_attn_fwd.cu) and dO:
//
//   K8  _bwd_fused_kernel (T_pad ≤ 1024):  Δ = rowsum(dO ∘ O) inside;
//       qs = bf16(q·scale), ks = bf16(k·scale); S = qs kᵀ; P = exp(S − lse);
//       dS = P ⊙ (dO Vᵀ − Δ);  dV = bf16(P)ᵀ dO,  dK = bf16(dS)ᵀ qs,
//       dQ = bf16(dS) ks                                   (fp32 products)
//   K9  _dq_kernel + _dkv_kernel (T_pad > 1024): Δ given (computed outside);
//       the same dV and dK;  dQ = (bf16(dS) k) · scale, scaled in fp32.
//
// The `split` flag picks K9's dQ operand and rounding; the wrapper sets it
// from T exactly where _bwd switches, so each TPU kernel keeps an exact twin.
// q·scale and k·scale use the scale rounded to bf16 (the TPU kernels'
// weak-typed `q_ref[0] * scale`); K9's fp32 dQ scale is the exact
// `dq_scale`.
//
// The design is K2's (qknorm_attn_bwd.cu): the two backward walks of
// attn_bwd.cuh — whose header says what bounds them on the H100 (the tensor
// cores and the exp/ALU work of the [T, T] tiles, not memory) and how the
// design answers that — with the plain operands and a plain epilogue, after a
// prologue; three launches on one stream, all deterministic (no atomics):
//
// 1. the prologue (qknorm_project.cu's plain mode, nvit_flash_project,
//    launched by the wrapper) — qs and, for K8, ks once per call as bf16
//    [B·H, T, D] scratch, and lse and Δ (K8: Σ_d dO·O in fp32; K9: the given
//    one) padded to whole 64-row tiles.  The dK/dV walk reads every query
//    tile once per key tile and the dQ walk every key tile once per query
//    tile, so rounding the scaled operands in the walks would repeat it
//    ⌈T/64⌉ times.
// 2. dK/dV (≙ _dkv_kernel) — one block (one warpgroup) per (b·h, 64-key
//    tile): k and v, read raw through their strides, stay in shared memory
//    while each query tile of qs, dO, lse and Δ comes through the cp.async
//    ring; Sᵀ, dPᵀ, Pᵀ and dSᵀ on wgmma in registers; dV and dK accumulate in
//    registers and are rounded to bf16 straight from them.
// 3. dQ (≙ _dq_kernel) — one block per (b·h, 64-query tile) walking the key
//    tiles: k (for S) and v raw, and for K8 ks (for dQ) from the scratch; K9
//    multiplies dS by the k tile it already holds, so its stages hold two
//    tiles where K8's hold three.  dQ accumulates in registers.
//
// Ragged T: the TPU kernels pad T; K8 zeroes padded query ROWS of P (their
// lse is garbage) and K9's dK/dV zeroes padded query COLUMNS of Pᵀ — the
// same entries.  Here nothing is padded in device memory but the prologue's
// scratch rows of lse and Δ: P = 0 for queries past T (their dO and Δ are
// zero too) and for keys past T; key rows past T are computed on zero-filled
// k/v and never stored.  k, v, dO and the three outputs are addressed through
// (batch, head, token) strides with a contiguous head dim, so k/v can stay
// views of the fused QKV projection and dq/dk/dv can land in one
// [B, T, 3, H, D] buffer.

#include "attn_bwd.cuh"

namespace {

using namespace attn_bwd;

// rows r_i = 16·warp + lane/4 + 8·i of a 64 × D fp32 accumulator
// (hopper.cuh's layout), times `mul`, → bf16 rows row0 + r_i of one head
// (`st` apart); rows past T are not stored
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ head, int64_t st, int row0, int T,
                                           const float (&acc)[D / 2], float mul) {
  const int lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + (threadIdx.x >> 5) * 16 + (lane >> 2) + 8 * i;
    if (t < T) {
      bf16* g = head + (int64_t)t * st + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(g + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
    }
  }
}

// dK/dV pass: dV = bf16(Σ Pᵀ dO) and dK = bf16(Σ dSᵀ qs) of this block's 64
// keys (qs carries the scale into dK)
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_attn_bwd_dkv_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                          const bf16* __restrict__ dO, const bf16* __restrict__ qs,
                          const float* __restrict__ lse_pad, const float* __restrict__ delta_pad,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T, int T_pad,
                          Strides st) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int n0 = blockIdx.x * BLOCK;
  float acc_dv[D / 2], acc_dk[D / 2];
  dkv_walk<D, false>(acc_dv, acc_dk, base, smem_raw + (base - raw), k + b * st.k[0] + h * st.k[1], st.k[2],
                     v + b * st.v[0] + h * st.v[1], st.v[2], qs + (int64_t)bh * T * D,
                     dO + b * st.dO[0] + h * st.dO[1], st.dO[2], lse_pad + (int64_t)bh * T_pad,
                     delta_pad + (int64_t)bh * T_pad, n0, T, T_pad, 0.f);
  store_rows<D>(dv + b * st.dv[0] + h * st.dv[1], st.dv[2], n0, T, acc_dv, 1.0f);
  store_rows<D>(dk + b * st.dk[0] + h * st.dk[1], st.dk[2], n0, T, acc_dk, 1.0f);
}

// dQ pass: dQ = bf16(Σ dS ks) (K8, TWO_KEYS) or bf16((Σ dS k)·dq_scale) (K9)
// of this block's 64 queries
template <int D, bool TWO_KEYS>
__global__ void __launch_bounds__(NUM_THREADS)
flash_attn_bwd_dq_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const bf16* __restrict__ dO, const bf16* __restrict__ qs,
                         const bf16* __restrict__ ks, const float* __restrict__ lse_pad,
                         const float* __restrict__ delta_pad, bf16* __restrict__ dq, int H, int T,
                         int T_pad, float dq_scale, Strides st) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * BLOCK;
  const int64_t head = (int64_t)bh * T * D;
  float acc_dq[D / 2];
  dq_walk<D, false, TWO_KEYS>(acc_dq, base, qs + head, dO + b * st.dO[0] + h * st.dO[1], st.dO[2],
                              k + b * st.k[0] + h * st.k[1], st.k[2], TWO_KEYS ? ks + head : nullptr,
                              v + b * st.v[0] + h * st.v[1], st.v[2], lse_pad + (int64_t)bh * T_pad,
                              delta_pad + (int64_t)bh * T_pad, m0, T, T_pad / BLOCK, 0.f);
  store_rows<D>(dq + b * st.dq[0] + h * st.dq[1], st.dq[2], m0, T, acc_dq, TWO_KEYS ? 1.0f : dq_scale);
}

template <int D>
cudaError_t launch(const void* k, const void* v, const void* dO, const void* qs, const void* ks,
                   const void* lse_pad, const void* delta_pad, void* dq, void* dk, void* dv, int B,
                   int H, int T, float dq_scale, const Strides& st, cudaStream_t stream) {
  const int n_tiles = (T + BLOCK - 1) / BLOCK;
  const int T_pad = n_tiles * BLOCK;
  const dim3 grid(n_tiles, B * H);
  const bf16 *kp = static_cast<const bf16*>(k), *vp = static_cast<const bf16*>(v);
  const bf16 *dOp = static_cast<const bf16*>(dO), *qsp = static_cast<const bf16*>(qs);
  const float *lp = static_cast<const float*>(lse_pad), *dp = static_cast<const float*>(delta_pad);
  cudaError_t err;
  const int smem_kv = LayoutKV<D>::BYTES;
  if ((err = allow_smem(flash_attn_bwd_dkv_kernel<D>, smem_kv)) != cudaSuccess) return err;
  flash_attn_bwd_dkv_kernel<D><<<grid, NUM_THREADS, smem_kv, stream>>>(
      kp, vp, dOp, qsp, lp, dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T, T_pad, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if (ks != nullptr) {  // K8
    const int smem_q = LayoutQ<D, true>::BYTES;
    if ((err = allow_smem(flash_attn_bwd_dq_kernel<D, true>, smem_q)) != cudaSuccess) return err;
    flash_attn_bwd_dq_kernel<D, true><<<grid, NUM_THREADS, smem_q, stream>>>(
        kp, vp, dOp, qsp, static_cast<const bf16*>(ks), lp, dp, static_cast<bf16*>(dq), H, T, T_pad,
        dq_scale, st);
  } else {  // K9
    const int smem_q = LayoutQ<D, false>::BYTES;
    if ((err = allow_smem(flash_attn_bwd_dq_kernel<D, false>, smem_q)) != cudaSuccess) return err;
    flash_attn_bwd_dq_kernel<D, false><<<grid, NUM_THREADS, smem_q, stream>>>(
        kp, vp, dOp, qsp, nullptr, lp, dp, static_cast<bf16*>(dq), H, T, T_pad, dq_scale, st);
  }
  return cudaGetLastError();
}

}  // namespace

// k, v, dO: bf16 [B, H, T, D] addressed through (batch, head, token) element
// strides, head dim contiguous; qs (and ks for K8): bf16 [B·H, T, D] and
// lse_pad, delta_pad: fp32 [B·H, 64·ceil(T/64)], all from nvit_flash_project.
// Outputs dq, dk, dv: bf16, addressed as k.  split = 0 is K8 (ks given, dQ =
// bf16(dS)·ks), split = 1 is K9 (ks null, dQ = (bf16(dS)·k)·dq_scale in fp32).
// strides = {k_sb, k_sh, k_st, v_.., dO_.., dq_.., dk_.., dv_..}.
extern "C" cudaError_t nvit_flash_attn_bwd(const void* k, const void* v, const void* dO,
                                           const void* qs, const void* ks, const void* lse_pad,
                                           const void* delta_pad, void* dq, void* dk, void* dv,
                                           int B, int H, int T, int D, float dq_scale, int split,
                                           const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || (split != 0) != (ks == nullptr)) return cudaErrorInvalidValue;
  Strides st{};
  int64_t* dst[6] = {st.k, st.v, st.dO, st.dq, st.dk, st.dv};
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(k, v, dO, qs, ks, lse_pad, delta_pad, dq, dk, dv, B, H, T, dq_scale, st, s);
  if (D == 32) return launch<32>(k, v, dO, qs, ks, lse_pad, delta_pad, dq, dk, dv, B, H, T, dq_scale, st, s);
  return cudaErrorInvalidValue;
}
