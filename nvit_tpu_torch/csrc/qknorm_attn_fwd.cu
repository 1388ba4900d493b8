// QK-norm flash attention, forward — hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel nvit_tpu/ops/flash_attention.py::_fwd_qknorm_kernel,
// launched by _fwd_qknorm_call: K1 is its row-max arm (bounded=False), K5 its
// bounded arm (bounded=True) and _fwd_qknorm's "auto" cond between the two.
// Per (b, h):
//
//   q̂ = bf16((s·scale) ⊙ q/max(‖q‖, 1e-30))      k̂ = bf16(s ⊙ k/max(‖k‖, 1e-30))
//   S = q̂ k̂ᵀ (fp32)   P = exp(S − m)   O = (bf16(P) V) / Σ P   lse = m + log Σ P
//
// with s = sqk_eff[h] (fp32, [H, D]) and, by `mode`:
//   rowmax (K1)  m = the row max of S;
//   bounded (K5) m = bound = scale·max_d(s_d²), which bounds every score
//                (Cauchy-Schwarz), and P = exp(max(S − bound, −60)): the
//                floor keeps Σ P > 0 at any learned-sqk drift;
//   auto (K5)    bounded for every head when scale·max(sqk_eff²) over ALL
//                heads is below 20, else rowmax — decided here on the card
//                from the [H, D] sqk_eff each block reads, so the caller
//                never waits on the device.
// q̂ and k̂ come from the projection prologue (qknorm_project.cu), which
// rounds them once per call in K1's multiply order; this kernel reads them
// as bf16 [B·H, T, D] scratch and v through its (batch, head, token) strides.
//
// The tile loop — one warpgroup per 64-query block, S, P and O in registers
// on wgmma, K/V through a two-stage cp.async ring — is attn_fwd.cuh's, shared
// with K7 (flash_attn_fwd.cu); its header says what bounds it and how the
// design answers that.  This file instantiates it with the QK-norm operands.
// The projection runs once per call in the prologue, not per tile: the
// alternative, each landed q/k tile projected in shared memory, repeats it
// ⌈T/64⌉ times and measured slower than the prologue design (PERF.md §6).
//
// Numerics vs the TPU kernel: the same q̂/k̂ rounding; the online rescale
// rounds P to bf16 relative to the running max instead of the final row
// max, a difference of at most one bf16 rounding of P; exp2 of the folded
// argument differs from exp by float rounding only.

#include "attn_fwd.cuh"

namespace {

using namespace attn_fwd;

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
qknorm_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ sqk,
                       bf16* __restrict__ o, float* __restrict__ lse, int H, int T, float scale,
                       int mode, Strides st) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[NUM_WARPS];
  tile_loop<D, false>(q, k, v, sqk, o, lse, H, T, scale, mode, st, smem_raw, red);
}

template <int D>
cudaError_t launch_qknorm(const void* q, const void* k, const void* v, const void* sqk, void* o,
                          void* lse, int B, int H, int T, float scale, int mode, const Strides& st,
                          cudaStream_t stream) {
  return launch<D>(qknorm_attn_fwd_kernel<D>, B, H, T, stream, static_cast<const bf16*>(q),
                   static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                   static_cast<const float*>(sqk), static_cast<bf16*>(o), static_cast<float*>(lse), H,
                   T, scale, mode, st);
}

}  // namespace

// q, k: q̂ (s·scale) and k̂ (s), bf16, from nvit_qknorm_project; v and o:
// bf16 [B, H, T, D]; all addressed through (batch, head, token) element
// strides, last dim contiguous; sqk: fp32 [H, D]; lse: fp32 [B·H, T] or
// null; mode: 0 rowmax (K1), 1 bounded, 2 auto (K5).
// strides = {q_sb, q_sh, q_st, k_.., v_.., o_..}.
extern "C" cudaError_t nvit_qknorm_attn_fwd(const void* q, const void* k, const void* v,
                                            const void* sqk, void* o, void* lse, int B, int H,
                                            int T, int D, float scale, int mode,
                                            const int64_t* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
  if (mode < MODE_ROWMAX || mode > MODE_AUTO) return cudaErrorInvalidValue;
  const Strides st = unpack_strides(strides);
  if (D == 64) return launch_qknorm<64>(q, k, v, sqk, o, lse, B, H, T, scale, mode, st, s);
  if (D == 32) return launch_qknorm<32>(q, k, v, sqk, o, lse, B, H, T, scale, mode, st, s);
  return cudaErrorInvalidValue;
}
