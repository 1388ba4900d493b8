// Flash attention, forward — hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel nvit_tpu/ops/flash_attention.py::_fwd_kernel,
// launched by _fwd (baseline mode's attention).  Per (b, h):
//
//   q_s = bf16(q · bf16(scale))   S = q_s kᵀ (fp32)   P = exp(S − rowmax)
//   O = (bf16(P) V) / Σ P   lse = m + log Σ P
//
// The scale is folded into the q operand and rounded to bf16 with it, as the
// TPU kernel's `q_ref[0] * scale` does (a bf16 array times a weak-typed
// Python float: the scale is rounded to bf16, the product once more).  The
// wrapper passes the bf16-rounded scale.
//
// The design is K1's (qknorm_attn_fwd.cu): the tile loop of attn_fwd.cuh
// with its plain operands — one warpgroup per 64-query block, S = q_s kᵀ and
// O += P V as wgmmas with S, P and O in registers, K/V tiles through a
// two-stage cp.async ring — whose header says what bounds it on the H100 (the
// tensor cores and the exp work, not memory) and how the design answers that.
// The q tile is read raw through its strides and multiplied by the scale in
// shared memory once per block, right after it lands: one 64 × D pass, no
// launch of its own and no scratch, unlike K1's projection, which must
// normalise k too.  k and v are read raw through their strides.  The TPU
// kernel holds a whole [BLOCK_Q, T] fp32 score tile in VMEM (up to 2.4 MB at
// T = 784); here the online softmax walks 64-key tiles instead.  Ragged T:
// key columns past T are masked to −inf and their rows zero-filled, query
// rows past T are computed on zeros and not stored — nothing is padded in
// device memory.
//
// Numerics vs the TPU kernel: the same bf16 operand fold and fp32 scores;
// the online rescale rounds P to bf16 relative to the RUNNING max instead of
// the true row max, a difference of at most one bf16 rounding of P.

#include "attn_fwd.cuh"

namespace {

using namespace attn_fwd;

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse, int H,
                      int T, float scale, Strides st) {
  extern __shared__ unsigned char smem_raw[];
  tile_loop<D, true>(q, k, v, nullptr, o, lse, H, T, scale, MODE_ROWMAX, st, smem_raw, nullptr);
}

template <int D>
cudaError_t launch_plain(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                         int T, float scale, const Strides& st, cudaStream_t stream) {
  return launch<D>(flash_attn_fwd_kernel<D>, B, H, T, stream, static_cast<const bf16*>(q),
                   static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
                   static_cast<float*>(lse), H, T, scale, st);
}

}  // namespace

// q, k, v: bf16 [B, H, T, D] addressed through (batch, head, token) element
// strides, last dim contiguous; o: bf16, same addressing; lse: fp32 [B·H, T]
// or null; scale: the softmax scale already rounded to bf16.
// strides = {q_sb, q_sh, q_st, k_.., v_.., o_..}.
extern "C" cudaError_t nvit_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                           void* lse, int B, int H, int T, int D, float scale,
                                           const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = unpack_strides(strides);
  if (D == 64) return launch_plain<64>(q, k, v, o, lse, B, H, T, scale, st, s);
  if (D == 32) return launch_plain<32>(q, k, v, o, lse, B, H, T, scale, st, s);
  return cudaErrorInvalidValue;
}
