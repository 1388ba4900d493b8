// Fused gated MLP, forward — hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel nvit_tpu/ops/gated_mlp.py::_fwd_kernel, launched
// by _call via _fwd: K3 with has_bias=False (_gated_core), K6 with
// has_bias=True (_gated_core_b):
//
//   u = x Wuᵀ (+ bu)   v = x Wvᵀ (+ bv)     fp32 accumulate, the bf16 bias added in fp32
//   out[n, H] = bf16( u ⊙ silu(v) )         fp32 gate
//
// with x [n, K] and W [2H, K] in torch's [out, in] layout (rows 0..H-1 are
// Wu, rows H..2H-1 are Wv — the suv-folded c_fc weight, or the cross-attention
// proj weight) and, for K6, b = [bu | bv] [2H] (≙ _uv_tiles).  Only the
// half-width result is written: the [n, 2H] u|v product never reaches device
// memory, which is the point of the TPU kernel.
//
// What bounds it on the H100: at the flagship c_fc shape (n = B·784, K = 768,
// H = 3072) it is a GEMM of 2·n·K·2H flops over (n·K + 2H·K + n·H)·2 bytes —
// ~1,170 flops per byte at B = 32, far above the bf16 ridge, so tensor-core
// throughput bounds it.
//
// Design: the product is gated_gemm.cuh's persistent, warp-specialized
// GEMM (a TMA producer warpgroup feeding a 4-stage ring of 64-wide K steps;
// two consumer warpgroups of m64n256k16 wgmma over a 128-row × (128 u + 128
// v)-column tile); its header says how that answers the bound.  This file
// adds the epilogue, on the accumulator registers: u and v of each output
// element already sit in one thread, so it adds the bias (K6: two bf16 pairs
// a column pair from L1/L2, in fp32), gates u·(v·σ(v)) in fp32, rounds once
// to bf16 and stages the 128 × 128 tile in its own 32 KB buffer, which a TMA
// store writes out (clipped at n and H) while the next tile's products run.

#include "gated_gemm.cuh"

namespace {

using namespace gated_gemm;

constexpr int STAGES = 4;
using Sm = Smem<STAGES>;
constexpr int SMEM = Sm::bytes(OUT_TILE);

__global__ void __launch_bounds__(NUM_THREADS, 1)
gated_mlp_fwd_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_out, const bf16* __restrict__ bias, int n, int K,
                     int H) {
  extern __shared__ unsigned char smem_raw[];
  const Sm sm(smem_raw, OUT_TILE);
  unsigned char* staged_out = smem_raw + (sm.extra - smem_u32(smem_raw));
  const auto no_load = [](int, int, uint32_t, uint32_t) {};
  const auto epilogue = [&](float(&acc)[ACC], const Thread& th, int m0, int j0, int) {
    wait_staging(th);
    // (+ bias), u · (v · σ(v)) in fp32, one bf16 cast, into the staged tile
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float2 bu, bv;
      bias_pair(bu, bv, bias, j0 + 8 * j + th.q2, H);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float g[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float u = acc[4 * j + 2 * i + c] + (c ? bu.y : bu.x);  // ≙ _uv_tiles: u + bu.astype(f32)
          const float v = acc[BN / 2 + 4 * j + 2 * i + c] + (c ? bv.y : bv.x);
          g[c] = u * (v * sigmoid(v));
        }
        *reinterpret_cast<uint32_t*>(staged_out + out_offset(th.r0 + 8 * i, 8 * j + th.q2)) =
            pack_bf16(g[0], g[1]);
      }
    }
    staged();
    if (th.lead) {
      for (int h = 0; h < 2 && j0 + 64 * h < H; ++h) tma_store_2d(&tm_out, sm.extra + h * BOX, j0 + 64 * h, m0);
      tma_store_commit();
    }
  };
  run<STAGES, false>(&tm_x, &tm_w, n, K, H, sm, no_load, epilogue);
}

}  // namespace

// x: bf16 [n, K] row-major; w: bf16 [2H, K] row-major; bias: bf16 [2H] or
// null (K3); out: bf16 [n, H].  Requires K % 16 == 0, H % 64 == 0 and
// 16-byte-aligned pointers.
extern "C" cudaError_t nvit_gated_mlp_fwd(const void* x, const void* w, const void* bias, void* out,
                                          int n, int K, int H, void* stream) {
  if (n <= 0 || K <= 0 || K % 16 != 0 || H <= 0 || H % 64 != 0) return cudaErrorInvalidValue;
  const cudaError_t err = prepare(gated_mlp_fwd_kernel, SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_x, tm_w, tm_out;
  if (!encode_operands(&tm_x, &tm_w, x, w, n, K, H) || !encode_rows(&tm_out, out, n, H))
    return cudaErrorInvalidValue;
  return launch(gated_mlp_fwd_kernel, SMEM, n, H, static_cast<cudaStream_t>(stream), tm_x, tm_w, tm_out,
                static_cast<const bf16*>(bias), n, K, H);
}
