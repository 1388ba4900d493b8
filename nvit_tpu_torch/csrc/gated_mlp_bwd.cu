// Fused gated MLP, backward — hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel nvit_tpu/ops/gated_mlp.py::_bwd_kernel, launched
// by _bwd_duv through _call: K4 with has_bias=False (_core_bwd), K6's
// backward with has_bias=True (_core_bwd_b).  Given the output gradient g, it
// recomputes u and v and writes their gradients:
//
//   [u | v] = x [Wu | Wv]ᵀ (+ [bu | bv]) (fp32 accumulate, bias added in fp32)
//   σ = sigmoid(v)                                                      (fp32)
//   du = bf16(g·v·σ)      dv = bf16(g·u·σ·(1 + v·(1 − σ)))
//
// with x [n, K], W [2H, K] in torch's [out, in] layout (rows 0..H-1 are Wu,
// rows H..2H-1 are Wv) and g [n, H].  du and dv land side by side in one
// [n, 2H] buffer, so the caller forms dx = duv·W and dW = duvᵀ·x with one
// cuBLAS GEMM each — the dense products _dw_dx leaves to XLA.  The [n, 2H]
// u|v product itself never reaches device memory: the recompute replaces a
// round trip of it, which is the point of the TPU kernel.  K6's db is the
// fp32 column sum of this [du | dv] buffer, which the JAX package also takes
// outside the kernel (_core_bwd_b).
//
// What bounds it on the H100: the recompute GEMM is 4·n·K·H flops over
// (n·K + 2H·K + 3·n·H)·2 bytes (x, W, g in; du, dv out) — ~460 flops per byte
// at the flagship c_fc shape (n = B·784, K = 768, H = 3072), above the bf16
// ridge: tensor-core throughput bounds it, but the epilogue moves 2.3× the
// forward's bytes.
//
// Design: the product is gated_gemm.cuh's persistent, warp-specialized GEMM,
// as in K3 (gated_mlp_fwd.cu), on a 3-stage ring: the epilogue needs two
// 32 KB tiles of its own.  Per tile the producer also loads the 128 × 128 g
// tile by TMA into the first of them, once the last tile's stores have read
// it, so it lands while this tile's products run.  The epilogue works on the
// accumulator registers (u and v of an element in one thread; K6 adds the
// bias in fp32 first), forms σ(v) once, writes du over g in place (each
// thread reads and writes the same pairs) and dv into the second tile, and
// TMA stores both to columns [j0, j0 + 128) and [H + j0, H + j0 + 128) of the
// [n, 2H] buffer, mapped as [n][2][H] so a store never crosses from du's
// half into dv's, while the next tile's products run.

#include "gated_gemm.cuh"

namespace {

using namespace gated_gemm;

constexpr int STAGES = 3;
using Sm = Smem<STAGES>;
constexpr int SMEM = Sm::bytes(2 * OUT_TILE);  // g (then du), dv

__global__ void __launch_bounds__(NUM_THREADS, 1)
gated_mlp_bwd_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_g, const __grid_constant__ CUtensorMap tm_duv,
                     const bf16* __restrict__ bias, int n, int K, int H) {
  extern __shared__ unsigned char smem_raw[];
  const Sm sm(smem_raw, 2 * OUT_TILE);
  unsigned char* du_tile = smem_raw + (sm.extra - smem_u32(smem_raw));
  unsigned char* dv_tile = du_tile + OUT_TILE;
  // g rows m0 .. m0 + 127, columns j0 .. j0 + 127 (zeros past n and H)
  const auto load_g = [&](int m0, int j0, uint32_t dst, uint32_t bar) {
    mbar_arrive_expect_tx(bar, OUT_TILE);
    tma_load_2d(dst, &tm_g, j0, m0, bar);
    tma_load_2d(dst + BOX, &tm_g, j0 + 64, m0, bar);
  };
  const auto epilogue = [&](float(&acc)[ACC], const Thread& th, int m0, int j0, int local) {
    mbar_wait(sm.epi_full, local & 1);
    // the gate's derivatives in fp32 against the g tile → du (over g), dv
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float2 bu, bv;
      bias_pair(bu, bv, bias, j0 + 8 * j + th.q2, H);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t off = out_offset(th.r0 + 8 * i, 8 * j + th.q2);
        const float2 gg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(du_tile + off));
        float du[2], dv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float u = acc[4 * j + 2 * i + c] + (c ? bu.y : bu.x);  // ≙ _uv_tiles: u + bu.astype(f32)
          const float v = acc[BN / 2 + 4 * j + 2 * i + c] + (c ? bv.y : bv.x);
          const float gc = c ? gg.y : gg.x;
          const float sig = sigmoid(v);
          // ≙ _bwd_kernel: g·v·σ and g·u·σ·(1 + v·(1 − σ)), left to right
          du[c] = gc * v * sig;
          dv[c] = gc * u * sig * (1.f + v * (1.f - sig));
        }
        *reinterpret_cast<uint32_t*>(du_tile + off) = pack_bf16(du[0], du[1]);
        *reinterpret_cast<uint32_t*>(dv_tile + off) = pack_bf16(dv[0], dv[1]);
      }
    }
    staged();
    if (th.lead) {
      for (int h = 0; h < 2 && j0 + 64 * h < H; ++h) {
        tma_store_3d(&tm_duv, sm.extra + h * BOX, j0 + 64 * h, 0, m0);
        tma_store_3d(&tm_duv, sm.extra + OUT_TILE + h * BOX, j0 + 64 * h, 1, m0);
      }
      tma_store_commit();
    }
  };
  run<STAGES, true>(&tm_x, &tm_w, n, K, H, sm, load_g, epilogue);
}

}  // namespace

// x: bf16 [n, K] row-major; w: bf16 [2H, K] row-major; bias: bf16 [2H] or
// null (K4); g: bf16 [n, H] row-major; duv: bf16 [n, 2H] (du in columns
// 0..H-1, dv in H..2H-1).  Requires K % 16 == 0, H % 64 == 0 and
// 16-byte-aligned pointers.
extern "C" cudaError_t nvit_gated_mlp_bwd(const void* x, const void* w, const void* bias,
                                          const void* g, void* duv, int n, int K, int H,
                                          void* stream) {
  if (n <= 0 || K <= 0 || K % 16 != 0 || H <= 0 || H % 64 != 0) return cudaErrorInvalidValue;
  const cudaError_t err = prepare(gated_mlp_bwd_kernel, SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_x, tm_w, tm_g, tm_duv;
  // duv as [n][2][H]: 64 columns × 128 rows of one half
  const cuuint64_t dd[3] = {(cuuint64_t)H, 2, (cuuint64_t)n}, ds[2] = {(cuuint64_t)H * 2, (cuuint64_t)H * 4};
  const cuuint32_t dbox[3] = {64, 1, BM};
  if (!encode_operands(&tm_x, &tm_w, x, w, n, K, H) || !encode_rows(&tm_g, g, n, H) ||
      !encode(&tm_duv, duv, 3, dd, ds, dbox))
    return cudaErrorInvalidValue;
  return launch(gated_mlp_bwd_kernel, SMEM, n, H, static_cast<cudaStream_t>(stream), tm_x, tm_w, tm_g, tm_duv,
                static_cast<const bf16*>(bias), n, K, H);
}
