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
// round trip of it, which is the point of the TPU kernel.
//
// What bounds it on the H100: the recompute GEMM is 4·n·K·H flops over
// (n·K + 2H·K + 3·n·H)·2 bytes (x, W, g in; du, dv out) — ~460 flops per byte
// at the flagship c_fc shape (n = B·784, K = 768, H = 3072), above the bf16
// ridge: tensor-core throughput bounds it.
//
// Design: K3's (gated_mlp_fwd.cu) — ONE GEMM with TWO fp32 accumulators over
// weight rows j and H + j, both operands K-major, x and weight tiles through
// a 2-stage cp.async ring in 32-wide K steps, four warps (2 × 2) of
// nvcuda::wmma bf16 16×16×16 fragments over a 64 × 64 tile of u and of v.
// Only the epilogue differs: it reads the matching g tile (and, for K6, adds
// the bias to u and v as K3's epilogue does), computes σ(v) once in fp32 and
// writes du and dv, each cast once to bf16.  K6's db is the fp32 column sum
// of this [du | dv] buffer, which the JAX package also takes outside the
// kernel (_core_bwd_b).  Ragged n (B·784
// against 64-row tiles) is zero-filled on load and masked on store, as is a
// last K step of 16; K % 16 and H % 64 are required and checked by the
// wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;  // rows of x per block
constexpr int BN = 64;  // columns per block (of u and of v each)
constexpr int BK = 32;  // K step
constexpr int STAGES = 2;
constexpr int NUM_THREADS = 128;  // 4 warps, 2 × 2 over the 64 × 64 tile
constexpr int LDT = BK + 8;       // bf16 tile pitch: 80 bytes, off the 128-byte bank period

struct Smem {
  bf16 x[STAGES][BM * LDT];
  bf16 wu[STAGES][BN * LDT];
  bf16 wv[STAGES][BN * LDT];
  float epi[NUM_THREADS / 32][2][16 * 16];  // per-warp u / v fragment scratch
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = valid ? 16 : 0;  // 0 ⇒ the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One K step of the x, Wu and Wv tiles (as in K3): 256 16-byte chunks per
// tile, 2 per thread per tile; chunks past n or past K are zero-filled.
__device__ __forceinline__ void load_stage(Smem& sm, int stage, const bf16* __restrict__ x,
                                           const bf16* __restrict__ w, int n, int K, int H,
                                           int m0, int j0, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = threadIdx.x + i * NUM_THREADS;
    const int r = chunk >> 2;
    const int c = (chunk & 3) * 8;
    const int xr = m0 + r;
    const bool k_live = k0 + c < K;
    const bool x_live = k_live && xr < n;
    const int kc = k_live ? k0 + c : 0;
    cp_async16(&sm.x[stage][r * LDT + c], x + (int64_t)(x_live ? xr : 0) * K + kc, x_live);
    cp_async16(&sm.wu[stage][r * LDT + c], w + (int64_t)(j0 + r) * K + kc, k_live);
    cp_async16(&sm.wv[stage][r * LDT + c], w + (int64_t)(H + j0 + r) * K + kc, k_live);
  }
}

// the bias values of 8 adjacent columns in fp32
__device__ __forceinline__ void load_bias8(float* dst, const bf16* __restrict__ b) {
  const uint4 raw = *reinterpret_cast<const uint4*>(b);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int c = 0; c < 8; ++c) dst[c] = __bfloat162float(e[c]);
}

__global__ void __launch_bounds__(NUM_THREADS)
gated_mlp_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const bf16* __restrict__ bias, const bf16* __restrict__ g,
                     bf16* __restrict__ duv, int n, int K, int H) {
  __shared__ __align__(128) Smem sm;
  const int m0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 1;  // 32-row half of the tile
  const int wn = warp & 1;   // 32-col half of the tile

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_u[2][2], acc_v[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc_u[i][j], 0.f);
      wmma::fill_fragment(acc_v[i][j], 0.f);
    }

  const int nk = (K + BK - 1) / BK;
  load_stage(sm, 0, x, w, n, K, H, m0, j0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < nk) load_stage(sm, stage ^ 1, x, w, n, K, H, m0, j0, (kt + 1) * BK);
    cp_async_commit();  // possibly empty: keeps "wait for all but one" uniform
    cp_async_wait_one();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      // W tiles are stored [out col][k] row-major = Wᵀ [k][col] column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bu[2], bv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &sm.x[stage][(wm * 32 + i * 16) * LDT + kk * 16], LDT);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(bu[j], &sm.wu[stage][(wn * 32 + j * 16) * LDT + kk * 16], LDT);
        wmma::load_matrix_sync(bv[j], &sm.wv[stage][(wn * 32 + j * 16) * LDT + kk * 16], LDT);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(acc_u[i][j], a[i], bu[j], acc_u[i][j]);
          wmma::mma_sync(acc_v[i][j], a[i], bv[j], acc_v[i][j]);
        }
    }
    __syncthreads();  // the stage is refilled by the next iteration's loads
  }

  // epilogue: the gate's derivatives in fp32 against the g tile, masked rows
  float* eu = sm.epi[warp][0];
  float* ev = sm.epi[warp][1];
  const int er = lane >> 1;       // fragment row 0..15
  const int ec = (lane & 1) * 8;  // fragment cols ec..ec+7
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(eu, acc_u[i][j], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(ev, acc_v[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * 32 + i * 16 + er;
      if (row < n) {
        const int col = j0 + wn * 32 + j * 16 + ec;
        const uint4 graw = *reinterpret_cast<const uint4*>(g + (int64_t)row * H + col);
        const bf16* ge = reinterpret_cast<const bf16*>(&graw);
        float bu[8], bv[8];
        if (bias != nullptr) {
          load_bias8(bu, bias + col);
          load_bias8(bv, bias + H + col);
        }
        uint4 pu, pv;
        bf16* du = reinterpret_cast<bf16*>(&pu);
        bf16* dv = reinterpret_cast<bf16*>(&pv);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float u = eu[er * 16 + ec + c];
          float vv = ev[er * 16 + ec + c];
          if (bias != nullptr) {  // ≙ _uv_tiles: u + bu.astype(f32)
            u += bu[c];
            vv += bv[c];
          }
          const float gg = __bfloat162float(ge[c]);
          const float sig = 1.f / (1.f + expf(-vv));
          // ≙ _bwd_kernel: g·v·σ and g·u·σ·(1 + v·(1 − σ)), left to right
          du[c] = __float2bfloat16(gg * vv * sig);
          dv[c] = __float2bfloat16(gg * u * sig * (1.f + vv * (1.f - sig)));
        }
        bf16* out = duv + (int64_t)row * (2 * H) + col;
        *reinterpret_cast<uint4*>(out) = pu;
        *reinterpret_cast<uint4*>(out + H) = pv;
      }
      __syncwarp();
    }
}

}  // namespace

// x: bf16 [n, K] row-major; w: bf16 [2H, K] row-major; bias: bf16 [2H] or
// null (K4); g: bf16 [n, H] row-major; duv: bf16 [n, 2H] (du in columns
// 0..H-1, dv in H..2H-1).  Requires K % 16 == 0, H % 64 == 0 and
// 16-byte-aligned pointers.
extern "C" cudaError_t nvit_gated_mlp_bwd(const void* x, const void* w, const void* bias,
                                          const void* g, void* duv, int n, int K, int H,
                                          void* stream) {
  if (n <= 0 || K <= 0 || K % 16 != 0 || H % BN != 0) return cudaErrorInvalidValue;
  dim3 grid((n + BM - 1) / BM, H / BN);
  gated_mlp_bwd_kernel<<<grid, NUM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(g), static_cast<bf16*>(duv), n, K, H);
  return cudaGetLastError();
}
