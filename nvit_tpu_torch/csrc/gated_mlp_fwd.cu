// Fused gated MLP, forward — hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel nvit_tpu/ops/gated_mlp.py::_fwd_kernel with
// has_bias=False, launched by _call via _fwd / _gated_core:
//
//   out[n, H] = bf16( (x Wuᵀ) ⊙ silu(x Wvᵀ) )     fp32 accumulate, fp32 gate
//
// with x [n, K] and W [2H, K] in torch's [out, in] layout (rows 0..H-1 are
// Wu, rows H..2H-1 are Wv — the suv-folded c_fc weight, or the cross-attention
// proj weight).  Only the half-width result is written: the [n, 2H] u|v
// product never reaches device memory, which is the point of the TPU kernel.
//
// What bounds it on the H100: at the flagship c_fc shape (n = B·784, K = 768,
// H = 3072) it is a GEMM of 2·n·K·2H flops over (n·K + 2H·K + n·H)·2 bytes —
// ~1000 flops per byte at B = 32, far above the bf16 ridge, so tensor-core
// throughput bounds it.
//
// Design: ONE GEMM with TWO accumulators.  A block computes a 64-row × 64-col
// tile of u AND the matching tile of v (weight rows j and H + j), so both
// halves of every output element are in the same thread's registers for the
// epilogue.  Both operands are K-major, so x tiles and weight tiles stream
// through a 2-stage cp.async ring in 32-wide K steps.  Four warps (2 × 2)
// each own 32 × 32 of u and of v as nvcuda::wmma bf16 16×16×16 fragments
// with fp32 accumulators.  The epilogue stages one fragment pair through a
// per-warp fp32 scratch, applies u·(v·σ(v)) in fp32 and writes bf16 once.
// wgmma/TMA and larger tiles are later work.  Ragged n (B·784 against 64-row
// tiles) is zero-filled on load and masked on store; so is a last K step of
// 16 when K % 32 == 16.  K % 16 and H % 64 are required and checked by the
// wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;  // rows of x per block
constexpr int BN = 64;  // output columns per block (of u and of v each)
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

// One K step of the x, Wu and Wv tiles: 64 rows × 32 bf16 = 4 chunks of 16 bytes
// per row, 256 chunks per tile, 2 per thread per tile.  Chunks past n (x rows)
// or past K (columns) are zero-filled and read nothing.
__device__ __forceinline__ void load_stage(Smem& sm, int stage, const bf16* __restrict__ x,
                                           const bf16* __restrict__ w, int n, int K, int H,
                                           int m0, int j0, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = threadIdx.x + i * NUM_THREADS;  // 0..255
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

__global__ void __launch_bounds__(NUM_THREADS)
gated_mlp_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     bf16* __restrict__ out, int n, int K, int H) {
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

  // epilogue: u · (v · σ(v)) in fp32, one bf16 cast, masked rows
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
        uint4 packed;
        bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float u = eu[er * 16 + ec + c];
          const float vv = ev[er * 16 + ec + c];
          const float sig = 1.f / (1.f + expf(-vv));
          e[c] = __float2bfloat16(u * (vv * sig));
        }
        const int col = j0 + wn * 32 + j * 16 + ec;
        *reinterpret_cast<uint4*>(out + (int64_t)row * H + col) = packed;
      }
      __syncwarp();
    }
}

}  // namespace

// x: bf16 [n, K] row-major; w: bf16 [2H, K] row-major; out: bf16 [n, H].
// Requires K % 16 == 0, H % 64 == 0 and 16-byte-aligned pointers.
extern "C" cudaError_t nvit_gated_mlp_fwd(const void* x, const void* w, void* out, int n, int K,
                                          int H, void* stream) {
  if (n <= 0 || K <= 0 || K % 16 != 0 || H % BN != 0) return cudaErrorInvalidValue;
  dim3 grid((n + BM - 1) / BM, H / BN);
  gated_mlp_fwd_kernel<<<grid, NUM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), n, K, H);
  return cudaGetLastError();
}
