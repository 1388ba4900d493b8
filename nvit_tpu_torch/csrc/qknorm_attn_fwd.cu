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
//                never waits on the device.  The normalisation is fused: q and k are
// read once from device memory and projected in fp32 registers, so the
// projected q̂/k̂ never exist in device memory (the point of the TPU kernel).
//
// What bounds it on the H100: at the flagship shape (T = 784, D = 64) the
// two matmuls are 4·T²·D flops per (b, h) against 4·T·D·2 bytes of q/k/v/o —
// ~400 flops per byte, above the bf16 ridge (~295), so tensor-core throughput
// and the softmax's exp/max work bound it, not memory.
//
// Design: the TPU kernel holds the whole [T, T] fp32 score tile in VMEM
// (2.4 MB at T = 784); a block here has 227 KB of shared memory.  So one
// block takes a 64-row query tile of one (b, h) and loops over 64-key K/V
// tiles with an ONLINE softmax (running max m and sum l per row, O rescaled
// by exp(m_old − m_new)).  Four warps each own 16 query rows: scores, softmax
// and the P·V update are warp-local; only the K/V tile loads are block-wide.
// Matmuls use the tensor cores through nvcuda::wmma (bf16 16×16×16, fp32
// accumulate); O accumulates in fp32 shared memory.  wgmma/TMA pipelining is
// later work.  Ragged T (784 = 12·64 + 16): key columns past T are masked to
// −inf and their V rows zero-filled; query rows past T are computed on zeros
// (the 1e-30 floor keeps them finite) and not stored.
//
// K5's bounded arm drops the online softmax's row max and rescale: the bound
// is a constant known before the first tile (one block-wide max over D, or
// H·D in auto, of values already in L2), so O accumulates with α = 1.
//
// Numerics vs the TPU kernel: the same fp32 projection and multiply order;
// the online rescale rounds P to bf16 relative to the running max instead of
// the final row max, a difference of at most one bf16 rounding of P.  The
// bounded arm rounds P against the same bound as the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BLOCK_M = 64;  // query rows per block, 16 per warp
constexpr int BLOCK_N = 64;  // keys per K/V tile
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr float NORM_EPS = 1e-30f;  // ≙ flash_attention.py _NORM_EPS
constexpr unsigned FULL = 0xffffffffu;
// softmax stabilizer modes (ops/flash_attention.py MODES)
constexpr int MODE_ROWMAX = 0;
constexpr int MODE_BOUNDED = 1;
constexpr int MODE_AUTO = 2;
constexpr float BOUND_GATE = 20.0f;          // ≙ flash_attention.py _BOUND_GATE
constexpr float BOUNDED_EXP_FLOOR = -60.0f;  // ≙ _BOUNDED_EXP_FLOOR

// max_i s[i]² over n fp32 values, the same in every thread of the block
__device__ __forceinline__ float block_max_sq(const float* __restrict__ s, int n, float* red) {
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += NUM_THREADS) m = fmaxf(m, s[i] * s[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  __syncthreads();  // red is free: an earlier call's readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NUM_WARPS; ++w) m = fmaxf(m, red[w]);
  return m;
}

template <int D>
struct Smem {
  // pitches padded off a multiple of 128 bytes against bank conflicts; each
  // stays a multiple of 16 bytes (vector stores) and of wmma's ldm unit
  static constexpr int LDH = D + 8;        // bf16 q̂ / k̂ / v rows
  static constexpr int LDS = BLOCK_N + 4;  // fp32 scores
  static constexpr int LDP = BLOCK_N + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;        // fp32 output accumulator
  bf16 q[BLOCK_M * LDH];
  bf16 k[BLOCK_N * LDH];
  bf16 v[BLOCK_N * LDH];
  float s[BLOCK_M * LDS];
  bf16 p[BLOCK_M * LDP];
  float o[BLOCK_M * LDO];
};

// bf16((s·scale) ⊙ x/max(‖x‖, eps)) for one half row; the other half lives
// in the neighbouring lane.
template <int D>
__device__ __forceinline__ void project_row(uint4* out, const uint4* raw, int half,
                                            const float* __restrict__ s_vec, float scale) {
  constexpr int HALF = D / 2;
  constexpr int VEC = HALF / 8;
  float x[HALF];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const bf16* e = reinterpret_cast<const bf16*>(&raw[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[i * 8 + j] = __bfloat162float(e[j]);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < HALF; ++i) ss += x[i] * x[i];
  ss += __shfl_xor_sync(FULL, ss, 1);  // the row's other half
  const float norm = fmaxf(sqrtf(ss), NORM_EPS);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    uint4 packed;
    bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = half * HALF + i * 8 + j;
      e[j] = __float2bfloat16((s_vec[d] * scale) * (x[i * 8 + j] / norm));
    }
    out[i] = packed;
  }
}

// Block-wide load of rows [row0, row0 + 64) of one head: two threads per row,
// each holding D/2 values in fp32.  With `project`, writes bf16((s·scale) ⊙
// x/max(‖x‖, eps)) — the multiply order of _normed_scaled(x, s·scale);
// otherwise the raw row.  Rows past T are written as zeros.
template <int D, bool project>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int64_t stride_t,
                                          int row0, int T, const float* __restrict__ s_vec,
                                          float scale) {
  constexpr int HALF = D / 2;
  constexpr int VEC = HALF / 8;  // uint4 = 8 bf16
  constexpr int LDH = Smem<D>::LDH;
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int t = row0 + r;
  uint4 raw[VEC];
  if (t < T) {
    const uint4* g = reinterpret_cast<const uint4*>(src + (int64_t)t * stride_t + half * HALF);
#pragma unroll
    for (int i = 0; i < VEC; ++i) raw[i] = g[i];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) raw[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  uint4* out = reinterpret_cast<uint4*>(dst + r * LDH + half * HALF);
  if constexpr (!project) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = raw[i];
  } else {
    project_row<D>(out, raw, half, s_vec, scale);
  }
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
qknorm_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ sqk,
                       bf16* __restrict__ o, float* __restrict__ lse, int H, int T, float scale,
                       int mode, int64_t q_sb, int64_t q_sh, int64_t q_st, int64_t k_sb, int64_t k_sh,
                       int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t o_sb,
                       int64_t o_sh, int64_t o_st) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  __shared__ float red[NUM_WARPS];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int m0 = blockIdx.x * BLOCK_M;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* s_vec = sqk + h * D;  // sqk_eff[h]: no [B·H, D] broadcast needed

  // K5: the stabilizer is a per-head constant, from the RAW s (not s·scale)
  bool bounded = mode == MODE_BOUNDED;
  if (mode == MODE_AUTO) bounded = scale * block_max_sq(sqk, H * D, red) < BOUND_GATE;
  const float bound = bounded ? scale * block_max_sq(s_vec, D, red) : 0.f;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  load_rows<D, true>(sm.q, qb, q_st, m0, T, s_vec, scale);
  for (int i = threadIdx.x; i < BLOCK_M * S::LDO; i += NUM_THREADS) sm.o[i] = 0.f;

  // softmax state: lanes 2r and 2r+1 share row r of this warp's 16 rows
  const int r = lane >> 1;
  const int half = lane & 1;
  const int row = warp * 16 + r;
  float m_i = bounded ? bound : -INFINITY;
  float l_i = 0.f;

  for (int n0 = 0; n0 < T; n0 += BLOCK_N) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<D, true>(sm.k, kb, k_st, n0, T, s_vec, 1.0f);
    load_rows<D, false>(sm.v, vb, v_st, n0, T, nullptr, 1.0f);
    __syncthreads();

    // S[16 rows, 64 keys] = q̂ k̂ᵀ for this warp
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[D / 16];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wmma::load_matrix_sync(a[kk], sm.q + warp * 16 * S::LDH + kk * 16, S::LDH);
#pragma unroll
      for (int j = 0; j < BLOCK_N / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          // k̂ stored [key][d] row-major = k̂ᵀ [d][key] column-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
          wmma::load_matrix_sync(bfr, sm.k + j * 16 * S::LDH + kk * 16, S::LDH);
          wmma::mma_sync(acc, a[kk], bfr, acc);
        }
        wmma::store_matrix_sync(sm.s + warp * 16 * S::LDS + j * 16, acc, S::LDS,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();

    // online softmax over this tile; each lane takes half of its row
    if (bounded) {  // K5: exp(max(s − bound, −60)) against the constant bound, α = 1
      constexpr int HN = BLOCK_N / 2;
      const float* srow = sm.s + row * S::LDS + half * HN;
      bf16* prow = sm.p + row * S::LDP + half * HN;
      const int kv0 = n0 + half * HN;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < HN; ++c) {
        // columns past T: zero, as the TPU kernel re-zeroes them after the clamp
        const float pv = kv0 + c < T ? expf(fmaxf(srow[c] - bound, BOUNDED_EXP_FLOOR)) : 0.f;
        psum += pv;
        prow[c] = __float2bfloat16(pv);
      }
      l_i += psum + __shfl_xor_sync(FULL, psum, 1);
    } else {
      constexpr int HN = BLOCK_N / 2;
      const float* srow = sm.s + row * S::LDS + half * HN;
      bf16* prow = sm.p + row * S::LDP + half * HN;
      const int kv0 = n0 + half * HN;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < HN; ++c) mx = fmaxf(mx, kv0 + c < T ? srow[c] : -INFINITY);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      const float m_new = fmaxf(m_i, mx);  // finite: every tile holds ≥ 1 live key
      const float alpha = expf(m_i - m_new);  // 0 on the first tile
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < HN; ++c) {
        const float pv = kv0 + c < T ? expf(srow[c] - m_new) : 0.f;
        psum += pv;
        prow[c] = __float2bfloat16(pv);
      }
      psum += __shfl_xor_sync(FULL, psum, 1);
      l_i = l_i * alpha + psum;
      m_i = m_new;
      float* orow = sm.o + row * S::LDO + half * (D / 2);
#pragma unroll
      for (int d = 0; d < D / 2; ++d) orow[d] *= alpha;
    }
    __syncwarp();

    // O[16 rows, D] += bf16(P) · V
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sm.o + warp * 16 * S::LDO + j * 16, S::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pa, sm.p + warp * 16 * S::LDP + kk * 16, S::LDP);
        wmma::load_matrix_sync(vf, sm.v + kk * 16 * S::LDH + j * 16, S::LDH);
        wmma::mma_sync(acc, pa, vf, acc);
      }
      wmma::store_matrix_sync(sm.o + warp * 16 * S::LDO + j * 16, acc, S::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int t = m0 + row;
  if (t < T) {
    const float* orow = sm.o + row * S::LDO + half * (D / 2);
    bf16* og = o + b * o_sb + h * o_sh + (int64_t)t * o_st + half * (D / 2);
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {  // D/2 values as uint4 stores of 8
      uint4 packed;
      bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(orow[i * 8 + j] / l_i);
      reinterpret_cast<uint4*>(og)[i] = packed;
    }
    if (lse != nullptr && half == 0) lse[(int64_t)bh * T + t] = m_i + logf(l_i);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* sqk, void* o, void* lse,
                   int B, int H, int T, float scale, int mode, const int64_t* st,
                   cudaStream_t stream) {
  const size_t smem = sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(qknorm_attn_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BLOCK_M - 1) / BLOCK_M, B * H);
  qknorm_attn_fwd_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(sqk), static_cast<bf16*>(o), static_cast<float*>(lse), H, T, scale,
      mode, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 [B, H, T, D] addressed through (batch, head, token) element
// strides, last dim contiguous; sqk: fp32 [H, D]; o: bf16, same addressing;
// lse: fp32 [B·H, T] or null; mode: 0 rowmax (K1), 1 bounded, 2 auto (K5).
// strides = {q_sb, q_sh, q_st, k_.., v_.., o_..}.
extern "C" cudaError_t nvit_qknorm_attn_fwd(const void* q, const void* k, const void* v,
                                            const void* sqk, void* o, void* lse, int B, int H,
                                            int T, int D, float scale, int mode,
                                            const int64_t* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode < MODE_ROWMAX || mode > MODE_AUTO) return cudaErrorInvalidValue;
  if (D == 64) return launch<64>(q, k, v, sqk, o, lse, B, H, T, scale, mode, strides, s);
  if (D == 32) return launch<32>(q, k, v, sqk, o, lse, B, H, T, scale, mode, strides, s);
  return cudaErrorInvalidValue;
}
