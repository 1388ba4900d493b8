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
// What bounds it on the H100: at the flagship shape (T = 784, D = 64) the
// two matmuls are 4·T²·D flops per (b, h) against 4·T·D·2 bytes of q/k/v/o —
// ~400 flops per byte, above the bf16 ridge (~295), so tensor-core throughput
// and the softmax's exp/max work bound it, not memory.
//
// Design: the TPU kernel holds a whole [BLOCK_Q, T] fp32 score tile in VMEM
// (up to 2.4 MB at T = 784); a block here has 227 KB of shared memory.  So
// one block takes a 64-row query tile of one (b, h) and loops over 64-key K/V
// tiles with an ONLINE softmax (running max m and sum l per row, O rescaled
// by exp(m_old − m_new)).  Four warps each own 16 query rows: scores, softmax
// and the P·V update are warp-local; only the K/V tile loads are block-wide.
// Matmuls use the tensor cores through nvcuda::wmma (bf16 16×16×16, fp32
// accumulate); O accumulates in fp32 shared memory.  This is K1's
// (qknorm_attn_fwd.cu) tile loop without the QK-norm prologue; wgmma/TMA
// pipelining is later work.  Ragged T (784 = 12·64 + 16): the TPU kernel pads
// T and masks padded key columns; here key columns past T are masked to −inf
// and their V rows zero-filled, and query rows past T are computed on zeros
// and not stored — nothing is padded in device memory.
//
// Numerics vs the TPU kernel: the same bf16 operand fold and fp32 scores;
// the online rescale rounds P to bf16 relative to the RUNNING max instead of
// the true row max, a difference of at most one bf16 rounding of P.

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
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Smem {
  // pitches padded off a multiple of 128 bytes against bank conflicts; each
  // stays a multiple of 16 bytes (vector stores) and of wmma's ldm unit
  static constexpr int LDH = D + 8;        // bf16 q_s / k / v rows
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

// Block-wide load of rows [row0, row0 + 64) of one head: two threads per row,
// each holding D/2 values.  With `scaled`, writes bf16(x · scale) (scale
// already bf16-exact); otherwise the raw row.  Rows past T are zeros.
template <int D, bool scaled>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int64_t stride_t,
                                          int row0, int T, float scale) {
  constexpr int HALF = D / 2;
  constexpr int VEC = HALF / 8;  // uint4 = 8 bf16
  constexpr int LDH = Smem<D>::LDH;
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int t = row0 + r;
  const uint4* g = reinterpret_cast<const uint4*>(src + (int64_t)t * stride_t + half * HALF);
  uint4* out = reinterpret_cast<uint4*>(dst + r * LDH + half * HALF);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    uint4 raw = t < T ? g[i] : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (scaled) {
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    }
    out[i] = raw;
  }
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                      int H, int T, float scale, int64_t q_sb, int64_t q_sh, int64_t q_st,
                      int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh,
                      int64_t v_st, int64_t o_sb, int64_t o_sh, int64_t o_st) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int m0 = blockIdx.x * BLOCK_M;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  load_rows<D, true>(sm.q, q + b * q_sb + h * q_sh, q_st, m0, T, scale);
  for (int i = threadIdx.x; i < BLOCK_M * S::LDO; i += NUM_THREADS) sm.o[i] = 0.f;

  // softmax state: lanes 2r and 2r+1 share row r of this warp's 16 rows
  const int r = lane >> 1;
  const int half = lane & 1;
  const int row = warp * 16 + r;
  float m_i = -INFINITY;
  float l_i = 0.f;

  for (int n0 = 0; n0 < T; n0 += BLOCK_N) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<D, false>(sm.k, kb, k_st, n0, T, 1.0f);
    load_rows<D, false>(sm.v, vb, v_st, n0, T, 1.0f);
    __syncthreads();

    // S[16 rows, 64 keys] = q_s kᵀ for this warp
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
          // k stored [key][d] row-major = kᵀ [d][key] column-major
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
    {
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                   int T, float scale, const int64_t* st, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(flash_attn_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_attn_fwd_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, T, scale, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
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
  if (D == 64) return launch<64>(q, k, v, o, lse, B, H, T, scale, strides, s);
  if (D == 32) return launch<32>(q, k, v, o, lse, B, H, T, scale, strides, s);
  return cudaErrorInvalidValue;
}
