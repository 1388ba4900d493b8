// The gated-MLP GEMM — Hopper (sm_90a), on hopper.cuh — shared by K3/K6's
// forward (gated_mlp_fwd.cu) and K4/K6's backward (gated_mlp_bwd.cu).  Per
// output tile, 128 rows of x [n, K] against 128 output columns j0 .. j0 + 127:
//
//   [u | v] = x [Wu | Wv]ᵀ     fp32 accumulate; Wu = W rows j0 ..,  Wv = W rows H + j0 ..
//
// with W [2H, K] in torch's [out, in] layout.  Each kernel brings its own
// epilogue (the bias, the gate or its derivatives) as a functor.
//
// What bounds it on the H100: at the flagship c_fc shape (n = 32·784,
// K = 768, H = 3072) the product is 4·n·K·H = 237 GFLOP over ~0.2 GB
// (forward) or ~0.5 GB (backward) of device memory — 460–1,170 flops per
// byte, above the bf16 ridge: tensor-core throughput bounds it, and only
// wgmma reaches it.  The design:
//
// * Two consumer warpgroups and one producer warpgroup (384 threads; the
//   producer gives up registers with setmaxnreg, the consumers take them).
//   The shared-memory B tile is 256 K-major rows: Wu rows j0 .. j0 + 127,
//   then Wv rows H + j0 .. H + j0 + 127.  Consumer warpgroup g multiplies x
//   rows 64·g .. 64·g + 63 of the tile against all 256 with one m64n256k16
//   wgmma per k-step, both operands from shared memory, into 128 fp32
//   registers a thread.  In the accumulator layout (hopper.cuh) u column c
//   sits in register 4·j + 2·i + (c % 2) with j = c / 8, and v column c in
//   the same thread, 64 registers on: u and v of an element meet with no
//   exchange.
// * K steps of 64 values: one 128-byte swizzled row per tile row, 16 KB of
//   x and 2 × 16 KB of W a stage, in a ring of STAGES stages.  One thread of
//   the producer fills it with TMA (three boxes a stage; the tensor maps
//   come from cuTensorMapEncodeTiled, reached through the runtime's driver
//   entry point, so the build links no libcuda).  Each stage has a "full"
//   mbarrier (the TMA's bytes) and an "empty" one (one arrival per consumer
//   warpgroup once the wgmma that read it is done), so the producer runs up
//   to STAGES k-tiles ahead, across tile boundaries, and the consumers keep
//   one wgmma group in flight while they wait for the next stage.
// * Persistent: one block per SM walks tiles blockIdx.x, + gridDim.x, ...,
//   columns fastest, so the ~5 row tiles in flight at c_fc are read from
//   device memory once and W (9.4 MB) stays in the 50 MB L2.  The epilogue
//   stages its bf16 result in shared memory and hands it to a TMA store,
//   which drains while the next tile's products run; the next tile's first
//   stages are already loaded when the epilogue ends.
// * The epilogue is the tensor cores' idle time (the two consumer warpgroups
//   share one tile), so its gate takes σ from a fast exp and reciprocal
//   (`sigmoid`): with IEEE expf and a divide K3 took 1.33× as long
//   at c_fc (PERF.md §6).
//
// Edges (the wrapper's contract: K % 16 == 0, H % 64 == 0, any n ≥ 1): TMA
// zero-fills x rows past n and columns past K; W is mapped as [2][H][K], so
// the rows past H of a Wu box read zeros, not Wv.  The stores are clipped at
// n and, through [n][H] or [n][2][H] maps, at H within each half.
//
// Determinism: no split-K and no atomics; each output is one fp32 K-sum in
// a fixed order, so two calls give the same bytes.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: declarations only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace gated_gemm {

using namespace hopper;

constexpr int BM = 2 * TILE_ROWS;  // rows of x per tile: one 64-row wgmma tile per consumer warpgroup
constexpr int BN = 128;            // output columns per tile: of u, and the same of v
constexpr int BK = 64;             // K step: one 128-byte swizzled row per tile row
constexpr int NUM_THREADS = 3 * WG_THREADS;  // producer warpgroup, then two consumer warpgroups
constexpr int CONSUMERS = 2 * WG_THREADS;
constexpr int ACC = BN;                      // fp32 accumulators a thread: 64 × 2·BN over 128 threads
constexpr int BOX = BM * 64 * 2;             // a 128-row × 64-column bf16 TMA box: 16 KB
constexpr int STAGE = 3 * BOX;               // x, Wu, Wv
constexpr int OUT_TILE = 2 * BOX;            // a 128 × 128 bf16 tile as two boxes of 64 columns
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int EPILOGUE_BAR = 1;              // the consumers' named barrier

// byte offset of columns c, c + 1 (c even) of row r in a staged tile of two
// 64-column boxes, each in TMA's 128-byte swizzle (16-byte chunk index XOR
// r % 8): the eight rows a warp's accumulator pairs cover land in eight
// different bank groups
__device__ __forceinline__ uint32_t out_offset(int r, int c) {
  return (c >> 6) * BOX + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// the block's dynamic shared memory: the ring, `extra` bytes of epilogue
// buffers, then the barriers — full[s], empty[s], and two for the epilogue
template <int STAGES>
struct Smem {
  uint32_t ring, extra, full, empty, epi_full, epi_empty;
  static constexpr int bytes(int extra_bytes) { return STAGES * STAGE + extra_bytes + (2 * STAGES + 2) * 8 + 1024; }
  __device__ __forceinline__ Smem(unsigned char* raw, int extra_bytes) {
    ring = (smem_u32(raw) + 1023) & ~1023u;
    extra = ring + STAGES * STAGE;
    full = extra + extra_bytes;
    empty = full + STAGES * 8;
    epi_full = empty + STAGES * 8;
    epi_empty = epi_full + 8;
  }
};

// The tiles a block walks: t = blockIdx.x, + gridDim.x, ..., with rows
// m0 = (t / col tiles)·BM and columns j0 = (t % col tiles)·BN
struct Walk {
  int col_tiles, tiles, nk;
  __device__ __forceinline__ Walk(int n, int K, int H)
      : col_tiles((H + BN - 1) / BN), tiles(col_tiles * ((n + BM - 1) / BM)), nk((K + BK - 1) / BK) {}
  __device__ __forceinline__ int m0(int t) const { return (t / col_tiles) * BM; }
  __device__ __forceinline__ int j0(int t) const { return (t % col_tiles) * BN; }
};

// What a consumer thread holds: rows r_i = 64·wg + 16·warp + lane/4 + 8·i of
// the tile, columns 8·j + q2 + c (j < 16) — u in acc[4·j + 2·i + c], v in
// acc[64 + 4·j + 2·i + c]; `lead` marks thread 0 of the consumers
struct Thread {
  int r0, q2, wg;
  bool lead;
};

// The consumer warpgroups' walk (see run): each tile's products into acc,
// then its epilogue
template <int STAGES, bool LOAD_EPI, typename Epilogue>
__device__ __forceinline__ void consume(const Walk& walk, const Smem<STAGES>& sm, Epilogue epilogue) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int ct = threadIdx.x - WG_THREADS;
  const int lane = ct & 31;
  const Thread th{(ct >> 7) * TILE_ROWS + ((ct >> 5) & 3) * 16 + (lane >> 2), 2 * (lane & 3), ct >> 7, ct == 0};
  const bool arrives = (ct & (WG_THREADS - 1)) == 0;  // one thread per warpgroup
  const uint32_t a_off = th.wg * TILE_ROWS * 128;     // this warpgroup's x rows
  float acc[ACC];
  int it = 0;
  int local = 0;
  for (int t = blockIdx.x; t < walk.tiles; t += gridDim.x, ++local) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < walk.nk; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(sm.full + 8 * s, (it / STAGES) & 1);
      const uint32_t st = sm.ring + s * STAGE;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss(acc, smem_desc<128>(st + a_off + kk * 32), smem_desc<128>(st + BOX + kk * 32), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-tile's product is done: its stage is free
      fence_operands(acc);
      if (kt > 0 && arrives) mbar_arrive(sm.empty + 8 * ((it - 1) % STAGES));
      if constexpr (LOAD_EPI) {
        // the last tile's epilogue buffers, once its stores have read them
        // (at the second k-step: the first one's wgmma is in flight meanwhile)
        if (kt == (walk.nk > 1) && local > 0 && th.lead) {
          tma_store_wait_read();
          mbar_arrive(sm.epi_empty);
        }
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (arrives) mbar_arrive(sm.empty + 8 * ((it - 1) % STAGES));
    epilogue(acc, th, walk.m0(t), walk.j0(t), local);
  }
  if (th.lead) tma_store_wait();
}

// The whole kernel body.  The epilogue functor, run by the 256 consumer
// threads, gets (acc, Thread, m0, j0, local), `local` the block's count of
// tiles before this one; it stages its result in the `extra` buffers and
// stores it by TMA (wait_staging / staged).  With LOAD_EPI the producer
// also loads one tile-sized operand per tile into `extra` (the backward's
// g): `load_epi(m0, j0, dst, bar)` issues it once the consumers have
// arrived on epi_empty — at the next tile's second k-step, when the lead
// thread's stores have read the buffers.
template <int STAGES, bool LOAD_EPI, typename LoadEpi, typename Epilogue>
__device__ __forceinline__ void run(const CUtensorMap* tm_x, const CUtensorMap* tm_w, int n, int K, int H,
                                    const Smem<STAGES>& sm, LoadEpi load_epi, Epilogue epilogue) {
  const Walk walk(n, K, H);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    mbar_init(sm.epi_full, 1);
    mbar_init(sm.epi_empty, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // one if / else whose arms never meet again, so ptxas honours setmaxnreg
  if (threadIdx.x < WG_THREADS) {  // ---------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    int it = 0;
    int local = 0;
    for (int t = blockIdx.x; t < walk.tiles; t += gridDim.x, ++local) {
      const int m0 = walk.m0(t), j0 = walk.j0(t);
      for (int kt = 0; kt < walk.nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(sm.empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        const uint32_t full = sm.full + 8 * s, dst = sm.ring + s * STAGE;
        mbar_arrive_expect_tx(full, STAGE);
        tma_load_2d(dst, tm_x, kt * BK, m0, full);
        tma_load_3d(dst + BOX, tm_w, kt * BK, j0, 0, full);
        tma_load_3d(dst + 2 * BOX, tm_w, kt * BK, j0, 1, full);
      }
      if constexpr (LOAD_EPI) {
        mbar_wait(sm.epi_empty, (local & 1) ^ 1);
        load_epi(m0, j0, sm.extra, sm.epi_full);
      }
    }
  } else {  // ---------------------------------------------------- consumers
    consume<STAGES, LOAD_EPI>(walk, sm, epilogue);
  }
}

// Stage-to-store handshake of an epilogue that writes a staged tile: before
// writing, the last tile's store must have read the buffer; after writing,
// the consumers' generic writes are made visible to the TMA store
__device__ __forceinline__ void wait_staging(const Thread& th) {
  if (th.lead) tma_store_wait_read();
  named_bar_sync(EPILOGUE_BAR, CONSUMERS);
}
__device__ __forceinline__ void staged() {
  fence_proxy_async();
  named_bar_sync(EPILOGUE_BAR, CONSUMERS);
}

// σ(v) in fp32 from ex2.approx and an approximate reciprocal: within a few
// fp32 ulps of 1 / (1 + e^−v), far below the outputs' bf16 rounding, and far
// cheaper than IEEE expf and a divide — the epilogue's math runs while the
// tensor cores idle, 64 elements a thread
__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }

// this thread's bias values (fp32) of u and v at columns col, col + 1, or
// zeros without a bias or past H
__device__ __forceinline__ void bias_pair(float2& bu, float2& bv, const bf16* __restrict__ bias, int col,
                                          int H) {
  bu = bv = make_float2(0.f, 0.f);
  if (bias != nullptr && col < H) {
    bu = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
    bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + H + col));
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A row-major bf16 tensor of `rank` dims (innermost first, `dims`; byte
// strides of the outer ones, `strides`) → a tensor map of `box` boxes whose
// rows (the innermost dim, 64 values) are 128-byte swizzled; out-of-bounds
// elements read as zeros and are not written
inline bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 64 columns × 128 rows of a row-major [rows, cols] bf16 matrix (x, out, g)
inline bool encode_rows(CUtensorMap* map, const void* base, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, BM};
  return encode(map, base, 2, dims, strides, box);
}

// the maps of x [n, K] (64 K × 128 rows) and of W [2H, K] as [2][H][K]
// (64 K × 128 rows of one half)
inline bool encode_operands(CUtensorMap* tm_x, CUtensorMap* tm_w, const void* x, const void* w, int n, int K,
                            int H) {
  const cuuint64_t wd[3] = {(cuuint64_t)K, (cuuint64_t)H, 2}, ws[2] = {(cuuint64_t)K * 2, (cuuint64_t)H * K * 2};
  const cuuint32_t wbox[3] = {64, BN, 1};
  return encode_rows(tm_x, x, n, K) && encode(tm_w, w, 3, wd, ws, wbox);
}

// Raise `kernel`'s dynamic shared-memory limit to `smem` bytes — per device,
// so on every call.  Call it before encoding tensor maps: as a runtime call
// it makes the device's context current on this thread (autograd's backward
// runs on a thread of its own), which cuTensorMapEncodeTiled needs.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Launch `kernel` persistently: one block per SM, at most one per tile
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int smem, int n, int H, cudaStream_t stream, Args... args) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((H + BN - 1) / BN) * ((n + BM - 1) / BM);
  kernel<<<(int)(tiles < sms ? tiles : sms), NUM_THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace gated_gemm
