// Hopper (sm_90a) building blocks of the port's hand-written kernels:
// cp.async copies into 128-/64-byte swizzled shared-memory tiles, mbarriers
// and TMA (tensor-map) copies, the wgmma shared-memory descriptor, and the
// warpgroup matrix multiplies on them.
// The PTX is written by hand (no CUTLASS/CuTe), so a kernel source that
// includes this header still builds in seconds.
//
// Tiles.  A tile is 64 rows of D bf16 values (D = 64: 128-byte rows, D = 32:
// 64-byte rows) at a 1024-byte aligned shared-memory address.  The 16-byte
// chunk j of row r sits at byte r·ROW + 16·j, XORed in bits [4, 7) with bits
// [7, 10) of that offset (128-byte swizzle, ROW = 128) or in bits [4, 6)
// with bits [7, 9) (64-byte swizzle, ROW = 64) — the layout wgmma reads, so
// the same tile serves as a K-major operand (rows are M or N, the D values
// along K) or as an MN-major one (rows are K, the D values along N), and
// rows read by the eight threads of a quad never share a bank.  TMA's
// 128-byte swizzle writes the same layout; the gated GEMM (gated_gemm.cuh)
// stacks such tiles: 128 rows of x, 256 of W, the swizzle continuing down
// the rows.
//
// Accumulators.  A warpgroup (four warps, 128 threads) holds a 64 × N fp32
// tile in N/2 registers a thread: warp w, lane l holds rows
// r0 = 16·w + l/4 and r1 = r0 + 8, columns 8·j + 2·(l % 4) + c, in
// register 4·j + 2·i + c for row r_i (j < N/8, i, c < 2).  Four bf16 pairs
// of columns 16·kk .. 16·kk + 15 of that layout are exactly wgmma's A
// operand from registers for the k-step kk (`pack_a`), so a softmax computed
// on the accumulator feeds the next product without touching shared memory.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int TILE_ROWS = 64;    // wgmma's M, and every tile's row count

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- cp.async
// 16 bytes global → shared; `valid` false writes 16 zero bytes (src unread)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's generic-proxy shared-memory writes (cp.async included) made
// visible to the async proxy that wgmma reads through; then a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA); then a barrier
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival that also expects `bytes` of TMA transactions on the barrier
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// waits until the barrier's phase of parity `parity` has completed.  A wait
// that lasts ~20 s of SM clock (a pipeline fault, never a slow copy) traps,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 35)) {
      __trap();
    }
  }
}

// ------------------------------------------------------------------- TMA
// a 2-D / 3-D box of the tensor map at `map` (a __grid_constant__ kernel
// parameter), coordinates innermost first → shared address dst, completing
// its bytes on the barrier `bar`; elements out of bounds are zero-filled
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(dst), "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// shared address src → a 2-D / 3-D box of the tensor map; elements out of
// bounds are not written.  Completes as a bulk group (tma_store_commit)
__device__ __forceinline__ void tma_store_2d(const void* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(map), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store_3d(const void* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
               ::"l"(map), "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}
__device__ __forceinline__ void tma_store_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// this thread's committed stores have finished reading shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and have completed
__device__ __forceinline__ void tma_store_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// a barrier among the `count` threads of named barrier `id` (1..15; 0 is __syncthreads')
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// byte offset of 16-byte chunk j of row r in a swizzled tile of ROW-byte rows
template <int ROW>
__device__ __forceinline__ uint32_t swizzle(int r, int j) {
  static_assert(ROW == 128 || ROW == 64, "128- or 64-byte rows");
  const uint32_t o = r * ROW + j * 16;
  return o ^ (((o >> 7) & (ROW == 128 ? 7u : 3u)) << 4);
}

// Rows [row0, row0 + 64) of a [T, D] bf16 matrix whose rows are `stride`
// elements apart (head dim contiguous, 16-byte aligned) → the swizzled tile
// at shared address dst; rows past T are zero-filled.  Issued by the whole
// warpgroup, one 16-byte chunk per thread per step, neighbouring threads on
// neighbouring chunks of a row.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                          int64_t stride, int row0, int T) {
  constexpr int CPR = D / 8;  // chunks per row
#pragma unroll
  for (int i = 0; i < TILE_ROWS * CPR / WG_THREADS; ++i) {
    const int c = threadIdx.x + i * WG_THREADS;
    const int r = c / CPR, j = c % CPR;
    const bool ok = row0 + r < T;
    cp_async16(dst + swizzle<2 * D>(r, j), src + (ok ? (int64_t)(row0 + r) * stride + j * 8 : 0), ok);
  }
}

// ------------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor of a swizzled tile of ROW-byte rows: start
// address, leading byte offset (unused by these layouts: 1), stride byte
// offset = 8 rows, layout 1 (128-byte swizzle) or 2 (64-byte).  A K-major
// k-step of 16 values advances the start by 32 bytes inside the swizzled
// row; an MN-major one by 16 rows.
template <int ROW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t layout = ROW == 128 ? 1 : 2;
  constexpr uint64_t sbo = (8 * ROW) >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (sbo << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses to an accumulator across an
// in-flight wgmma: call before the fence and after the wait
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// k-step kk of a 64 × 64 fp32 accumulator (keys or queries along N) as
// wgmma's bf16 A operand: columns 16·kk .. 16·kk + 15, rounded once
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&s)[32], int kk) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);  // row r0, columns 2·(l%4) + {0, 1}
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);  // row r1
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);  // row r0, columns + 8
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);  // row r1, columns + 8
}

// D[64×64] (+)= A[64×16] B[16×64], A and B from shared memory, both K-major;
// `accumulate` 0 overwrites D
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64×64] (+)= A[64×16] B[16×64], A and B from shared memory, B MN-major
// (stored [k][n], n contiguous: its transpose flag set); A K-major (A_MN = 0,
// stored [m][k]) or MN-major (A_MN = 1, stored [k][m]).  `accumulate` 0
// overwrites D
template <int A_MN>
__device__ __forceinline__ void wgmma_ss_bmn(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(A_MN));
}

// D[64×32] (+)= A[64×16] B[16×32], as above
template <int A_MN>
__device__ __forceinline__ void wgmma_ss_bmn(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(A_MN));
}

// The A operands of a 64 × 64 accumulator tile (pack_a's, k-steps 0..3) →
// a bf16 [64][64] tile, 128-byte swizzled, at shared address `tile`: each
// pair where it sits (rows r0, r0 + 8; columns 16·kk + 2·(l % 4) and + 8),
// so the four threads of a quad write one 16-byte chunk of a row.  The tile
// serves K-major (rows are M) or MN-major (rows are K).
__device__ __forceinline__ void store_a_tile(uint32_t tile, const uint32_t (&a)[4][4]) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const uint32_t cb = 4 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) st_shared_u32(tile + swizzle<128>(r0 + 8 * i, 2 * kk + h) + cb, a[kk][2 * h + i]);
}

// D[64×256] (+)= A[64×16] B[16×256], A and B from shared memory, both
// K-major; 128 fp32 accumulators a thread.  `accumulate` 0 overwrites D
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64×64] += A[64×16] B[16×64], A from registers (bf16 pairs, the
// accumulator's layout), B from shared memory MN-major: stored [k][n] with n
// contiguous, so the transpose flag is set
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64×32] += A[64×16] B[16×32], A from registers (bf16 pairs, the
// accumulator's layout), B from shared memory MN-major: stored [k][n] with n
// contiguous, so the transpose flag is set
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

}  // namespace hopper
