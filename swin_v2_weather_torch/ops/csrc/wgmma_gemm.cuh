// The Hopper GEMM core of the port: C[M, N] = A[M, K] @ B[K, N] with bf16
// operands and fp32 accumulation, written for sm_90a with TMA and wgmma. It
// carries fc1 + GELU and its backward (K3/K4, fc1_gelu.cu), the whole-MLP
// forward (K5, mlp.cu) and, as a pair of products on one output tile
// (gemm_pair_kernel), the whole-MLP backward's recompute (K6, mlp.cu); the qkv projection of the qkv-fused attention, forward and
// backward, and the backward's dx and dW (K1/K2/K7/K10/K12 and the
// large-head variant, qkv_projection.cuh); and the core's own entry point
// (gemm_core.cu). Each caller adds only its epilogue.
//
// What bounds a GEMM on this card: at the shapes of the port (T = 64800 token
// rows against K and N of 768-4096) every product is far above the card's
// ridge (about 295 operations a byte in bf16), so the tensor cores bound it:
// 989 TFLOP/s dense bf16, which only wgmma reaches (an earlier nvcuda::wmma
// tile GEMM on a two-stage cp.async ring, since removed, ran the K2
// projection backward at 18 % of that).
//
// The design:
//  * one block owns a 128 x BN output tile (BN = 128 or 256; 192 for the
//    qkv projection at head dim 96, whose tiles hold whole heads) and runs
//    three warpgroups. Warpgroup 0 is the producer: one thread keeps a ring
//    of STAGES (6 at BN = 128, else 4) 64-deep K slices in flight with TMA
//    (cp.async.bulk.tensor, 128-byte swizzle), each stage guarded by a "full"
//    mbarrier (the TMA's transaction count) and an "empty" one (the consumer
//    warps' releases). Warpgroups 1 and 2 are the consumers: each owns 64
//    rows of the tile and issues wgmma.mma_async m64nBNk16 straight from the
//    swizzled shared-memory tiles, four a slice, keeping one slice's group in
//    flight while it waits for the previous one (wait_group 1), then releases
//    that slice's stage. setmaxnreg moves registers from the producer (40) to
//    the consumers (232): a consumer holds BN / 2 fp32 accumulators.
//  * either operand may be K-major or MN-major (wgmma's transpose bits), so
//    dx = dqkv @ W^T reads W [C_in, 3C] as it is stored, and dW = x^T @ dqkv
//    reads x [T, C_in] as it is stored: no transposed copy. A K-major tile is
//    one TMA box of 64 K x rows; an MN-major tile is boxes of 64 MN columns x
//    64 K rows, 8 KB each, placed one after another.
//  * ragged edges: TMA fills rows and columns past the tensor with zeros, and
//    the epilogue is called only for rows < M and columns < N.
//  * split-K: grid z picks the K range [z k_chunk, (z + 1) k_chunk) (k_chunk a
//    multiple of 64); a caller that splits writes fixed fp32 partials per
//    split and sums them in split order afterwards (no atomics), so two calls
//    give the same bits.
//  * the epilogue functor takes the fp32 accumulators where wgmma leaves them:
//    epi(row, col, v0, v1) for columns col and col + 1 of one row (col even),
//    or, where it declares kTile, the thread's whole tile at once; where it
//    declares kPrefetch, each pair with a word it read before the mainloop.
//
// Contract (checked by launch and by ops/gemm_core.py): M, N, K >= 1; the
// contiguous dimension of each operand (A: K, or M if MN-major; B: N, or K if
// K-major) and both leading dimensions multiples of 8 elements; 16-byte
// aligned bases; N even; at most 65535 row tiles and splits.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)

#include <cstdint>
#include <type_traits>

#include "cuda_common.cuh"

namespace swin_wg {

using swin_cuda::bf16;
using swin_cuda::smem_u32;

constexpr int BM = 128;       // rows of a block tile: two consumer warpgroups of 64
constexpr int BK = 64;        // K depth of a ring stage: 128 bytes of bf16, the swizzle span
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int BOX = 8192;     // bytes of one 64 x 64 bf16 box (an MN-major tile column)

template <int BN>
struct Shape {
  static constexpr int STAGES = BN == 128 ? 6 : 4;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the ring, its 2 x STAGES barriers and the slack that aligns the ring to
  // the 1024 bytes the 128-byte swizzle repeats over
  static constexpr int SMEM = STAGES * STAGE_BYTES + 16 * STAGES + 1024;
};

// ---------------------------------------------------------------------------
// device primitives: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D TMA box into shared memory at dst; (c0, c1) = (inner, outer)
// element coordinates of its first element; completion counts on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (K-major: rows of 128 bytes, 8-row groups
// 1024 bytes apart; MN-major: 8-row K groups 1024 apart, 64-wide MN boxes
// BOX apart), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulators at this point of the instruction stream, so that no
// read or write of them moves across a wgmma fence or wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B for one k16 step of a 64-row warpgroup tile: m64nNk16, bf16 in,
// fp32 accumulators; TA / TB are the transpose (MN-major) bits of A and B.
template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<192> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<256> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// An epilogue that declares kTile takes the thread's whole accumulator tile
// at once, epi.tile(acc, row, col, M, N) with (row, col) as the pair form's
// first call gets them, and may reduce across the quad's lanes (the qkv
// projection's head normalization, qkv_projection.cuh); the others take
// pairs, epi(row, col, v0, v1).
template <class E, class = void>
struct TileEpilogue : std::false_type {};
template <class E>
struct TileEpilogue<E, std::void_t<decltype(E::kTile)>> : std::true_type {};

// An epilogue that declares kPrefetch reads one 32-bit word for each pair of
// accumulators, epi.fetch(row, col), before the mainloop (K4's cotangent g,
// fc1_gelu.cu: the loads are in flight while the tile's products run), keeps
// the words in registers as the pair kernel keeps its own, and takes each
// back with its pair: epi(row, col, v0, v1, word).
template <class E, class = void>
struct PrefetchEpilogue : std::false_type {};
template <class E>
struct PrefetchEpilogue<E, std::void_t<decltype(E::kPrefetch)>> : std::true_type {};

// The consumer warpgroup c's share of ring slices [k_from, k_to) (TA / TB:
// A / B MN-major): wait for a slice's TMA bytes, issue its four k16 wgmmas
// from the swizzled tiles, keep one slice's group in flight while waiting
// for the previous one (wait_group 1), then release that slice's stage; at
// the end wait for the last group and release its stage too (the pair
// kernel's ring runs on into its second product). A k16 step is 32 bytes
// along a K-major row, 16 rows (2048 bytes) down an MN-major box; this
// warpgroup's 64 rows of A start BOX bytes in for c = 1 either way. ptxas
// overlaps the groups of this loop (no C7515 "wgmma serialized" report,
// which the same loop written inline in gemm_kernel drew).
template <int BN, bool TA, bool TB>
__device__ __forceinline__ void consume_slices(float (&acc)[BN / 2], uint32_t ring, uint32_t full0,
                                               uint32_t empty0, int c, int k_from, int k_to) {
  using S = Shape<BN>;
  const bool leader = (threadIdx.x & 31) == 0;
  for (int kt = k_from; kt < k_to; ++kt) {
    const int s = kt % S::STAGES;
    mbar_wait(full0 + 8 * s, (kt / S::STAGES) & 1);
    const uint32_t a = ring + s * S::STAGE_BYTES + c * BOX;
    const uint32_t b = ring + s * S::STAGE_BYTES + S::A_BYTES;
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = TA ? smem_desc(a + kk * 2048, BOX, 1024) : smem_desc(a + kk * 32, 16, 1024);
      const uint64_t db = TB ? smem_desc(b + kk * 2048, BOX, 1024) : smem_desc(b + kk * 32, 16, 1024);
      Wgmma<BN>::template mma<TA ? 1 : 0, TB ? 1 : 0>(acc, da, db);
    }
    wg_commit();
    wg_wait<1>();
    fence_acc(acc);
    if (kt > k_from && leader) mbar_arrive(empty0 + 8 * ((kt - 1) % S::STAGES));
  }
  wg_wait<0>();
  fence_acc(acc);
  if (k_to > k_from && leader) mbar_arrive(empty0 + 8 * ((k_to - 1) % S::STAGES));
}

// Block (x, y, z) computes output columns [BN x, + BN) of rows [BM y, + BM)
// over K range [z k_chunk, + k_chunk) and hands them to epi.
template <int BN, bool A_MN, bool B_MN, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                int M, int N, int K, int k_chunk, Epi epi) {
  using S = Shape<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = ring + S::STAGES * S::STAGE_BYTES;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * S::STAGES;             // empty[s] at empty0 + 8 s
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);    // the producer's expect_tx, then the TMA bytes
      mbar_init(empty0 + 8 * s, 8);   // one release from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S::STAGES;
        if (kt >= S::STAGES) mbar_wait(empty0 + 8 * s, ((kt / S::STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, S::STAGE_BYTES);
        const uint32_t a = ring + s * S::STAGE_BYTES;
        const uint32_t b = a + S::A_BYTES;
        const int k0 = k_begin + kt * BK;
        if constexpr (A_MN) {  // A^T stored [K, M]: two 64-column boxes
          tma_load(a, &ta, full, m0, k0);
          tma_load(a + BOX, &ta, full, m0 + 64, k0);
        } else {  // A stored [M, K]: one box of 128 rows
          tma_load(a, &ta, full, k0, m0);
        }
        if constexpr (B_MN) {  // B stored [K, N]: BN / 64 boxes
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) tma_load(b + j * BOX, &tb, full, n0 + 64 * j, k0);
        } else {  // B^T stored [N, K]: one box of BN rows
          tma_load(b, &tb, full, k0, n0);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    if constexpr (PrefetchEpilogue<Epi>::value) {
      // the accumulator layout as in the other branch; the words as the pair
      // kernel's keep[]
      const int lane = tid & 31;
      const int r0 = m0 + c * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
      const int c0 = n0 + 2 * (lane & 3);
      uint32_t word[BN / 4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = c0 + 8 * j;
        word[2 * j] = col < N && r0 < M ? epi.fetch(r0, col) : 0u;
        word[2 * j + 1] = col < N && r0 + 8 < M ? epi.fetch(r0 + 8, col) : 0u;
      }
      consume_slices<BN, A_MN, B_MN>(acc, ring, full0, empty0, c, 0, nk);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = c0 + 8 * j;
        if (col < N) {
          if (r0 < M) epi(r0, col, acc[4 * j], acc[4 * j + 1], word[2 * j]);
          if (r0 + 8 < M) epi(r0 + 8, col, acc[4 * j + 2], acc[4 * j + 3], word[2 * j + 1]);
        }
      }
    } else {
      consume_slices<BN, A_MN, B_MN>(acc, ring, full0, empty0, c, 0, nk);
      // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
      // 16 w .. 16 w + 15; register 4 j + {0, 1} is row lane / 4, columns
      // 8 j + 2 (lane % 4) + {0, 1}; 4 j + {2, 3} the same columns 8 rows down
      const int lane = tid & 31;
      const int r0 = m0 + c * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
      const int c0 = n0 + 2 * (lane & 3);
      if constexpr (TileEpilogue<Epi>::value) {
        epi.tile(acc, r0, c0, M, N);
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = c0 + 8 * j;
          if (col < N) {
            if (r0 < M) epi(r0, col, acc[4 * j], acc[4 * j + 1]);
            if (r0 + 8 < M) epi(r0 + 8, col, acc[4 * j + 2], acc[4 * j + 3]);
          }
        }
      }
    }
  }
}

// Two products on one output tile (K6, mlp.cu): C1 = A1 @ B1 over K1, whose
// epilogue keeps one 32-bit word for each pair of accumulators (epi1(row,
// col, v0, v1) returns it: K6's packed bf16 pre-activation) in the consumer
// warpgroups' registers, then C2 = A2 @ B2 over K2 into the same
// accumulators, whose epilogue takes the words back (epi2(row, col, v0, v1,
// word)); the accumulator layout is the same for both, so each lane pairs
// its own entries. A1 and A2 are K-major; B1 / B2 MN-major where B1_MN /
// B2_MN. The ring and its barriers run on across the two products: the
// producer loads the K1 / BK slices of the first, then those of the second.
template <int BN, bool B1_MN, bool B2_MN, class Epi1, class Epi2>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_pair_kernel(const __grid_constant__ CUtensorMap ta1,
                     const __grid_constant__ CUtensorMap tb1,
                     const __grid_constant__ CUtensorMap ta2,
                     const __grid_constant__ CUtensorMap tb2, int M, int N, int K1, int K2,
                     Epi1 epi1, Epi2 epi2) {
  using S = Shape<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = ring + S::STAGES * S::STAGE_BYTES;
  const uint32_t empty0 = full0 + 8 * S::STAGES;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int nk1 = (K1 + BK - 1) / BK;
  const int nk = nk1 + (K2 + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S::STAGES;
        if (kt >= S::STAGES) mbar_wait(empty0 + 8 * s, ((kt / S::STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, S::STAGE_BYTES);
        const uint32_t a = ring + s * S::STAGE_BYTES;
        const uint32_t b = a + S::A_BYTES;
        const bool first = kt < nk1;
        const int k0 = (first ? kt : kt - nk1) * BK;
        tma_load(a, first ? &ta1 : &ta2, full, k0, m0);  // A stored [M, K]
        if (first ? B1_MN : B2_MN) {  // B stored [K, N]: BN / 64 boxes
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            tma_load(b + j * BOX, first ? &tb1 : &tb2, full, n0 + 64 * j, k0);
          }
        } else {  // B^T stored [N, K]: one box of BN rows
          tma_load(b, first ? &tb1 : &tb2, full, k0, n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int lane = tid & 31;
    const int r0 = m0 + c * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int c0 = n0 + 2 * (lane & 3);
    float acc[BN / 2];
    uint32_t keep[BN / 4];  // epi1's words: 4 j + {0, 1} -> keep[2 j], 4 j + {2, 3} -> keep[2 j + 1]
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    consume_slices<BN, false, B1_MN>(acc, ring, full0, empty0, c, 0, nk1);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = c0 + 8 * j;
      keep[2 * j] = col < N && r0 < M ? epi1(r0, col, acc[4 * j], acc[4 * j + 1]) : 0u;
      keep[2 * j + 1] = col < N && r0 + 8 < M ? epi1(r0 + 8, col, acc[4 * j + 2], acc[4 * j + 3]) : 0u;
      acc[4 * j] = acc[4 * j + 1] = acc[4 * j + 2] = acc[4 * j + 3] = 0.0f;
    }
    consume_slices<BN, false, B2_MN>(acc, ring, full0, empty0, c, nk1, nk);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = c0 + 8 * j;
      if (col < N) {
        if (r0 < M) epi2(r0, col, acc[4 * j], acc[4 * j + 1], keep[2 * j]);
        if (r0 + 8 < M) epi2(r0 + 8, col, acc[4 * j + 2], acc[4 * j + 3], keep[2 * j + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (no
// link against libcuda); null if the driver does not offer it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The TMA map of a row-major bf16 matrix [rows, cols] (leading dimension ld
// elements), read in boxes of box_cols x box_rows with the 128-byte swizzle;
// elements past the matrix read as zero.
inline bool make_map(CUtensorMap* map, const bf16* ptr, int rows, int cols, int ld, int box_cols,
                     int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches C = A @ B over `splits` K ranges (grid z, which epi may read).
// A_MN: A is given as A^T [K, M] (leading dimension lda); else A [M, K].
// B_MN: B is given as B [K, N]; else as B^T [N, K].
template <int BN, bool A_MN, bool B_MN, class Epi>
int launch(const bf16* A, int lda, const bf16* B, int ldb, int M, int N, int K, int splits,
           const Epi& epi, cudaStream_t stream) {
  const int a_vec = A_MN ? M : K;
  const int b_vec = B_MN ? N : K;
  const int m_tiles = (M + BM - 1) / BM;
  if (M < 1 || N < 1 || K < 1 || splits < 1 || splits > 65535 || m_tiles > 65535 ||
      a_vec % 8 != 0 || b_vec % 8 != 0 || lda % 8 != 0 || ldb % 8 != 0 || N % 2 != 0 ||
      reinterpret_cast<uintptr_t>(A) % 16 != 0 || reinterpret_cast<uintptr_t>(B) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // A runtime call first: on a thread where no CUDA context is current yet
  // (autograd's backward threads, say) it makes the device's primary context
  // current, which the encoder needs to check the tensors' addresses.
  using S = Shape<BN>;
  const cudaError_t err = cudaFuncSetAttribute(gemm_kernel<BN, A_MN, B_MN, Epi>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the encoder needs 64-byte aligned maps, which a stack variable of the
  // host compiler's is not promised to be: align them by hand
  unsigned char raw[2 * sizeof(CUtensorMap) + 64];
  CUtensorMap* maps = reinterpret_cast<CUtensorMap*>(
      (reinterpret_cast<uintptr_t>(raw) + 63) & ~static_cast<uintptr_t>(63));
  if (!make_map(&maps[0], A, A_MN ? K : M, A_MN ? M : K, lda, 64, A_MN ? 64 : BM) ||
      !make_map(&maps[1], B, B_MN ? K : N, B_MN ? N : K, ldb, 64, B_MN ? 64 : BN)) {
    return static_cast<int>(cudaErrorInvalidPitchValue);  // the driver refused a tensor map
  }
  const int per_split = (K + splits - 1) / splits;
  const int k_chunk = (per_split + BK - 1) / BK * BK;
  const dim3 grid((N + BN - 1) / BN, m_tiles, splits);
  gemm_kernel<BN, A_MN, B_MN, Epi><<<grid, THREADS, S::SMEM, stream>>>(maps[0], maps[1], M, N, K,
                                                                        k_chunk, epi);
  return static_cast<int>(cudaGetLastError());
}

// Launches gemm_pair_kernel: C1 = A1 [M, K1] @ B1 then C2 = A2 [M, K2] @ B2 on
// each 128 x BN tile of [M, N]; A1, A2 K-major; B1 / B2 given as B [K, N]
// where B1_MN / B2_MN, else as B^T [N, K].
template <int BN, bool B1_MN, bool B2_MN, class Epi1, class Epi2>
int launch_pair(const bf16* A1, int lda1, const bf16* B1, int ldb1, const bf16* A2, int lda2,
                const bf16* B2, int ldb2, int M, int N, int K1, int K2, const Epi1& epi1,
                const Epi2& epi2, cudaStream_t stream) {
  const int m_tiles = (M + BM - 1) / BM;
  if (M < 1 || N < 1 || K1 < 1 || K2 < 1 || m_tiles > 65535 || K1 % 8 != 0 || K2 % 8 != 0 ||
      (B1_MN ? N : K1) % 8 != 0 || (B2_MN ? N : K2) % 8 != 0 || lda1 % 8 != 0 ||
      lda2 % 8 != 0 || ldb1 % 8 != 0 || ldb2 % 8 != 0 || N % 2 != 0 ||
      reinterpret_cast<uintptr_t>(A1) % 16 != 0 || reinterpret_cast<uintptr_t>(A2) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(B1) % 16 != 0 || reinterpret_cast<uintptr_t>(B2) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  using S = Shape<BN>;
  auto kernel = gemm_pair_kernel<BN, B1_MN, B2_MN, Epi1, Epi2>;
  // a runtime call before the encoder, as in launch
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned char raw[4 * sizeof(CUtensorMap) + 64];
  CUtensorMap* maps = reinterpret_cast<CUtensorMap*>(
      (reinterpret_cast<uintptr_t>(raw) + 63) & ~static_cast<uintptr_t>(63));
  if (!make_map(&maps[0], A1, M, K1, lda1, 64, BM) ||
      !make_map(&maps[1], B1, B1_MN ? K1 : N, B1_MN ? N : K1, ldb1, 64, B1_MN ? 64 : BN) ||
      !make_map(&maps[2], A2, M, K2, lda2, 64, BM) ||
      !make_map(&maps[3], B2, B2_MN ? K2 : N, B2_MN ? N : K2, ldb2, 64, B2_MN ? 64 : BN)) {
    return static_cast<int>(cudaErrorInvalidPitchValue);
  }
  const dim3 grid((N + BN - 1) / BN, m_tiles);
  kernel<<<grid, THREADS, S::SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3], M, N, K1, K2,
                                             epi1, epi2);
  return static_cast<int>(cudaGetLastError());
}

// The block width the core takes for N output columns: 256, or 128 where
// N <= 128 (mirrored by ops/gemm_core.py).
inline int block_n(int N) { return N > 128 ? 256 : 128; }

// launch<BN, ...> with BN = block_n(N).
template <bool A_MN, bool B_MN, class Epi>
int launch_auto(const bf16* A, int lda, const bf16* B, int ldb, int M, int N, int K, int splits,
                const Epi& epi, cudaStream_t stream) {
  if (block_n(N) == 256) return launch<256, A_MN, B_MN>(A, lda, B, ldb, M, N, K, splits, epi, stream);
  return launch<128, A_MN, B_MN>(A, lda, B, ldb, M, N, K, splits, epi, stream);
}

// ---------------------------------------------------------------------------
// epilogues shared by several callers
// ---------------------------------------------------------------------------

struct StoreBf16 {  // bf16(v)
  bf16* out;
  int ld;
  __device__ void operator()(int row, int col, float v0, float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * ld + col) =
        __floats2bfloat162_rn(v0, v1);
  }
};

struct StoreBiasBf16 {  // bf16(v + b[col]): a flax Dense's product, bias and one rounding
  const float* b;
  bf16* out;
  int ld;
  __device__ void operator()(int row, int col, float v0, float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * ld + col) =
        __floats2bfloat162_rn(v0 + b[col], v1 + b[col + 1]);
  }
};

struct StoreSplitF32 {  // the fp32 partial of split blockIdx.z
  float* out;
  int ld;
  size_t split_stride;
  __device__ void operator()(int row, int col, float v0, float v1) const {
    *reinterpret_cast<float2*>(out + blockIdx.z * split_stride + static_cast<size_t>(row) * ld +
                               col) = make_float2(v0, v1);
  }
};

}  // namespace swin_wg
