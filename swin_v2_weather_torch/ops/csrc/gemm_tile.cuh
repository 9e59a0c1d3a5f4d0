// The tiled bf16 GEMM body of the fc1 forward (K3) and backward (K4) in
// fc1_gelu.cu and of the MLP backward's recompute (K6) in mlp.cu. Each kernel
// adds only its epilogue. The Hopper GEMM core (wgmma_gemm.cuh) carries the
// port's other products; these three move onto it in a later change.
//
// C[M, N] = A[M, K] @ B[K, N] with bf16 operands and fp32 accumulation on the
// tensor cores (nvcuda::wmma 16x16x16 fragments). Each 256-thread block owns a
// 128 x 128 output tile; its 8 warps each own 32 x 64. The K loop runs in
// 32-wide slices through a two-stage cp.async ring in shared memory, so the
// next slice loads while the current one multiplies. Either operand may be
// given transposed (A stored [K, M], B stored [N, K], both row-major), which is
// how the backward reads W and x without a transposed copy. Ragged edges are
// zero-filled in shared memory and masked in the epilogue. Split-K: block
// z of the grid sums over K range [z * k_chunk, (z + 1) * k_chunk).
//
// Layout contract (checked by launch_gemm): the dimension along which an
// operand's rows are contiguous (A: K, or M if transposed; B: N, or K if
// transposed) is a multiple of 8, and so are the leading dimensions, for
// 16-byte loads.

#pragma once

#include <mma.h>

#include <type_traits>

#include "cuda_common.cuh"

namespace swin_gemm {

using namespace nvcuda;
using namespace swin_cuda;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <bool A_T, bool B_T>
struct Tiles {
  static constexpr int A_LD = (A_T ? BM : BK) + 8;  // smem pitch (elements)
  static constexpr int B_LD = (B_T ? BK : BN) + 8;
  static constexpr int A_ELEMS = (A_T ? BK : BM) * A_LD;
  static constexpr int B_ELEMS = (B_T ? BN : BK) * B_LD;
  static constexpr int BYTES = 2 * (A_ELEMS + B_ELEMS) * static_cast<int>(sizeof(bf16));
};

// Accumulates this block's tile over K range [k_begin, k_end) into acc. Ends
// with a block-wide barrier, after which smem may be reused.
template <bool A_T, bool B_T>
__device__ void mainloop(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B,
                         int ldb, int M, int N, int k_begin, int k_end, int m0, int n0,
                         unsigned char* smem, Acc (&acc)[2][4]) {
  using T = Tiles<A_T, B_T>;
  bf16* As = reinterpret_cast<bf16*>(smem);  // [2][A_ELEMS]
  bf16* Bs = As + 2 * T::A_ELEMS;            // [2][B_ELEMS]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;  // warp's row offset in the tile
  const int wn = (warp & 1) * 64;   // warp's column offset in the tile

  auto load_slice = [&](int stage, int k0) {
    bf16* as = As + stage * T::A_ELEMS;
    bf16* bs = Bs + stage * T::B_ELEMS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 512 chunks of 8
      const int idx = tid + i * THREADS;
      if constexpr (A_T) {  // smem [BK][BM]: row k, 16 chunks along m
        const int r = idx >> 4, c = (idx & 15) * 8;
        const int gk = k0 + r, gm = m0 + c;
        const bool ok = gk < k_end && gm < M;
        cp_async16(as + r * T::A_LD + c, ok ? A + static_cast<size_t>(gk) * lda + gm : A, ok);
      } else {  // smem [BM][BK]: row m, 4 chunks along k
        const int r = idx >> 2, c = (idx & 3) * 8;
        const int gm = m0 + r, gk = k0 + c;
        const bool ok = gm < M && gk < k_end;
        cp_async16(as + r * T::A_LD + c, ok ? A + static_cast<size_t>(gm) * lda + gk : A, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // B: 512 chunks of 8
      const int idx = tid + i * THREADS;
      if constexpr (B_T) {  // smem [BN][BK]: row n, 4 chunks along k
        const int r = idx >> 2, c = (idx & 3) * 8;
        const int gn = n0 + r, gk = k0 + c;
        const bool ok = gn < N && gk < k_end;
        cp_async16(bs + r * T::B_LD + c, ok ? B + static_cast<size_t>(gn) * ldb + gk : B, ok);
      } else {  // smem [BK][BN]: row k, 16 chunks along n
        const int r = idx >> 4, c = (idx & 15) * 8;
        const int gk = k0 + r, gn = n0 + c;
        const bool ok = gk < k_end && gn < N;
        cp_async16(bs + r * T::B_LD + c, ok ? B + static_cast<size_t>(gk) * ldb + gn : B, ok);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  if (nk > 0) load_slice(0, k_begin);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load_slice(cur ^ 1, k_begin + (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* as = As + cur * T::A_ELEMS;
    const bf16* bs = Bs + cur * T::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      using ALayout = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
      using BLayout = typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm + i * 16;
        wmma::load_matrix_sync(a[i], A_T ? as + kk * T::A_LD + m : as + m * T::A_LD + kk,
                               T::A_LD);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 16;
        wmma::load_matrix_sync(b[j], B_T ? bs + n * T::B_LD + kk : bs + kk * T::B_LD + n,
                               T::B_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Hands the block's accumulators to epi(row, col, v) eight consecutive
// columns at a time (v[0..7] fp32, col a multiple of 8), for rows < M and
// columns < N. scratch: 8 warps x 256 floats of shared memory.
template <class Epi>
__device__ void epilogue(Acc (&acc)[2][4], float* scratch, int M, int N, int m0, int n0,
                         const Epi& epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 64;
  float* cs = scratch + warp * 256;
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int grow = m0 + wm + i * 16 + r;
      const int gcol = n0 + wn + j * 16 + c0;
      if (grow < M && gcol < N) epi(grow, gcol, cs + r * 16 + c0);
      __syncwarp();
    }
  }
}

template <bool A_T, bool B_T, class Epi>
__global__ void __launch_bounds__(THREADS)
    gemm_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb, int M,
                int N, int K, int k_chunk, Epi epi) {
  // the epilogue's 8 KB scratch reuses the operand ring after the main loop
  constexpr int BYTES = Tiles<A_T, B_T>::BYTES > THREADS / 32 * 256 * 4
                            ? Tiles<A_T, B_T>::BYTES
                            : THREADS / 32 * 256 * 4;
  __shared__ __align__(128) unsigned char smem[BYTES];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  Acc acc[2][4];
  mainloop<A_T, B_T>(A, lda, B, ldb, M, N, k_begin, k_end, m0, n0, smem, acc);
  epilogue(acc, reinterpret_cast<float*>(smem), M, N, m0, n0, epi);
}

// Launches C = A @ B over `splits` K ranges (grid z); epi sees blockIdx.z.
template <bool A_T, bool B_T, class Epi>
int launch_gemm(const bf16* A, int lda, const bf16* B, int ldb, int M, int N, int K, int splits,
                const Epi& epi, cudaStream_t stream) {
  const int a_vec = A_T ? M : K;  // contiguous dimension of each operand
  const int b_vec = B_T ? K : N;
  if (M < 1 || N < 1 || K < 1 || splits < 1 || splits > 65535 || a_vec % 8 != 0 ||
      b_vec % 8 != 0 || lda % 8 != 0 || ldb % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int m_tiles = (M + BM - 1) / BM;
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int per_split = (K + splits - 1) / splits;
  const int k_chunk = (per_split + BK - 1) / BK * BK;
  const dim3 grid((N + BN - 1) / BN, m_tiles, splits);
  gemm_kernel<A_T, B_T, Epi><<<grid, THREADS, 0, stream>>>(A, lda, B, ldb, M, N, K, k_chunk, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swin_gemm
