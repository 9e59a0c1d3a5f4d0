// The projection backward shared by the qkv-fused window-attention backwards
// (K2/K7/K10/K12 in window_attention_qkv_bwd.cu, the large-head variant in
// window_attention_qkv_large.cu): given the bf16 cotangent of the projection
// output dqkv [T, N] (N = 3C, or 3 * heads * 128 for K10), compute
//   dx = dqkv @ W^T on the GEMM core (wgmma_gemm.cuh), W [C_in, N] read as
//        the K-major B operand in place, bf16 out,
//   dW = bf16(x)^T @ dqkv in fp32 on the core, x read as the MN-major A
//        operand in place, split over token ranges into fixed partials,
//   db = column sums of dqkv over token ranges,
// then one kernel that sums the dW and db partials in split order and the
// d(scale) partials in partial order, dividing by scale, and (with the CPB
// bias) the d(bias) partials in window order. No atomics: two calls give the
// same bits.

#pragma once

#include "wgmma_gemm.cuh"
#include "window_attention_common.cuh"

namespace swin_qkv_proj {

using swin_cuda::bf16;

// part[s, n] = sum of d[t, n] over token range s, in token order
static __global__ void column_sums_kernel(const bf16* __restrict__ d, int T, int N,
                                          int rows_per_split, float* __restrict__ part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(T, r0 + rows_per_split);
  float acc = 0.0f;
  for (int r = r0; r < r1; ++r) acc += __bfloat162float(d[static_cast<size_t>(r) * N + n]);
  part[static_cast<size_t>(blockIdx.y) * N + n] = acc;
}

// dW = sum of the split partials, db = sum of the column-sum partials (both in
// split order), dscale[h] = (sum over the n_part partials, in order) / scale[h]
static __global__ void reduce_kernel(const float* __restrict__ dw_part, int dw_splits, int n_dw,
                                     float* __restrict__ dw, const float* __restrict__ db_part,
                                     int db_splits, int n_db, float* __restrict__ db,
                                     const float* __restrict__ ds_part, int n_part, int heads,
                                     const float* __restrict__ scale,
                                     float* __restrict__ dscale) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_dw) {
    float acc = 0.0f;
    for (int s = 0; s < dw_splits; ++s) acc += dw_part[static_cast<size_t>(s) * n_dw + i];
    dw[i] = acc;
  } else if (i < n_dw + n_db) {
    const int j = static_cast<int>(i - n_dw);
    float acc = 0.0f;
    for (int s = 0; s < db_splits; ++s) acc += db_part[static_cast<size_t>(s) * n_db + j];
    db[j] = acc;
  } else if (i < n_dw + n_db + heads) {
    const int hh = static_cast<int>(i - n_dw - n_db);
    float acc = 0.0f;
    for (int k = 0; k < n_part; ++k) acc += ds_part[static_cast<size_t>(k) * heads + hh];
    dscale[hh] = acc / scale[hh];
  }
}

// The qkv projection of the qkv-fused backwards, split off their attention
// pass onto the GEMM core: qkv [T, N] = bf16(x [T, C_in] @ W + b), fp32
// accumulation and one rounding (K1's site). slab_hd = 0: W is the packed
// [C_in, N]. Otherwise W is v5's reordered [N / slab_hd, C_in, slab_hd] and
// b the packed [N]: each (role, head) slab is its own product, in the same K
// order, written to its slab_hd columns of qkv.
inline int project(const bf16* x, const bf16* w, const float* b, bf16* qkv, int T, int Cin,
                   int N, int slab_hd, cudaStream_t s) {
  if (slab_hd == 0) {
    return swin_wg::launch_auto<false, true>(x, Cin, w, N, T, N, Cin, 1,
                                             swin_wg::StoreBiasBf16{b, qkv, N}, s);
  }
  int code = 0;
  for (int col0 = 0; col0 < N && code == 0; col0 += slab_hd) {
    code = swin_wg::launch_auto<false, true>(
        x, Cin, w + static_cast<size_t>(col0) * Cin, slab_hd, T, slab_hd, Cin, 1,
        swin_wg::StoreBiasBf16{b + col0, qkv + col0, N}, s);
  }
  return code;
}

// Everything after the attention backward: dx, dW, db, dscale and (dbias
// non-null) dbias. dqkv [T, N] bf16; dw_part [dw_splits, C_in, N], db_part
// [db_splits, N] fp32; dscale_part [n_part, heads]; dbias_part [n_win, heads,
// LP, LP] (dbias only).
inline int projection_backward(const bf16* x, const bf16* w, const bf16* dqkv, int T, int Cin,
                               int N, float* dw_part, float* db_part, const float* dscale_part,
                               int n_part, int heads, const float* scale, bf16* dx, float* dw,
                               float* db, float* dscale, const float* dbias_part, int n_win,
                               int L, int LP, float* dbias, int dw_splits, int db_splits,
                               cudaStream_t s) {
  // dx [T, C_in] = dqkv [T, N] @ W^T: A K-major, B^T = W stored [C_in, N]
  int code = swin_wg::launch_auto<false, false>(dqkv, N, w, N, T, Cin, N, 1,
                                                swin_wg::StoreBf16{dx, Cin}, s);
  if (code != 0) return code;
  // dW [C_in, N] = x^T @ dqkv: A^T = x stored [T, C_in], B = dqkv stored [T, N]
  code = swin_wg::launch_auto<true, true>(
      x, Cin, dqkv, N, Cin, N, T, dw_splits,
      swin_wg::StoreSplitF32{dw_part, N, static_cast<size_t>(Cin) * N}, s);
  if (code != 0) return code;

  const int rows_per_split = (T + db_splits - 1) / db_splits;
  column_sums_kernel<<<dim3((N + 127) / 128, db_splits), 128, 0, s>>>(dqkv, T, N,
                                                                      rows_per_split, db_part);
  code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;

  const int n_dw = Cin * N;
  const long long n_all = static_cast<long long>(n_dw) + N + heads;
  reduce_kernel<<<static_cast<unsigned>((n_all + 255) / 256), 256, 0, s>>>(
      dw_part, dw_splits, n_dw, dw, db_part, db_splits, N, db, dscale_part, n_part, heads, scale,
      dscale);
  code = static_cast<int>(cudaGetLastError());
  if (code != 0 || dbias == nullptr) return code;

  const long long n_bias = static_cast<long long>(heads) * L * L;
  swin_attn::dbias_reduce_kernel<<<static_cast<unsigned>((n_bias + 255) / 256), 256, 0, s>>>(
      dbias_part, n_win, heads, L, LP, dbias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swin_qkv_proj
