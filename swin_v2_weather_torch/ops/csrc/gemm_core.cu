// The Hopper GEMM core's own entry point (wgmma_gemm.cuh): C = A @ B with an
// fp32 result (split-K partials summed in split order) or a bf16 one, either
// operand K-major or MN-major.
//
// Replaces the matrix products inside the TPU kernels
// swin_v2_weather_tpu/ops/mlp_kernels.py:_make_mlp_fwd_kernel (K5's fc1 and
// fc2, mlp.cu) and swin_v2_weather_tpu/ops/window_attention.py:
// _make_qkv_kernel and _make_qkv_bwd_kernel (K1's projection, K2's
// recomputed one and its dx and dW, qkv_projection.cuh), and
// _make_mlp_bwd_kernel (K6's two products, mlp.cu), which the MXU runs there. Those
// callers launch the core with their own epilogues; this entry holds the
// core itself against a plain product and times it alone (ops/gemm_core.py,
// chip_smoke.py). What bounds it and what its design does about it:
// wgmma_gemm.cuh.

#include "wgmma_gemm.cuh"

namespace {

using swin_wg::bf16;

// c[i] = sum of part[s, i] over the splits, in split order
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits, long long n,
                                  float* __restrict__ c) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += part[s * n + i];
  c[i] = acc;
}

template <bool A_MN, bool B_MN>
int run(const bf16* a, const bf16* b, float* part, void* c, int M, int N, int K, int lda, int ldb,
        int splits, bool out_bf16, cudaStream_t s) {
  if (out_bf16) {
    if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    return swin_wg::launch_auto<A_MN, B_MN>(a, lda, b, ldb, M, N, K, 1,
                                            swin_wg::StoreBf16{static_cast<bf16*>(c), N}, s);
  }
  float* dst = splits == 1 ? static_cast<float*>(c) : part;
  const int code = swin_wg::launch_auto<A_MN, B_MN>(
      a, lda, b, ldb, M, N, K, splits,
      swin_wg::StoreSplitF32{dst, N, static_cast<size_t>(M) * N}, s);
  if (code != 0 || splits == 1) return code;
  const long long n = static_cast<long long>(M) * N;
  sum_splits_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      part, splits, n, static_cast<float*>(c));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C [M, N] = A [M, K] @ B [K, N]. a_mn: A is given as A^T [K, M] (leading
// dimension lda), else as A [M, K]; b_mn: B is given as B [K, N], else as
// B^T [N, K]. out_bf16: C bf16 (splits 1); else C fp32, with part [splits,
// M, N] fp32 the scratch of splits > 1.
extern "C" int swin_gemm_core(const void* a, const void* b, void* part, void* c, int M, int N,
                              int K, int lda, int ldb, int a_mn, int b_mn, int splits,
                              int out_bf16, void* stream) {
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  float* P = static_cast<float*>(part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool o = out_bf16 != 0;
  if (splits > 1 && !o && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (a_mn) {
    return b_mn ? run<true, true>(A, B, P, c, M, N, K, lda, ldb, splits, o, s)
                : run<true, false>(A, B, P, c, M, N, K, lda, ldb, splits, o, s);
  }
  return b_mn ? run<false, true>(A, B, P, c, M, N, K, lda, ldb, splits, o, s)
              : run<false, false>(A, B, P, c, M, N, K, lda, ldb, splits, o, s);
}
