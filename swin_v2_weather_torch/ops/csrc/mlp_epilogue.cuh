// The Swin MLP's epilogue arithmetic on the GEMM core (wgmma_gemm.cuh),
// shared by fc1 + GELU (K3/K4, fc1_gelu.cu) and the whole MLP (K5/K6,
// mlp.cu): flax Dense(dtype=bf16)'s rounding of the pre-activation, the
// exact-erf GELU and the two factors of its derivative, all in fp32.

#pragma once

#include "wgmma_gemm.cuh"

namespace swin_mlp {

using swin_cuda::bf16;

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.0f + erff(z * kInvSqrt2));
}

// Phi(z) = 0.5 (1 + erf(z / sqrt 2)), the normal CDF
__device__ __forceinline__ float gelu_cdf(float z) { return 0.5f * (1.0f + erff(z * kInvSqrt2)); }

// phi(z), the normal density; gelu'(z) = Phi(z) + z phi(z)
__device__ __forceinline__ float gelu_pdf(float z) { return expf(z * z * -0.5f) * kInvSqrt2Pi; }

// after x @ W1: a = bf16(gelu(bf16(acc + b1))), the activation of K3 and of
// K5's first product
struct Fc1Epilogue {
  const float* b1;
  bf16* a;
  int ld;
  __device__ void operator()(int row, int col, float v0, float v1) const {
    const float z0 = round_bf16(v0 + b1[col]);
    const float z1 = round_bf16(v1 + b1[col + 1]);
    *reinterpret_cast<__nv_bfloat162*>(a + static_cast<size_t>(row) * ld + col) =
        __floats2bfloat162_rn(gelu(z0), gelu(z1));
  }
};

}  // namespace swin_mlp
