// fc1 + exact-erf GELU of the Swin MLP, forward and backward, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernels swin_v2_weather_tpu/ops/mlp_kernels.py:
//   _make_fwd_kernel (launched by fc1_gelu_pallas):  out  = gelu_exact(bf16(x @ W1 + b1))
//   _make_bwd_kernel (launched by fc1_dpre_pallas):  dpre = bf16(g * gelu'(bf16(x @ W1 + b1)))
// both token-tiled; the backward recomputes the pre-activation instead of
// reading a saved [T, hidden] tensor.
//
// What bounds them on this card: at the flagship shape, [64800, 768] x [768, 3072],
// the GEMM is 306 GFLOP against 100 MB of input and 398 MB of bf16 output (the
// backward also reads the 398 MB cotangent), about 600 (backward: 380) FLOP per
// byte, above the H100's ~295 FLOP/byte ridge: tensor-core throughput bounds
// them, and the epilogue (one erf, and for the backward one exp, per output)
// must not stall the matrix pipe or touch the [T, 3072] tensors twice.
//
// What the design does about it: both kernels are the tiled tensor-core GEMM of
// gemm_tile.cuh (128 x 128 x 32 tiles, wmma bf16 with fp32 accumulation, a
// two-stage cp.async ring) with their own fused epilogues. The bias, the bf16
// rounding of the pre-activation (the rounding site of flax Dense(dtype=bf16))
// and the GELU or its derivative times the cotangent run in the epilogue, which
// reads g and writes each output once as 16-byte bf16 vectors. wgmma/TMA
// pipelines come later; this version is the simple, correct baseline.
//
// Contract (checked by the Python wrapper): x [T, K] bf16, W [K, N] bf16, g and
// out [T, N] bf16, all row-major contiguous; b [N] fp32; K % 32 == 0,
// N % 128 == 0; any T >= 1 (the ragged last token tile is masked).

#include "gemm_tile.cuh"

namespace {

using namespace swin_gemm;

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

// Dense(dtype=bf16) rounds the pre-activation before the activation
__device__ __forceinline__ float pre_activation(float acc, float bias) {
  return __bfloat162float(__float2bfloat16(acc + bias));
}

struct GeluEpilogue {
  const float* bias;
  bf16* out;
  int N;
  __device__ void operator()(int row, int col, const float* v) const {
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float pre = pre_activation(v[e], bias[col + e]);
      o[e] = __float2bfloat16(0.5f * pre * (1.0f + erff(pre * kInvSqrt2)));
    }
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * N + col) =
        *reinterpret_cast<const uint4*>(o);
  }
};

struct DpreEpilogue {
  const float* bias;
  const bf16* g;
  bf16* out;
  int N;
  __device__ void operator()(int row, int col, const float* v) const {
    const size_t off = static_cast<size_t>(row) * N + col;
    __align__(16) bf16 gv[8];
    *reinterpret_cast<uint4*>(gv) = *reinterpret_cast<const uint4*>(g + off);
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float pre = pre_activation(v[e], bias[col + e]);
      // gelu'(z) = Phi(z) + z * phi(z)
      const float phi = expf(pre * pre * -0.5f) * kInvSqrt2Pi;
      const float cdf = 0.5f * (1.0f + erff(pre * kInvSqrt2));
      o[e] = __float2bfloat16(__bfloat162float(gv[e]) * (cdf + pre * phi));
    }
    *reinterpret_cast<uint4*>(out + off) = *reinterpret_cast<const uint4*>(o);
  }
};

bool valid_shape(int T, int K, int N) {
  return T >= 1 && K >= BK && K % BK == 0 && N >= BN && N % BN == 0;
}

}  // namespace

extern "C" int swin_fc1_gelu_fwd(const void* x, const void* w, const void* b, void* out, int T,
                                 int K, int N, void* stream) {
  if (!valid_shape(T, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  const GeluEpilogue epi{static_cast<const float*>(b), static_cast<bf16*>(out), N};
  return launch_gemm<false, false>(static_cast<const bf16*>(x), K, static_cast<const bf16*>(w),
                                   N, T, N, K, 1, epi, static_cast<cudaStream_t>(stream));
}

extern "C" int swin_fc1_dpre_bwd(const void* x, const void* w, const void* b, const void* g,
                                 void* out, int T, int K, int N, void* stream) {
  if (!valid_shape(T, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  const DpreEpilogue epi{static_cast<const float*>(b), static_cast<const bf16*>(g),
                         static_cast<bf16*>(out), N};
  return launch_gemm<false, false>(static_cast<const bf16*>(x), K, static_cast<const bf16*>(w),
                                   N, T, N, K, 1, epi, static_cast<cudaStream_t>(stream));
}
