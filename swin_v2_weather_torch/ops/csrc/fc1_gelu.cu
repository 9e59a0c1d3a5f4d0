// fc1 + exact-erf GELU of the Swin MLP, forward and backward, hand-written for
// Hopper (sm_90a) on the GEMM core (wgmma_gemm.cuh).
//
// Replaces the TPU kernels swin_v2_weather_tpu/ops/mlp_kernels.py:
//   _make_fwd_kernel (launched by fc1_gelu_pallas), K3:  out  = gelu_exact(bf16(x @ W1 + b1))
//   _make_bwd_kernel (launched by fc1_dpre_pallas), K4:  dpre = bf16(g * gelu'(bf16(x @ W1 + b1)))
// both token-tiled; the backward recomputes the pre-activation instead of
// reading a saved [T, hidden] tensor.
//
// What bounds them on this card: at the flagship shape, [64800, 768] x [768, 3072],
// the product is 306 GFLOP (0.309 ms at 989 TFLOP/s) against 100 MB of input
// and 398 MB of bf16 output (the backward also reads the 398 MB cotangent:
// 0.27 ms of bytes at 3.35 TB/s), about 600 (backward: 380) FLOP per byte,
// above the H100's ~295 FLOP/byte ridge: the tensor cores bound them, and the
// epilogue (one erf, and for the backward one exp, per output) must not stall
// the matrix pipe or touch the [T, 3072] tensors twice.
//
// What the design does about it: each is one launch of the core (TMA ring,
// wgmma from swizzled shared memory, 128 x 256 block tiles), x read as the
// K-major A operand and W1 [768, 3072] as the MN-major B operand in place.
//   K3 takes K5's first epilogue (Fc1Epilogue, mlp_epilogue.cuh): K3 is K5's
//   fc1 product with nothing after it.
//   K4's epilogue forms dpre from the kept-pre arithmetic of K6's (z =
//   bf16(acc + b1), Phi(z) + z phi(z)), with g read instead of computed. g
//   reaches the epilogue through the core's prefetch form: before its
//   mainloop each consumer thread loads the g pairs of its accumulators (64
//   words at the 256-wide tile, held beside the 128 accumulators as the pair
//   kernel holds its kept words), so the loads are in flight while the
//   tile's products run and the epilogue does not wait on device memory.
// The rounding sites are the TPU kernels' (flax Dense(dtype=bf16) rounds the
// pre-activation); only the order of the fp32 sums differs.
//
// Contract (checked by the Python wrapper, ops/mlp_kernels.py fc1_plan): x
// [T, K] bf16, W [K, N] bf16, g and out [T, N] bf16, all row-major
// contiguous; b [N] fp32; K and N multiples of 8 (the core's); any T >= 1 up
// to 65535 tiles of 128 (the ragged edges are zero-filled by TMA and masked
// in the epilogue).

#include "mlp_epilogue.cuh"

namespace {

using swin_cuda::bf16;
using namespace swin_mlp;

// K4, after x @ W1, with g's pair of each accumulator pair fetched before the
// mainloop: dpre = bf16(g (Phi(z) + z phi(z))), z = bf16(acc + b1)
struct DpreEpilogue {
  static constexpr bool kPrefetch = true;
  const float* b1;
  const bf16* g;
  bf16* dpre;
  int ld;
  __device__ uint32_t fetch(int row, int col) const {
    return __ldg(reinterpret_cast<const unsigned int*>(g + static_cast<size_t>(row) * ld + col));
  }
  __device__ void operator()(int row, int col, float v0, float v1, uint32_t gw) const {
    const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw));
    const float z0 = round_bf16(v0 + b1[col]);
    const float z1 = round_bf16(v1 + b1[col + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dpre + static_cast<size_t>(row) * ld + col) =
        __floats2bfloat162_rn(gv.x * (gelu_cdf(z0) + z0 * gelu_pdf(z0)),
                              gv.y * (gelu_cdf(z1) + z1 * gelu_pdf(z1)));
  }
};

// The core's limits: K and N multiples of 8, at most 65535 row tiles of 128.
bool valid_shape(int T, int K, int N) {
  return T >= 1 && (T + swin_wg::BM - 1) / swin_wg::BM <= 65535 && K >= 8 && K % 8 == 0 &&
         N >= 8 && N % 8 == 0;
}

}  // namespace

// K3: out [T, N] = gelu(bf16(x [T, K] @ w [K, N] + b)).
extern "C" int swin_fc1_gelu_fwd(const void* x, const void* w, const void* b, void* out, int T,
                                 int K, int N, void* stream) {
  if (!valid_shape(T, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  return swin_wg::launch_auto<false, true>(
      static_cast<const bf16*>(x), K, static_cast<const bf16*>(w), N, T, N, K, 1,
      Fc1Epilogue{static_cast<const float*>(b), static_cast<bf16*>(out), N},
      static_cast<cudaStream_t>(stream));
}

// K4: out [T, N] = bf16(g [T, N] * gelu'(bf16(x @ w + b))).
extern "C" int swin_fc1_dpre_bwd(const void* x, const void* w, const void* b, const void* g,
                                 void* out, int T, int K, int N, void* stream) {
  if (!valid_shape(T, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  return swin_wg::launch_auto<false, true>(
      static_cast<const bf16*>(x), K, static_cast<const bf16*>(w), N, T, N, K, 1,
      DpreEpilogue{static_cast<const float*>(b), static_cast<const bf16*>(g),
                   static_cast<bf16*>(out), N},
      static_cast<cudaStream_t>(stream));
}
