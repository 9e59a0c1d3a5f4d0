// The whole Swin MLP (fc1 + exact-erf GELU + fc2), forward and backward,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels swin_v2_weather_tpu/ops/mlp_kernels.py:
//   _make_mlp_fwd_kernel (launched by mlp_fwd_pallas), K5:
//     out = bf16(bf16(gelu(bf16(x @ W1 + b1))) @ W2) + bf16(b2)
//   _make_mlp_bwd_kernel (launched by mlp_bwd_pallas), K6:
//     pre = bf16(x @ W1 + b1);  a = bf16(gelu(pre));  dpre = bf16((g @ W2^T) * gelu'(pre))
// The rounding sites are those of the TPU kernels (flax Dense(dtype=bf16)
// rounds each product, then adds the bias in bf16).
//
// What bounds them on this card: at the flagship shape (T = 64800 tokens,
// C = 768, hidden = 3072) each is two chained GEMMs, 2 T hidden (C_in + C_out)
// = 612 GFLOP, 0.62 ms at 989 TFLOP/s. K5 moves about 0.21 GB (x, W1, W2,
// out: 0.06 ms at 3.35 TB/s), K6 about 1.0 GB (x, g, W1, W2 in; a and dpre
// out: 0.30 ms). Both are tensor-core bound.
//
// What the designs do about it:
//   K5 is two products on the Hopper GEMM core (wgmma_gemm.cuh: TMA ring,
//   wgmma from swizzled shared memory, 128 x 256 block tiles): x @ W1, whose
//   epilogue writes a = bf16(gelu(bf16(acc + b1))) to a [T, hidden] bf16
//   scratch the wrapper allocates and drops on return, then a @ W2, whose
//   epilogue forms out. The rounding sites are the TPU kernel's; only the
//   order of the fp32 sums differs. The scratch costs 2 T hidden bytes of
//   transient memory (0.37 GiB at the flagship shape, 0.49 GiB at e2048) and
//   twice that in HBM traffic (0.24 / 0.32 ms at 3.35 TB/s, under the 0.618 /
//   2.199 ms the products take at the tensor-core peak); the TPU kernel keeps
//   the activation out of device memory so that the multi-step fine-tune
//   holds no [T, hidden] tensor per block, and that still holds: FusedMlp
//   saves only its inputs, and no [T, hidden] tensor outlives the call. One
//   design serves every width, each product on full 128-row wgmma tiles,
//   and nothing is recomputed.
//   K6 is K4's tile GEMM (gemm_tile.cuh) run twice on one 128 x 128 output
//   tile: x @ W1 first, whose epilogue writes a to memory and keeps the bf16
//   pre-activation in shared memory, then g @ W2^T (W2 read transposed in
//   place) into the same accumulators, whose epilogue forms dpre. One set of
//   accumulators, so the register budget is K4's.
// K6 moves onto the GEMM core in a later change.
//
// Contract (checked by the Python wrapper): x [T, C_in], W1 [C_in, hidden],
// W2 [hidden, C_out], g and out [T, C_out], a and dpre [T, hidden], all bf16
// row-major contiguous; b1 [hidden] and b2 [C_out] fp32; C_in % 32 == 0,
// hidden % 128 == 0, C_out % 32 == 0; any T >= 1 (the ragged last token
// tile is zero-filled and masked).

#include "gemm_tile.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace swin_gemm;

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.0f + erff(z * kInvSqrt2));
}

// gelu'(z) = Phi(z) + z * phi(z)
__device__ __forceinline__ float gelu_grad(float z) {
  const float phi = expf(z * z * -0.5f) * kInvSqrt2Pi;
  const float cdf = 0.5f * (1.0f + erff(z * kInvSqrt2));
  return cdf + z * phi;
}

// ---------------------------------------------------------------------------
// K5: the MLP forward, two products on the GEMM core
// ---------------------------------------------------------------------------

namespace k5 {

// after x @ W1: a = bf16(gelu(bf16(acc + b1)))
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

// after a @ W2: out = bf16(bf16(acc) + bf16(b2)), the product rounded, then
// the bias added in bf16 (an fp32 add of the two bf16 values, rounded once)
struct Fc2Epilogue {
  const float* b2;
  bf16* out;
  int ld;
  __device__ void operator()(int row, int col, float v0, float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * ld + col) =
        __floats2bfloat162_rn(round_bf16(v0) + round_bf16(b2[col]),
                              round_bf16(v1) + round_bf16(b2[col + 1]));
  }
};

}  // namespace k5

// ---------------------------------------------------------------------------
// K6: the MLP backward's recompute kernel
// ---------------------------------------------------------------------------

namespace k6 {

constexpr int max3(int a, int b, int c) { return a > b ? (a > c ? a : c) : (b > c ? b : c); }

// the operand ring of either product, and the epilogue's 8 KB scratch
constexpr int RING_BYTES =
    max3(Tiles<false, false>::BYTES, Tiles<false, true>::BYTES, THREADS / 32 * 256 * 4);
constexpr int PRE_LD = BN + 8;  // the tile's bf16 pre-activation, [BM][PRE_LD]
constexpr int SMEM_BYTES = RING_BYTES + BM * PRE_LD * static_cast<int>(sizeof(bf16));

// after x @ W1: a = bf16(gelu(pre)) to memory; pre = bf16(acc + b1) kept in
// shared memory (exactly, since it is rounded to bf16 anyway)
struct PreEpilogue {
  const float* bias;
  bf16* a;
  bf16* pre_s;
  int N, m0, n0;
  __device__ void operator()(int row, int col, const float* v) const {
    __align__(16) bf16 p[8];
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float z = round_bf16(v[e] + bias[col + e]);
      p[e] = __float2bfloat16(z);
      o[e] = __float2bfloat16(gelu(z));
    }
    *reinterpret_cast<uint4*>(a + static_cast<size_t>(row) * N + col) =
        *reinterpret_cast<const uint4*>(o);
    *reinterpret_cast<uint4*>(pre_s + (row - m0) * PRE_LD + (col - n0)) =
        *reinterpret_cast<const uint4*>(p);
  }
};

// after g @ W2^T: dpre = bf16(da * gelu'(pre)), da in fp32
struct DpreEpilogue {
  const bf16* pre_s;
  bf16* dpre;
  int N, m0, n0;
  __device__ void operator()(int row, int col, const float* v) const {
    __align__(16) bf16 p[8];
    *reinterpret_cast<uint4*>(p) =
        *reinterpret_cast<const uint4*>(pre_s + (row - m0) * PRE_LD + (col - n0));
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(v[e] * gelu_grad(__bfloat162float(p[e])));
    *reinterpret_cast<uint4*>(dpre + static_cast<size_t>(row) * N + col) =
        *reinterpret_cast<const uint4*>(o);
  }
};

__global__ void __launch_bounds__(THREADS)
    mlp_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const bf16* __restrict__ g, bf16* __restrict__ a, bf16* __restrict__ dpre, int T,
                   int c_in, int hidden, int c_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* pre_s = reinterpret_cast<bf16*>(smem + RING_BYTES);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  Acc acc[2][4];
  mainloop<false, false>(x, c_in, w1, hidden, T, hidden, 0, c_in, m0, n0, smem, acc);
  epilogue(acc, reinterpret_cast<float*>(smem), T, hidden, m0, n0,
           PreEpilogue{b1, a, pre_s, hidden, m0, n0});
  // the epilogue's scratch is the ring the second product loads into; every
  // lane reads back only the pre values it wrote itself
  __syncthreads();
  // da = g @ W2^T: W2 [hidden, C_out] is the transposed B operand [N, K]
  mainloop<false, true>(g, c_out, w2, c_out, T, hidden, 0, c_out, m0, n0, smem, acc);
  epilogue(acc, reinterpret_cast<float*>(smem), T, hidden, m0, n0,
           DpreEpilogue{pre_s, dpre, hidden, m0, n0});
}

}  // namespace k6

bool valid_shape(int T, int c_in, int hidden, int c_out) {
  return T >= 1 && c_in >= BK && c_in % BK == 0 && hidden >= BN && hidden % BN == 0 &&
         c_out >= BK && c_out % BK == 0;
}

}  // namespace

// K5. Scratch (allocated by the caller): act [T, hidden] bf16.
extern "C" int swin_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* act, void* out, int T, int c_in, int hidden,
                            int c_out, void* stream) {
  if (!valid_shape(T, c_in, hidden, c_out)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = swin_wg::launch_auto<false, true>(
      static_cast<const bf16*>(x), c_in, static_cast<const bf16*>(w1), hidden, T, hidden, c_in, 1,
      k5::Fc1Epilogue{static_cast<const float*>(b1), static_cast<bf16*>(act), hidden}, s);
  if (code != 0) return code;
  return swin_wg::launch_auto<false, true>(
      static_cast<const bf16*>(act), hidden, static_cast<const bf16*>(w2), c_out, T, c_out, hidden,
      1, k5::Fc2Epilogue{static_cast<const float*>(b2), static_cast<bf16*>(out), c_out}, s);
}

extern "C" int swin_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* g, void* a, void* dpre, int T, int c_in, int hidden,
                            int c_out, void* stream) {
  if (!valid_shape(T, c_in, hidden, c_out)) return static_cast<int>(cudaErrorInvalidValue);
  const int m_tiles = (T + BM - 1) / BM;
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(k6::mlp_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         k6::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(hidden / BN, m_tiles);
  k6::mlp_bwd_kernel<<<grid, THREADS, k6::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(g), static_cast<bf16*>(a),
      static_cast<bf16*>(dpre), T, c_in, hidden, c_out);
  return static_cast<int>(cudaGetLastError());
}
