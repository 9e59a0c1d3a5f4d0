// The whole Swin MLP (fc1 + exact-erf GELU + fc2), forward and backward,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels swin_v2_weather_tpu/ops/mlp_kernels.py:
//   _make_mlp_fwd_kernel (launched by mlp_fwd_pallas), K5:
//     out = bf16(bf16(gelu(bf16(x @ W1 + b1))) @ W2) + bf16(b2)
//   _make_mlp_bwd_kernel (launched by mlp_bwd_pallas), K6:
//     pre = bf16(x @ W1 + b1);  a = bf16(gelu(pre));  dpre = bf16((g @ W2^T) * gelu'(pre))
//   (gelu(z) = z Phi(z), gelu'(z) = Phi(z) + z phi(z))
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
//   K6 is one launch of the core's pair kernel (gemm_pair_kernel): on each
//   128 x 256 output tile x @ W1 first (W1 read as the MN-major B operand in
//   place), whose epilogue only keeps the bf16 pre-activation packed in the
//   consumer warpgroups' registers (64 words a thread beside the 128
//   accumulators), then g @ W2^T (W2 [hidden, C_out] read as the K-major B
//   operand in place) into the same accumulators, whose epilogue forms both
//   a and dpre from one Phi(pre) and one phi(pre). No [T, hidden]
//   pre-activation reaches device memory, and the ring's loads of the second
//   product overlap the first one's epilogue. The GELU sits in the second
//   epilogue, not the first, because there the kept words are consumed as
//   it goes: a first epilogue that evaluated the GELU with 192 registers of
//   live state left too few for independent evaluations in flight, and was
//   far slower on the H100.
//
// Contract (checked by the Python wrapper): x [T, C_in], W1 [C_in, hidden],
// W2 [hidden, C_out], g and out [T, C_out], a and dpre [T, hidden], all bf16
// row-major contiguous; b1 [hidden] and b2 [C_out] fp32; C_in, hidden and
// C_out multiples of 8 (the core's); any T >= 1 up to 65535 tiles of 128
// (the ragged edges are zero-filled by TMA and masked in the epilogues).

#include "mlp_epilogue.cuh"

namespace {

using swin_cuda::bf16;
using namespace swin_mlp;

// ---------------------------------------------------------------------------
// K5: the MLP forward, two products on the GEMM core; the first one's
// epilogue is Fc1Epilogue (mlp_epilogue.cuh, shared with K3)
// ---------------------------------------------------------------------------

namespace k5 {

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
// K6: the MLP backward's recompute, two products on one tile of the core
// ---------------------------------------------------------------------------

namespace k6 {

// after x @ W1: pre = bf16(acc + b1), returned as the packed bf16 pair the
// consumer keeps in its registers (exactly, since it is rounded to bf16
// anyway); nothing is written
struct KeepPre {
  const float* b1;
  __device__ uint32_t operator()(int, int col, float v0, float v1) const {
    const __nv_bfloat162 pre = __floats2bfloat162_rn(v0 + b1[col], v1 + b1[col + 1]);
    return *reinterpret_cast<const uint32_t*>(&pre);
  }
};

// after g @ W2^T: with Phi(z) = 0.5 (1 + erf(z / sqrt 2)) and phi(z) the
// normal density, both from the kept pre: a = bf16(z Phi(z)) (gelu's bits:
// the 0.5 scaling is exact in either order) and dpre = bf16(da (Phi(z) +
// z phi(z))), da the fp32 accumulators
struct ActDpre {
  bf16* a;
  bf16* dpre;
  int ld;
  __device__ void operator()(int row, int col, float v0, float v1, uint32_t kept) const {
    const float2 z = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kept));
    const float c0 = gelu_cdf(z.x);
    const float c1 = gelu_cdf(z.y);
    const float p0 = gelu_pdf(z.x);
    const float p1 = gelu_pdf(z.y);
    const size_t o = static_cast<size_t>(row) * ld + col;
    *reinterpret_cast<__nv_bfloat162*>(a + o) = __floats2bfloat162_rn(z.x * c0, z.y * c1);
    *reinterpret_cast<__nv_bfloat162*>(dpre + o) =
        __floats2bfloat162_rn(v0 * (c0 + z.x * p0), v1 * (c1 + z.y * p1));
  }
};

}  // namespace k6

// The core's limits (wgmma_gemm.cuh): every contiguous dimension a multiple
// of 8 elements, at most 65535 row tiles of 128 tokens.
bool valid_shape(int T, int c_in, int hidden, int c_out) {
  return T >= 1 && (T + swin_wg::BM - 1) / swin_wg::BM <= 65535 && c_in >= 8 && c_in % 8 == 0 &&
         hidden >= 8 && hidden % 8 == 0 && c_out >= 8 && c_out % 8 == 0;
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
      Fc1Epilogue{static_cast<const float*>(b1), static_cast<bf16*>(act), hidden}, s);
  if (code != 0) return code;
  return swin_wg::launch_auto<false, true>(
      static_cast<const bf16*>(act), hidden, static_cast<const bf16*>(w2), c_out, T, c_out, hidden,
      1, k5::Fc2Epilogue{static_cast<const float*>(b2), static_cast<bf16*>(out), c_out}, s);
}

// K6. Outputs a and dpre [T, hidden] bf16.
extern "C" int swin_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* g, void* a, void* dpre, int T, int c_in, int hidden,
                            int c_out, void* stream) {
  if (!valid_shape(T, c_in, hidden, c_out)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // x @ W1: W1 [C_in, hidden] is B stored [K, N]; g @ W2^T: W2 [hidden, C_out]
  // is B^T stored [N, K]
  const k6::KeepPre epi1{static_cast<const float*>(b1)};
  const k6::ActDpre epi2{static_cast<bf16*>(a), static_cast<bf16*>(dpre), hidden};
  const bf16* x16 = static_cast<const bf16*>(x);
  const bf16* w1_16 = static_cast<const bf16*>(w1);
  const bf16* g16 = static_cast<const bf16*>(g);
  const bf16* w2_16 = static_cast<const bf16*>(w2);
  if (swin_wg::block_n(hidden) == 256) {
    return swin_wg::launch_pair<256, true, false>(x16, c_in, w1_16, hidden, g16, c_out, w2_16,
                                                  c_out, T, hidden, c_in, c_out, epi1, epi2, s);
  }
  return swin_wg::launch_pair<128, true, false>(x16, c_in, w1_16, hidden, g16, c_out, w2_16, c_out,
                                                T, hidden, c_in, c_out, epi1, epi2, s);
}
