// K13: the prestage probe's consumer, hand-written for Hopper (sm_90a): the sum
// of the three roles of a staged [3, B, nW, heads, Lp, hd] bf16 tensor into
// [B, nW, heads, Lp, hd].
//
// Replaces the TPU kernel scripts/prestage_probe.py:_consume (launched through
// pl.pallas_call in that script's consume). There it pins the staged array's
// physical layout, so that the probe times a materialised prestage transpose;
// the port's probe (swin_v2_weather_torch/scripts/prestage_probe.py) uses this
// kernel the same way.
//
// Bound on this card: bytes. At the flagship shapes ([3, 1, 400, 8, 168, 96])
// it reads 309.7 MB and writes 103.2 MB for 103 M additions: 0.123 ms at
// 3.35 TB/s.
//
// Design: an elementwise pass, 8 bf16 a thread as one 16-byte load from each
// role and one 16-byte store, a grid-stride loop over the 16-byte chunks.
//
// Rounding: the TPU kernel's s0 + s1 + s2 in bf16 rounds after each add (its
// interpret-mode result on the CPU is bf16(bf16(s0 + s1) + s2)); so does this
// one, each add in fp32.
//
// Contract (checked by the Python wrapper): s contiguous bf16, n = one role's
// element count, a multiple of 8; s and out 16-byte aligned.

#include "cuda_common.cuh"

using swin_cuda::bf16;

namespace {

__global__ void consume_kernel(const uint4* __restrict__ s, uint4* __restrict__ out,
                               long long n8) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n8;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint4 a = s[i], b = s[n8 + i], c = s[2 * n8 + i];
    const bf16* pa = reinterpret_cast<const bf16*>(&a);
    const bf16* pb = reinterpret_cast<const bf16*>(&b);
    const bf16* pc = reinterpret_cast<const bf16*>(&c);
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bf16 ab = __float2bfloat16(__bfloat162float(pa[e]) + __bfloat162float(pb[e]));
      o[e] = __float2bfloat16(__bfloat162float(ab) + __bfloat162float(pc[e]));
    }
    out[i] = *reinterpret_cast<const uint4*>(o);
  }
}

}  // namespace

// K13: s [3, n] bf16 -> out [n] bf16, out = bf16(bf16(s0 + s1) + s2).
extern "C" int swin_prestage_consume(const void* s, void* out, long long n, void* stream) {
  if (n < 8 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n8 = n / 8;
  const long long want = (n8 + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
  consume_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(s), static_cast<uint4*>(out), n8);
  return static_cast<int>(cudaGetLastError());
}
