// The pieces of K8's and K9's streamed backward (streamed_bwd.cuh, forms
// FORM_GRID and FORM_V1; window_attention_grid_large.cu and
// window_attention_v1_large.cu) around its rows and columns kernels,
// hand-written for Hopper (sm_90a): K9's prepass, which writes qn16, kn16
// and the norms for the streamed kernels, and the reductions of their
// d(scale) and d(bias) partials.
//
// Replaces the same TPU kernels as streamed_bwd.cuh
// (swin_v2_weather_tpu/ops/window_attention.py: K8 _make_grid_bwd_kernel /
// _grid_backward; K9 _make_v1_bwd_kernel / _v1_backward, with has_bias): the
// TPU kernels normalize q and k inside (K9) and carry d(scale) and d(bias) in
// VMEM across a sequential grid; here the blocks run in parallel, so each
// writes its partials and these kernels sum them in a fixed order (no
// atomics: two calls give the same bits).
//
// What bounds them on this card: bytes. The prepass reads q and k and writes
// qn16, kn16 (and 8 bytes a row of norms); the reductions read the partials
// once (d(bias): [windows, heads, LP, LP] fp32).
//
// Rounding sites: K9's, qn = q * inv in fp32 with inv = 1 / sqrt(max(sum
// q^2, 1e-24)) (the sum per lane over columns lane + 32 i, then the warp's
// butterfly), qn16 = bf16(qn); K8's dscale = sum(qn16 dqn) / scale, K9's
// sum(ds s), each summed over the blocks' partials in window order.

#pragma once

#include "qkv_attention.cuh"

namespace swin_qkv_attn_large {

using namespace swin_qkv_attn;

// K9's prepass: qn16 = bf16(q * inv) for every row of q and k, inv = 1 /
// sqrt(max(sum q^2, 1e-24)) summed as normalize_rows sums; one warp per row.
// qn, kn have q's layout; inv [2, rows] (q's rows, then k's).
template <int HD>
__global__ void normalize_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 bf16* __restrict__ qn, bf16* __restrict__ kn,
                                 float* __restrict__ inv, long long rows) {
  constexpr int NV = (HD + 31) / 32;
  const long long wid = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= 2 * rows) return;
  const bool is_k = wid >= rows;
  const long long r = is_k ? wid - rows : wid;
  const bf16* src = (is_k ? k : q) + r * HD;
  bf16* dst = (is_k ? kn : qn) + r * HD;
  float vals[NV];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d = lane + 32 * i;
    const float v = d < HD ? __bfloat162float(src[d]) : 0.0f;
    vals[i] = v;
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float iv = 1.0f / sqrtf(fmaxf(ss, 1e-24f));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) dst[d] = __float2bfloat16(vals[i] * iv);
  }
  if (lane == 0) inv[wid] = iv;
}

struct LargeBwdArgs {
  const void *q, *k, *v, *scale, *bias, *mask;  // q, k normalized (K9: the prepass's copies)
  float bflag;
  const void *g, *qraw, *kraw, *inv;  // qraw, kraw, inv: K9 only
  void *dq, *dk, *dv, *rstat, *dscale_part, *dbias_part, *dscale, *dbias;
};

// dscale = the nchunks partials of each window summed in order (K8: divided
// by scale) and, with the bias, dbias = the windows' d(bias) partials summed
// in window order
inline int reduce_partials(const LargeBwdArgs& a, const AttnGeo& geo, int nchunks, bool grid,
                           cudaStream_t s) {
  const int n_win = geo.B * geo.nwh * geo.nww;
  attn_dscale_reduce_kernel<<<(geo.heads + 31) / 32, 32, 0, s>>>(
      static_cast<const float*>(a.dscale_part), n_win * nchunks, geo.heads,
      static_cast<const float*>(a.scale), grid ? 1 : 0, static_cast<float*>(a.dscale));
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0 || a.bias == nullptr) return code;
  const long long n_bias = static_cast<long long>(geo.heads) * geo.L * geo.L;
  dbias_reduce_kernel<<<static_cast<unsigned>((n_bias + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(a.dbias_part), n_win, geo.heads, geo.L, geo.LP,
      static_cast<float*>(a.dbias));
  return static_cast<int>(cudaGetLastError());
}

// K9's prepass: the scratch copies qn16, kn16 and the norms inv [2, Bw *
// heads * L] (q's rows, then k's)
template <int HD>
int normalize_qk(const void* q, const void* k, void* qn, void* kn, void* inv, const AttnGeo& g,
              cudaStream_t s) {
  const long long rows = static_cast<long long>(g.B) * g.nwh * g.nww * g.heads * g.L;
  normalize_kernel<HD><<<static_cast<unsigned>((2 * rows + 7) / 8), 256, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<bf16*>(qn),
      static_cast<bf16*>(kn), static_cast<float*>(inv), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swin_qkv_attn_large
