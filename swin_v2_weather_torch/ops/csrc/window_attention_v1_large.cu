// K9's backward at large head dims and at any L: window attention on windowed
// [Bw, heads, L, D] tensors at head dims 128 and 256 (L <= 256), and the
// chunked form at every head dim and any L, hand-written for Hopper (sm_90a),
// each with its CPB-bias instance (the forward at every head dim is
// window_attention_v1.cu's).
//
// Replaces swin_v2_weather_tpu/ops/window_attention.py:_make_v1_bwd_kernel
// (the backward, _v1_backward), behind fused_window_attention (attn_impl
// 'pallas_v1'), where the one-block backward of window_attention_v1.cu does
// not fit shared memory (head dim 128 at L = 162, and the e2048 family: 8
// heads of 256) and, in the chunked form, where no other instance fits
// (every L above 256, and below it head dim 256 from L = 225 and head dims
// 32-96 where the one-block instance does not fit).
//
// Bound on this card: bytes. At the e2048 shape (q, k, v [400, 8, 162, 256]
// bf16, 265.4 MB each) the backward moves 7 tensors (0.555 ms at 3.35 TB/s)
// for 215 GFLOP.
//
// Design: the templates of qkv_attention_large.cuh, layout WINDOWED. A first
// kernel writes the normalized qn16, kn16 (and the fp32 norms) to scratch
// buffers, as the one-block kernels normalize in shared memory; the rows and
// columns kernels stream those, and the normalization VJP re-reads the raw q
// and k rows for the fp32 qn and kn.

#include "qkv_attention_large.cuh"

using namespace swin_qkv_attn;
using namespace swin_qkv_attn_large;

namespace {

int normalize_dispatch(int hd, const void* q, const void* k, void* qn, void* kn, void* inv,
                       const AttnGeo& g, cudaStream_t s) {
  switch (hd) {
    case 32:
      return normalize_qk<32>(q, k, qn, kn, inv, g, s);
    case 64:
      return normalize_qk<64>(q, k, qn, kn, inv, g, s);
    case 96:
      return normalize_qk<96>(q, k, qn, kn, inv, g, s);
    case 128:
      return normalize_qk<128>(q, k, qn, kn, inv, g, s);
    case 256:
      return normalize_qk<256>(q, k, qn, kn, inv, g, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool CHUNKED>
int v1_bwd(const void* q, const void* k, const void* v, const void* scale, const void* bias,
           const void* mask, const void* g, void* dq, void* dk, void* dv, void* qn, void* kn,
           void* inv, void* rstat, void* dscale_part, void* dbias_part, void* dscale,
           void* dbias, int B, int nwh, int nww, int heads, int hd, int L, void* stream) {
  AttnGeo geo;
  if (!windowed_geo(geo, B, nwh, nww, heads, hd, L) || (!CHUNKED && hd != 128 && hd != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = normalize_dispatch(hd, q, k, qn, kn, inv, geo, s);
  if (code != 0) return code;
  return dispatch_large_bwd<WINDOWED, CHUNKED>(
      hd,
      LargeBwdArgs{qn, kn, v, scale, bias, mask, 1.0f, g, q, k, inv, dq, dk, dv, rstat,
                   dscale_part, dbias_part, dscale, dbias},
      geo, s);
}

}  // namespace

// The backward at head dims 128 and 256: the operands and outputs of
// swin_window_attention_v1_bwd; scratch qn, kn [Bw, heads, L, hd] bf16, inv
// [2, Bw, heads, L] fp32, rstat [Bw, heads, LP, 3] fp32 (row max, sum e, u),
// dscale_part [Bw * ceil(LP / 64), heads] and, with the bias, dbias_part
// [Bw, heads, LP, LP] fp32.
extern "C" int swin_window_attention_v1_large_bwd(
    const void* q, const void* k, const void* v, const void* scale, const void* bias,
    const void* mask, const void* g, void* dq, void* dk, void* dv, void* qn, void* kn, void* inv,
    void* rstat, void* dscale_part, void* dbias_part, void* dscale, void* dbias, int B, int nwh,
    int nww, int heads, int hd, int L, void* stream) {
  return v1_bwd<false>(q, k, v, scale, bias, mask, g, dq, dk, dv, qn, kn, inv, rstat,
                       dscale_part, dbias_part, dscale, dbias, B, nwh, nww, heads, hd, L, stream);
}

// The chunked backward (head dims 32-256, any L; shared memory independent
// of L): the operands, scratch and outputs of the large-head one.
extern "C" int swin_window_attention_v1_chunked_bwd(
    const void* q, const void* k, const void* v, const void* scale, const void* bias,
    const void* mask, const void* g, void* dq, void* dk, void* dv, void* qn, void* kn, void* inv,
    void* rstat, void* dscale_part, void* dbias_part, void* dscale, void* dbias, int B, int nwh,
    int nww, int heads, int hd, int L, void* stream) {
  return v1_bwd<true>(q, k, v, scale, bias, mask, g, dq, dk, dv, qn, kn, inv, rstat, dscale_part,
                      dbias_part, dscale, dbias, B, nwh, nww, heads, hd, L, stream);
}
