// K9's backward at every head dim and L: window attention on windowed [Bw,
// heads, L, D] tensors, the streamed kernels at head dims 32-256 and any L,
// hand-written for Hopper (sm_90a), with its CPB-bias instance (the forward
// at every head dim is window_attention_v1.cu's).
//
// Replaces swin_v2_weather_tpu/ops/window_attention.py:_make_v1_bwd_kernel
// (the backward, _v1_backward), behind fused_window_attention (attn_impl
// 'pallas_v1'): the flagship's head dim 96, head dim 128, the e2048 family's
// 8 heads of 256, and every L, beyond 256 too.
//
// Bound on this card: bytes. At the e2048 shape (q, k, v [400, 8, 162, 256]
// bf16, 265.4 MB each) the backward moves 7 tensors (0.555 ms at 3.35 TB/s)
// for 215 GFLOP; at the flagship's (head dim 96) 7 x 99.5 MB (0.208 ms) for
// 80.6 GFLOP.
//
// Design: a prepass writes the normalized qn16, kn16 (and the fp32 norms) to
// scratch buffers (qkv_attention_large.cuh normalize_qk), as the K9 forward
// normalizes in shared memory; then the streamed kernels of
// streamed_bwd.cuh, form FORM_V1 (K9's row-max softmax with p = e / sum e,
// u = sum(dp p); the normalization VJP inside on the fp32 qn and kn from
// the raw rows; d(scale) = sum(ds s) taken in the columns kernel): a rows
// kernel (the row max, the sum, u, then ds, d(bias) and dq) and a columns
// kernel (dv, dk and the d(scale) partial), 8 warps a block, every score
// tile in mma registers, keys or queries streamed through a three-stage
// cp.async ring from the contiguous [L, D] slab of each (window, head);
// then the d(scale) and d(bias) partials summed in order. Past L = 192 the
// rows kernel recomputes z and dp in a sweep per statistic; nothing in
// shared memory grows with L but the columns kernel's row statistics.

#include "qkv_attention_large.cuh"
#include "streamed_bwd.cuh"

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

// the streamed backward at head dim HD, bias-free or BIAS, on the prepass's
// qn16, kn16 (a.q, a.k) and the raw rows (a.qraw, a.kraw)
template <int HD>
int streamed(const LargeBwdArgs& a, const AttnGeo& geo, cudaStream_t s) {
  namespace sb = swin_streamed_bwd;
  const sb::Geo sg{geo.B, 0, 0, geo.heads, 0, 0, geo.nwh, geo.nww, geo.L, geo.LP, geo.L, geo.L, 0};
  const sb::Args sa{static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                    static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
                    HD, HD, HD, HD,
                    static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
                    HD, static_cast<const float*>(a.scale), static_cast<const float*>(a.bias),
                    static_cast<const float*>(a.mask), 1.0f, static_cast<const float*>(a.inv),
                    static_cast<float*>(a.rstat), static_cast<float*>(a.dscale_part),
                    static_cast<float*>(a.dbias_part), static_cast<const bf16*>(a.qraw),
                    static_cast<const bf16*>(a.kraw)};
  const int code = a.bias != nullptr ? sb::launch<HD, sb::FORM_V1, true, false>(sa, sg, s)
                                     : sb::launch<HD, sb::FORM_V1, false, false>(sa, sg, s);
  if (code != 0) return code;
  return reduce_partials(a, geo, sb::plan_of(geo.LP).nchunk, false, s);
}

int dispatch_streamed(int hd, const LargeBwdArgs& a, const AttnGeo& g, cudaStream_t s) {
  if (a.bias != nullptr && (a.dbias_part == nullptr || a.dbias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (hd) {
    case 32:
      return streamed<32>(a, g, s);
    case 64:
      return streamed<64>(a, g, s);
    case 96:
      return streamed<96>(a, g, s);
    case 128:
      return streamed<128>(a, g, s);
    case 256:
      return streamed<256>(a, g, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int streamed_info(int hd, bool bias, int L, int* info) {
  namespace sb = swin_streamed_bwd;
  const sb::Geo g{1, 0, 0, 1, 0, 0, 1, 1, L, (L + 15) / 16 * 16, L, L, 0};
  switch (hd) {
    case 32:
      return bias ? sb::launch_info<32, sb::FORM_V1, true, false>(g, info)
                  : sb::launch_info<32, sb::FORM_V1, false, false>(g, info);
    case 64:
      return bias ? sb::launch_info<64, sb::FORM_V1, true, false>(g, info)
                  : sb::launch_info<64, sb::FORM_V1, false, false>(g, info);
    case 96:
      return bias ? sb::launch_info<96, sb::FORM_V1, true, false>(g, info)
                  : sb::launch_info<96, sb::FORM_V1, false, false>(g, info);
    case 128:
      return bias ? sb::launch_info<128, sb::FORM_V1, true, false>(g, info)
                  : sb::launch_info<128, sb::FORM_V1, false, false>(g, info);
    case 256:
      return bias ? sb::launch_info<256, sb::FORM_V1, true, false>(g, info)
                  : sb::launch_info<256, sb::FORM_V1, false, false>(g, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int v1_bwd(const void* q, const void* k, const void* v, const void* scale, const void* bias,
           const void* mask, const void* g, void* dq, void* dk, void* dv, void* qn, void* kn,
           void* inv, void* rstat, void* dscale_part, void* dbias_part, void* dscale,
           void* dbias, int B, int nwh, int nww, int heads, int hd, int L, void* stream) {
  AttnGeo geo;
  if (!windowed_geo(geo, B, nwh, nww, heads, hd, L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = normalize_dispatch(hd, q, k, qn, kn, inv, geo, s);
  if (code != 0) return code;
  const LargeBwdArgs args{qn, kn, v, scale, bias, mask, 1.0f, g, q, k, inv, dq, dk, dv, rstat,
                          dscale_part, dbias_part, dscale, dbias};
  return dispatch_streamed(hd, args, geo, s);
}

}  // namespace

// The streamed backward (head dims 32-256, any L): the forward's operands
// (swin_window_attention_v1_fwd) and g [Bw, heads, L, hd] bf16 -> dq, dk, dv
// [Bw, heads, L, hd] bf16 (the normalization VJP included), dscale [heads]
// fp32 and, with the bias, dbias [heads, L, L] fp32; scratch qn, kn [Bw, heads, L, hd]
// bf16, inv [2, Bw, heads, L] fp32 (q's norms, then k's), rstat [Bw, heads,
// LP, 3] fp32 (row max, sum e, u), dscale_part [Bw * ceil(LP / 64), heads]
// and, with the bias, dbias_part [Bw, heads, LP, LP] fp32.
extern "C" int swin_window_attention_v1_streamed_bwd(
    const void* q, const void* k, const void* v, const void* scale, const void* bias,
    const void* mask, const void* g, void* dq, void* dk, void* dv, void* qn, void* kn, void* inv,
    void* rstat, void* dscale_part, void* dbias_part, void* dscale, void* dbias, int B, int nwh,
    int nww, int heads, int hd, int L, void* stream) {
  return v1_bwd(q, k, v, scale, bias, mask, g, dq, dk, dv, qn, kn, inv, rstat, dscale_part,
                dbias_part, dscale, dbias, B, nwh, nww, heads, hd, L, stream);
}

// The streamed backward's launch at head dim hd and window length L, into
// info[0..9]: threads a block, blocks per (window, head), then the rows and
// the columns kernel's dynamic shared memory, registers a thread, local
// (spill) bytes a thread and resident blocks per SM.
extern "C" int swin_window_attention_v1_streamed_bwd_info(int hd, int bias, int L, void* info) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  return streamed_info(hd, bias != 0, L, static_cast<int*>(info));
}
