// K8's backward at large head dims and at any L: window attention on the NHWC
// grid at head dims 128 and 256 (L <= 256; the streamed kernels), and the
// chunked form at every head dim and any L, hand-written for Hopper
// (sm_90a), each with its CPB-bias instance (the forward at every head dim
// is window_attention_grid.cu's).
//
// Replaces swin_v2_weather_tpu/ops/window_attention.py:_make_grid_bwd_kernel
// (the backward, _grid_backward), behind fused_window_attention_grid
// (attn_impl 'pallas'), where the one-block backward of
// window_attention_grid.cu does not fit shared memory (head dim 128 at
// L = 162, and the e2048 family: 8 heads of 256) and, in the chunked form,
// where no other instance fits (every L above 256, and below it head dim 256
// from L = 225 and head dims 32-96 where the one-block instance does not fit).
//
// Bound on this card: bytes. At the e2048 shape (qn, kn, v [1, 180, 360, 2048]
// bf16, 265.4 MB each) the backward moves 7 tensors (0.555 ms at 3.35 TB/s)
// for 215 GFLOP.
//
// Design: at head dims 128 and 256 (L <= 256) the streamed kernels of
// streamed_bwd.cuh, form FORM_GRID (K8's row-max-subtracting softmax; dqn
// and dkn returned, the normalization VJP outside): a rows kernel (the row
// max, the sum and u, then ds, d(bias) and dqn) and a columns kernel (dv,
// dkn), 8 warps a block, every score tile in mma registers, keys or queries
// streamed through a three-stage cp.async ring; then the d(scale) and
// d(bias) partials summed in order (qkv_attention_large.cuh). The chunked
// form is qkv_attention_large.cuh's, layout GRID.

#include "qkv_attention_large.cuh"
#include "streamed_bwd.cuh"

using namespace swin_qkv_attn;
using namespace swin_qkv_attn_large;

namespace {

// the streamed backward at head dim HD, bias-free or BIAS
template <int HD>
int streamed(const LargeBwdArgs& a, const AttnGeo& geo, cudaStream_t s) {
  namespace sb = swin_streamed_bwd;
  const sb::Geo sg{geo.B, geo.H, geo.W, geo.heads, geo.wh, geo.ww, geo.nwh, geo.nww,
                   geo.L, geo.LP, geo.L, geo.L, 0};
  const sb::Args sa{static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                    static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
                    geo.ldq, geo.ldk, geo.ldv, geo.ldo,
                    static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
                    geo.ldo, static_cast<const float*>(a.scale), static_cast<const float*>(a.bias),
                    static_cast<const float*>(a.mask), a.bflag, nullptr,
                    static_cast<float*>(a.rstat), static_cast<float*>(a.dscale_part),
                    static_cast<float*>(a.dbias_part)};
  const int code = a.bias != nullptr ? sb::launch<HD, sb::FORM_GRID, true, false>(sa, sg, s)
                                     : sb::launch<HD, sb::FORM_GRID, false, false>(sa, sg, s);
  if (code != 0) return code;
  return reduce_partials(a, geo, sb::plan_of(geo.LP).nchunk, true, s);
}

template <bool CHUNKED>
int grid_bwd(const void* q, const void* k, const void* v, const void* scale, const void* bias,
             const void* mask, float bflag, const void* g, void* dq, void* dk, void* dv,
             void* rstat, void* dscale_part, void* dbias_part, void* dscale, void* dbias, int B,
             int H, int W, int C, int heads, int wh, int ww, int ldq, int ldk, int ldv,
             void* stream) {
  AttnGeo geo;
  if (!grid_geo(geo, B, H, W, C, heads, wh, ww, ldq, ldk, ldv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LargeBwdArgs args{q, k, v, scale, bias, mask, bflag, g, nullptr, nullptr, nullptr, dq, dk,
                          dv, rstat, dscale_part, dbias_part, dscale, dbias};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (!CHUNKED) {
    if (geo.LP > MAX_LP || (bias != nullptr && (dbias_part == nullptr || dbias == nullptr))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    switch (C / heads) {
      case 128:
        return streamed<128>(args, geo, s);
      case 256:
        return streamed<256>(args, geo, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return dispatch_chunked_bwd<GRID>(C / heads, args, geo, s);
  }
}

}  // namespace

// The backward at head dims 128 and 256: the operands and outputs of
// swin_window_attention_grid_bwd. Workspaces: rstat [B * nW, heads, LP, 3]
// fp32 (row max, 1 / sum e, u), dscale_part [B * nW * ceil(LP / 64), heads]
// fp32 and, with the bias, dbias_part [B * nW, heads, LP, LP] fp32.
extern "C" int swin_window_attention_grid_large_bwd(
    const void* q, const void* k, const void* v, const void* scale, const void* bias,
    const void* mask, float bflag, const void* g, void* dq, void* dk, void* dv, void* rstat,
    void* dscale_part, void* dbias_part, void* dscale, void* dbias, int B, int H, int W, int C,
    int heads, int wh, int ww, int ldq, int ldk, int ldv, void* stream) {
  return grid_bwd<false>(q, k, v, scale, bias, mask, bflag, g, dq, dk, dv, rstat, dscale_part,
                         dbias_part, dscale, dbias, B, H, W, C, heads, wh, ww, ldq, ldk, ldv,
                         stream);
}

// The chunked backward (head dims 32-256, any L; shared memory independent
// of L): the operands, workspaces and outputs of the large-head one.
extern "C" int swin_window_attention_grid_chunked_bwd(
    const void* q, const void* k, const void* v, const void* scale, const void* bias,
    const void* mask, float bflag, const void* g, void* dq, void* dk, void* dv, void* rstat,
    void* dscale_part, void* dbias_part, void* dscale, void* dbias, int B, int H, int W, int C,
    int heads, int wh, int ww, int ldq, int ldk, int ldv, void* stream) {
  return grid_bwd<true>(q, k, v, scale, bias, mask, bflag, g, dq, dk, dv, rstat, dscale_part,
                        dbias_part, dscale, dbias, B, H, W, C, heads, wh, ww, ldq, ldk, ldv,
                        stream);
}
