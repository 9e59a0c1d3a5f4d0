// K8's backward at every head dim and L: window attention on the NHWC grid,
// the streamed kernels, hand-written for Hopper (sm_90a), with its CPB-bias
// instance (the forward at every head dim is window_attention_grid.cu's).
//
// Replaces swin_v2_weather_tpu/ops/window_attention.py:_make_grid_bwd_kernel
// (the backward, _grid_backward), behind fused_window_attention_grid
// (attn_impl 'pallas'): the flagship's head dim 96 at L = 162 (the grid
// train steps), head dims 32-256 and every L, beyond 256 too.
//
// Bound on this card: bytes. At the flagship shape (qn, kn, v [1, 180, 360,
// 768] bf16, 8 heads of 96, window 9 x 18) the backward moves 7 x 99.5 MB
// (0.208 ms at 3.35 TB/s) for 80.6 GFLOP; at the e2048 shape (head dim 256,
// [1, 180, 360, 2048], 265.4 MB a tensor) 7 tensors (0.555 ms) for 215
// GFLOP.
//
// Design: the streamed kernels of streamed_bwd.cuh, form FORM_GRID (K8's
// row-max-subtracting softmax; dqn and dkn returned, the normalization VJP
// outside): a rows kernel (the row max, the sum and u, then ds, d(bias) and
// dqn) and a columns kernel (dv, dkn), 8 warps a block, every score tile in
// mma registers, keys or queries streamed through a three-stage cp.async
// ring (two blocks an SM at head dims up to 96, one above); then the
// d(scale) and d(bias) partials summed in order (qkv_attention_large.cuh).
// Nothing in shared memory grows with L but the token table and the row
// statistics, so one design takes every L.

#include "qkv_attention_large.cuh"
#include "streamed_bwd.cuh"

using namespace swin_qkv_attn;
using namespace swin_qkv_attn_large;

namespace {

namespace sb = swin_streamed_bwd;

// the streamed backward at head dim HD, bias-free or BIAS
template <int HD>
int streamed(const LargeBwdArgs& a, const AttnGeo& geo, cudaStream_t s) {
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

template <int HD>
int streamed_info(bool bias, int L, int* info) {
  const sb::Geo g{1, 0, 0, 1, 0, 0, 1, 1, L, (L + 15) / 16 * 16, L, L, 0};
  return bias ? sb::launch_info<HD, sb::FORM_GRID, true, false>(g, info)
              : sb::launch_info<HD, sb::FORM_GRID, false, false>(g, info);
}

}  // namespace

// The backward: the forward's operands (swin_window_attention_grid_fwd) and
// g [B, H, W, C] bf16 contiguous -> dq, dk, dv [B, H, W, C] bf16 (dqn and
// dkn: the normalization VJP is the caller's), dscale [heads] fp32 and, with
// the bias, dbias [heads, L, L] fp32. Workspaces: rstat [B * nW, heads, LP,
// 3] fp32 (row max, 1 / sum e, u), dscale_part [B * nW * ceil(LP / 64),
// heads] fp32 and, with the bias, dbias_part [B * nW, heads, LP, LP] fp32.
extern "C" int swin_window_attention_grid_streamed_bwd(
    const void* q, const void* k, const void* v, const void* scale, const void* bias,
    const void* mask, float bflag, const void* g, void* dq, void* dk, void* dv, void* rstat,
    void* dscale_part, void* dbias_part, void* dscale, void* dbias, int B, int H, int W, int C,
    int heads, int wh, int ww, int ldq, int ldk, int ldv, void* stream) {
  AttnGeo geo;
  if (!grid_geo(geo, B, H, W, C, heads, wh, ww, ldq, ldk, ldv) ||
      (bias != nullptr && (dbias_part == nullptr || dbias == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LargeBwdArgs args{q, k, v, scale, bias, mask, bflag, g, nullptr, nullptr, nullptr, dq, dk,
                          dv, rstat, dscale_part, dbias_part, dscale, dbias};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / heads) {
    case 32:
      return streamed<32>(args, geo, s);
    case 64:
      return streamed<64>(args, geo, s);
    case 96:
      return streamed<96>(args, geo, s);
    case 128:
      return streamed<128>(args, geo, s);
    case 256:
      return streamed<256>(args, geo, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward's launch at head dim hd and window length L, into info[0..9]:
// threads a block, blocks per (window, head), then the rows and the columns
// kernel's dynamic shared memory, registers a thread, local (spill) bytes a
// thread and resident blocks per SM.
extern "C" int swin_window_attention_grid_streamed_bwd_info(int hd, int bias, int L, void* info) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  int* out = static_cast<int*>(info);
  switch (hd) {
    case 32:
      return streamed_info<32>(bias != 0, L, out);
    case 64:
      return streamed_info<64>(bias != 0, L, out);
    case 96:
      return streamed_info<96>(bias != 0, L, out);
    case 128:
      return streamed_info<128>(bias != 0, L, out);
    case 256:
      return streamed_info<256>(bias != 0, L, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
