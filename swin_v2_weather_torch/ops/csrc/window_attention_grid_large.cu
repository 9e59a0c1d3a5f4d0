// K8 at large head dims: window attention on the NHWC grid, forward and
// backward at head dims 128 and 256, hand-written for Hopper (sm_90a), with its
// CPB-bias instance (at L = 162 the forward at 128 keeps the one-block kernel).
//
// Replaces swin_v2_weather_tpu/ops/window_attention.py:_make_grid_kernel (the
// forward, launched by _grid_forward) and _make_grid_bwd_kernel (the backward,
// _grid_backward), behind fused_window_attention_grid (attn_impl 'pallas'),
// where the one-block instances of window_attention_grid.cu do not fit shared
// memory (the e2048 family: 8 heads of 256 at L = 162).
//
// Bound on this card: bytes. At the e2048 shape (qn, kn, v [1, 180, 360, 2048]
// bf16, 265.4 MB each) the forward moves 4 tensors (0.317 ms at 3.35 TB/s),
// the backward 7 (0.555 ms), against 86 and 215 GFLOP.
//
// Design: the templates of qkv_attention_large.cuh, layout GRID (keys streamed
// through a two-stage ring in whole sweeps; the backward split into a rows
// and a columns kernel joined by per-row statistics). Shared memory: 185,856 B
// forward, 194,576 / 218,112 B backward at head dim 256, L = 162.

#include "qkv_attention_large.cuh"

using namespace swin_qkv_attn;
using namespace swin_qkv_attn_large;

// The forward at head dims 128 and 256: the operands of swin_window_attention_grid_fwd.
extern "C" int swin_window_attention_grid_large_fwd(const void* q, const void* k, const void* v,
                                                    const void* scale, const void* bias,
                                                    const void* mask, float bflag, void* out,
                                                    int B, int H, int W, int C, int heads, int wh,
                                                    int ww, int ldq, int ldk, int ldv,
                                                    void* stream) {
  AttnGeo g;
  if (!grid_geo(g, B, H, W, C, heads, wh, ww, ldq, ldk, ldv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_large_fwd<GRID>(C / heads, FwdArgs{q, k, v, scale, bias, mask, bflag, out}, g,
                                  static_cast<cudaStream_t>(stream));
}

// The backward at head dims 128 and 256: the operands and outputs of
// swin_window_attention_grid_bwd. Workspaces: rstat [B * nW, heads, LP, 3]
// fp32 (row max, 1 / sum e, u), dscale_part [B * nW * ceil(LP / 64), heads]
// fp32 and, with the bias, dbias_part [B * nW, heads, LP, LP] fp32.
extern "C" int swin_window_attention_grid_large_bwd(
    const void* q, const void* k, const void* v, const void* scale, const void* bias,
    const void* mask, float bflag, const void* g, void* dq, void* dk, void* dv, void* rstat,
    void* dscale_part, void* dbias_part, void* dscale, void* dbias, int B, int H, int W, int C,
    int heads, int wh, int ww, int ldq, int ldk, int ldv, void* stream) {
  AttnGeo geo;
  if (!grid_geo(geo, B, H, W, C, heads, wh, ww, ldq, ldk, ldv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_large_bwd<GRID>(
      C / heads,
      LargeBwdArgs{q, k, v, scale, bias, mask, bflag, g, nullptr, nullptr, nullptr, dq, dk, dv,
                   rstat, dscale_part, dbias_part, dscale, dbias},
      geo, static_cast<cudaStream_t>(stream));
}
