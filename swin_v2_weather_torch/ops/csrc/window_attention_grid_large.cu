// K8's backward at large head dims and at any L: window attention on the NHWC
// grid at head dims 128 and 256 (L <= 256), and the chunked form at every head
// dim and any L, hand-written for Hopper (sm_90a), each with its CPB-bias
// instance (the forward at every head dim is window_attention_grid.cu's).
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
// Design: the templates of qkv_attention_large.cuh, layout GRID (keys streamed
// through a two-stage ring in whole sweeps, split into a rows and a columns
// kernel joined by per-row statistics). Shared memory: 194,576 / 218,112 B at
// head dim 256, L = 162; the chunked form's does not depend on L.

#include "qkv_attention_large.cuh"

using namespace swin_qkv_attn;
using namespace swin_qkv_attn_large;

namespace {

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
  return dispatch_large_bwd<GRID, CHUNKED>(
      C / heads,
      LargeBwdArgs{q, k, v, scale, bias, mask, bflag, g, nullptr, nullptr, nullptr, dq, dk, dv,
                   rstat, dscale_part, dbias_part, dscale, dbias},
      geo, static_cast<cudaStream_t>(stream));
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
