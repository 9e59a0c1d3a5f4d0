// K9: window attention on windowed [Bw, heads, L, D] tensors, forward and
// backward, hand-written for Hopper (sm_90a), with its CPB-bias instance.
//
// Replaces swin_v2_weather_tpu/ops/window_attention.py:_make_kernel (the
// forward, launched by _pallas_forward) and _make_v1_bwd_kernel (the backward,
// _v1_backward), the kernels behind fused_window_attention (attn_impl
// 'pallas_v1'), with and without the raw CPB bias.
//
// Bound on this card: bytes. At the flagship shape (q, k, v [400, 8, 162, 96]
// bf16) the forward moves 4 x 99.5 MB for 32.3 GFLOP (0.119 ms at 3.35 TB/s),
// the backward 7 x 99.5 MB for 80.6 GFLOP (0.208 ms).
//
// Design (the templates in qkv_attention.cuh, layout WINDOWED): the forward,
// at head dims 32-256 and any L, streams the contiguous [L, D] slabs of k and
// v through a cp.async ring past blocks of up to 4 query-row tiles, and
// normalizes q once and each k tile as it lands, in shared memory (no qn or
// kn in device memory); the scores stay in mma registers over two key
// sweeps, and p = e / sum e is the correctly rounded quotient.
// The backward keeps one block per (window, head): it normalizes q and k rows
// in shared memory (and recomputes the fp32 qn, kn from the inputs for the
// normalization VJP), keeps the scores on chip and sums the per-(window,
// head) d(scale) and d(bias) partials in window order. The TPU kernel pads L
// from 162 to 176 for its sublane tiling; here the backward's tile height LP
// is L rounded up to 16 (176 too), padded rows zero-filled and masked.

#include "qkv_attention.cuh"

using namespace swin_qkv_attn;

// The forward: q, k, v [B * nwh * nww, heads, L, hd] bf16 contiguous, windows
// in h-major order; scale [heads] fp32; bias [heads, L, L] fp32 (the BIAS
// instance) or null; mask [L, L] fp32 or null, added on the last window row ->
// out [Bw, heads, L, hd] bf16.
extern "C" int swin_window_attention_v1_fwd(const void* q, const void* k, const void* v,
                                            const void* scale, const void* bias,
                                            const void* mask, void* out, int B, int nwh,
                                            int nww, int heads, int hd, int L, void* stream) {
  AttnGeo g;
  if (!windowed_geo(g, B, nwh, nww, heads, hd, L)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_fwd<WINDOWED>(hd, FwdArgs{q, k, v, scale, bias, mask, 1.0f, out}, g, stream);
}

// The forward's launch at head dim hd and window length L: the operands of
// swin_window_attention_grid_fwd_info.
extern "C" int swin_window_attention_v1_fwd_info(int hd, int bias, int L, void* info) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_fwd_info<WINDOWED>(hd, bias != 0, L, static_cast<int*>(info));
}

// The backward: the forward's operands and g [Bw, heads, L, hd] bf16 -> dq, dk,
// dv [Bw, heads, L, hd] bf16 (the normalization VJP included), dscale [heads]
// fp32 and, with the bias, dbias [heads, L, L] fp32. Workspaces: dscale_part
// [Bw, heads] fp32 and, with the bias, dbias_part [Bw, heads, LP, LP] fp32.
extern "C" int swin_window_attention_v1_bwd(const void* q, const void* k, const void* v,
                                            const void* scale, const void* bias,
                                            const void* mask, const void* g, void* dq, void* dk,
                                            void* dv, void* dscale_part, void* dbias_part,
                                            void* dscale, void* dbias, int B, int nwh, int nww,
                                            int heads, int hd, int L, void* stream) {
  AttnGeo geo;
  if (!windowed_geo(geo, B, nwh, nww, heads, hd, L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_bwd<WINDOWED>(
      hd,
      BwdArgs{q, k, v, scale, bias, mask, 1.0f, g, dq, dk, dv, dscale_part, dbias_part, dscale,
              dbias},
      geo, stream);
}
