// K9: window attention on windowed [Bw, heads, L, D] tensors, the forward,
// hand-written for Hopper (sm_90a), with its CPB-bias instance (the backward
// at every head dim is window_attention_v1_large.cu's).
//
// Replaces swin_v2_weather_tpu/ops/window_attention.py:_make_kernel (the
// forward, launched by _pallas_forward), the kernel behind
// fused_window_attention (attn_impl 'pallas_v1'), with and without the raw
// CPB bias.
//
// Bound on this card: bytes. At the flagship shape (q, k, v [400, 8, 162, 96]
// bf16) the forward moves 4 x 99.5 MB for 32.3 GFLOP (0.119 ms at 3.35 TB/s).
//
// Design (the templates in qkv_attention.cuh, layout WINDOWED): the forward,
// at head dims 32-256 and any L, streams the contiguous [L, D] slabs of k and
// v through a cp.async ring past blocks of up to 4 query-row tiles, and
// normalizes q once and each k tile as it lands, in shared memory (no qn or
// kn in device memory); the scores stay in mma registers over two key
// sweeps, and p = e / sum e is the correctly rounded quotient.

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
