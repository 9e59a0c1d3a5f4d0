// K8: window attention on the NHWC grid, the forward, hand-written for Hopper
// (sm_90a), with its CPB-bias instance (the backward at every head dim and L
// is window_attention_grid_large.cu's).
//
// Replaces swin_v2_weather_tpu/ops/window_attention.py:_make_grid_kernel (the
// forward, launched by _grid_forward), the kernel behind
// fused_window_attention_grid (attn_impl 'pallas'), with and without the raw
// CPB bias.
//
// Bound on this card: bytes. At the flagship shape (qn, kn, v [1, 180, 360,
// 768] bf16, 8 heads of 96, window 9 x 18) the forward moves 4 x 99.5 MB for
// 32.3 GFLOP (0.119 ms at 3.35 TB/s against 0.033 ms at 989 TFLOP/s).
//
// Design (the template in qkv_attention.cuh, layout GRID): at head dims
// 32-256 and any L, the forward runs blocks of up to 4 query-row tiles of one
// (window, head) (two warps a tile), windows the grid by a table of token
// pixels and reads each of q, k and v with its own pixel stride, so the
// model's channel slices of the qkv tensor are read in place; k and v stream
// through a cp.async ring, the scores stay in mma registers (z kept there
// whole up to L = 192), and two sweeps over the keys replace three sweeps
// and a p row buffer.

#include "qkv_attention.cuh"

using namespace swin_qkv_attn;

// The forward: q, k, v [B, H, W, *] bf16 with pixel strides ldq, ldk, ldv
// (channels contiguous), scale [heads] fp32, bias [heads, L, L] fp32 (the BIAS
// instance) or null, mask [L, L] fp32 or null, gated by bflag on the last
// window row -> out [B, H, W, C] bf16.
extern "C" int swin_window_attention_grid_fwd(const void* q, const void* k, const void* v,
                                              const void* scale, const void* bias,
                                              const void* mask, float bflag, void* out, int B,
                                              int H, int W, int C, int heads, int wh, int ww,
                                              int ldq, int ldk, int ldv, void* stream) {
  AttnGeo g;
  if (!grid_geo(g, B, H, W, C, heads, wh, ww, ldq, ldk, ldv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_fwd<GRID>(C / heads, FwdArgs{q, k, v, scale, bias, mask, bflag, out}, g,
                            stream);
}

// The forward's launch at head dim hd and window length L (bias: the BIAS
// instance), into info[7]: threads a block, dynamic shared memory, registers,
// local (spill) bytes a thread, resident blocks per SM, blocks per (window,
// head), 1 where it is the z-in-registers path.
extern "C" int swin_window_attention_grid_fwd_info(int hd, int bias, int L, void* info) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_fwd_info<GRID>(hd, bias != 0, L, static_cast<int*>(info));
}
