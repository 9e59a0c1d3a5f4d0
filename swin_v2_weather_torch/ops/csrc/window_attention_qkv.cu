// qkv-fused scaled-cosine window attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel swin_v2_weather_tpu/ops/window_attention.py:_make_qkv_kernel
// (the v3 forward, launched by _qkv_forward): the qkv projection, the windowing,
// per-head q/k L2 normalization, the max-free softmax of (s - 1) * scale (plus
// the shift mask on the last window row) and e @ v / rowsum, reading the
// activation in its NHWC grid layout and writing the result back into grid
// positions. Its BIAS instance (entry point swin_window_attention_qkv_bias_fwd,
// K7) replaces the same kernel with has_bias=True, reached through
// _build_qkv_bias: the logits become z = s * scale + badd[h][q][k], badd the
// pre-folded CPB term (row-max-shifted bias - scale, fp32 [heads, L, L], read
// from L2: 0.84 MB for every block). The shift keeps the max-free softmax
// rigorous: z <= 0 with one z = 0 in every row.
//
// What bounds it on this card: at the flagship shape (x [1, 180, 360, 768] bf16,
// 9 x 18 windows so L = 162, 8 heads of 96) the projection is a [64800, 768] x
// [768, 2304] product (229 GFLOP) and the attention two [162, 162, 96]
// products per (window, head) (32 GFLOP): tensor-core work, 0.265 ms at the
// bf16 peak. The [L, L] scores must never reach device memory (336 MB in fp32
// if they did).
//
// What the design does about it. The TPU kernel's one program per (window,
// head) recomputed that head's [L, 768] x [768, 288] projection in the block;
// on this card that was 3.68 of the 4.16 ms the previous one-block kernel took
// at the flagship shape on the H100 (PERF.md section 6), on wmma tiles
// with every head's block re-reading the window's x. So each call runs
//  1. the projection on the Hopper GEMM core (wgmma_gemm.cuh, through
//     swin_qkv_proj::project_normalized in qkv_projection.cuh), qkv =
//     bf16(x @ W + b) [T, 3C] into a scratch the wrapper allocates and drops
//     on return (0.28 GiB at the flagship shape; 299 MB written and read
//     back, 0.18 ms of HBM time against the product's 0.5-0.7 ms), with q and
//     k L2-normalized per head in the epilogue: the block width holds whole
//     heads (192 columns at head dim 96, 256 at 32, 64, 128 and 256), so a
//     head's columns of a row sit in one quad of lanes and its sum of squares
//     is a quad shuffle away;
//  2. the attention pass: an instance of the K8/K9 forward template
//     (qkv_attention.cuh, layouts QKV and QKV4) that reads q, k and v as
//     channel slices of the scratch through a per-block token table, keeps
//     the score tiles in mma registers and streams k and v through a
//     cp.async ring, so it takes head dims 32-256 and any L. K1's max-free
//     softmax forms each score and its e = exp(z) once: the row sum of e is
//     kept per lane, bf16(e) @ v accumulated with no rescaling, and out =
//     acc * (1 / sum e) at the end.
// Where the normalization sits: inside the pass (K9's way) every row-chunk
// block of a (window, head) normalizes all the keys again, and that took
// 0.30 of the 1.40 ms K1 spent at the flagship shape on the H100 (0.82 of
// 5.62 at head dim 256; PERF.md section 6), against 0.09 of 4.16 for the
// old kernel's single normalization; in the projection's epilogue each row
// is normalized once, on values still in registers.
//
// Rounding sites (the TPU kernel's contract): qkv = bf16(bf16(x) @ bf16(W) + b)
// with fp32 accumulation; q16 = bf16(q * (1 / sqrt(max(sum q^2, 1e-24)))), same
// for k; s = q16 @ k16^T in fp32; z = (s - 1) * scale[h] (+ flag * mask on the
// last window row), with the bias z = fl(s * scale[h]) + badd[h][q][k] (+ the
// mask); e = exp(z); out = (bf16(e) @ v16 in fp32) * (1 / sum e). Only the
// order of the fp32 sums differs from a plain row sum: sum q^2 per lane over
// its columns of the head, then the quad; sum e per lane in key order, then
// the quad, then the warp pair; e @ v by key step.
//
// K10 (entry point swin_window_attention_qkv_padded_fwd) replaces the v6 TPU
// kernel swin_v2_weather_tpu/ops/window_attention.py:_make_qkv6_kernel
// (launched by _qkv6_forward, reached through fused_window_attention_qkv_padded):
// v3's math on weights whose per-head columns are zero-padded to 128 lanes,
// [C_in, 3 * heads * 128], writing [B, H, W, heads * 128] with the pad lanes
// exactly zero. On this card a head dim of 96 is already a legal MMA width, so
// K10 is K1 with a head pitch of 128: the projection runs over the padded
// columns, the pass reads the HD live columns of each head and writes exact
// zeros in the pad lanes.
//
// K12 (entry points swin_window_attention_qkv5_fwd and _qkv4_fwd) replaces the
// v5 and v4 TPU kernels of swin_v2_weather_tpu/ops/attic/window_attention_v45.py
// (_make_qkv5_kernel, launched by _qkv5_forward; _make_qkv4_kernel, launched by
// _qkv4_forward), reached through fused_window_attention_qkv(impl='v5'/'v4'):
//   * v5 reads each (role, head) slab of the weight reordered to [3 * heads,
//     C_in, hd] as one dense product on the core (the TPU kernel's point: no
//     misaligned lane slices of a packed slab), in the packed product's K
//     order, and runs v3's pass: its output equals K1's bit for bit.
//   * v4 reads the window-major rows [B, nW, lm, C_in] (lm = L rounded up to
//     8) that the wrapper prepares, as JAX prepares them outside its kernel,
//     and writes all lm rows of [B, nW, lm, C] (the pad query rows attend to
//     the real keys, unmasked; the caller throws them away). Its softmax rounds
//     p16 = bf16(e * (1 / sum e)) before p16 @ v, so its pass (layout QKV4)
//     sweeps the keys twice: up to L = 192 each warp keeps e of its keys in
//     registers and the second sweep streams only v; beyond that the second
//     sweep reloads k. Its padded-head form (QKV_PAD_HEADS) has head pitch
//     128, as K10 is K1's.
//
// Contract (checked by the Python wrapper): x [B, H, W, C_in] bf16, W [C_in, 3C]
// bf16, both contiguous; b [3C] fp32; scale [heads] fp32; mask [L, L] fp32 or
// null; bias [heads, L, L] fp32 (BIAS only); qkv [T, 3C] bf16 scratch; C_in % 8
// == 0; head dim in {32, 64, 96, 128, 256} (the padded forms 32-128); H % wh ==
// W % ww == 0; any L.

#include "qkv_attention.cuh"
#include "qkv_projection.cuh"

namespace {

using namespace swin_qkv_attn;

// The attention pass of layout LAYOUT (QKV or QKV4) at head dim hd, head pitch
// hd or (PAD) 128.
template <int LAYOUT, bool BIAS, bool PAD>
int dispatch_pass(int hd, const FwdArgs& a, const AttnGeo& g, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch_fwd<32, LAYOUT, BIAS, PAD ? 128 : 32>(a, g, s);
    case 64:
      return launch_fwd<64, LAYOUT, BIAS, PAD ? 128 : 64>(a, g, s);
    case 96:
      return launch_fwd<96, LAYOUT, BIAS, PAD ? 128 : 96>(a, g, s);
    case 128:
      return launch_fwd<128, LAYOUT, BIAS, 128>(a, g, s);
    case 256:
      if constexpr (!PAD) return launch_fwd<256, LAYOUT, BIAS, 256>(a, g, s);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The pass's launch shape at window length L (lq query rows), as
// fwd_info_as reports it.
template <int LAYOUT, bool BIAS, bool PAD>
int dispatch_info(int hd, int L, int lq, int* info) {
  switch (hd) {
    case 32:
      return fwd_info<32, LAYOUT, BIAS, PAD ? 128 : 32>(L, lq, info);
    case 64:
      return fwd_info<64, LAYOUT, BIAS, PAD ? 128 : 64>(L, lq, info);
    case 96:
      return fwd_info<96, LAYOUT, BIAS, PAD ? 128 : 96>(L, lq, info);
    case 128:
      return fwd_info<128, LAYOUT, BIAS, 128>(L, lq, info);
    case 256:
      if constexpr (!PAD) return fwd_info<256, LAYOUT, BIAS, 256>(L, lq, info);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The whole forward of every variant: the projection on the GEMM core into
// the qkv scratch [T, 3C], q and k normalized in its epilogue (slab_hd: v5's
// reordered weight, one product a slab), then the attention pass reading its
// q, k, v slices. The token rows are the grid's B * H * W pixels (QKV) or
// v4's B * nW * lq window-major rows (QKV4). C = heads * hd, or heads * 128
// (PAD).
template <int LAYOUT, bool BIAS, bool PAD>
int forward(const void* x, const void* w, const void* b, const void* scale, const void* bias,
            const void* mask, float bflag, void* qkv, void* out, int B, int nwh, int nww, int lq,
            int Cin, int heads, int hd, int wh, int ww, int slab_hd, void* stream) {
  const int C = heads * (PAD ? 128 : hd);
  const int L = wh * ww;
  AttnGeo g;
  if (B < 1 || wh < 1 || ww < 1 || Cin < 8 || Cin % 8 != 0 || (BIAS && bias == nullptr) ||
      !make_attn_geo(g, B, nwh * wh, nww * ww, heads, wh, ww, L, nwh, nww, 3 * C, 3 * C, 3 * C,
                     C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g.lq = lq;
  const long long T = LAYOUT == QKV4 ? static_cast<long long>(B) * nwh * nww * lq
                                     : static_cast<long long>(B) * nwh * wh * nww * ww;
  if (T > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qkv16 = static_cast<const bf16*>(qkv);
  int code = swin_qkv_proj::project_normalized(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(b),
      static_cast<bf16*>(qkv), static_cast<int>(T), Cin, 3 * C, PAD ? 128 : hd, slab_hd, s);
  if (code != 0) return code;
  const FwdArgs a{qkv16, qkv16 + C, qkv16 + 2 * C, scale, bias, mask, bflag, out};
  return dispatch_pass<LAYOUT, BIAS, PAD>(hd, a, g, s);
}

}  // namespace

// K1: the bias-free forward. qkv: the [B, H, W, 3C] bf16 scratch.
extern "C" int swin_window_attention_qkv_fwd(const void* x, const void* w, const void* b,
                                             const void* scale, const void* mask, float bflag,
                                             void* qkv, void* out, int B, int H, int W, int Cin,
                                             int C, int heads, int wh, int ww, void* stream) {
  if (heads < 1 || C % heads != 0 || wh < 1 || ww < 1 || H % wh != 0 || W % ww != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return forward<QKV, false, false>(x, w, b, scale, nullptr, mask, bflag, qkv, out, B, H / wh,
                                    W / ww, wh * ww, Cin, heads, C / heads, wh, ww, 0, stream);
}

// K7: the forward with the pre-folded CPB term bias [heads, L, L] fp32.
extern "C" int swin_window_attention_qkv_bias_fwd(const void* x, const void* w, const void* b,
                                                  const void* scale, const void* bias,
                                                  const void* mask, float bflag, void* qkv,
                                                  void* out, int B, int H, int W, int Cin, int C,
                                                  int heads, int wh, int ww, void* stream) {
  if (heads < 1 || C % heads != 0 || wh < 1 || ww < 1 || H % wh != 0 || W % ww != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return forward<QKV, true, false>(x, w, b, scale, bias, mask, bflag, qkv, out, B, H / wh,
                                   W / ww, wh * ww, Cin, heads, C / heads, wh, ww, 0, stream);
}

// K10: the v6 forward on head-padded weights W [C_in, 3 * heads * 128], b
// [3 * heads * 128]; qkv [B, H, W, 3 * heads * 128]; out [B, H, W, heads *
// 128], pad lanes zero; hd the live head dim (32, 64, 96, or 128, which is
// K1's instance).
extern "C" int swin_window_attention_qkv_padded_fwd(const void* x, const void* w, const void* b,
                                                    const void* scale, const void* mask,
                                                    float bflag, void* qkv, void* out, int B,
                                                    int H, int W, int Cin, int heads, int hd,
                                                    int wh, int ww, void* stream) {
  if (wh < 1 || ww < 1 || H % wh != 0 || W % ww != 0 || hd > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return forward<QKV, false, true>(x, w, b, scale, nullptr, mask, bflag, qkv, out, B, H / wh,
                                   W / ww, wh * ww, Cin, heads, hd, wh, ww, 0, stream);
}

// K12 v5: K1 on the reordered weight w5 [3 * heads, C_in, hd] (b [3C] in the
// packed order, which is w5's slab order); the other operands as K1's.
extern "C" int swin_window_attention_qkv5_fwd(const void* x, const void* w5, const void* b,
                                              const void* scale, const void* mask, float bflag,
                                              void* qkv, void* out, int B, int H, int W, int Cin,
                                              int C, int heads, int wh, int ww, void* stream) {
  if (heads < 1 || C % heads != 0 || wh < 1 || ww < 1 || H % wh != 0 || W % ww != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return forward<QKV, false, false>(x, w5, b, scale, nullptr, mask, bflag, qkv, out, B, H / wh,
                                    W / ww, wh * ww, Cin, heads, C / heads, wh, ww, C / heads,
                                    stream);
}

// K12 v4: xw [B, nwh * nww, lm, C_in] bf16 window-major (lm = L rounded up to
// 8, rows >= L zero), W [C_in, 3C] bf16, b [3C] fp32 (C = heads * hd, or
// heads * 128 with head-padded W and b), scale [heads], mask [L, L] fp32 or
// null, qkv [B * nW * lm, 3C] scratch -> out [B, nW, lm, C] bf16, every row
// written (pad lanes zero).
extern "C" int swin_window_attention_qkv4_fwd(const void* xw, const void* w, const void* b,
                                              const void* scale, const void* mask, float bflag,
                                              void* qkv, void* out, int B, int nwh, int nww,
                                              int lm, int Cin, int C, int heads, int hd, int wh,
                                              int ww, void* stream) {
  const int L = wh * ww;
  if (lm < L || lm > (L + 15) / 16 * 16 || lm % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == heads * hd) {
    return forward<QKV4, false, false>(xw, w, b, scale, nullptr, mask, bflag, qkv, out, B, nwh,
                                       nww, lm, Cin, heads, hd, wh, ww, 0, stream);
  }
  if (C != heads * 128 || hd > 128) return static_cast<int>(cudaErrorInvalidValue);
  return forward<QKV4, false, true>(xw, w, b, scale, nullptr, mask, bflag, qkv, out, B, nwh, nww,
                                    lm, Cin, heads, hd, wh, ww, 0, stream);
}

// The attention pass's launch at head dim hd and window length L (v4: lm
// query rows), into info[0..6] as swin_window_attention_grid_fwd_info: bias,
// pad (head pitch 128) and v4 pick the instance.
extern "C" int swin_window_attention_qkv_fwd_info(int hd, int bias, int pad, int v4, int L,
                                                  int lm, void* info) {
  int* out = static_cast<int*>(info);
  if (v4) {
    return pad ? dispatch_info<QKV4, false, true>(hd, L, lm, out)
               : dispatch_info<QKV4, false, false>(hd, L, lm, out);
  }
  if (pad) return dispatch_info<QKV, false, true>(hd, L, L, out);
  return bias ? dispatch_info<QKV, true, false>(hd, L, L, out)
              : dispatch_info<QKV, false, false>(hd, L, L, out);
}

extern "C" const char* swin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
