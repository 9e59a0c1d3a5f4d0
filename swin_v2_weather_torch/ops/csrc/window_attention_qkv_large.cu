// The backward of the qkv-fused scaled-cosine window attention wherever its
// one-block kernel (window_attention_qkv_bwd.cu) does not run, hand-written
// for Hopper (sm_90a): the streamed variant of K2 and of K7's, K10's and
// K12's backwards. It takes head dims 128 and 256 at every L (at 256 the
// one-block kernel does not fit shared memory; at 128, L = 162 this one took
// 4.42 ms to its 4.55 on the H100), and every head dim 32-256 past L = 256,
// with the head pitch 128 of K10 and the padded v4. The forward of every
// head dim is window_attention_qkv.cu's.
//
// Replaces, at those shapes, the TPU kernels of
// swin_v2_weather_tpu/ops/window_attention.py: _make_qkv_bwd_kernel /
// _qkv_backward (K2; with has_bias through _build_qkv_bias, K7), the padded
// heads' _make_qkv6_bwd_kernel / _qkv6_backward (K10), and of
// ops/attic/window_attention_v45.py: _make_qkv5_bwd_kernel / _qkv5_backward
// and _make_qkv4_bwd_kernel / _qkv4_backward (K12 v5 and v4, padded or
// not). Their one-block-per-(window, head) layout keeps q, k, v and g
// [LP, HD] in shared memory at once: 374,592 B at head dim 256 and L = 162
// (the e2048 family), and more than the 232,448 B a block may use at every
// head dim past L = 256.
//
// What bounds it on this card: tensor-core work. At full width with the
// window 12 x 24 (L = 288; x [1, 180, 360, 768], W [768, 2304], 8 heads of
// 96, 225 windows) the recomputed projection, dx and dW are three
// 229-GFLOP products and the five [288, 288, 96] products per (window,
// head) 143 GFLOP: 0.840 ms at 989 TFLOP/s; at 8 heads of 256 (C = 2048),
// 5.333 ms.
//
// Design: the fused projection is split off. Each call runs
//  1. the projection on the Hopper GEMM core (wgmma_gemm.cuh) whose epilogue
//     rounds qkv = bf16(fp32 acc + b) (K1's site) and L2-normalizes q and k
//     per head as the forward's does (qkv_projection.cuh,
//     project_normalized_keep), so the backward's qn16 is the forward's; it
//     also keeps inv = 1 / |q| (and 1 / |k|) of each token row and, for v4,
//     parks the raw q and k rows in their dq and dk slots of dqkv;
//  2. the streamed attention kernels of streamed_bwd.cuh (form FORM_QKV):
//     the rows kernel (r = 1 / sum e and u = sum(dp e), then ds, d(bias) and
//     dq = (dqn - qn qd) inv_q with its d(scale) partial) and the columns
//     kernel (dv and dk = (dkn - kn kd) inv_k), every score tile in mma
//     registers, 8 warps a block, keys or queries streamed through a
//     three-stage cp.async ring; at head dim 256 up to L = 192 the rows
//     kernel keeps z and dp in registers, elsewhere it recomputes them in a
//     sweep per statistic (two: the sum and u, then ds);
//  3. the projection backward (qkv_projection.cuh): dx and the split-K dW on
//     the core, the db column sums, the reductions in a fixed order.
// The cost of the split: the [T, 3C] qkv buffer goes to device memory and
// back (796 MB each way at the full e2048 image, 0.24 ms each at 3.35 TB/s).
//
// Rounding sites: K2's (window_attention_qkv_bwd.cu); only the order of some
// fp32 sums differs (the projection's GEMM tiles, the row statistics per
// lane, quad and pair, qd per half of the head dim, the d(scale) partials
// per block of 64 rows). dW, db, dscale and d(bias) are summed in a fixed
// order, with no atomics. v5 (variant QKV_V5) runs the projection per (role,
// head) slab of the reordered weight, in the packed product's K order, so
// its results are K2's; v4 (QKV_V4) reads window-major rows and takes the
// fp32 qn = q * inv_q in qd and the normalization VJP, from the raw q and k
// rows parked in dqkv and read back before they are overwritten. The padded
// heads (head pitch 128 above the live head dim) get exact zeros in the pad
// lanes of dqkv, so dx and dW see none of them and dW's and db's pad
// columns are exactly zero.
//
// Contract (checked by the Python wrapper, ops/window_attention.py
// qkv_streamed_bwd): K2's operands, head dims 32-256, any L; the head pitch
// C / heads is the head dim, or 128 above head dims 32-96 (K10, padded v4;
// no bias, not v5); each kernel's shared memory within 232,448 B; the
// scratch buffers as the wrapper allocates them.

#include "qkv_projection.cuh"
#include "streamed_bwd.cuh"

namespace {

using namespace swin_attn;
namespace sb = swin_streamed_bwd;

// The rows of x, g and the outputs: the grid's pixels, or v4's window-major
// rows (lm a window).
template <int VAR>
int token_rows(const Geometry& g) {
  return VAR == QKV_V4 ? g.B * g.nwh * g.nww * g.lm : g.B * g.H * g.W;
}

// The streamed geometry of a launch: v4 reads and writes lm rows a window,
// all of which attend.
template <int VAR>
sb::Geo streamed_geo(const Geometry& geo) {
  const int ls = VAR == QKV_V4 ? geo.lm : geo.L;
  return sb::Geo{geo.B, geo.H, geo.W, geo.heads, geo.wh, geo.ww, geo.nwh, geo.nww,
                 geo.L, geo.LP, ls, ls, VAR == QKV_V4 ? 1 : 0};
}

// QKV_V5: wr is the reordered weight the recompute reads, w the packed one of
// the projection backward; otherwise both are the packed W. QKV_V4: the
// window-major rows, the raw q, k parked in dqkv for the fp32 qn. The head
// pitch is C / heads (g's row of C columns: ldg / heads in the streamed
// kernels): HD, or 128 for the padded heads.
template <int HD, bool BIAS, int VAR>
int backward(const void* x, const void* wr, const void* w, const void* b, const void* scale,
             const void* bias, const void* mask, float bflag, const void* g, void* qkv,
             void* inv, void* rstat, void* dqkv, void* dw_part, void* db_part,
             void* dscale_part, void* dbias_part, void* dx, void* dw, void* db, void* dscale,
             void* dbias, const Geometry& geo, int dw_splits, int db_splits, cudaStream_t s) {
  const int C = geo.C;
  const int C3 = 3 * C;
  const int T = token_rows<VAR>(geo);
  bf16* qkv16 = static_cast<bf16*>(qkv);
  bf16* dqkv16 = static_cast<bf16*>(dqkv);
  int code = swin_qkv_proj::project_normalized_keep(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wr), static_cast<const float*>(b),
      qkv16, T, geo.Cin, C3, C / geo.heads, VAR == QKV_V5 ? HD : 0, static_cast<float*>(inv),
      VAR == QKV_V4 ? dqkv16 : nullptr, s);
  if (code != 0) return code;
  const sb::Args sa{qkv16, qkv16 + C, qkv16 + 2 * C, static_cast<const bf16*>(g),
                    C3, C3, C3, C, dqkv16, dqkv16 + C, dqkv16 + 2 * C, C3,
                    static_cast<const float*>(scale), static_cast<const float*>(bias),
                    static_cast<const float*>(mask), bflag, static_cast<const float*>(inv),
                    static_cast<float*>(rstat), static_cast<float*>(dscale_part),
                    static_cast<float*>(dbias_part)};
  code = sb::launch<HD, sb::FORM_QKV, BIAS, VAR == QKV_V4>(sa, streamed_geo<VAR>(geo), s);
  if (code != 0) return code;
  const int n_win = geo.B * geo.nwh * geo.nww;
  return swin_qkv_proj::projection_backward(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), dqkv16, T, geo.Cin, C3,
      static_cast<float*>(dw_part), static_cast<float*>(db_part),
      static_cast<const float*>(dscale_part), n_win * sb::plan_of(geo.LP).nchunk, geo.heads,
      static_cast<const float*>(scale), static_cast<bf16*>(dx), static_cast<float*>(dw),
      static_cast<float*>(db), static_cast<float*>(dscale), static_cast<const float*>(dbias_part),
      n_win, geo.L, geo.LP, BIAS ? static_cast<float*>(dbias) : nullptr, dw_splits, db_splits,
      s);
}

// The backward of one variant at the live head dim hd.
template <int VAR, bool BIAS>
int dispatch(int hd, const void* x, const void* wr, const void* w, const void* b,
             const void* scale, const void* bias, const void* mask, float bflag, const void* g,
             void* qkv, void* inv, void* rstat, void* dqkv, void* dw_part, void* db_part,
             void* dscale_part, void* dbias_part, void* dx, void* dw, void* db, void* dscale,
             void* dbias, const Geometry& geo, int dw_splits, int db_splits, cudaStream_t s) {
  switch (hd) {
#define SWIN_STREAMED_CASE(HD)                                                                \
  case HD:                                                                                    \
    return backward<HD, BIAS, VAR>(x, wr, w, b, scale, bias, mask, bflag, g, qkv, inv, rstat, \
                                   dqkv, dw_part, db_part, dscale_part, dbias_part, dx, dw,   \
                                   db, dscale, dbias, geo, dw_splits, db_splits, s);
    SWIN_STREAMED_CASE(32)
    SWIN_STREAMED_CASE(64)
    SWIN_STREAMED_CASE(96)
    SWIN_STREAMED_CASE(128)
    SWIN_STREAMED_CASE(256)
#undef SWIN_STREAMED_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The streamed backward of every qkv-fused variant: var 0 K2 (v3; K7 with
// bias, K10 with the head pitch C / heads = 128 above hd), 1 K12 v5 (wr the
// reordered [3 * heads, C_in, hd] weight of the recompute; dx and dW from
// the packed w), 2 K12 v4 (x and g window-major [B, nW, lm, *]; padded v4
// with the head pitch 128). H = nwh * wh, W = nww * ww; lm is the rows a
// window holds (v4: L up to LP, a multiple of 8; else L). Scratch: qkv and
// dqkv [T, 3C] bf16, inv [T, 2, heads], rstat [B * nW, heads, LP, 2],
// dw_part [dw_splits, C_in, 3C], db_part [db_splits, 3C], dscale_part
// [B * nW * ceil(LP / 64), heads] and, with the bias, dbias_part [B * nW,
// heads, LP, LP], all fp32 but qkv and dqkv. Outputs dx (v4: dxw, pad rows
// zero) in x's layout bf16, dW [C_in, 3C], db [3C] (zero pad columns),
// dscale [heads] and, with the bias, dbias [heads, L, L], fp32.
extern "C" int swin_window_attention_qkv_streamed_bwd(
    const void* x, const void* wr, const void* w, const void* b, const void* scale,
    const void* bias, const void* mask, float bflag, const void* g, void* qkv, void* inv,
    void* rstat, void* dqkv, void* dw_part, void* db_part, void* dscale_part, void* dbias_part,
    void* dx, void* dw, void* db, void* dscale, void* dbias, int B, int nwh, int nww, int lm,
    int Cin, int C, int heads, int hd, int wh, int ww, int var, int dw_splits, int db_splits,
    void* stream) {
  Geometry geo;
  if (!make_geometry(geo, B, nwh * wh, nww * ww, Cin, C, heads, wh, ww, true) || dw_splits < 1 ||
      db_splits < 1 || var < QKV_V3 || var > QKV_V4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (var == QKV_V4) {
    if (lm < geo.L || lm > geo.LP || lm % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    geo.lm = lm;
  } else if (lm != geo.L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hp = C / heads;
  const bool pad = hp != hd;
  const bool with_bias = bias != nullptr;
  if ((pad && (hp != 128 || hd > 96 || var == QKV_V5)) ||
      (with_bias && (var != QKV_V3 || pad || dbias_part == nullptr || dbias == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SWIN_STREAMED_ARGS                                                                    \
  hd, x, wr, w, b, scale, bias, mask, bflag, g, qkv, inv, rstat, dqkv, dw_part, db_part,      \
      dscale_part, dbias_part, dx, dw, db, dscale, dbias, geo, dw_splits, db_splits, s
  if (var == QKV_V5) return dispatch<QKV_V5, false>(SWIN_STREAMED_ARGS);
  if (var == QKV_V4) return dispatch<QKV_V4, false>(SWIN_STREAMED_ARGS);
  if (with_bias) return dispatch<QKV_V3, true>(SWIN_STREAMED_ARGS);
  return dispatch<QKV_V3, false>(SWIN_STREAMED_ARGS);
#undef SWIN_STREAMED_ARGS
}
