// The window-attention backward, streamed, hand-written for Hopper (sm_90a):
// one template for the qkv-fused family's backward (K2, its K7 CPB-bias
// instance, K10's padded heads and K12's v5/v4 instances, padded v4 too;
// window_attention_qkv_large.cu) wherever its one-block backward does not
// run: head dims 128 and 256 where that one does not fit shared memory, and
// every head dim 32-256 past L = 256; and for the whole of the grid route's
// (K8 with its BIAS instance; window_attention_grid_large.cu) and of the
// windowed route's (K9 with its BIAS instance; window_attention_v1_large.cu):
// every head dim 32-256, any L. The softmax form (FORM), the layout of the
// token rows and (FORM_QKV) the head pitch are its parameters.
//
// Replaces, at those shapes, the TPU kernels of
// swin_v2_weather_tpu/ops/window_attention.py:
//   K2  _make_qkv_bwd_kernel / _qkv_backward (K7: has_bias through
//       _build_qkv_bias; K12: ops/attic/window_attention_v45.py
//       _make_qkv5_bwd_kernel / _qkv5_backward, _make_qkv4_bwd_kernel /
//       _qkv4_backward): the attention part of the backward, after the
//       recomputed projection (window_attention_qkv_large.cu);
//   K8  _make_grid_bwd_kernel / _grid_backward;
//   K9  _make_v1_bwd_kernel / _v1_backward, after a prepass that writes qn16,
//       kn16 and the norms (qkv_attention_large.cuh normalize_qk).
//
// What bounds it on this card: bytes. At the e2048 train steps' shape (T =
// 16200 tokens, 8 heads of 256, L = 162) the pass reads q, k, v and g and
// writes dq, dk and dv, 7 x 66.4 MB (0.139 ms at 3.35 TB/s), for five
// [L, L, 256] products per (window, head), 54 GFLOP (0.054 ms at 989
// TFLOP/s). The [L, L] scores never leave the chip.
//
// Design. Two kernels joined by per-row statistics, as FlashAttention-2
// splits the backward: the rows kernel forms dq, the columns kernel dk and
// dv; every sum has a fixed order and there are no atomics, so two calls
// give the same bits.
//  * Blocks of up to RT_MAX = 4 16-row tiles of one (window, head), two
//    warps a tile (8 warps; one block an SM at head dim 256, where the
//    registers and shared memory allow no second). Occupancy is the lever
//    below that: K9's columns kernel at head dims up to 128 and both of
//    K8's kernels up to head dim 96 are held to 128 registers, two blocks an
//    SM, with nothing spilled (K9's columns kernel lost a third of its time
//    at head dims 96 and 128). K8's rows kernel fits 128 by keeping z alone
//    (Z_ONLY, below), not z and dp (96 a lane, which spilled 8-48 B a
//    thread at 128 registers); K9's, whose ds sweep needs p and dp both,
//    keeps one block an SM (it spills at 128). The qkv-fused family's
//    kernels up to head dim 128 run two blocks an SM too (its rows kernel
//    there recomputes z and dp at every L and holds dqn alone). The tiles of
//    a (window, head) are split evenly over adjacent blocks, then heads,
//    then windows, so the streamed side comes from device memory once and
//    from L2 after. The block's own rows (q and g; k and v) are staged once;
//    the other side streams through a three-stage cp.async ring of 32-row
//    steps with one barrier a step, so the loads run two steps ahead of the
//    products.
//  * Each warp of a pair takes 16 of a step's 32 streamed rows: its score
//    tiles (s = q k^T and dp = g v^T over the whole head dim) are m16n8k16
//    mma on ldmatrix fragments and stay in its registers; it forms p or ds
//    there, rounds it to a bf16 A fragment (the accumulator-to-A identity)
//    and swaps it with its pair through shared memory (512 B, a 64-thread
//    named barrier). Each warp then multiplies both fragments, in key (or
//    query) order, into its half of the head dim: an fp32 [16, HD / 2]
//    accumulator in registers (64 at head dim 256; the columns kernel holds
//    dv and dk, 128).
//  * Rows kernel: the row statistics, each warp over its keys, merged over
//    the quad and then the pair (warp 0's then warp 1's): K8 the row max,
//    then the sum of e = exp(z - m) and u = sum(dp e); K9 the row max, the
//    sum of e, then u = sum(dp p) with p = e / sum e; the qkv-fused family's
//    max-free softmax the sum and u alone. Up to L = KEEP_L = 192 (every
//    configuration of the repo) the first sweep (k and v tiles) keeps z and
//    dp of the warp's keys in registers (6 steps: 96 a lane), the statistics
//    follow from them (K9's p replaces e there), and a second sweep (k tiles
//    only) forms ds from them: 3 score-sized products a (query, key) tile
//    pair. K8's two-block instances (head dims up to 96) keep z alone
//    (Z_ONLY: 48 a lane): the first sweep (k tiles) gives z, the max and the
//    sum of e = exp(z - m) in place, a second (v tiles) dp for u = sum(dp e),
//    and the ds sweep (k and v tiles) dp again, bit for bit: 4 products a
//    tile pair at twice the occupancy, the same sums in the same order.
//    Longer windows (K8's and K9's at any L: nothing in shared memory grows
//    with L but the token table and the columns kernel's row statistics,
//    1,152 and 3,456 B at L = 288) recompute z and dp in a sweep per
//    statistic (K8 three sweeps, K9 four, the qkv-fused family two); each
//    statistic is exact over the lane's keys in key order before the quad
//    and pair merges, as on the kept path, so both paths sum in the same
//    order. The statistics go to
//    a small workspace for the columns kernel. The ds sweep forms ds, its
//    d(bias) entries (BIAS) and dqn += dsb @ kn16; then qd = <qn, dqn>, and
//    the qkv-fused family's and K9's dq = (dqn - qn qd) inv_q (K8 returns
//    dqn), and (K2's family, K8) the block's d(scale) partial, the sum of qd
//    over its rows.
//  * Columns kernel: one sweep over the queries: s^T and dp^T, p16^T and
//    dsb^T from the stored statistics, dv += p16^T @ g16 and dkn += dsb^T @
//    qn16; the qkv-fused family's and K9's dk = (dkn - kn kd) inv_k (K8
//    returns dkn). K9's d(scale) = sum(ds s) needs s before the scale and the
//    bias, which the rows kernel no longer holds once z replaced it; the
//    columns kernel has s^T in its registers anyway, so the block's d(scale)
//    partial (its keys against every query) is taken there.
//  * Token rows: the grid's pixels (K2's family, K8; a table of the window's
//    L pixel rows in shared memory), v4's window-major rows (the same table)
//    or K9's contiguous [L, HD] slab of each (window, head) in [Bw, heads,
//    L, HD] tensors (row l of the slab; no table, no head offset). Head h
//    starts at column h * HD of a token row; the qkv-fused family's at
//    h * hp, its head pitch hp = ldg / heads: HD, or 128 for its padded
//    heads (K10, padded v4), whose pad lanes of dq, dk and dv the kernels
//    write as exact zeros (dx and dW are formed from them).
//
// Rounding sites (the TPU kernels' contracts):
//   FORM_QKV (K2, K7, K12): q, k normalized by the recomputed projection's
//     epilogue (qn16 = bf16(q inv), the forward's values, inv kept);
//     z = (s - 1) scale, or fl(s scale) + badd, plus bflag * mask on rows
//     < L; e = exp(z) (no max), r = 1 / sum e, u = sum(dp e); p16 = bf16(e r);
//     ds = (dp - u r) e (r scale), dsb = bf16(ds); d(bias) = ds / scale in
//     fp32; dqn = dsb kn16, dkn = dsb^T qn16, dv = p16^T g16 in fp32; qd =
//     <qn, dqn> with qn = qn16 (v4: the fp32 q inv from the raw row parked
//     in dq's slot), dq = (dqn - qn qd) inv_q, likewise dk; d(scale) partial
//     = sum of qd over the rows < LQ (v4: its lm rows attend).
//   FORM_GRID (K8): z = fl(s scale) (+ bias) (+ bflag * mask), m = max z,
//     e = exp(z - m), r = 1 / sum e, u = sum(dp e), p16 = bf16(e r); ds =
//     (dp - u r) e r (d(bias) = ds), dsb = bf16(ds scale); dqn, dkn leave in
//     bf16; d(scale) partial = sum of <qn16, dqn> (divided by scale in the
//     reduction).
//   FORM_V1 (K9): qn16, kn16 and inv from the prepass (qn = q inv in fp32,
//     inv = 1 / sqrt(max(sum q^2, 1e-24))); z = fl(s scale) (+ bias) (+ mask
//     on the last window row), m = max z, e = exp(z - m), p = e / sum e (the
//     correctly rounded quotient, as the K9 forward's), u = sum(dp p) with p
//     in fp32, p16 = bf16(p); ds = p (dp - u) (d(bias) = ds), dsb = bf16(ds
//     scale); d(scale) partial = sum(ds s) over the block's keys; qd = <qn,
//     dqn> with the fp32 qn = q inv_q from the raw row, dq = (dqn - qn qd)
//     inv_q, likewise dk.
// Only the order of fp32 sums differs from the plain versions (the row
// statistics per lane, quad and pair; qd per half of the head dim; K9's
// d(scale) per lane, warp and key block).
#pragma once

#include <math_constants.h>

#include "window_attention_common.cuh"

namespace swin_streamed_bwd {

using namespace swin_attn;

constexpr int FORM_QKV = 0;   // K2's family: max-free softmax, the normalization VJP inside
constexpr int FORM_GRID = 1;  // K8: the row max subtracted, dqn and dkn returned as they are
// K9: the row max subtracted, p = e / sum e, the normalization VJP inside on
// the raw rows; token rows are the [L, HD] slabs of [Bw, heads, L, HD]
constexpr int FORM_V1 = 2;

constexpr int RT_MAX = 4;  // 16-row tiles a block, two warps each
constexpr int STEP = 32;   // streamed rows a step, 16 a warp of the pair
constexpr int NS = 3;      // ring stages
constexpr int THREADS = RT_MAX * 64;
constexpr int KEEP_L = 192;  // the longest window whose z and dp the rows kernel keeps
constexpr int kMaxSmem = 232448;

struct Geo {
  int B, H, W, heads, wh, ww, nwh, nww, L, LP;
  int LS;            // rows of a window read and written: L, or v4's lm
  int LQ;            // query rows that attend: L, or v4's lm
  int window_major;  // token rows window-major (v4: LS a window), else the grid's pixels
};

struct Args {
  // column 0 of token row 0 (head h at + h * HD, FORM_QKV + h * ldg / heads,
  // its head pitch; FORM_V1: row 0)
  const bf16 *q, *k, *v, *g;
  int ldq, ldk, ldv, ldg;  // token row strides (elements)
  bf16 *dq, *dk, *dv;         // the outputs, likewise (v4: dq and dk hold the raw rows first)
  int ldd;
  const float *scale, *bias, *mask;  // bias [heads, L, L] (BIAS), mask [L, L] or null
  float bflag;
  // 1 / |q| and 1 / |k| of each token row: FORM_QKV [T, 2, heads]; FORM_V1
  // [2, Bw * heads * L] (q's rows, then k's, in slab-row order)
  const float* inv;
  float *rstat, *dscale_part, *dbias_part;
  const bf16 *qr, *kr;  // FORM_V1: the raw q and k (q is then qn16, k kn16), layout of q
};

// The launch at LP = L rounded up to 16: rt tiles a block, nchunk blocks a
// (window, head) (mirrored by streamed_bwd_plan in ops/window_attention.py).
struct Plan {
  int rt, nchunk;
};

inline Plan plan_of(int LP) {
  const int ntiles = LP / 16;
  Plan p;
  p.nchunk = (ntiles + RT_MAX - 1) / RT_MAX;
  p.rt = (ntiles + p.nchunk - 1) / p.nchunk;
  return p;
}

// 16-byte units holding n 4-byte words
inline size_t words16(int n) { return static_cast<size_t>((n + 3) / 4) * 16; }

// the own rows (two tensors) and the ring, bf16
template <int HD>
size_t tile_bytes(int rt) {
  return static_cast<size_t>(2 * rt * 16 + NS * 2 * STEP) * (HD + 8) * sizeof(bf16);
}

// rows kernel: + the pairs' ds fragments [rt][2][32] uint4, their row
// statistics [rt][2][16][4] fp32, the d(scale) sums [8] and the token table
// (none for FORM_V1's slabs)
template <int HD, int FORM>
size_t rows_smem(int rt, int LS) {
  return tile_bytes<HD>(rt) + rt * 64 * 16 + rt * 128 * 4 + 32 +
         (FORM == FORM_V1 ? 0 : words16(LS));
}

// columns kernel: + the p and ds fragments [rt][2][2][32] uint4, the row
// exchange [rt][2][16][4], the window's row statistics [LP][NST] and the
// table (FORM_V1: the d(scale) sums [8] in its place)
template <int HD, int FORM>
size_t cols_smem(int rt, int LP, int LS) {
  constexpr int NST = FORM == FORM_QKV ? 2 : 3;
  return tile_bytes<HD>(rt) + rt * 128 * 16 + rt * 128 * 4 + words16(LP * NST) +
         (FORM == FORM_V1 ? 32 : words16(LS));
}

// block -> (row chunk, head, window): the chunks of a (window, head)
// adjacent, then its heads, then the windows
__device__ __forceinline__ Tile decode_block(const Geo& g, int nchunk, int& chunk) {
  int bid = blockIdx.x;
  chunk = bid % nchunk;
  bid /= nchunk;
  Tile t;
  t.h = bid % g.heads;
  bid /= g.heads;
  t.wc = bid % g.nww;
  bid /= g.nww;
  t.wr = bid % g.nwh;
  t.bi = bid / g.nwh;
  return t;
}

__device__ __forceinline__ int window_of(const Geo& g, const Tile& t) {
  return (t.bi * g.nwh + t.wr) * g.nww + t.wc;
}

// the token row of window row l (< LS)
__device__ __forceinline__ int token_row(const Geo& g, const Tile& t, int l) {
  if (g.window_major) return window_of(g, t) * g.LS + l;
  return (t.bi * g.H + t.wr * g.wh + l / g.ww) * g.W + t.wc * g.ww + l % g.ww;
}

// window rows row0 .. row0 + nrows - 1 of src (the head's column 0; SLAB:
// the slab's row 0, row l at l * ld) into dst (pitch HD + 8) by cp.async,
// rows >= LS zero-filled; the caller commits
template <int HD, bool SLAB>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int ld,
                                           const int* tok, int LS, int row0, int nrows) {
  constexpr int LDQ = HD + 8;
  constexpr int CH = HD / 8;
  for (int idx = threadIdx.x; idx < nrows * CH; idx += blockDim.x) {
    const int r = idx / CH;
    const int c = (idx % CH) * 8;
    const int l = row0 + r;
    const bool ok = l < LS;
    const size_t row = SLAB ? static_cast<size_t>(l) : static_cast<size_t>(ok ? tok[l] : 0);
    cp_async16(dst + r * LDQ + c, src + (ok ? row * ld + c : 0), ok);
  }
}

// z of query qi and key: -inf outside the L keys and the LQ attending rows;
// the forwards' arithmetic (qkv_attention.cuh), each operation rounded
template <int FORM, bool BIAS>
struct Logits {
  float sc, bflag;
  const float* bh;    // the head's bias [L, L] (BIAS)
  const float* mask;  // [L, L], on the last window row only
  int L, LQ;
  bool masked;
  __device__ __forceinline__ float operator()(float s, int qi, int key) const {
    if (key >= L || qi >= LQ) return -CUDART_INF_F;
    float z;
    if constexpr (FORM == FORM_QKV && !BIAS) {
      z = __fmul_rn(__fsub_rn(s, 1.0f), sc);
    } else {
      z = __fmul_rn(s, sc);
      if constexpr (BIAS) z = __fadd_rn(z, bh[qi * L + key]);
    }
    if (masked && qi < L) z = __fadd_rn(z, __fmul_rn(bflag, mask[qi * L + key]));
    return z;
  }
};

__device__ __forceinline__ void pair_sync(int wt) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + wt));
}

// (f0, f1): the A fragments of a step's first and second 16 rows, from this
// warp's (mine, rows 16 hf ..) and its pair's (other): selected element by
// element, so both stay in registers
__device__ __forceinline__ void in_order(unsigned (&f0)[4], unsigned (&f1)[4],
                                         const unsigned (&mine)[4], const uint4& other, int hf) {
  const unsigned o[4] = {other.x, other.y, other.z, other.w};
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    f0[x] = hf == 0 ? mine[x] : o[x];
    f1[x] = hf == 0 ? o[x] : mine[x];
  }
}

// ---------------------------------------------------------------------------
// the rows kernel: one block per (window, head, chunk of rt query tiles)
// ---------------------------------------------------------------------------

// Blocks an SM each kernel's launch bounds ask for (128 registers a thread at
// two): K8's instances up to head dim 96 both kernels, K9's columns kernel up
// to head dim 128, the qkv-fused family's both kernels up to head dim 128;
// the others one.
template <int HD, int FORM>
__host__ __device__ constexpr int rows_blocks() {
  return (FORM == FORM_GRID && HD <= 96) || (FORM == FORM_QKV && HD <= 128) ? 2 : 1;
}
template <int HD, int FORM>
__host__ __device__ constexpr int cols_blocks() {
  return (FORM == FORM_GRID && HD <= 96) || (FORM != FORM_GRID && HD <= 128) ? 2 : 1;
}

// Whether the rows kernel has its KEEP instance: the qkv-fused family's only
// at head dim 256, so that its instances up to head dim 128 recompute z and
// dp at every L and fit 128 registers (two blocks an SM)
template <int HD, int FORM>
__host__ __device__ constexpr bool has_keep() {
  return FORM != FORM_QKV || HD == 256;
}

// exact zeros into the pad lanes [HD, hp) of a head's row: the lanes of a
// quad take 16-byte pieces in turn
template <int HD>
__device__ __forceinline__ void zero_pad(bf16* head_row, int hp) {
  for (int c = HD + (threadIdx.x & 3) * 8; c < hp; c += 32) {
    *reinterpret_cast<uint4*>(head_row + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// KEEP (L <= KEEP_L): z and dp of the warp's keys stay in registers from the
// first sweep to the last (two sweeps, k read twice, v once)
template <int HD, int FORM, bool BIAS, bool RAW, bool KEEP>
__global__ void __launch_bounds__(THREADS, rows_blocks<HD, FORM>())
    streamed_bwd_rows_kernel(Args a, Geo g, int rt, int nchunk) {
  constexpr int LDQ = HD + 8;
  constexpr int DW = HD / 2;  // columns of dqn a warp holds
  constexpr int NO = DW / 8;  // its n8 tiles
  constexpr bool V1 = FORM == FORM_V1;
  constexpr bool MAXSUB = FORM != FORM_QKV;
  // K8 at two blocks an SM keeps z alone: a sweep for z, one for dp and u,
  // then the ds sweep with dp recomputed (k and v tiles)
  constexpr bool Z_ONLY = KEEP && rows_blocks<HD, FORM>() == 2;
  constexpr int NSW = V1 ? 4 : MAXSUB ? 3 : 2;  // sweeps over the keys without KEEP
  constexpr int KST = KEEP_L / STEP;            // steps KEEP holds
  constexpr int NST = MAXSUB ? 3 : 2;  // statistics stored a row: (m,) r (K9: sum e), u
  constexpr int STAGE = 2 * STEP * LDQ;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // the block's query rows [rt * 16, LDQ]
  bf16* gs = qs + rt * 16 * LDQ;             // their cotangent rows
  bf16* ring = gs + rt * 16 * LDQ;           // NS stages of (k [STEP], v [STEP])
  uint4* xfrag = reinterpret_cast<uint4*>(ring + NS * STAGE);  // [rt][2][32] ds fragments
  float* xstat = reinterpret_cast<float*>(xfrag + rt * 64);     // [rt][2][16][4]
  float* wsum = xstat + rt * 128;                               // [8]
  int* tok = reinterpret_cast<int*>(wsum + 8);                  // [LS] token rows (not K9)

  int chunk;
  const Tile t = decode_block(g, nchunk, chunk);
  const int win = window_of(g, t);
  const size_t wh = static_cast<size_t>(win) * g.heads + t.h;
  const size_t slab = wh * g.L;  // K9: the (window, head)'s first token row
  const int L = g.L;
  const int LP = g.LP;
  const int LS = g.LS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wt = warp >> 1;  // the pair's query tile
  const int hf = warp & 1;   // the warp's half of a step's keys and of the head dim
  const int g4 = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int row0 = chunk * rt * 16;
  const int q0 = row0 + wt * 16;
  const bool active = q0 < LP;
  const int qr[2] = {q0 + g4, q0 + g4 + 8};  // the lane's query rows
  const int nsteps = (L + STEP - 1) / STEP;
  const int nitems = (Z_ONLY ? 3 : KEEP ? 2 : NSW) * nsteps;
  // the head's column 0 of token row 0, or K9's slab row 0
  const int hp = FORM == FORM_QKV ? a.ldg / g.heads : HD;  // the head pitch
  const size_t hoff = V1 ? slab * HD : static_cast<size_t>(t.h) * hp;

  if constexpr (!V1) {
    for (int l = threadIdx.x; l < LS; l += blockDim.x) tok[l] = token_row(g, t, l);
    __syncthreads();
  }
  stage_rows<HD, V1>(qs, a.q + hoff, a.ldq, tok, LS, row0, rt * 16);
  stage_rows<HD, V1>(gs, a.g + hoff, a.ldg, tok, LS, row0, rt * 16);
  // item i: step i % nsteps of sweep i / nsteps (k: every sweep but
  // Z_ONLY's second; v: KEEP's first sweep, Z_ONLY's last two, else the last
  // two sweeps: K8's sums and ds, K9's u and ds; K2's family both)
  auto load_item = [&](int i) {
    if (i < nitems) {
      const int sw = i / nsteps;
      const int st = i % nsteps;
      bf16* dst = ring + (i % NS) * STAGE;
      if (!Z_ONLY || sw != 1) {
        stage_rows<HD, V1>(dst, a.k + hoff, a.ldk, tok, LS, st * STEP, STEP);
      }
      if (Z_ONLY ? sw >= 1 : KEEP ? sw == 0 : sw >= NSW - 2) {
        stage_rows<HD, V1>(dst + STEP * LDQ, a.v + hoff, a.ldv, tok, LS, st * STEP, STEP);
      }
    }
    cp_async_commit();  // (an empty group past the end keeps the count)
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) load_item(i);  // the first group holds the own rows too

  const float sc = a.scale[t.h];
  const Logits<FORM, BIAS> logit{sc, a.bflag,
                                 BIAS ? a.bias + static_cast<size_t>(t.h) * L * L : nullptr,
                                 a.mask, L, g.LQ, a.mask != nullptr && t.wr == g.nwh - 1};
  // ldmatrix lane offsets: A operand rows, the B operand of x y^T (16 rows of
  // y), the transposed B operand of p y (16 rows of y as k)
  const int aoff = (lane & 15) * LDQ + (lane >> 4) * 8;
  const int boff = ((lane >> 4) * 8 + (lane & 7)) * LDQ + ((lane >> 3) & 1) * 8;
  const int toff = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + (lane >> 4) * 8;
  const bf16* qw = qs + wt * 16 * LDQ;
  const bf16* gw = gs + wt * 16 * LDQ;
  uint4* xmine = xfrag + (wt * 2 + hf) * 32 + lane;
  const uint4* xpart = xfrag + (wt * 2 + (hf ^ 1)) * 32 + lane;
  float* smine = xstat + ((wt * 2 + hf) * 16 + g4) * 4;  // + 32 r: row g4 + 8 r
  const float* spair = xstat + (wt * 32 + g4) * 4;       // warp 0's; + 64 warp 1's

  float m[2] = {MAXSUB ? -CUDART_INF_F : 0.0f, MAXSUB ? -CUDART_INF_F : 0.0f};
  float l[2] = {0.0f, 0.0f}, u[2] = {0.0f, 0.0f}, r[2] = {0.0f, 0.0f};
  float acc[NO][4];
  const float rsc = 1.0f / sc;

  // item i landed and every warp is done with item i - 1; the next load goes out
  auto next_item = [&](int i) -> const bf16* {
    cp_async_wait<NS - 2>();
    __syncthreads();
    load_item(i + NS - 1);
    return ring + (i % NS) * STAGE;
  };
  // z of the warp's 16 keys of step st (-inf past L) and dp = g v^T
  auto scores = [&](float (&z)[2][4], float (&dp)[2][4], const bf16* kst, int st, bool with_dp) {
    const int kb = st * STEP + hf * 16;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        z[n][x] = -CUDART_INF_F;
        dp[n][x] = 0.0f;
      }
    }
    if (kb >= L) return;
    float sv[2][4];
    score_tile<HD>(sv, qw, kst + hf * 16 * LDQ, aoff, boff);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) z[n][x] = logit(sv[n][x], qr[x >> 1], kb + n * 8 + c2 + (x & 1));
    }
    if (with_dp) score_tile<HD>(dp, gw, kst + STEP * LDQ + hf * 16 * LDQ, aoff, boff);
  };
  // dp = g v^T alone of the warp's 16 keys of step st (0 past L), as scores
  // forms it
  auto dp_tile = [&](float (&dp)[2][4], const bf16* kst, int st) {
    if (st * STEP + hf * 16 >= L) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int x = 0; x < 4; ++x) dp[n][x] = 0.0f;
      }
      return;
    }
    score_tile<HD>(dp, gw, kst + STEP * LDQ + hf * 16 * LDQ, aoff, boff);
  };
  // e = exp(z - m) in place (0 past L)
  auto exps = [&](float (&z)[2][4]) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) z[n][x] = z[n][x] == -CUDART_INF_F ? 0.0f : expf(z[n][x] - m[x >> 1]);
    }
  };
  // K9: p = e / sum e in place, the correctly rounded quotient (0 on padded
  // rows, whose e and sum are 0)
  auto probs = [&](float (&e)[2][4]) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        e[n][x] = l[x >> 1] > 0.0f ? __fdiv_rn(e[n][x], l[x >> 1]) : 0.0f;
      }
    }
  };
  auto add_l = [&](const float (&e)[2][4]) {  // K9's first sum: e alone
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) l[x >> 1] += e[n][x];
    }
  };
  // K9's u = sum(dp p) (Z_ONLY's sum(dp e), e in p's place)
  auto add_u = [&](const float (&p)[2][4], const float (&dp)[2][4]) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) u[x >> 1] += dp[n][x] * p[n][x];
    }
  };
  auto add_sums = [&](const float (&e)[2][4], const float (&dp)[2][4]) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        l[x >> 1] += e[n][x];
        u[x >> 1] += dp[n][x] * e[n][x];
      }
    }
  };
  auto add_max = [&](const float (&z)[2][4]) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) m[x >> 1] = fmaxf(m[x >> 1], z[n][x]);
    }
  };
  // a statistic of the rows over the quad's lanes, then the pair (warp 0's,
  // warp 1's): kind 0 the max; 1 the sums (the sum of e and u, then r; K9
  // and Z_ONLY the sum of e alone); 2 their u. The last one stores the
  // row's statistics for the columns kernel. Each exchange slot is written
  // once a kernel.
  auto merge = [&](int kind) {
    const bool with_l = kind == 1, with_u = V1 || Z_ONLY ? kind == 2 : kind == 1;
#pragma unroll
    for (int y = 0; y < 2; ++y) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        if (kind == 0) {
          m[y] = fmaxf(m[y], __shfl_xor_sync(0xffffffffu, m[y], o));
        } else {
          if (with_l) l[y] += __shfl_xor_sync(0xffffffffu, l[y], o);
          if (with_u) u[y] += __shfl_xor_sync(0xffffffffu, u[y], o);
        }
      }
      if ((lane & 3) == 0) {
        if (kind == 0) smine[32 * y] = m[y];
        if (with_l) smine[32 * y + 1] = l[y];
        if (with_u) smine[32 * y + 2] = u[y];
      }
    }
    pair_sync(wt);
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      if (kind == 0) {
        m[y] = fmaxf(spair[32 * y], spair[64 + 32 * y]);
      } else {
        if (with_l) l[y] = spair[32 * y + 1] + spair[64 + 32 * y + 1];
        if (with_u) u[y] = spair[32 * y + 2] + spair[64 + 32 * y + 2];
        if (!V1) r[y] = l[y] > 0.0f ? 1.0f / l[y] : 0.0f;  // padded rows: e = 0 throughout
        if (with_u && hf == 0 && (lane & 3) == 0) {
          float* rs = a.rstat + (wh * LP + qr[y]) * NST;
          if constexpr (MAXSUB) rs[0] = m[y];
          rs[NST - 2] = V1 ? l[y] : r[y];
          rs[NST - 1] = u[y];
        }
      }
    }
  };
  // step st of the ds sweep: ds = (dp - u r) e r (scale) (K9: p (dp - u)),
  // its d(bias) entries, dsb swapped with the pair, then dqn += dsb @ kn16
  // over the step's keys in order, this warp's columns
  auto ds_step = [&](const float (&e)[2][4], float (&dp)[2][4], const bf16* kst, int st) {
    const int kb = st * STEP + hf * 16;
    float ds[2][4];  // the values dsb rounds
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int y = x >> 1;
        float db;  // the d(bias) entry
        if constexpr (FORM == FORM_QKV) {
          ds[n][x] = (dp[n][x] - u[y] * r[y]) * e[n][x] * (r[y] * sc);
          db = ds[n][x] * rsc;
        } else if constexpr (V1) {  // e holds p
          db = e[n][x] * (dp[n][x] - u[y]);
          ds[n][x] = db * sc;
        } else {
          db = (dp[n][x] - u[y] * r[y]) * e[n][x] * r[y];
          ds[n][x] = db * sc;
        }
        dp[n][x] = db;
      }
    }
    if constexpr (BIAS) {  // the block's d(bias) rows (0 outside the window)
      if (kb < L) {
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          float* drow = a.dbias_part + (wh * LP + qr[y]) * LP + kb + c2;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            *reinterpret_cast<float2*>(drow + n * 8) = make_float2(dp[n][2 * y], dp[n][2 * y + 1]);
          }
        }
      }
    }
    unsigned fa[4];
    to_a(fa, ds);  // dsb
    *xmine = make_uint4(fa[0], fa[1], fa[2], fa[3]);
    pair_sync(wt);
    unsigned f0[4], f1[4];  // the fragments of the step's first and second 16 keys
    in_order(f0, f1, fa, *xpart, hf);
    accumulate_rows<DW>(acc, f0, kst + hf * DW, toff);
    if (st * STEP + 16 < L) accumulate_rows<DW>(acc, f1, kst + 16 * LDQ + hf * DW, toff);
  };
  auto zero_acc_regs = [&]() {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[j][x] = 0.0f;
    }
  };

  if constexpr (KEEP) {
    // L <= KEEP_L: sweep 1 (k and v tiles) keeps z and dp of the warp's keys
    // in registers; the statistics follow from them; sweep 2 streams k only.
    // Z_ONLY: sweep 1 streams k and keeps z, a sweep of v tiles takes u, and
    // the ds sweep streams k and v
    float zr[KST][2][4], dr[Z_ONLY ? 1 : KST][2][4];
#pragma unroll
    for (int st = 0; st < KST; ++st) {
      if (st < nsteps) {
        const bf16* kst = next_item(st);
        if (active) scores(zr[st], dr[Z_ONLY ? 0 : st], kst, st, !Z_ONLY);
      }
    }
    if (active) {
      if constexpr (MAXSUB) {
#pragma unroll
        for (int st = 0; st < KST; ++st) {
          if (st < nsteps) add_max(zr[st]);
        }
        merge(0);
      }
#pragma unroll
      for (int st = 0; st < KST; ++st) {
        if (st < nsteps) {
          exps(zr[st]);
          if constexpr (V1 || Z_ONLY) {
            add_l(zr[st]);
          } else {
            add_sums(zr[st], dr[st]);
          }
        }
      }
      merge(1);
      if constexpr (V1) {  // p replaces e in the registers, then u
#pragma unroll
        for (int st = 0; st < KST; ++st) {
          if (st < nsteps) {
            probs(zr[st]);
            add_u(zr[st], dr[st]);
          }
        }
        merge(2);
      }
    }
    if constexpr (Z_ONLY) {  // u = sum(dp e) over a sweep of v tiles
#pragma unroll
      for (int st = 0; st < KST; ++st) {
        if (st < nsteps) {
          const bf16* vst = next_item(nsteps + st);
          if (active) {
            float dp[2][4];
            dp_tile(dp, vst, st);
            add_u(zr[st], dp);
          }
        }
      }
      if (active) merge(2);
    }
    zero_acc_regs();
#pragma unroll
    for (int st = 0; st < KST; ++st) {
      if (st < nsteps) {
        const bf16* kst = next_item((Z_ONLY ? 2 : 1) * nsteps + st);
        if (!active) continue;
        if constexpr (Z_ONLY) {  // dp again, as the u sweep formed it
          float dp[2][4];
          dp_tile(dp, kst, st);
          ds_step(zr[st], dp, kst, st);
        } else {
          ds_step(zr[st], dr[st], kst, st);
        }
      }
    }
  } else {
    // longer windows: one sweep for each statistic (K8: the max, then the
    // sums; K9: the max, the sum, u; K2's family: the sums), then the ds
    // sweep, z and dp recomputed
    constexpr int SW_DS = V1 ? 3 : 2;
    zero_acc_regs();
    for (int i = 0; i < nitems; ++i) {
      const bf16* kst = next_item(i);
      // 0 the max, 1 the sums, (K9: 2 u), then ds
      const int sw = i / nsteps + (MAXSUB ? 0 : 1);
      const int st = i % nsteps;
      if (!active) continue;
      float z[2][4], dp[2][4];
      scores(z, dp, kst, st, V1 ? sw > 1 : sw > 0);
      if (sw == 0) {
        add_max(z);
      } else {
        exps(z);
        if (sw == 1) {
          if constexpr (V1) {
            add_l(z);
          } else {
            add_sums(z, dp);
          }
        } else if (sw < SW_DS) {
          probs(z);
          add_u(z, dp);
        } else {
          if constexpr (V1) probs(z);
          ds_step(z, dp, kst, st);
        }
      }
      if (st == nsteps - 1 && sw < SW_DS) merge(sw);  // a statistics sweep ends
    }
  }
  cp_async_wait<0>();

  // qd = <qn, dqn> of each row over the warp's columns, the quad's, then the
  // pair's; K2's family and K9: dq = (dqn - qn qd) inv_q (qn = qn16, or
  // v4's fp32 q inv_q from the raw row in dq's slot, read by the lane before
  // it writes it; K9's fp32 q inv_q from the raw q); K8: dqn
  float part = 0.0f;  // the sum of qd over the pair's attending rows (warp 0)
  if (active) {
    int tq[2];  // the token row (K9: the slab row)
    float iq[2];
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const bool in = qr[y] < LS;
      tq[y] = in ? (V1 ? qr[y] : tok[qr[y]]) : 0;
      iq[y] = !in ? 0.0f
              : V1 ? a.inv[slab + qr[y]]
              : FORM == FORM_QKV ? a.inv[(static_cast<size_t>(tq[y]) * 2) * g.heads + t.h]
                                 : 0.0f;
    }
    auto qn_at = [&](int y, int d) -> float2 {  // the row's qn at columns d, d + 1
      if constexpr (RAW || V1) {
        if (qr[y] >= LS) return make_float2(0.0f, 0.0f);
        const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            (V1 ? a.qr : a.dq) + static_cast<size_t>(tq[y]) * a.ldd + hoff + d));
        return make_float2(w.x * iq[y], w.y * iq[y]);
      } else {
        return __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(qw + (g4 + 8 * y) * LDQ + d));
      }
    };
    float qd[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const float2 f = qn_at(y, hf * DW + j * 8 + c2);
        qd[y] += f.x * acc[j][2 * y];
        qd[y] += f.y * acc[j][2 * y + 1];
      }
    }
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      qd[y] += __shfl_xor_sync(0xffffffffu, qd[y], 1);
      qd[y] += __shfl_xor_sync(0xffffffffu, qd[y], 2);
      if ((lane & 3) == 0) smine[32 * y + 3] = qd[y];
    }
    pair_sync(wt);
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      qd[y] = spair[32 * y + 3] + spair[64 + 32 * y + 3];
      if (hf == 0 && (lane & 3) == 0 && qr[y] < g.LQ) part += qd[y];
      if (qr[y] < LS) {
        bf16* dst = a.dq + static_cast<size_t>(tq[y]) * a.ldd + hoff;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const int d = hf * DW + j * 8 + c2;
          float v0 = acc[j][2 * y], v1 = acc[j][2 * y + 1];
          if constexpr (FORM != FORM_GRID) {
            const float2 f = qn_at(y, d);
            v0 = (v0 - f.x * qd[y]) * iq[y];
            v1 = (v1 - f.y * qd[y]) * iq[y];
          }
          *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(v0, v1);
        }
        if (FORM == FORM_QKV && hf == 1) zero_pad<HD>(dst, hp);
      }
    }
  }
  // the block's d(scale) partial, in a fixed order (lanes, then warps); K9
  // takes its d(scale) in the columns kernel
  if constexpr (!V1) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) wsum[warp] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.0f;
      for (int w = 0; w < 2 * rt; ++w) total += wsum[w];
      a.dscale_part[(static_cast<size_t>(win) * nchunk + chunk) * g.heads + t.h] = total;
    }
  }
}

// ---------------------------------------------------------------------------
// the columns kernel: one block per (window, head, chunk of rt key tiles)
// ---------------------------------------------------------------------------

template <int HD, int FORM, bool BIAS, bool RAW>
__global__ void __launch_bounds__(THREADS, cols_blocks<HD, FORM>())
    streamed_bwd_cols_kernel(Args a, Geo g, int rt, int nchunk) {
  constexpr int LDQ = HD + 8;
  constexpr int DW = HD / 2;
  constexpr int NO = DW / 8;
  constexpr bool V1 = FORM == FORM_V1;
  constexpr bool MAXSUB = FORM != FORM_QKV;
  constexpr int NST = MAXSUB ? 3 : 2;
  constexpr int STAGE = 2 * STEP * LDQ;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // the block's key rows [rt * 16, LDQ]
  bf16* vs = ks + rt * 16 * LDQ;             // their value rows
  bf16* ring = vs + rt * 16 * LDQ;           // NS stages of (q [STEP], g [STEP])
  uint4* xfrag = reinterpret_cast<uint4*>(ring + NS * STAGE);  // [rt][2][2][32] p, ds fragments
  float* xstat = reinterpret_cast<float*>(xfrag + rt * 128);    // [rt][2][16][4]
  float* rsh = xstat + rt * 128;                               // [LP][NST] row statistics
  int* tok = reinterpret_cast<int*>(rsh) + (g.LP * NST + 3) / 4 * 4;  // [LS] (K9: none)
  float* wsum = reinterpret_cast<float*>(tok);  // K9: the warps' d(scale) sums [8]

  int chunk;
  const Tile t = decode_block(g, nchunk, chunk);
  const int win = window_of(g, t);
  const size_t wh = static_cast<size_t>(win) * g.heads + t.h;
  const size_t slab = wh * g.L;  // K9: the (window, head)'s first token row
  const int L = g.L;
  const int LP = g.LP;
  const int LS = g.LS;
  const int LQ = g.LQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wt = warp >> 1;
  const int hf = warp & 1;
  const int g4 = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int row0 = chunk * rt * 16;
  const int k0 = row0 + wt * 16;
  const bool active = k0 < LP;
  const int kr[2] = {k0 + g4, k0 + g4 + 8};  // the lane's key rows
  const int nitems = (LQ + STEP - 1) / STEP;
  const int hp = FORM == FORM_QKV ? a.ldg / g.heads : HD;  // the head pitch
  const size_t hoff = V1 ? slab * HD : static_cast<size_t>(t.h) * hp;

  if constexpr (!V1) {
    for (int l = threadIdx.x; l < LS; l += blockDim.x) tok[l] = token_row(g, t, l);
  }
  for (int i = threadIdx.x; i < LP * NST; i += blockDim.x) rsh[i] = a.rstat[wh * LP * NST + i];
  __syncthreads();
  stage_rows<HD, V1>(ks, a.k + hoff, a.ldk, tok, LS, row0, rt * 16);
  stage_rows<HD, V1>(vs, a.v + hoff, a.ldv, tok, LS, row0, rt * 16);
  auto load_item = [&](int i) {
    if (i < nitems) {
      bf16* dst = ring + (i % NS) * STAGE;
      stage_rows<HD, V1>(dst, a.q + hoff, a.ldq, tok, LS, i * STEP, STEP);
      stage_rows<HD, V1>(dst + STEP * LDQ, a.g + hoff, a.ldg, tok, LS, i * STEP, STEP);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) load_item(i);

  const float sc = a.scale[t.h];
  const Logits<FORM, BIAS> logit{sc, a.bflag,
                                 BIAS ? a.bias + static_cast<size_t>(t.h) * L * L : nullptr,
                                 a.mask, L, LQ, a.mask != nullptr && t.wr == g.nwh - 1};
  const int aoff = (lane & 15) * LDQ + (lane >> 4) * 8;
  const int boff = ((lane >> 4) * 8 + (lane & 7)) * LDQ + ((lane >> 3) & 1) * 8;
  const int toff = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + (lane >> 4) * 8;
  const bf16* kw = ks + wt * 16 * LDQ;
  const bf16* vw = vs + wt * 16 * LDQ;
  uint4* xmine = xfrag + (wt * 2 + hf) * 64 + lane;  // + 32: the ds fragment
  const uint4* xpart = xfrag + (wt * 2 + (hf ^ 1)) * 64 + lane;
  float* smine = xstat + ((wt * 2 + hf) * 16 + g4) * 4;
  const float* spair = xstat + (wt * 32 + g4) * 4;

  float dv[NO][4], dk[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      dv[j][x] = 0.0f;
      dk[j][x] = 0.0f;
    }
  }
  float dsc = 0.0f;  // K9: the lane's sum of ds s, its entries in step order

  for (int i = 0; i < nitems; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    load_item(i + NS - 1);
    const bf16* qst = ring + (i % NS) * STAGE;
    const bf16* gst = qst + STEP * LDQ;
    if (!active) continue;
    const int qb = i * STEP + hf * 16;  // the warp's first query of the step
    float p[2][4], ds[2][4];
    if (qb < LQ) {
      float s[2][4], dp[2][4];
      score_tile<HD>(s, kw, qst + hf * 16 * LDQ, aoff, boff);   // s^T [key][query]
      score_tile<HD>(dp, vw, gst + hf * 16 * LDQ, aoff, boff);  // dp^T [key][query]
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = qb + n * 8 + c2 + c;
          const float* st = rsh + qi * NST;
          const float mq = MAXSUB ? st[0] : 0.0f;
          const float rq = st[NST - 2];  // 1 / sum e (K9: sum e)
          const float uq = st[NST - 1];
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            const int x = 2 * y + c;
            const float z = logit(s[n][x], qi, kr[y]);
            const float ev = z == -CUDART_INF_F ? 0.0f : expf(z - mq);
            if constexpr (V1) {  // the rows kernel's p and ds, bit for bit
              p[n][x] = z == -CUDART_INF_F ? 0.0f : __fdiv_rn(ev, rq);
              const float d = p[n][x] * (dp[n][x] - uq);
              ds[n][x] = d * sc;
              dsc += d * s[n][x];
            } else if constexpr (FORM == FORM_QKV) {
              p[n][x] = ev * rq;
              ds[n][x] = (dp[n][x] - uq * rq) * ev * (rq * sc);
            } else {
              p[n][x] = ev * rq;
              ds[n][x] = (dp[n][x] - uq * rq) * ev * rq * sc;
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          p[n][x] = 0.0f;
          ds[n][x] = 0.0f;
        }
      }
    }
    unsigned fp[4], fd[4];
    to_a(fp, p);   // p16^T
    to_a(fd, ds);  // dsb^T
    xmine[0] = make_uint4(fp[0], fp[1], fp[2], fp[3]);
    xmine[32] = make_uint4(fd[0], fd[1], fd[2], fd[3]);
    pair_sync(wt);
    unsigned p0[4], p1[4], d0[4], d1[4];  // the step's first and second 16 queries
    in_order(p0, p1, fp, xpart[0], hf);
    in_order(d0, d1, fd, xpart[32], hf);
    // dv += p16^T @ g16 and dkn += dsb^T @ qn16 over the step's queries in
    // order, this warp's columns
    accumulate_rows<DW>(dv, p0, gst + hf * DW, toff);
    accumulate_rows<DW>(dk, d0, qst + hf * DW, toff);
    if (i * STEP + 16 < LQ) {
      accumulate_rows<DW>(dv, p1, gst + 16 * LDQ + hf * DW, toff);
      accumulate_rows<DW>(dk, d1, qst + 16 * LDQ + hf * DW, toff);
    }
  }
  cp_async_wait<0>();
  if constexpr (V1) {  // the block's d(scale) partial, in a fixed order (lanes, then warps)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dsc += __shfl_xor_sync(0xffffffffu, dsc, o);
    if (lane == 0) wsum[warp] = dsc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.0f;
      for (int w = 0; w < 2 * rt; ++w) total += wsum[w];
      a.dscale_part[(static_cast<size_t>(win) * nchunk + chunk) * g.heads + t.h] = total;
    }
  }
  if (!active) return;

  // K2's family and K9: kd = <kn, dkn> (the quad's, then the pair's) and dk =
  // (dkn - kn kd) inv_k (kn = kn16, or v4's fp32 k inv_k from the raw row in
  // dk's slot, K9's from the raw k); K8: dkn. dv as it is. Rows >= LS are
  // not written.
  int tk[2];  // the token row (K9: the slab row)
  float ik[2];
  const size_t nrows = static_cast<size_t>(g.B) * g.nwh * g.nww * g.heads * g.L;  // K9
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const bool in = kr[y] < LS;
    tk[y] = in ? (V1 ? kr[y] : tok[kr[y]]) : 0;
    ik[y] = !in ? 0.0f
            : V1 ? a.inv[nrows + slab + kr[y]]
            : FORM == FORM_QKV ? a.inv[(static_cast<size_t>(tk[y]) * 2 + 1) * g.heads + t.h]
                               : 0.0f;
  }
  auto kn_at = [&](int y, int d) -> float2 {
    if constexpr (RAW || V1) {
      if (kr[y] >= LS) return make_float2(0.0f, 0.0f);
      const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          (V1 ? a.kr : a.dk) + static_cast<size_t>(tk[y]) * a.ldd + hoff + d));
      return make_float2(w.x * ik[y], w.y * ik[y]);
    } else {
      return __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(kw + (g4 + 8 * y) * LDQ + d));
    }
  };
  float kd[2] = {0.0f, 0.0f};
  if constexpr (FORM != FORM_GRID) {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const float2 f = kn_at(y, hf * DW + j * 8 + c2);
        kd[y] += f.x * dk[j][2 * y];
        kd[y] += f.y * dk[j][2 * y + 1];
      }
    }
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      kd[y] += __shfl_xor_sync(0xffffffffu, kd[y], 1);
      kd[y] += __shfl_xor_sync(0xffffffffu, kd[y], 2);
      if ((lane & 3) == 0) smine[32 * y] = kd[y];
    }
    pair_sync(wt);
#pragma unroll
    for (int y = 0; y < 2; ++y) kd[y] = spair[32 * y] + spair[64 + 32 * y];
  }
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    if (kr[y] >= LS) continue;
    const size_t off = static_cast<size_t>(tk[y]) * a.ldd + hoff;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = hf * DW + j * 8 + c2;
      float k0v = dk[j][2 * y], k1v = dk[j][2 * y + 1];
      if constexpr (FORM != FORM_GRID) {
        const float2 f = kn_at(y, d);
        k0v = (k0v - f.x * kd[y]) * ik[y];
        k1v = (k1v - f.y * kd[y]) * ik[y];
      }
      *reinterpret_cast<__nv_bfloat162*>(a.dv + off + d) =
          __floats2bfloat162_rn(dv[j][2 * y], dv[j][2 * y + 1]);
      *reinterpret_cast<__nv_bfloat162*>(a.dk + off + d) = __floats2bfloat162_rn(k0v, k1v);
    }
    if constexpr (FORM == FORM_QKV) zero_pad<HD>((hf == 0 ? a.dv : a.dk) + off, hp);
  }
}

// ---------------------------------------------------------------------------
// launch: the rows kernel, then the columns kernel, on one stream
// ---------------------------------------------------------------------------

// the rows kernel that takes L
template <int HD, int FORM, bool BIAS, bool RAW>
auto rows_kernel_for(int L) {
  if constexpr (has_keep<HD, FORM>()) {
    return L <= KEEP_L ? streamed_bwd_rows_kernel<HD, FORM, BIAS, RAW, true>
                       : streamed_bwd_rows_kernel<HD, FORM, BIAS, RAW, false>;
  } else {
    return streamed_bwd_rows_kernel<HD, FORM, BIAS, RAW, false>;
  }
}

template <int HD, int FORM, bool BIAS, bool RAW>
int launch(const Args& a, const Geo& g, cudaStream_t s) {
  const Plan p = plan_of(g.LP);
  const size_t rs = rows_smem<HD, FORM>(p.rt, g.LS);
  const size_t cs = cols_smem<HD, FORM>(p.rt, g.LP, g.LS);
  const long long blocks = static_cast<long long>(g.B) * g.nwh * g.nww * g.heads * p.nchunk;
  if (g.LS > g.LP || g.LQ > g.LS || rs > static_cast<size_t>(kMaxSmem) ||
      cs > static_cast<size_t>(kMaxSmem) || blocks < 1 || blocks > 2147483647LL ||
      (FORM == FORM_QKV &&
       (a.ldg % g.heads != 0 || a.ldg / g.heads < HD || a.ldg / g.heads % 8 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto rows = rows_kernel_for<HD, FORM, BIAS, RAW>(g.L);
  const auto cols = streamed_bwd_cols_kernel<HD, FORM, BIAS, RAW>;
  cudaError_t err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(rs));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cs));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  rows<<<static_cast<unsigned>(blocks), p.rt * 64, rs, s>>>(a, g, p.rt, p.nchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cols<<<static_cast<unsigned>(blocks), p.rt * 64, cs, s>>>(a, g, p.rt, p.nchunk);
  return static_cast<int>(cudaGetLastError());
}

// The launch of both kernels at the geometry's L, into info[0..9]: the
// threads a block and blocks per (window, head), then for the rows kernel
// and the columns kernel each: dynamic shared memory, registers a thread,
// local (spill) bytes a thread and resident blocks per SM (from the CUDA
// runtime). Launches nothing.
template <int HD, int FORM, bool BIAS, bool RAW>
int launch_info(const Geo& g, int* info) {
  const Plan p = plan_of(g.LP);
  const size_t rs = rows_smem<HD, FORM>(p.rt, g.LS);
  const size_t cs = cols_smem<HD, FORM>(p.rt, g.LP, g.LS);
  if (rs > static_cast<size_t>(kMaxSmem) || cs > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto rows = rows_kernel_for<HD, FORM, BIAS, RAW>(g.L);
  const auto cols = streamed_bwd_cols_kernel<HD, FORM, BIAS, RAW>;
  info[0] = p.rt * 64;
  info[1] = p.nchunk;
  int at = 2;
  auto one = [&](auto kernel, size_t smem) -> int {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    int resident = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, p.rt * 64, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    info[at++] = static_cast<int>(smem);
    info[at++] = attr.numRegs;
    info[at++] = static_cast<int>(attr.localSizeBytes);
    info[at++] = resident;
    return 0;
  };
  const int code = one(rows, rs);
  return code != 0 ? code : one(cols, cs);
}

}  // namespace swin_streamed_bwd
