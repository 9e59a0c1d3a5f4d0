// Window attention on pre-projected q, k, v, the forward, hand-written for
// Hopper (sm_90a): one template for the grid-layout kernel (K8,
// window_attention_grid.cu) and the windowed-layout kernel (K9,
// window_attention_v1.cu), each with a CPB-bias instance. The template is
// also the attention pass of the qkv-fused forwards (K1, K7, K10 and K12's
// v5/v4, window_attention_qkv.cu: layouts QKV and QKV4), which read q, k and
// v as channel slices of their projection's [T, 3C] scratch. K8's and K9's
// backward, at every head dim and L, is the streamed template's
// (streamed_bwd.cuh, forms FORM_GRID and FORM_V1).
//
// Replaces the TPU kernels of swin_v2_weather_tpu/ops/window_attention.py:
//   K8  _make_grid_kernel (forward, launched by _grid_forward), reached
//       through fused_window_attention_grid (attn_impl 'pallas'). q and k arrive
//       L2-normalized per head (the normalization and its VJP stay outside, in
//       plain PyTorch, as they stay in XLA there); the kernel reads q, k and
//       v in the model's NHWC grid [B, H, W, C] and writes out there,
//       windowing by index math. q, k and v may be channel slices of one
//       [B, H, W, 3C] tensor: each is read with its own pixel stride, so the
//       wrapper copies nothing.
//   K9  _make_kernel (forward, _pallas_forward), reached through
//       fused_window_attention (attn_impl 'pallas_v1'): windowed [Bw, heads,
//       L, D] tensors, with the per-row L2 normalization of q and k inside
//       the kernel.
// With has_bias=True both TPU kernels take the raw CPB bias [heads, L, L] fp32
// (no row-max shift, no fold); the max pass of the softmax keeps them safe
// with it. The BIAS instances here do the same.
//
// What bounds them on this card: at the flagship shape (q, k, v [1, 180, 360,
// 768] bf16, or the same bytes windowed as [400, 8, 162, 96]; 8 heads of 96,
// L = 162) a (window, head) reads 3 x 31 KB and writes 31 KB (forward) or
// reads 4 and writes 3 such tiles (backward) for 2 (forward) or 5 (backward)
// [162, 162, 96] products: 32.3 and 80.6 GFLOP against 398 MB and 697 MB, so
// at the card's 989 TFLOP/s and 3.35 TB/s the bytes bound them (0.119 and
// 0.208 ms). The [L, L] scores must never reach device memory (336 MB per
// call in fp32 if they did). Short of that bound, the forward's time goes to
// the softmax's per-entry work (logits, exp, p16) and to the latency of its
// sweeps between barriers, not to its bytes (PERF.md section 6).
//
// The forward (one template for head dims 32-256 and any L). Blocks of up to
// 4 (3 at head dim 256) 16-row query tiles of one (window, head), two warps
// a tile: each warp of the pair takes half the keys of every 32-key step
// and forms half of out's head dim, the pair swapping its bf16 p fragments
// through shared memory (a 64-thread named barrier). The row tiles of a
// (window, head) are adjacent blocks, then heads, then windows, so k and v
// come from device memory once and from L2 after. q [rt * 16, HD] is staged
// once; k and v stream through a cp.async ring of 32- or 64-key tiles, so
// shared memory does not grow with L beyond a table of L words (76,432 B at
// the flagship, 100,496 B at head dim 256: two blocks per SM, whose loads
// overlap each other's products). K8's token pixels come from that table,
// not from a division per load. The products are m16n8k16 bf16 mma (inline
// PTX) on ldmatrix fragments; a lane holds rows r and r + 8 and two
// adjacent keys per 8-key tile, so the row statistics are quad shuffles, and
// the bf16 p fragments are the A operand of p @ v as they stand (the
// accumulator-to-A identity of m16n8k16). Two sweeps over the keys, on one
// of two paths:
//  * L <= 192 (every config of the repo): each warp keeps z of its keys in
//    registers (48 fp32 a lane). Sweep 1 streams k and computes z once (the
//    bias and mask entries read once, issued ahead of the step's products);
//    the exact row max and sum of e follow in registers (the lane's keys in
//    order, the quad, then the pair), one exp an entry; sweep 2 streams
//    only v and rounds p16 from e.
//  * longer windows: sweep 1 takes the row max and the sum of e together,
//    each lane over its own keys with its sum rescaled when its max moves
//    (never the output), merged across the quad and the pair at the end;
//    sweep 2 reloads k, recomputes z and forms p16 from the final max and
//    sum.
// K9 normalizes q once and each k tile in shared memory before the barrier
// that releases it (the streamed path keeps the keys' norms in the table and
// rescales its second load of k by them); its p = e / sum e is the correctly
// rounded quotient from the row's reciprocal and one fma correction
// (Markstein's). out leaves through q's shared rows, 16 bytes a thread.
//
// The qkv-fused forwards' pass (layouts QKV and QKV4) reads q, k and v as
// channel slices of the [T, 3C] projection (token rows from the table: the
// grid's pixels, or v4's window-major rows; head pitch HP), q and k already
// L2-normalized by the projection's epilogue (qkv_projection.cuh), and keeps
// K1's max-free softmax: z = (s - 1) * scale, or fl(s * scale) + badd, plus
// the mask on rows < L; e = exp(z) with no max (z <= 0 up to the mask), so
// each score is formed and exponentiated once:
//  * QKV (K1, K7, K10, v5): p16 = bf16(e) with no rescaling, and out =
//    (p16 @ v) * (1 / sum e) (sum e over the lane in key order, the quad,
//    then the pair) at the end. Up to L = 192 the Z path's shape (sweep 1
//    keeps e of the warp's keys in registers, sweep 2 streams v); beyond it
//    one streamed sweep whose ring stages hold a k and a v tile.
//  * QKV4 (v4): K8's two sweeps with the max pinned at 0: p16 = bf16(e *
//    (1 / sum e)) before p16 @ v; lq (= lm) query rows read and written,
//    the pad rows attending to the real keys unmasked.
//
// Rounding sites (the TPU kernels' contracts; the backward's are kept by
// streamed_bwd.cuh):
//   K8  qn16, kn16, v16 as given (bf16); s = qn16 kn16^T in fp32;
//       z = s * scale_h (+ bias_h) (+ bflag * mask on the last window row);
//       m = max z, e = exp(z - m), p16 = bf16(e * (1 / sum e)),
//       out = bf16(p16 v16). Backward: r = 1 / sum e; dv = p16^T g16,
//       dp = g16 v16^T; ds = (dp - sum(dp e) r) e r (unscaled: d(bias) = sum
//       over windows of ds); dsb = bf16(ds * scale_h); dqn = dsb kn16, dkn =
//       dsb^T qn16, written in bf16 (q's dtype); dscale_h = sum(qn16 dqn) /
//       scale_h.
//   K9  qn = q * (1 / sqrt(max(sum q^2, 1e-24))) in fp32, qn16 = bf16(qn),
//       likewise k; s = qn16 kn16^T; z as K8 with bflag = 1; p = e / sum e;
//       out = bf16(bf16(p) v16). Backward: dv = bf16(p)^T g16, dp = g16 v16^T;
//       ds = p (dp - sum(dp p)); dscale_h = sum(ds * s) taken directly;
//       d(bias) = sum ds; dsb = bf16(ds * scale_h); dqn = dsb kn16, dkn =
//       dsb^T qn16; the normalization VJP on the fp32 qn and kn (q and k
//       re-read): dq = (dqn - qn <qn, dqn>) / |q|, likewise dk.
// The forward's sum e is taken in another order than a plain row sum (per
// lane, the quad, the pair; on the streamed path also rescaled as the max
// moves): p16 and out keep their rounding sites, and only the last fp32 bits
// of sum e may differ.
//
// Contract (checked by the Python wrappers): bf16 q, k, v; fp32 scale
// [heads], bias [heads, L, L] (BIAS only) and mask [L, L] or null; pixel
// strides (K8, QKV, QKV4) multiples of 8 elements and 16-byte aligned bases;
// head dim in {32, 64, 96, 128, 256}, any L (QKV4: L <= lq <= LP).

#pragma once

#include <math_constants.h>

#include "window_attention_common.cuh"

namespace swin_qkv_attn {

using namespace swin_attn;

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may opt into
constexpr int GRID = 0;           // K8: NHWC grid [B, H, W, C], q and k pre-normalized
constexpr int WINDOWED = 1;       // K9: [Bw, heads, L, D], q and k normalized inside
// The qkv-fused forwards' pass (window_attention_qkv.cu): q, k, v rows of the
// projection's scratch, q and k normalized by its epilogue, K1's max-free
// softmax (e = exp(z), no max: z <= 0 up to the mask, see there).
constexpr int QKV = 2;   // K1, K7, K10, v5: the grid's pixels; p16 = bf16(e), 1 / sum e last
constexpr int QKV4 = 3;  // K12 v4: window-major rows, lq of them; p16 = bf16(e / sum e)

struct AttnGeo {
  int B, H, W, heads, wh, ww, L, LP, nwh, nww;
  int ldq, ldk, ldv, ldo;  // pixel strides in elements (GRID, QKV*): q, k, v; g and outputs
  int lq;                  // query rows a window reads and writes: L, or v4's lm (QKV4)
};

// Window index in h-major order (the order of window_partition).
__device__ __forceinline__ int window_index(const AttnGeo& g, const Tile& t) {
  return (t.bi * g.nwh + t.wr) * g.nww + t.wc;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// (m, l) <- the merge of two partial softmax statistics (max m, sum l of
// exp(z - m)); an empty part has m = -inf and l = 0. Symmetric, so the lanes
// (and warps) that merge the same parts agree bit for bit.
__device__ __forceinline__ void merge_stat(float& m, float& l, float m2, float l2) {
  const float mm = fmaxf(m, m2);
  const float a = m == -CUDART_INF_F ? 0.0f : l * expf(m - mm);
  const float b = m2 == -CUDART_INF_F ? 0.0f : l2 * expf(m2 - mm);
  m = mm;
  l = a + b;
}

// K9: L2-normalize rows 0 .. nrows - 1 of t (pitch HD + 8) in place, each
// row by one warp, NB rows of a warp at a time (independent chains): t16 =
// bf16(t * inv), inv = 1 / sqrt(max(sum t^2, 1e-24)), summed as normalize_rows
// sums (lane-strided, then the butterfly, which leaves the sum in every
// lane); lane j < NB takes the j-th row's 1 / sqrt and hands it back. With
// inv_out, the inverse norms of rows < nkeep are kept there.
template <int HD>
__device__ void normalize_block_rows(bf16* t, int nrows, float* inv_out = nullptr,
                                     int nkeep = 0) {
  constexpr int LDQ = HD + 8;
  constexpr int NV = (HD + 31) / 32;
  constexpr int NB = HD > 128 ? 2 : 8;  // (registers: NB * NV values a lane)
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int row0 = threadIdx.x >> 5; row0 < nrows; row0 += NB * nw) {
    float vals[NB][NV];
    float ss[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int row = row0 + j * nw;
      ss[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = lane + 32 * i;
        const float x = (row < nrows && d < HD) ? __bfloat162float(t[row * LDQ + d]) : 0.0f;
        vals[j][i] = x;
        ss[j] += x * x;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < NB; ++j) ss[j] += __shfl_xor_sync(0xffffffffu, ss[j], o);
    }
    float mine = ss[0];
#pragma unroll
    for (int j = 1; j < NB; ++j) mine = lane == j ? ss[j] : mine;
    mine = 1.0f / sqrtf(fmaxf(mine, 1e-24f));
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int row = row0 + j * nw;
      const float inv = __shfl_sync(0xffffffffu, mine, j);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = lane + 32 * i;
        if (row < nrows && d < HD) t[row * LDQ + d] = __float2bfloat16(vals[j][i] * inv);
      }
      if (lane == 0 && row < nkeep) inv_out[row] = inv;
    }
  }
}

// K9, sweep 2: rows 0 .. nrows - 1 of t (pitch HD + 8) normalized in place by
// the inverse norms sweep 1 kept (the same bf16(t * inv)), 16 bytes a thread.
template <int HD>
__device__ void rescale_block_rows(bf16* t, int nrows, const float* inv) {
  constexpr int LDQ = HD + 8;
  for (int idx = threadIdx.x; idx < nrows * (HD / 8); idx += blockDim.x) {
    const int row = idx / (HD / 8);
    uint4* p = reinterpret_cast<uint4*>(t + row * LDQ + (idx % (HD / 8)) * 8);
    const float iv = inv[row];
    uint4 w = *p;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float2 f = __bfloat1622float2(h[x]);
      h[x] = __floats2bfloat162_rn(f.x * iv, f.y * iv);
    }
    *p = w;
  }
}

// The forward's block shape at head dim HD: at most RT_MAX 16-row query
// tiles a block, two warps a tile; the ring holds NS stages of KS keys (a k
// and a v tile each, or one of them where Z), taken in steps of 16 NT keys,
// of which each warp of a pair takes 8 NT (NT 8-key score tiles) and forms
// half of out's columns. Z (L <= ZL): each warp keeps the z of its keys in
// registers (ZST steps), so k is read once, sweep 2 streams only v and the
// softmax is the exact max-then-sum. MINB blocks an SM is the launch bound
// (registers). Shared memory: q, the ring, the pairs' p exchange and row
// statistics, and a table of L words.
constexpr int ZL = 192;  // the longest window the Z path takes

template <int HD, bool Z>
struct FwdShape {
  static constexpr int RT_MAX = HD > 128 ? 3 : 4;
  static constexpr int NT = 2;
  static constexpr int KS = (HD > 128 || !Z) ? 32 : 64;
  static constexpr int NS = (HD > 128 && !Z) ? 3 : 4;
  static constexpr int TILES = Z ? 1 : 2;  // k and v tiles a ring stage holds
  static constexpr int ZST = Z ? ZL / (16 * NT) : 1;
  static constexpr int MINB = 2;
  static constexpr int THREADS = RT_MAX * 2 * 32;
};

// The launch at window length L: rt query tiles a block (the tiles of a
// (window, head) split evenly over nchunk blocks) and the dynamic shared
// memory, with a table of ltab words (L; QKV4 lq) (mirrored by
// attn_fwd_plan and qkv_fwd_plan in ops/window_attention.py).
struct FwdPlan {
  int rt, nchunk;
  size_t smem;
};

template <int HD, bool Z>
FwdPlan fwd_plan(int L, int ltab) {
  using S = FwdShape<HD, Z>;
  const int ntiles = (L + 15) / 16;
  FwdPlan p;
  p.nchunk = (ntiles + S::RT_MAX - 1) / S::RT_MAX;
  p.rt = (ntiles + p.nchunk - 1) / p.nchunk;
  p.smem = (static_cast<size_t>(p.rt) * 16 + static_cast<size_t>(S::TILES) * S::NS * S::KS) *
               (HD + 8) * sizeof(bf16) +
           static_cast<size_t>(p.rt) * (S::NT * 1024 + 256) + (ltab + 3) / 4 * 16;
  return p;
}

// Rows row0 .. row0 + nrows - 1 of the block's (window, head) tile of src into
// dst (pitch HD + 8) by cp.async, rows >= L zero-filled: token l sits at
// src + base + tok[l] * ld (GRID, QKV: tok the grid pixel; QKV4 the
// window-major row) or src + base + l * HD (WINDOWED). The caller commits.
template <int LAYOUT, int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int ld,
                                           size_t base, const int* tok, int L, int row0,
                                           int nrows) {
  constexpr int LDQ = HD + 8;
  for (int idx = threadIdx.x; idx < nrows * (HD / 8); idx += blockDim.x) {
    const int r = idx / (HD / 8);
    const int c = (idx % (HD / 8)) * 8;
    const int l = row0 + r;
    const bool ok = l < L;
    size_t off = 0;
    if (ok) {
      off = base + c + (LAYOUT != WINDOWED ? static_cast<size_t>(tok[l]) * ld
                                       : static_cast<size_t>(l) * HD);
    }
    cp_async16(dst + r * LDQ + c, src + off, ok);
  }
}

// The lane's two entries (keys key0, key0 + 1; key0 even) of the row at p (a
// row of an [L, L] fp32 table): one 8-byte load where L is even; in the
// tail step (!full) keys >= L read 0.
__device__ __forceinline__ float2 load_pair(bool full, const float* __restrict__ p, int key0,
                                            int L) {
  if (!full && key0 >= L) return make_float2(0.0f, 0.0f);
  if ((L & 1) == 0) return __ldg(reinterpret_cast<const float2*>(p + key0));
  return make_float2(__ldg(p + key0), (full || key0 + 1 < L) ? __ldg(p + key0 + 1) : 0.0f);
}

// HP: the head pitch of q, k, v and out (HD, or 128 for K10's and v4's
// padded heads: out's pad lanes are written as exact zeros).
template <int HD, int LAYOUT, bool BIAS, bool Z, int HP = HD>
__global__ void __launch_bounds__(FwdShape<HD, Z>::THREADS, FwdShape<HD, Z>::MINB)
    qkv_attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ scale,
                             const float* __restrict__ bias, const float* __restrict__ mask,
                             float bflag, bf16* __restrict__ out, AttnGeo g, int rt, int nchunk) {
  using S = FwdShape<HD, Z>;
  constexpr bool NORM = LAYOUT == WINDOWED;  // q and k normalized here (K9)
  constexpr bool TABLE = LAYOUT != WINDOWED;  // token rows from the block's table
  constexpr bool MAXFREE = LAYOUT == QKV || LAYOUT == QKV4;  // e = exp(z), no max
  constexpr bool SCALE_END = LAYOUT == QKV;  // p16 = bf16(e); out = (p16 @ v) / sum e
  constexpr bool ONE = SCALE_END && !Z;      // (streamed) one sweep of k and v tiles
  static_assert(HP >= HD && (HP == HD || TABLE), "a pass the launches take");
  constexpr int LDQ = HD + 8;
  constexpr int NT = S::NT;            // 8-key score tiles a warp takes in a step
  constexpr int NC = NT / 2;           // its 16-key chunks (A fragments of p @ v)
  constexpr int STEP = 16 * NT;        // keys a step (both warps of the pair)
  constexpr int DW = HD / 2;           // columns of out a warp forms
  constexpr int NK = HD / 16;          // k16 steps of a score tile
  constexpr int NO = DW / 8;           // n8 tiles of out a warp holds
  constexpr int SUB = S::KS / STEP;    // steps a ring stage
  constexpr int STAGE = S::TILES * S::KS * LDQ;  // elements a ring stage
  static_assert(S::KS % STEP == 0 && S::ZST % SUB == 0, "whole steps a stage");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // the block's q rows [rt * 16, LDQ]; out at the end
  bf16* ring = qs + rt * 16 * LDQ;           // NS stages of (k [KS, LDQ], v [KS, LDQ]), or of one
  uint4* pex = reinterpret_cast<uint4*>(ring + S::NS * STAGE);  // [rt][2][2][NC][32]
  float* xstat = reinterpret_cast<float*>(pex + rt * NT * 64);  // [2][rt * 16][2]
  int* tok = reinterpret_cast<int*>(xstat + rt * 64);  // [lq]: token l's row (TABLE)
  float* invk = reinterpret_cast<float*>(tok);          // [L]: K9's 1 / |k| of token l

  // block -> (row chunk, head, window): the chunks of a (window, head) are
  // adjacent, then its heads (so they share k and v, and the grid's rows,
  // through L2)
  int bid = blockIdx.x;
  const int chunk = bid % nchunk;
  bid /= nchunk;
  Tile t;
  t.h = bid % g.heads;
  bid /= g.heads;
  t.wc = bid % g.nww;
  bid /= g.nww;
  t.wr = bid % g.nwh;
  t.bi = bid / g.nwh;

  const int L = g.L;
  const int LQ = g.lq;  // query rows, read and written (L, or v4's lm; keys stay < L)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wt = warp >> 1;    // the warp's 16-row query tile
  const int dsub = warp & 1;   // its half of a step's keys and of out's columns
  const int row0 = chunk * rt * 16;
  const int qr = row0 + wt * 16 + (lane >> 2);  // the lane's query rows qr and qr + 8
  const int c2 = (lane & 3) * 2;                // its first key (column) of an 8-key tile
  const bool active = row0 + wt * 16 < LQ;      // the pair has a real row
  const int nkt = (L + S::KS - 1) / S::KS;      // ring stages per sweep
  // sweep 1: k tiles; sweep 2: (k and) v tiles; ONE: k and v tiles, once
  const int nitems = ONE ? nkt : 2 * nkt;

  size_t base;
  if constexpr (TABLE) {
    for (int l = threadIdx.x; l < LQ; l += blockDim.x) {
      if constexpr (LAYOUT == QKV4) {
        tok[l] = window_index(g, t) * LQ + l;
      } else {
        const int row = t.wr * g.wh + l / g.ww;
        const int col = t.wc * g.ww + l % g.ww;
        tok[l] = (t.bi * g.H + row) * g.W + col;
      }
    }
    base = static_cast<size_t>(t.h) * HP;
    __syncthreads();
  } else {
    base = (static_cast<size_t>(window_index(g, t)) * g.heads + t.h) * L * HD;
  }
  auto load_item = [&](int i) {
    if (i < nitems) {
      const int kt = i % nkt;
      bf16* st = ring + (i % S::NS) * STAGE;
      if (Z && i >= nkt) {
        stage_rows<LAYOUT, HD>(st, v, g.ldv, base, tok, L, kt * S::KS, S::KS);
      } else {
        stage_rows<LAYOUT, HD>(st, k, g.ldk, base, tok, L, kt * S::KS, S::KS);
        if (ONE || (!Z && i >= nkt)) {
          stage_rows<LAYOUT, HD>(st + S::KS * LDQ, v, g.ldv, base, tok, L, kt * S::KS, S::KS);
        }
      }
    }
    cp_async_commit();  // (an empty group past the end keeps the count)
  };
  stage_rows<LAYOUT, HD>(qs, q, g.ldq, base, tok, LQ, row0, rt * 16);
#pragma unroll
  for (int i = 0; i < S::NS - 1; ++i) load_item(i);  // the first group holds q too
  // K9 normalizes q once and each k tile before the barrier that releases
  // it (so warps done with the last item start on it): sweep 1 (k tiles)
  // keeps the keys' norms where the streamed sweep 2 reloads k, and that
  // sweep rescales its k tiles by them
  auto normalize_item = [&](int i) {
    if constexpr (NORM) {
      if (i >= nitems || (Z && i >= nkt)) return;
      const int kt = i % nkt;
      bf16* kst = ring + (i % S::NS) * STAGE;
      const int nk = min(S::KS, L - kt * S::KS);  // (rows past L stay zero)
      if (i < nkt) {
        normalize_block_rows<HD>(kst, nk, invk + kt * S::KS, Z ? 0 : L - kt * S::KS);
      } else {
        rescale_block_rows<HD>(kst, nk, invk + kt * S::KS);
      }
    }
  };
  if constexpr (NORM) {
    cp_async_wait<S::NS - 2>();
    __syncthreads();
    normalize_block_rows<HD>(qs, min(rt * 16, LQ - row0));
  }
  // item i has landed (K9: item i + 1 too, and item i, complete since the
  // last barrier, is normalized) and every warp is done with item i - 1; the
  // next load goes out
  auto next_item = [&](int i) -> bf16* {
    cp_async_wait<NORM ? S::NS - 3 : S::NS - 2>();
    normalize_item(i);
    __syncthreads();
    load_item(i + S::NS - 1);
    return ring + (i % S::NS) * STAGE;
  };

  const float sc = scale[t.h];
  const bool masked = mask != nullptr && t.wr == g.nwh - 1;  // (rows >= L take no mask)
  // the lane's rows of the bias and mask tables (rows >= L clamped to L - 1:
  // their z is finite and never written)
  const float* brow[2];
  const float* mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = static_cast<size_t>(min(qr + 8 * r, L - 1)) * L;
    brow[r] = BIAS ? bias + static_cast<size_t>(t.h) * L * L + row : nullptr;
    mrow[r] = masked ? mask + row : nullptr;
  }
  const bool rok[2] = {qr < LQ, qr + 8 < LQ};
  const bool mok[2] = {masked && qr < L, masked && qr + 8 < L};
  // ldmatrix lane offsets: the warp's keys of a step as the B operand of
  // q k^T (two 8-key tiles a load), q rows as A, v rows (transposed) as the
  // B operand of p v for the warp's columns
  const int koff = (dsub * 8 * NT + (lane >> 4) * 8 + (lane & 7)) * LDQ + ((lane >> 3) & 1) * 8;
  const int qoff = (wt * 16 + (lane & 15)) * LDQ + (lane >> 4) * 8;
  const int voff = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + (lane >> 4) * 8 + dsub * DW;
  uint4* pmine = pex + ((wt * 2) * 2 + dsub) * NC * 32 + lane;  // parity 0; + c * 32 a chunk
  const uint4* ppart = pex + ((wt * 2) * 2 + (dsub ^ 1)) * NC * 32 + lane;
  constexpr int PAR = 2 * NC * 32;  // uint4s from one parity's buffers to the other's
  float* xmine = xstat + ((dsub * rt + wt) * 16 + (lane >> 2)) * 2;  // + 16 r: row qr + 8 r
  const float* xpair = xstat + (wt * 16 + (lane >> 2)) * 2;        // warp 0's; + rt * 32 warp 1's

  // the row max (streamed sweep 1: the lane's); MAXFREE: 0 throughout, so
  // exp(z - m) is exp(z) and the statistics' merges plain sums
  const float m0 = MAXFREE ? 0.0f : -CUDART_INF_F;
  float m[2] = {m0, m0};
  float l[2] = {0.0f, 0.0f};                    // the row's sum of e (likewise)
  float rs[2] = {0.0f, 0.0f};                   // K8, QKV* 1 / sum e, K9 sum e
  float ry[2] = {0.0f, 0.0f};                   // K9: 1 / sum e, for the division's correction
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  }
  int parity = 0;  // the p exchange's buffer, alternating per step

  // z of the warp's NT tiles of the step at key kb (stage rows kr): s = q k^T,
  // z = s * scale (+ bias) (+ bflag * mask), -inf past L; the bias and mask
  // entries are issued ahead of the products. full: every key of the step is
  // real (no key checks; each call site passes a constant).
  auto scores = [&](bool full, float (*z)[4], const bf16* kr, int kb) {
    const int k0 = kb + dsub * 8 * NT;  // the warp's first key of the step
    bool take[NT];  // the warp's 8-key tiles with a real key
#pragma unroll
    for (int n = 0; n < NT; ++n) take[n] = full || k0 + 8 * n < L;
    if (!take[0]) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) z[n][e] = -CUDART_INF_F;
      }
      return;
    }
    float2 ab[NT][2], am[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key0 = k0 + n * 8 + c2;
        ab[n][r] = BIAS ? load_pair(full, brow[r], key0, L) : make_float2(0.0f, 0.0f);
        am[n][r] = mok[r] ? load_pair(full, mrow[r], key0, L) : make_float2(0.0f, 0.0f);
      }
    }
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    }
    kr += koff;
    constexpr int KU = NK > 8 ? 4 : NK;  // k16 steps unrolled (registers at head dim 256)
#pragma unroll 1
    for (int k0s = 0; k0s < NK; k0s += KU) {
#pragma unroll
      for (int kk = k0s; kk < k0s + KU; ++kk) {
        unsigned a[4];
        ldsm4(a, qs + qoff + kk * 16);
#pragma unroll
        for (int n2 = 0; n2 < NC; ++n2) {
          if (take[2 * n2]) {
            unsigned b[4];
            ldsm4(b, kr + n2 * 16 * LDQ + kk * 16);
            mma16816(s[2 * n2], a, b[0], b[1]);
            if (take[2 * n2 + 1]) mma16816(s[2 * n2 + 1], a, b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float val;
        if constexpr (MAXFREE && !BIAS) {  // K1's (s - 1) * scale
          val = __fmul_rn(__fsub_rn(s[n][e], 1.0f), sc);
        } else {
          val = __fmul_rn(s[n][e], sc);
          if (BIAS) val = __fadd_rn(val, (e & 1) ? ab[n][r].y : ab[n][r].x);
        }
        if (masked) val = __fadd_rn(val, __fmul_rn(bflag, (e & 1) ? am[n][r].y : am[n][r].x));
        if (!full && k0 + n * 8 + c2 + (e & 1) >= L) val = -CUDART_INF_F;
        z[n][e] = val;
      }
    }
  };

  // p16 of the step from e (K8, QKV4 e * (1 / sum e); K9 e / sum e, the
  // correctly rounded quotient from the row's reciprocal and one fma
  // correction, Markstein's; QKV e itself, out scaled at the end), swapped
  // with the pair's other warp, then out += p16 @ v16
  // over the step's keys, in key order, for this warp's columns (stage rows vr)
  auto pv_step = [&](const float (*e16)[4], const bf16* vr, int kb) {
    unsigned pa[NC][4];  // the A fragments of the warp's 16-key chunks
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float ev = e16[n][e];
        if constexpr (SCALE_END) {
          p[e] = ev;
        } else if constexpr (LAYOUT == WINDOWED) {
          const float q0 = ev * ry[r];
          p[e] = fmaf(fmaf(-q0, rs[r], ev), ry[r], q0);
        } else {
          p[e] = ev * rs[r];
        }
      }
      pa[n / 2][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      pmine[parity * PAR + c * 32] = make_uint4(pa[c][0], pa[c][1], pa[c][2], pa[c][3]);
    }
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + wt));
    vr += voff;
#pragma unroll
    for (int h2 = 0; h2 < 2 * NC; ++h2) {
      if (kb + h2 * 16 < L) {
        unsigned af[4];  // the A fragment of keys kb + 16 h2 ..: this warp's or its pair's
        if (h2 / NC == dsub) {
#pragma unroll
          for (int x = 0; x < 4; ++x) af[x] = pa[h2 % NC][x];
        } else {
          const uint4 pw = ppart[parity * PAR + (h2 % NC) * 32];
          af[0] = pw.x;
          af[1] = pw.y;
          af[2] = pw.z;
          af[3] = pw.w;
        }
#pragma unroll
        for (int j = 0; j < NO / 2; ++j) {
          unsigned b[4];
          ldsm4_t(b, vr + h2 * 16 * LDQ + j * 16);
          mma16816(o[2 * j], af, b[0], b[1]);
          mma16816(o[2 * j + 1], af, b[2], b[3]);
        }
      }
    }
    parity ^= 1;
  };

  // the rows' sum of e across the quad, then the pair (warp 0's + warp 1's),
  // in place in l; the rows' 1 / sum e (0 past lq) into rs
  auto finish_sums = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if ((lane & 3) == 0) xmine[16 * r + 1] = l[r];
    }
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + wt));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = xpair[16 * r + 1] + xpair[16 * r + rt * 32 + 1];
      rs[r] = LAYOUT == WINDOWED ? l[r] : (rok[r] ? 1.0f / l[r] : 0.0f);
      ry[r] = 1.0f / l[r];
    }
  };

  if constexpr (ONE) {
    // (QKV beyond L = 192) one sweep over the k and v tiles: e = exp(z) and
    // the lane's sum of e in key order, out += bf16(e) @ v16 in registers;
    // out is scaled by 1 / sum e at the end (K1's max-free softmax needs no
    // second look at the keys)
    for (int i = 0; i < nitems; ++i) {
      bf16* st = next_item(i);
      if (!active) continue;
#pragma unroll
      for (int ss = 0; ss < SUB; ++ss) {
        const int kb = i * S::KS + ss * STEP;
        if (kb >= L) break;
        float z[NT][4];
        if (kb + STEP <= L) {
          scores(true, z, st + ss * STEP * LDQ, kb);
        } else {
          scores(false, z, st + ss * STEP * LDQ, kb);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ev = expf(z[n][e]);  // 0 past L
            z[n][e] = ev;
            l[e >> 1] += ev;
          }
        }
        pv_step(z, st + (S::KS + ss * STEP) * LDQ, kb);
      }
    }
    if (active) finish_sums();
  } else if constexpr (Z) {
    // sweep 1: the k tiles; each warp keeps z of its keys and its lanes' max
    float zr[S::ZST][NT][4];
#pragma unroll
    for (int st = 0; st < S::ZST; ++st) {  // -inf (e = 0) for the keys past the last stage
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) zr[st][n][e] = -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int kt = 0; kt < S::ZST / SUB; ++kt) {
      if (kt < nkt) {
        bf16* kst = next_item(kt);
        if (active) {
#pragma unroll
          for (int ss = 0; ss < SUB; ++ss) {
            const int kb = kt * S::KS + ss * STEP;
            float(*z)[4] = zr[kt * SUB + ss];
            if (kb + STEP <= L) {
              scores(true, z, kst + ss * STEP * LDQ, kb);
            } else if (kb < L) {
              scores(false, z, kst + ss * STEP * LDQ, kb);
            }
            if constexpr (!MAXFREE) {
#pragma unroll
              for (int n = 0; n < NT; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], z[n][e]);
              }
            }
          }
        }
      }
    }
    // the rows' max (quad, then the pair; MAXFREE: none), e = exp(z - m) in
    // place and the rows' sum of e (the lane's in key order, the quad's, warp
    // 0's + warp 1's)
    if (active) {
      if constexpr (!MAXFREE) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
          m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
          if ((lane & 3) == 0) xmine[16 * r] = m[r];
        }
        asm volatile("bar.sync %0, 64;\n" ::"r"(1 + wt));
#pragma unroll
        for (int r = 0; r < 2; ++r) m[r] = fmaxf(xpair[16 * r], xpair[16 * r + rt * 32]);
      }
#pragma unroll
      for (int st = 0; st < S::ZST; ++st) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ev = expf(zr[st][n][e] - m[e >> 1]);  // 0 past L
            zr[st][n][e] = ev;
            l[e >> 1] += ev;
          }
        }
      }
      finish_sums();
    }
    // sweep 2: the v tiles, out += p16 @ v16
#pragma unroll
    for (int kt = 0; kt < S::ZST / SUB; ++kt) {
      if (kt < nkt) {
        bf16* vst = next_item(nkt + kt);
        if (active) {
#pragma unroll
          for (int ss = 0; ss < SUB; ++ss) {
            const int kb = kt * S::KS + ss * STEP;
            if (kb < L) pv_step(zr[kt * SUB + ss], vst + ss * STEP * LDQ, kb);
          }
        }
      }
    }
  } else {
    for (int i = 0; i < nitems; ++i) {
      if (i == nkt) {  // sweep 1 done: merge the statistics of the quad's lanes
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int x = 1; x <= 2; x <<= 1) {
            const float m2 = __shfl_xor_sync(0xffffffffu, m[r], x);
            const float l2 = __shfl_xor_sync(0xffffffffu, l[r], x);
            merge_stat(m[r], l[r], m2, l2);
          }
          if ((lane & 3) == 0) {
            xmine[16 * r] = m[r];
            xmine[16 * r + 1] = l[r];
          }
        }
      }
      bf16* kst = next_item(i);
      if (i == nkt) {  // the rows' statistics: the pair's merged, in order
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m[r] = xpair[16 * r];
          l[r] = xpair[16 * r + 1];
          merge_stat(m[r], l[r], xpair[16 * r + rt * 32], xpair[16 * r + rt * 32 + 1]);
          rs[r] = LAYOUT == WINDOWED ? l[r] : (rok[r] ? 1.0f / l[r] : 0.0f);
          ry[r] = 1.0f / l[r];
        }
      }
      if (!active) continue;
      const bool sweep2 = i >= nkt;
      const int kt = i % nkt;
#pragma unroll
      for (int ss = 0; ss < SUB; ++ss) {
        const int kb = kt * S::KS + ss * STEP;  // the step's first key
        if (kb >= L) break;
        float z[NT][4];
        if (kb + STEP <= L) {
          scores(true, z, kst + ss * STEP * LDQ, kb);
        } else {
          scores(false, z, kst + ss * STEP * LDQ, kb);
        }
        if (!sweep2) {  // the lane's running max and sum of e, the sum rescaled as the max moves
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float tmax = -CUDART_INF_F;
#pragma unroll
            for (int n = 0; n < NT; ++n) tmax = fmaxf(tmax, fmaxf(z[n][2 * r], z[n][2 * r + 1]));
            if (!MAXFREE && tmax > m[r]) {
              l[r] *= expf(m[r] - tmax);
              m[r] = tmax;
            }
#pragma unroll
            for (int n = 0; n < NT; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float zz = z[n][2 * r + e];
                if (zz != -CUDART_INF_F) l[r] += expf(zz - m[r]);
              }
            }
          }
        } else {  // e from the final max, then p16 and out += p16 @ v16
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              z[n][e] = z[n][e] == -CUDART_INF_F ? 0.0f : expf(z[n][e] - m[e >> 1]);
            }
          }
          pv_step(z, kst + (S::KS + ss * STEP) * LDQ, kb);
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is past its products: q's rows take out
  if (active) {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bf16* dst = qs + (wt * 16 + (lane >> 2) + 8 * r) * LDQ + dsub * DW + j * 8 + c2;
        // SCALE_END: out = (e16 @ v16) * (1 / sum e)
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(SCALE_END ? o[j][2 * r] * rs[r] : o[j][2 * r],
                                  SCALE_END ? o[j][2 * r + 1] * rs[r] : o[j][2 * r + 1]);
      }
    }
  }
  __syncthreads();
  // the block's real rows, 16 bytes a thread (exact zeros in the pad lanes)
  const int nrows = min(rt * 16, LQ - row0);
  for (int idx = threadIdx.x; idx < nrows * (HP / 8); idx += blockDim.x) {
    const int rr = idx / (HP / 8);
    const int c = (idx % (HP / 8)) * 8;
    const int l = row0 + rr;
    const size_t off = base + c + (TABLE ? static_cast<size_t>(tok[l]) * g.ldo
                                         : static_cast<size_t>(l) * HD);
    *reinterpret_cast<uint4*>(out + off) =
        c < HD ? *reinterpret_cast<const uint4*>(qs + rr * LDQ + c) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// the d(scale) reduction of the streamed backwards (qkv_attention_large.cuh
// reduce_partials)
// ---------------------------------------------------------------------------

// dscale[h] = sum over windows (in window order) of part[win, h], divided by
// scale[h] when divide (K8's identity form)
static __global__ void attn_dscale_reduce_kernel(const float* __restrict__ part, int n_win,
                                                 int heads, const float* __restrict__ scale,
                                                 int divide, float* __restrict__ dscale) {
  const int hh = blockIdx.x * blockDim.x + threadIdx.x;
  if (hh >= heads) return;
  float acc = 0.0f;
  for (int w = 0; w < n_win; ++w) acc += part[static_cast<size_t>(w) * heads + hh];
  dscale[hh] = divide ? acc / scale[hh] : acc;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct FwdArgs {
  const void *q, *k, *v, *scale, *bias, *mask;
  float bflag;
  void* out;
};

inline int n_blocks(const AttnGeo& g, unsigned* blocks) {
  const long long n = static_cast<long long>(g.B) * g.nwh * g.nww * g.heads;
  if (n < 1 || n > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(n);
  return 0;
}

// Opts the forward instance into its dynamic shared memory, with the SM's
// carveout at its shared-memory maximum so that two or three blocks fit.
template <class K>
int set_fwd_smem(K kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared));
}

template <int HD, int LAYOUT, bool BIAS, bool Z, int HP = HD>
int launch_fwd_as(const FwdArgs& a, const AttnGeo& g, cudaStream_t stream) {
  const FwdPlan p = fwd_plan<HD, Z>(g.L, g.lq);
  unsigned blocks;
  if (n_blocks(g, &blocks) != 0 || static_cast<long long>(blocks) * p.nchunk > 2147483647LL ||
      g.lq < g.L || g.lq > g.LP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = qkv_attention_fwd_kernel<HD, LAYOUT, BIAS, Z, HP>;
  const int code = set_fwd_smem(kernel, p.smem);
  if (code != 0) return code;
  kernel<<<blocks * p.nchunk, p.rt * 2 * 32, p.smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const float*>(a.scale),
      static_cast<const float*>(a.bias), static_cast<const float*>(a.mask), a.bflag,
      static_cast<bf16*>(a.out), g, p.rt, p.nchunk);
  return static_cast<int>(cudaGetLastError());
}

// The Z path where it applies (L <= ZL), else the streamed one.
template <int HD, int LAYOUT, bool BIAS, int HP = HD>
int launch_fwd(const FwdArgs& a, const AttnGeo& g, cudaStream_t stream) {
  return g.L <= ZL ? launch_fwd_as<HD, LAYOUT, BIAS, true, HP>(a, g, stream)
                   : launch_fwd_as<HD, LAYOUT, BIAS, false, HP>(a, g, stream);
}

// The forward instance's launch at window length L (lq query rows), into
// info[0..6]: threads a block, dynamic shared memory, registers a thread,
// local (spill) bytes a thread, resident blocks per SM, blocks per (window,
// head), 1 on the Z path.
template <int HD, int LAYOUT, bool BIAS, bool Z, int HP = HD>
int fwd_info_as(int L, int lq, int* info) {
  const FwdPlan p = fwd_plan<HD, Z>(L, lq);
  auto kernel = qkv_attention_fwd_kernel<HD, LAYOUT, BIAS, Z, HP>;
  int code = set_fwd_smem(kernel, p.smem);
  if (code != 0) return code;
  cudaFuncAttributes attr;
  code = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
  if (code != 0) return code;
  const int threads = p.rt * 2 * 32;
  int resident = 0;
  code = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, p.smem));
  if (code != 0) return code;
  info[0] = threads;
  info[1] = static_cast<int>(p.smem);
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = resident;
  info[5] = p.nchunk;
  info[6] = Z ? 1 : 0;
  return 0;
}

template <int HD, int LAYOUT, bool BIAS, int HP = HD>
int fwd_info(int L, int lq, int* info) {
  return L <= ZL ? fwd_info_as<HD, LAYOUT, BIAS, true, HP>(L, lq, info)
                 : fwd_info_as<HD, LAYOUT, BIAS, false, HP>(L, lq, info);
}

// Picks the head-dim and BIAS instance; BIAS when a bias pointer is given.
template <int LAYOUT>
int dispatch_fwd(int hd, const FwdArgs& a, const AttnGeo& g, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bias = a.bias != nullptr;
  switch (hd) {
    case 32:
      return bias ? launch_fwd<32, LAYOUT, true>(a, g, s) : launch_fwd<32, LAYOUT, false>(a, g, s);
    case 64:
      return bias ? launch_fwd<64, LAYOUT, true>(a, g, s) : launch_fwd<64, LAYOUT, false>(a, g, s);
    case 96:
      return bias ? launch_fwd<96, LAYOUT, true>(a, g, s) : launch_fwd<96, LAYOUT, false>(a, g, s);
    case 128:
      return bias ? launch_fwd<128, LAYOUT, true>(a, g, s)
                  : launch_fwd<128, LAYOUT, false>(a, g, s);
    case 256:
      return bias ? launch_fwd<256, LAYOUT, true>(a, g, s)
                  : launch_fwd<256, LAYOUT, false>(a, g, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int LAYOUT>
int dispatch_fwd_info(int hd, bool bias, int L, int* info) {
  switch (hd) {
    case 32:
      return bias ? fwd_info<32, LAYOUT, true>(L, L, info) : fwd_info<32, LAYOUT, false>(L, L, info);
    case 64:
      return bias ? fwd_info<64, LAYOUT, true>(L, L, info) : fwd_info<64, LAYOUT, false>(L, L, info);
    case 96:
      return bias ? fwd_info<96, LAYOUT, true>(L, L, info) : fwd_info<96, LAYOUT, false>(L, L, info);
    case 128:
      return bias ? fwd_info<128, LAYOUT, true>(L, L, info) : fwd_info<128, LAYOUT, false>(L, L, info);
    case 256:
      return bias ? fwd_info<256, LAYOUT, true>(L, L, info) : fwd_info<256, LAYOUT, false>(L, L, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Fills the geometry from the launch arguments; false if they are not valid
// (any L).
inline bool make_attn_geo(AttnGeo& g, int B, int H, int W, int heads, int wh, int ww, int L,
                          int nwh, int nww, int ldq, int ldk, int ldv, int ldo) {
  if (B < 1 || heads < 1 || L < 1 || nwh < 1 || nww < 1 || ldq % 8 != 0 || ldk % 8 != 0 ||
      ldv % 8 != 0 || ldo % 8 != 0) {
    return false;
  }
  g.B = B;
  g.H = H;
  g.W = W;
  g.heads = heads;
  g.wh = wh;
  g.ww = ww;
  g.L = L;
  g.LP = (L + 15) / 16 * 16;
  g.nwh = nwh;
  g.nww = nww;
  g.ldq = ldq;
  g.ldk = ldk;
  g.ldv = ldv;
  g.ldo = ldo;
  g.lq = L;
  return true;
}

// K8's geometry: the NHWC grid [B, H, W, C], q, k, v with pixel strides ldq,
// ldk, ldv; g and the outputs contiguous (stride C).
inline bool grid_geo(AttnGeo& g, int B, int H, int W, int C, int heads, int wh, int ww, int ldq,
                     int ldk, int ldv) {
  return wh >= 1 && ww >= 1 && heads >= 1 && H % wh == 0 && W % ww == 0 && C % heads == 0 &&
         make_attn_geo(g, B, H, W, heads, wh, ww, wh * ww, H / wh, W / ww, ldq, ldk, ldv, C);
}

// K9's geometry: contiguous windowed [B * nwh * nww, heads, L, hd] tensors.
inline bool windowed_geo(AttnGeo& g, int B, int nwh, int nww, int heads, int hd, int L) {
  return hd >= 16 && make_attn_geo(g, B, 0, 0, heads, 0, 0, L, nwh, nww, hd, hd, hd, hd);
}

}  // namespace swin_qkv_attn
