// Window attention on pre-projected q, k, v, forward and backward, hand-written
// for Hopper (sm_90a): one set of templates for the grid-layout kernels (K8,
// window_attention_grid.cu) and the windowed-layout kernels (K9,
// window_attention_v1.cu), each with a CPB-bias instance.
//
// Replaces the TPU kernels of swin_v2_weather_tpu/ops/window_attention.py:
//   K8  _make_grid_kernel (forward, launched by _grid_forward) and
//       _make_grid_bwd_kernel (backward, _grid_backward), reached through
//       fused_window_attention_grid (attn_impl 'pallas'). q and k arrive
//       L2-normalized per head (the normalization and its VJP stay outside, in
//       plain PyTorch, as they stay in XLA there); the kernels read q, k, v and
//       g in the model's NHWC grid [B, H, W, C] and write dq, dk, dv there,
//       windowing by index math. q, k and v may be channel slices of one
//       [B, H, W, 3C] tensor: each is read with its own pixel stride, so the
//       wrapper copies nothing.
//   K9  _make_kernel (forward, _pallas_forward) and _make_v1_bwd_kernel
//       (backward, _v1_backward), reached through fused_window_attention
//       (attn_impl 'pallas_v1'): windowed [Bw, heads, L, D] tensors, with the
//       per-row L2 normalization of q and k and its VJP inside the kernels.
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
// call in fp32 if they did).
//
// What the design does about it: one block per (image, window, head), heads
// fastest, LP / 16 warps (LP = L rounded up to 16; 11 warps at L = 162), q, k,
// v (and g) tiles [LP, HD] staged once in shared memory by cp.async (padded
// rows zero-filled), so every input byte is read from device memory once and
// every output byte written once; the scores live in registers and a per-warp
// 16 x 16 fp32 scratch tile. Each warp owns 16 query rows and sweeps the key
// tiles on nvcuda::wmma bf16 fragments with fp32 accumulation. Unlike K1/K7
// the softmax subtracts the row max and normalizes before the p @ v product,
// as the TPU kernels do, so the forward sweeps the score tiles three times
// (row max, row sum, then bf16(p) into a per-warp row buffer) and recomputes
// the cheap [16, 16, HD] products rather than keeping [16, LP] fp32 rows
// (which would not fit beside q, k and v in 227 KB). The backward follows
// K2's split (window_attention_qkv_bwd.cu): pass 1 with query rows per warp
// (row max; row sum, with K8 also u = sum(dp e); K9's u = sum(dp p) in a third
// sweep; then ds into the row buffer, dq = ds @ kn), pass 2 with key rows per
// warp (dv = p^T g, dk = ds^T qn) from the saved per-row max, sum and u. The
// TPU kernels carry d(scale) and d(bias) in VMEM across a sequential grid; the
// blocks here run in parallel, so each (window, head) writes a d(scale)
// partial and, with the bias, an fp32 [LP, LP] d(bias) partial, and small
// kernels sum them in window order: no atomics, two calls give the same bits.
// wgmma/TMA, a persistent schedule and fewer score sweeps come later; this is
// the simple, correct baseline.
//
// Rounding sites (the TPU kernels' contracts):
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
//
// Contract (checked by the Python wrappers): bf16 q, k, v, g; fp32 scale
// [heads], bias [heads, L, L] (BIAS only) and mask [L, L] or null; head dim in
// {32, 64, 96, 128}; L <= 256; pixel strides (K8) multiples of 8 elements and
// 16-byte aligned bases; each direction's shared memory within 227 KB (at
// L = 162: head dims up to 128 forward, 96 backward). Larger head dims take
// the large-head variant (qkv_attention_large.cuh).

#pragma once

#include <math_constants.h>

#include "window_attention_common.cuh"

namespace swin_qkv_attn {

using namespace swin_attn;

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may opt into
constexpr int GRID = 0;           // K8: NHWC grid [B, H, W, C], q and k pre-normalized
constexpr int WINDOWED = 1;       // K9: [Bw, heads, L, D], q and k normalized inside

struct AttnGeo {
  int B, H, W, heads, wh, ww, L, LP, nwh, nww;
  int ldq, ldk, ldv, ldo;  // pixel strides in elements (GRID): q, k, v; g and outputs
};

// Window index in h-major order (the order of window_partition).
__device__ __forceinline__ int window_index(const AttnGeo& g, const Tile& t) {
  return (t.bi * g.nwh + t.wr) * g.nww + t.wc;
}

// Element offset of token l's head slice in a tensor of pixel stride ld.
template <int LAYOUT, int HD>
__device__ __forceinline__ size_t row_offset(const AttnGeo& g, const Tile& t, int l, int ld) {
  if constexpr (LAYOUT == GRID) {
    const int row = t.wr * g.wh + l / g.ww;
    const int col = t.wc * g.ww + l % g.ww;
    const size_t pix = (static_cast<size_t>(t.bi) * g.H + row) * g.W + col;
    return pix * ld + static_cast<size_t>(t.h) * HD;
  } else {
    const size_t win = static_cast<size_t>(window_index(g, t));
    return ((win * g.heads + t.h) * g.L + l) * HD;
  }
}

// Stages the block's [LP, HD] tile of src (row pitch HD + 8) by cp.async;
// padded rows are zero-filled. The caller commits and waits.
template <int LAYOUT, int HD>
__device__ void load_tile(bf16* dst, const bf16* __restrict__ src, int ld, const AttnGeo& g,
                          const Tile& t) {
  constexpr int LDQ = HD + 8;
  for (int idx = threadIdx.x; idx < g.LP * (HD / 8); idx += blockDim.x) {
    const int l = idx / (HD / 8);
    const int c = (idx % (HD / 8)) * 8;
    const bool ok = l < g.L;
    const bf16* s = src + (ok ? row_offset<LAYOUT, HD>(g, t, l, ld) + c : 0);
    cp_async16(dst + l * LDQ + c, s, ok);
  }
}

template <int HD>
size_t fwd_smem_bytes(int LP) {
  const size_t nwarps = LP / 16;
  return 3u * LP * (HD + 8) * sizeof(bf16) + nwarps * 256 * sizeof(float) +
         nwarps * 16 * (LP + 8) * sizeof(bf16);
}

template <int HD>
size_t bwd_smem_bytes(int LP) {
  const size_t nwarps = LP / 16;
  return 4u * LP * (HD + 8) * sizeof(bf16) + nwarps * 256 * sizeof(float) +
         nwarps * 16 * (LP + 8) * sizeof(bf16) + (5u * LP + 32) * sizeof(float);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int HD, int LAYOUT, bool BIAS>
__global__ void __launch_bounds__(MAX_LP * 2)
    qkv_attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ scale,
                             const float* __restrict__ bias, const float* __restrict__ mask,
                             float bflag, bf16* __restrict__ out, AttnGeo g) {
  constexpr int NF = HD / 16;
  constexpr int LDQ = HD + 8;

  extern __shared__ __align__(128) unsigned char smem[];
  const int LP = g.LP;
  const int L = g.L;
  const int nwarps = LP / 16;
  const int LDP = LP + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + LP * LDQ;
  bf16* vs = ks + LP * LDQ;
  float* scratch = reinterpret_cast<float*>(vs + LP * LDQ);
  bf16* pbuf = reinterpret_cast<bf16*>(scratch + nwarps * 256);  // bf16(p), 16 x LDP per warp

  const Tile t = tile_of_block(g);
  const int h = t.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* cs = scratch + warp * 256;
  const int fr = lane >> 1;       // fragment row this lane finishes
  const int fc = (lane & 1) * 8;  // first of its 8 fragment columns

  load_tile<LAYOUT, HD>(qs, q, g.ldq, g, t);
  load_tile<LAYOUT, HD>(ks, k, g.ldk, g, t);
  load_tile<LAYOUT, HD>(vs, v, g.ldv, g, t);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (LAYOUT == WINDOWED) {  // K9 normalizes q and k rows in place
    normalize_rows<HD>(qs, nullptr);
    normalize_rows<HD>(ks, nullptr);
    __syncthreads();
  }

  const float sc = scale[h];
  const int qrow = warp * 16 + fr;
  const bool qok = qrow < L;
  const float* brow = (BIAS && qok) ? bias + (static_cast<size_t>(h) * L + qrow) * L : nullptr;
  const float* mrow =
      (mask != nullptr && t.wr == g.nwh - 1 && qok) ? mask + static_cast<size_t>(qrow) * L : nullptr;
  const bf16* qw = qs + warp * 16 * LDQ;
  const int nkt = LP / 16;

  // z of the lane's 8 entries of the score tile key0.. (in cs); -inf outside
  // the L x L window
  auto logits = [&](int key0, float (&z)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int key = key0 + e;
      float val = -CUDART_INF_F;
      if (qok && key < L) {
        val = __fmul_rn(cs[fr * 16 + fc + e], sc);
        if (brow != nullptr) val = __fadd_rn(val, brow[key]);
        if (mrow != nullptr) val = __fadd_rn(val, __fmul_rn(bflag, mrow[key]));
      }
      z[e] = val;
    }
  };
  auto score_tile = [&](int kt) {
    Frag s;
    dot_rows<HD>(s, qw, ks + kt * 16 * LDQ);
    wmma::store_matrix_sync(cs, s, 16, wmma::mem_row_major);
    __syncwarp();
  };

  float z[8];
  float m = -CUDART_INF_F;
  for (int kt = 0; kt < nkt; ++kt) {  // sweep 1: row max
    score_tile(kt);
    logits(kt * 16 + fc, z);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, z[e]);
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));  // the two lanes of a row

  float rowsum = 0.0f;
  for (int kt = 0; kt < nkt; ++kt) {  // sweep 2: row sum of e = exp(z - m)
    score_tile(kt);
    logits(kt * 16 + fc, z);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (qok && kt * 16 + fc + e < L) rowsum += expf(z[e] - m);
    }
  }
  rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
  const float rinv = qok ? 1.0f / rowsum : 0.0f;

  bf16* pw = pbuf + warp * 16 * LDP;
  for (int kt = 0; kt < nkt; ++kt) {  // sweep 3: bf16(p) into the row buffer
    score_tile(kt);
    logits(kt * 16 + fc, z);
    __align__(16) bf16 pv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float p = 0.0f;
      if (qok && kt * 16 + fc + e < L) {
        const float ev = expf(z[e] - m);
        p = LAYOUT == GRID ? ev * rinv : ev / rowsum;
      }
      pv[e] = __float2bfloat16(p);
    }
    *reinterpret_cast<uint4*>(pw + fr * LDP + kt * 16 + fc) = *reinterpret_cast<const uint4*>(pv);
    __syncwarp();
  }

  Frag o[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(o[j], 0.0f);
  for (int kt = 0; kt < nkt; ++kt) {  // out = bf16(p) @ v16
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, pw + kt * 16, LDP);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, vs + kt * 16 * LDQ + j * 16, LDQ);
      wmma::mma_sync(o[j], a, b, o[j]);
    }
  }
  const size_t off = qok ? row_offset<LAYOUT, HD>(g, t, qrow, g.ldo) : 0;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(cs, o[j], 16, wmma::mem_row_major);
    __syncwarp();
    if (qok) {
      store8(out + off + j * 16 + fc, cs + fr * 16 + fc, [](int, float a) { return a; });
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <int HD, int LAYOUT, bool BIAS>
__global__ void __launch_bounds__(MAX_LP * 2)
    qkv_attention_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ gout,
                             const float* __restrict__ scale, const float* __restrict__ bias,
                             const float* __restrict__ mask, float bflag, bf16* __restrict__ dq,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             float* __restrict__ dscale_part, float* __restrict__ dbias_part,
                             AttnGeo geo) {
  constexpr int NF = HD / 16;
  constexpr int LDQ = HD + 8;
  constexpr bool NORM_IN = LAYOUT == WINDOWED;  // K9: normalization and its VJP inside

  extern __shared__ __align__(128) unsigned char smem[];
  const int LP = geo.LP;
  const int L = geo.L;
  const int nwarps = LP / 16;
  const int LDP = LP + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + LP * LDQ;
  bf16* vs = ks + LP * LDQ;
  bf16* gs = vs + LP * LDQ;
  float* scratch = reinterpret_cast<float*>(gs + LP * LDQ);
  bf16* rowbuf = reinterpret_cast<bf16*>(scratch + nwarps * 256);  // 16 x LDP per warp
  float* mrow = reinterpret_cast<float*>(rowbuf + nwarps * 16 * LDP);  // row max of z
  float* srow = mrow + LP;  // K8: 1 / sum e; K9: sum e
  float* urow = srow + LP;  // K8: sum(dp e); K9: sum(dp p)
  float* inv_q = urow + LP;
  float* inv_k = inv_q + LP;
  float* wsum = inv_k + LP;  // per-warp d(scale) sums

  const Tile t = tile_of_block(geo);
  const int h = t.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* cs = scratch + warp * 256;
  const int fr = lane >> 1;
  const int fc = (lane & 1) * 8;

  load_tile<LAYOUT, HD>(qs, q, geo.ldq, geo, t);
  load_tile<LAYOUT, HD>(ks, k, geo.ldk, geo, t);
  load_tile<LAYOUT, HD>(vs, v, geo.ldv, geo, t);
  load_tile<LAYOUT, HD>(gs, gout, geo.ldo, geo, t);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (NORM_IN) {
    normalize_rows<HD>(qs, inv_q);
    normalize_rows<HD>(ks, inv_k);
    __syncthreads();
  }

  const float sc = scale[h];
  const int nkt = LP / 16;
  const int win = window_index(geo, t);
  const float* bh = BIAS ? bias + static_cast<size_t>(h) * L * L : nullptr;
  const float* mk = (mask != nullptr && t.wr == geo.nwh - 1) ? mask : nullptr;
  bf16* pw = rowbuf + warp * 16 * LDP;

  auto scores = [&](const bf16* a_rows, const bf16* b_rows) {  // cs = a_rows @ b_rows^T
    Frag s;
    dot_rows<HD>(s, a_rows, b_rows);
    wmma::store_matrix_sync(cs, s, 16, wmma::mem_row_major);
    __syncwarp();
  };
  // s (the lane's 8 entries of the score tile in cs, query row qi, keys
  // key0..) and z = s * scale (+ bias) (+ bflag * mask); ok outside the window
  // is false and z there is -inf
  auto logits = [&](int qi, int key0, float (&s)[8], float (&z)[8], bool (&ok)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int key = key0 + e;
      s[e] = cs[fr * 16 + fc + e];
      ok[e] = qi < L && key < L;
      float val = -CUDART_INF_F;
      if (ok[e]) {
        val = __fmul_rn(s[e], sc);
        if (bh != nullptr) val = __fadd_rn(val, bh[qi * L + key]);
        if (mk != nullptr) val = __fadd_rn(val, __fmul_rn(bflag, mk[qi * L + key]));
      }
      z[e] = val;
    }
  };
  // softmax probability: K8 e * (1 / sum e) (sr = 1 / sum e), K9 e / sum e (sr = sum e)
  auto prob = [&](bool ok, float z, float m, float sr) -> float {
    if (!ok) return 0.0f;
    const float ev = expf(z - m);
    return LAYOUT == GRID ? ev * sr : ev / sr;
  };
  // ds, unscaled: K8 (dp - u r) e r, K9 p (dp - u)
  auto dlogit = [&](bool ok, float z, float dp, float m, float sr, float u) -> float {
    if (!ok) return 0.0f;
    const float ev = expf(z - m);
    return LAYOUT == GRID ? (dp - u * sr) * ev * sr : ev / sr * (dp - u);
  };

  float s[8], z[8];
  bool ok[8];

  // ---------------- pass 1: this warp's 16 query rows ------------------------
  const int qrow = warp * 16 + fr;
  const bool qok = qrow < L;
  const bf16* qw = qs + warp * 16 * LDQ;
  const bf16* gw = gs + warp * 16 * LDQ;

  float m = -CUDART_INF_F;
  for (int kt = 0; kt < nkt; ++kt) {  // row max
    scores(qw, ks + kt * 16 * LDQ);
    logits(qrow, kt * 16 + fc, s, z, ok);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, z[e]);
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  float rowsum = 0.0f, u = 0.0f;
  for (int kt = 0; kt < nkt; ++kt) {  // row sum of e; K8 also u = sum(dp e)
    scores(qw, ks + kt * 16 * LDQ);
    logits(qrow, kt * 16 + fc, s, z, ok);
    __syncwarp();
    if constexpr (LAYOUT == GRID) scores(gw, vs + kt * 16 * LDQ);  // dp = g v^T
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float ev = ok[e] ? expf(z[e] - m) : 0.0f;
      rowsum += ev;
      if constexpr (LAYOUT == GRID) u += cs[fr * 16 + fc + e] * ev;
    }
    __syncwarp();
  }
  rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
  const float sr = LAYOUT == GRID ? (rowsum > 0.0f ? 1.0f / rowsum : 0.0f) : rowsum;
  if constexpr (LAYOUT == WINDOWED) {  // u = sum(dp p) with p = e / sum e
    for (int kt = 0; kt < nkt; ++kt) {
      scores(qw, ks + kt * 16 * LDQ);
      logits(qrow, kt * 16 + fc, s, z, ok);
      __syncwarp();
      scores(gw, vs + kt * 16 * LDQ);
#pragma unroll
      for (int e = 0; e < 8; ++e) u += cs[fr * 16 + fc + e] * prob(ok[e], z[e], m, sr);
      __syncwarp();
    }
  }
  u += __shfl_xor_sync(0xffffffffu, u, 1);
  if ((lane & 1) == 0) {
    mrow[qrow] = m;
    srow[qrow] = sr;
    urow[qrow] = u;
  }

  // ds rows: bf16(ds * scale) into the row buffer, ds itself into the block's
  // d(bias) partial (BIAS), and K9's d(scale) partial sum(ds * s)
  float* drow = nullptr;
  if constexpr (BIAS) {
    drow = dbias_part + ((static_cast<size_t>(win) * geo.heads + h) * LP + qrow) * LP;
  }
  float dsc = 0.0f;
  for (int kt = 0; kt < nkt; ++kt) {
    scores(qw, ks + kt * 16 * LDQ);
    logits(qrow, kt * 16 + fc, s, z, ok);
    __syncwarp();
    scores(gw, vs + kt * 16 * LDQ);
    float ds[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ds[e] = dlogit(ok[e], z[e], cs[fr * 16 + fc + e], m, sr, u);
      dsc += ds[e] * s[e];
    }
    store8(pw + fr * LDP + kt * 16 + fc, ds, [&](int, float d) { return d * sc; });
    if constexpr (BIAS) {  // ds = 0 outside the window, so padded entries get 0
      float4* dst = reinterpret_cast<float4*>(drow + kt * 16 + fc);
      dst[0] = make_float4(ds[0], ds[1], ds[2], ds[3]);
      dst[1] = make_float4(ds[4], ds[5], ds[6], ds[7]);
    }
    __syncwarp();
  }

  Frag acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int kt = 0; kt < nkt; ++kt) {  // dqn = dsb @ kn16
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, pw + kt * 16, LDP);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, ks + kt * 16 * LDQ + j * 16, LDQ);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
  // <qn, dqn> of the row: K8 with the stored qn16; K9 with qn = q * inv_q in
  // fp32, q re-read from device memory
  const float iq = NORM_IN ? inv_q[qrow] : 1.0f;
  const bf16* qraw = (NORM_IN && qok) ? q + row_offset<LAYOUT, HD>(geo, t, qrow, geo.ldq) : nullptr;
  auto qn_at = [&](int d) -> float {
    if constexpr (NORM_IN) {
      return qok ? __bfloat162float(qraw[d]) * iq : 0.0f;
    } else {
      return __bfloat162float(qs[qrow * LDQ + d]);
    }
  };
  float qd = 0.0f;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(cs, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) qd += qn_at(j * 16 + fc + e) * cs[fr * 16 + fc + e];
    __syncwarp();
  }
  qd += __shfl_xor_sync(0xffffffffu, qd, 1);
  {
    const size_t off = qok ? row_offset<LAYOUT, HD>(geo, t, qrow, geo.ldo) : 0;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(cs, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      if (qok) {
        store8(dq + off + j * 16 + fc, cs + fr * 16 + fc, [&](int e, float dqn) {
          if constexpr (NORM_IN) {
            return (dqn - qn_at(j * 16 + fc + e) * qd) * iq;
          } else {
            return dqn;
          }
        });
      }
      __syncwarp();
    }
  }
  // the block's d(scale) partial, in a fixed order: K8 sum over rows of
  // <qn16, dqn> (divided by scale in the reduction), K9 sum(ds * s)
  float part;
  if constexpr (LAYOUT == GRID) {
    part = (qok && (lane & 1) == 0) ? qd : 0.0f;
  } else {
    part = dsc;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) wsum[warp] = part;
  __syncthreads();  // the per-row max, sums and u of every query row are in place too
  if (tid == 0) {
    float total = 0.0f;
    for (int i = 0; i < nwarps; ++i) total += wsum[i];
    dscale_part[static_cast<size_t>(win) * geo.heads + h] = total;
  }

  // ---------------- pass 2: this warp's 16 key rows --------------------------
  const int krow = warp * 16 + fr;
  const bool kok = krow < L;
  const bf16* kw = ks + warp * 16 * LDQ;
  const bf16* vw = vs + warp * 16 * LDQ;
  bf16* pt = pw;  // one 16 x 16 bf16 tile, [query][key]

#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int qt = 0; qt < nkt; ++qt) {  // dv = p16^T @ g16
    scores(qs + qt * 16 * LDQ, kw);  // s[query][key]
    const int qi = qt * 16 + fr;
    logits(qi, warp * 16 + fc, s, z, ok);
    const float mi = mrow[qi], si = srow[qi];
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) p[e] = prob(ok[e], z[e], mi, si);
    store8(pt + fr * 16 + fc, p, [](int, float a) { return a; });
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;  // p^T
    wmma::load_matrix_sync(a, pt, 16);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, gs + qt * 16 * LDQ + j * 16, LDQ);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
    __syncwarp();
  }
  const size_t koff = kok ? row_offset<LAYOUT, HD>(geo, t, krow, geo.ldo) : 0;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(cs, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    if (kok) store8(dv + koff + j * 16 + fc, cs + fr * 16 + fc, [](int, float a) { return a; });
    __syncwarp();
  }

#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int qt = 0; qt < nkt; ++qt) {  // dkn = dsb^T @ qn16
    scores(qs + qt * 16 * LDQ, kw);
    const int qi = qt * 16 + fr;
    logits(qi, warp * 16 + fc, s, z, ok);
    __syncwarp();
    scores(gs + qt * 16 * LDQ, vw);  // dp[query][key]
    const float mi = mrow[qi], si = srow[qi], ui = urow[qi];
    float ds[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) ds[e] = dlogit(ok[e], z[e], cs[fr * 16 + fc + e], mi, si, ui);
    store8(pt + fr * 16 + fc, ds, [&](int, float d) { return d * sc; });
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;  // dsb^T
    wmma::load_matrix_sync(a, pt, 16);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, qs + qt * 16 * LDQ + j * 16, LDQ);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
    __syncwarp();
  }
  const float ik = NORM_IN ? inv_k[krow] : 1.0f;
  const bf16* kraw = (NORM_IN && kok) ? k + row_offset<LAYOUT, HD>(geo, t, krow, geo.ldk) : nullptr;
  auto kn_at = [&](int d) -> float { return kok ? __bfloat162float(kraw[d]) * ik : 0.0f; };
  float kd = 0.0f;  // K9: <kn, dkn> of the row, kn = k * inv_k in fp32
  if constexpr (NORM_IN) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(cs, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) kd += kn_at(j * 16 + fc + e) * cs[fr * 16 + fc + e];
      __syncwarp();
    }
    kd += __shfl_xor_sync(0xffffffffu, kd, 1);
  }
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(cs, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    if (kok) {
      store8(dk + koff + j * 16 + fc, cs + fr * 16 + fc, [&](int e, float dkn) {
        if constexpr (NORM_IN) {
          return (dkn - kn_at(j * 16 + fc + e) * kd) * ik;
        } else {
          return dkn;
        }
      });
    }
    __syncwarp();
  }
}

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

struct BwdArgs {
  const void *q, *k, *v, *scale, *bias, *mask;
  float bflag;
  const void* g;
  void *dq, *dk, *dv, *dscale_part, *dbias_part, *dscale, *dbias;
};

inline int n_blocks(const AttnGeo& g, unsigned* blocks) {
  const long long n = static_cast<long long>(g.B) * g.nwh * g.nww * g.heads;
  if (n < 1 || n > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(n);
  return 0;
}

template <int HD, int LAYOUT, bool BIAS>
int launch_fwd(const FwdArgs& a, const AttnGeo& g, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<HD>(g.LP);
  unsigned blocks;
  if (smem > static_cast<size_t>(kMaxSmem) || n_blocks(g, &blocks) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(qkv_attention_fwd_kernel<HD, LAYOUT, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  qkv_attention_fwd_kernel<HD, LAYOUT, BIAS><<<blocks, (g.LP / 16) * 32, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const float*>(a.scale),
      static_cast<const float*>(a.bias), static_cast<const float*>(a.mask), a.bflag,
      static_cast<bf16*>(a.out), g);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int LAYOUT, bool BIAS>
int launch_bwd(const BwdArgs& a, const AttnGeo& g, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<HD>(g.LP);
  unsigned blocks;
  if (smem > static_cast<size_t>(kMaxSmem) || n_blocks(g, &blocks) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(qkv_attention_bwd_kernel<HD, LAYOUT, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  qkv_attention_bwd_kernel<HD, LAYOUT, BIAS><<<blocks, (g.LP / 16) * 32, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.bias),
      static_cast<const float*>(a.mask), a.bflag, static_cast<bf16*>(a.dq),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), static_cast<float*>(a.dscale_part),
      static_cast<float*>(a.dbias_part), g);
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  const int n_win = g.B * g.nwh * g.nww;
  attn_dscale_reduce_kernel<<<(g.heads + 31) / 32, 32, 0, stream>>>(
      static_cast<const float*>(a.dscale_part), n_win, g.heads,
      static_cast<const float*>(a.scale), LAYOUT == GRID ? 1 : 0,
      static_cast<float*>(a.dscale));
  code = static_cast<int>(cudaGetLastError());
  if (code != 0 || !BIAS) return code;
  const long long n_bias = static_cast<long long>(g.heads) * g.L * g.L;
  dbias_reduce_kernel<<<static_cast<unsigned>((n_bias + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(a.dbias_part), n_win, g.heads, g.L, g.LP,
      static_cast<float*>(a.dbias));
  return static_cast<int>(cudaGetLastError());
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int LAYOUT>
int dispatch_bwd(int hd, const BwdArgs& a, const AttnGeo& g, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bias = a.bias != nullptr;
  if (bias && (a.dbias_part == nullptr || a.dbias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (hd) {
    case 32:
      return bias ? launch_bwd<32, LAYOUT, true>(a, g, s) : launch_bwd<32, LAYOUT, false>(a, g, s);
    case 64:
      return bias ? launch_bwd<64, LAYOUT, true>(a, g, s) : launch_bwd<64, LAYOUT, false>(a, g, s);
    case 96:
      return bias ? launch_bwd<96, LAYOUT, true>(a, g, s) : launch_bwd<96, LAYOUT, false>(a, g, s);
    case 128:
      return bias ? launch_bwd<128, LAYOUT, true>(a, g, s)
                  : launch_bwd<128, LAYOUT, false>(a, g, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Fills the geometry from the launch arguments; false if they are not valid.
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
  return g.LP <= MAX_LP;
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
