// Window attention on pre-projected q, k, v, the backward at any L,
// hand-written for Hopper (sm_90a): the chunked form of K8
// (window_attention_grid_large.cu) and K9 (window_attention_v1_large.cu), each
// with its CPB-bias instance, at every head dim 32-256; and K9's prepass,
// which writes qn16, kn16 and the norms for the streamed backward
// (streamed_bwd.cuh, form FORM_V1) and the chunked one. (K8's and K9's
// backward at L <= 256 is streamed_bwd.cuh's, or for K8 at head dims up to
// 96 the one-block kernel of qkv_attention.cuh; the forward at every head
// dim is the streamed kernel of qkv_attention.cuh.)
//
// Replaces the same TPU kernels as qkv_attention.cuh
// (swin_v2_weather_tpu/ops/window_attention.py: K8 _make_grid_bwd_kernel /
// _grid_backward; K9 _make_v1_bwd_kernel / _v1_backward, with has_bias)
// where no instance whose shared memory grows with L fits: every L above
// 256 (ops/window_attention.py, attn_variant).
//
// What bounds it on this card: bytes, as for the other backwards; the
// chunked kernels run only where nothing else takes the shape, and their
// speed is not the point yet (see their section below).
//
// Rounding sites: the one-block instances' (qkv_attention.cuh): the row max,
// K8 r = 1 / sum e, K9 p = e / sum e, the raw bias, dsb = bf16(ds * scale_h),
// K8's dscale sum(qn16 dqn) / scale with the normalization VJP outside, K9's
// sum(ds s) with the VJP inside on the fp32 qn. Only the order of some fp32
// sums differs (qd and dscale partials per 64 rows, the transposed score
// tiles). d(scale) and d(bias) are summed in a fixed order, with no atomics.
//
// Contract (checked by the Python wrappers): the one-block backward's, with
// head dims 32-256, any L, and the scratch buffers as the wrappers allocate
// them.

#pragma once

#include "qkv_attention.cuh"

namespace swin_qkv_attn_large {

using namespace swin_qkv_attn;

constexpr int RW = 4;    // warps (16-row tiles) per backward block

// K9's prepass: qn16 = bf16(q * inv) for every row of q and k, inv = 1 /
// sqrt(max(sum q^2, 1e-24)) summed as normalize_rows sums; one warp per row.
// qn, kn have q's layout; inv [2, rows] (q's rows, then k's).
template <int HD>
__global__ void normalize_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 bf16* __restrict__ qn, bf16* __restrict__ kn,
                                 float* __restrict__ inv, long long rows) {
  constexpr int NV = (HD + 31) / 32;
  const long long wid = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= 2 * rows) return;
  const bool is_k = wid >= rows;
  const long long r = is_k ? wid - rows : wid;
  const bf16* src = (is_k ? k : q) + r * HD;
  bf16* dst = (is_k ? kn : qn) + r * HD;
  float vals[NV];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d = lane + 32 * i;
    const float v = d < HD ? __bfloat162float(src[d]) : 0.0f;
    vals[i] = v;
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float iv = 1.0f / sqrtf(fmaxf(ss, 1e-24f));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) dst[d] = __float2bfloat16(vals[i] * iv);
  }
  if (lane == 0) inv[wid] = iv;
}

// rows row0 .. row0 + nrows - 1 of the block's (window, head) tile of src into
// dst (pitch HD + 8) by cp.async; rows >= L zero-filled. The caller commits.
template <int LAYOUT, int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int ld,
                                          const AttnGeo& g, const Tile& t, int row0, int nrows) {
  constexpr int LDQ = HD + 8;
  for (int idx = threadIdx.x; idx < nrows * (HD / 8); idx += blockDim.x) {
    const int r = idx / (HD / 8);
    const int c = (idx % (HD / 8)) * 8;
    const int l = row0 + r;
    const bool ok = l < g.L;
    const bf16* s = src + (ok ? row_offset<LAYOUT, HD>(g, t, l, ld) + c : 0);
    cp_async16(dst + r * LDQ + c, s, ok);
  }
}

// z = s * scale (+ bias[qi][key]) (+ bflag * mask[qi][key]) of one score
// entry, -inf outside the L x L window: the one-block kernels' logits
__device__ __forceinline__ float logit(float s, int qi, int key, int L, float sc,
                                       const float* bh, const float* mk, float bflag) {
  if (qi >= L || key >= L) return -CUDART_INF_F;
  float val = __fmul_rn(s, sc);
  if (bh != nullptr) val = __fadd_rn(val, bh[qi * L + key]);
  if (mk != nullptr) val = __fadd_rn(val, __fmul_rn(bflag, mk[qi * L + key]));
  return val;
}

// softmax probability: K8 e * (1 / sum e) (sr = 1 / sum e), K9 e / sum e (sr = sum e)
template <int LAYOUT>
__device__ __forceinline__ float prob(float z, float m, float sr) {
  if (z == -CUDART_INF_F) return 0.0f;
  const float ev = expf(z - m);
  return LAYOUT == GRID ? ev * sr : ev / sr;
}

// ds, unscaled: K8 (dp - u r) e r, K9 p (dp - u)
template <int LAYOUT>
__device__ __forceinline__ float dlogit(float z, float dp, float m, float sr, float u) {
  if (z == -CUDART_INF_F) return 0.0f;
  const float ev = expf(z - m);
  return LAYOUT == GRID ? (dp - u * sr) * ev * sr : ev / sr * (dp - u);
}

// ---------------------------------------------------------------------------
// backward at any L, the chunked form, both layouts: where a per-warp row of
// dsb (p16^T and dsb^T) as long as the window would not fit (past L = 256),
// these keep one 16 x 16 tile of it per warp: each key
// (query) tile's dsb (or p16) is formed into the warp's tile and multiplied
// at once into an fp32 [16, HD] accumulator in shared memory
// (accumulate_tile, in tile order). Rows: the statistics sweeps (the row
// max; the sum, with K8's u = sum(dp e); K9's u = sum(dp p)), then one sweep
// forming ds and dqn += dsb kn16 tile by tile. Columns: one sweep for dv +=
// p16^T g16, a second for dkn += dsb^T qn16. The one-block instances'
// rounding sites, every output element summed over the tiles in order;
// every head dim 32-256. They run only where no other instance takes the
// shape (attn_variant); their speed is not the point yet.
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t chunk_smem_bytes() {
  return (3u * RW * 16 * (HD + 8) + RW * 16u * LDT) * sizeof(bf16) +
         (static_cast<size_t>(RW) * 16 * HD + RW * 256 + RW) * sizeof(float);
}

template <int HD, int LAYOUT, bool BIAS>
__global__ void __launch_bounds__(RW * 32, 1)
    chunk_bwd_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ gout,
                          const bf16* __restrict__ qraw, const float* __restrict__ inv,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          const float* __restrict__ mask, float bflag, bf16* __restrict__ dq,
                          float* __restrict__ rstat, float* __restrict__ dscale_part,
                          float* __restrict__ dbias_part, AttnGeo geo) {
  constexpr int LDQ = HD + 8;
  constexpr int NF = HD / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int LP = geo.LP;
  const int L = geo.L;
  bf16* qs = reinterpret_cast<bf16*>(smem);   // the block's query rows [RW * 16, LDQ]
  bf16* gs = qs + RW * 16 * LDQ;              // their cotangent rows
  bf16* ring = gs + RW * 16 * LDQ;            // two stages of (k tile, v tile)
  bf16* tiles = ring + 4 * 16 * LDQ;          // a 16 x 16 dsb tile per warp
  float* stage = reinterpret_cast<float*>(tiles + RW * 16 * LDT);  // dqn [16, HD] per warp
  float* scratch = stage + RW * 16 * HD;
  float* wsum = scratch + RW * 256;

  const Tile t = tile_of_block(geo);
  const int h = t.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* cs = scratch + warp * 256;
  const int fr = lane >> 1;
  const int fc = (lane & 1) * 8;
  const int nkt = LP / 16;
  const int row0 = blockIdx.y * RW * 16;
  const bool active = row0 + warp * 16 < LP;
  const int qrow = row0 + warp * 16 + fr;
  const bool qok = qrow < L;
  const int win = window_index(geo, t);
  const size_t wh_idx = static_cast<size_t>(win) * geo.heads + h;

  load_rows<LAYOUT, HD>(qs, q, geo.ldq, geo, t, row0, RW * 16);
  load_rows<LAYOUT, HD>(gs, gout, geo.ldo, geo, t, row0, RW * 16);
  cp_async_commit();

  auto load_kv = [&](int kt) {
    bf16* st = ring + (kt & 1) * 2 * 16 * LDQ;
    load_rows<LAYOUT, HD>(st, k, geo.ldk, geo, t, kt * 16, 16);
    load_rows<LAYOUT, HD>(st + 16 * LDQ, v, geo.ldv, geo, t, kt * 16, 16);
  };
  auto acquire = [&](int kt) -> const bf16* {
    if (kt == 0) {
      load_kv(0);
      cp_async_commit();
    }
    if (kt + 1 < nkt) load_kv(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    return ring + (kt & 1) * 2 * 16 * LDQ;
  };

  const float sc = scale[h];
  const float* bh = BIAS ? bias + static_cast<size_t>(h) * L * L : nullptr;
  const float* mk = (mask != nullptr && t.wr == geo.nwh - 1) ? mask : nullptr;
  const bf16* qw = qs + warp * 16 * LDQ;
  const bf16* gw = gs + warp * 16 * LDQ;
  float s[8], z[8];
  auto tile_logits = [&](const bf16* kb, int kt) {
    Frag f;
    dot_rows<HD>(f, qw, kb);
    wmma::store_matrix_sync(cs, f, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] = cs[fr * 16 + fc + e];
      z[e] = logit(s[e], qrow, kt * 16 + fc + e, L, sc, bh, mk, bflag);
    }
    __syncwarp();
  };
  auto tile_dp = [&](const bf16* kb) {  // dp = g v^T of the tile, into cs
    Frag f;
    dot_rows<HD>(f, gw, kb + 16 * LDQ);
    wmma::store_matrix_sync(cs, f, 16, wmma::mem_row_major);
    __syncwarp();
  };

  // the sweeps over the key tiles, one loop nest (each helper has one call
  // site, so it is inlined): the row max; the row sum of e (K8 also u = sum(dp
  // e)); K9's u = sum(dp p), p = e / sum e; then the ds sweep: dsb =
  // bf16(ds * scale) into the warp's tile, ds into the d(bias) rows (BIAS)
  // and K9's d(scale) partial sum(ds * s), then dqn += dsb @ kn16 of the tile
  constexpr int NS = LAYOUT == GRID ? 3 : 4;
  float* stw = stage + warp * 16 * HD;
  bf16* tw = tiles + warp * 16 * LDT;
  float* drow = BIAS && active ? dbias_part + (wh_idx * LP + qrow) * LP : nullptr;
  float m = -CUDART_INF_F, rowsum = 0.0f, sr = 0.0f, u = 0.0f, dsc = 0.0f;
  for (int sweep = 0; sweep < NS; ++sweep) {
    for (int kt = 0; kt < nkt; ++kt) {
      const bf16* kb = acquire(kt);
      if (active) {
        tile_logits(kb, kt);
        if (sweep > 1 || (sweep == 1 && LAYOUT == GRID)) tile_dp(kb);
        if (sweep == 0) {
#pragma unroll
          for (int e = 0; e < 8; ++e) m = fmaxf(m, z[e]);
        } else if (sweep == 1) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float ev = z[e] == -CUDART_INF_F ? 0.0f : expf(z[e] - m);
            rowsum += ev;
            if constexpr (LAYOUT == GRID) u += cs[fr * 16 + fc + e] * ev;
          }
          __syncwarp();
        } else if (sweep < NS - 1) {  // K9's sweep for u
#pragma unroll
          for (int e = 0; e < 8; ++e) u += cs[fr * 16 + fc + e] * prob<LAYOUT>(z[e], m, sr);
          __syncwarp();
        } else {
          float ds[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            ds[e] = dlogit<LAYOUT>(z[e], cs[fr * 16 + fc + e], m, sr, u);
            dsc += ds[e] * s[e];
          }
          store8(tw + fr * LDT + fc, ds, [&](int, float d) { return d * sc; });
          if constexpr (BIAS) {
            float4* dst = reinterpret_cast<float4*>(drow + kt * 16 + fc);
            dst[0] = make_float4(ds[0], ds[1], ds[2], ds[3]);
            dst[1] = make_float4(ds[4], ds[5], ds[6], ds[7]);
          }
          __syncwarp();
          accumulate_tile<HD>(stw, tw, kb);
        }
      }
      __syncthreads();
    }
    // the end of a sweep: its statistics
    if (sweep == 0) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    if (sweep == 1) {
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
      sr = LAYOUT == GRID ? (rowsum > 0.0f ? 1.0f / rowsum : 0.0f) : rowsum;
    }
    if (sweep == NS - 2) {
      u += __shfl_xor_sync(0xffffffffu, u, 1);
      if (active && (lane & 1) == 0) {
        float* st = rstat + (wh_idx * LP + qrow) * 3;
        st[0] = m;
        st[1] = sr;
        st[2] = u;
      }
      if (active) zero_acc<HD>(stw);
    }
  }

  // <qn, dqn> of the row and dq: K8 with the stored qn16; K9 with the fp32
  // qn = q * inv_q from the raw row
  constexpr bool NORM_IN = LAYOUT == WINDOWED;
  const float iq = (NORM_IN && qok) ? inv[wh_idx * L + qrow] : 1.0f;
  const bf16* qr =
      (NORM_IN && qok) ? qraw + row_offset<LAYOUT, HD>(geo, t, qrow, geo.ldq) : nullptr;
  auto qn_at = [&](int d) -> float {
    if constexpr (NORM_IN) {
      return qok ? __bfloat162float(qr[d]) * iq : 0.0f;
    } else {
      return __bfloat162float(qw[fr * LDQ + d]);
    }
  };
  float qd = 0.0f;
  if (active) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
#pragma unroll
      for (int e = 0; e < 8; ++e) qd += qn_at(j * 16 + fc + e) * stw[fr * HD + j * 16 + fc + e];
    }
  }
  qd += __shfl_xor_sync(0xffffffffu, qd, 1);
  if (active && qok) {
    const size_t off = row_offset<LAYOUT, HD>(geo, t, qrow, geo.ldo);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      store8(dq + off + j * 16 + fc, stw + fr * HD + j * 16 + fc, [&](int e, float dqn) {
        if constexpr (NORM_IN) {
          return (dqn - qn_at(j * 16 + fc + e) * qd) * iq;
        } else {
          return dqn;
        }
      });
    }
  }
  float part;
  if constexpr (LAYOUT == GRID) {
    part = (active && qok && (lane & 1) == 0) ? qd : 0.0f;
  } else {
    part = active ? dsc : 0.0f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) wsum[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int i = 0; i < RW; ++i) total += wsum[i];
    dscale_part[(static_cast<size_t>(win) * gridDim.y + blockIdx.y) * geo.heads + h] = total;
  }
}

template <int HD, int LAYOUT, bool BIAS>
__global__ void __launch_bounds__(RW * 32, 1)
    chunk_bwd_cols_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ gout,
                          const bf16* __restrict__ kraw, const float* __restrict__ inv,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          const float* __restrict__ mask, float bflag,
                          const float* __restrict__ rstat, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, AttnGeo geo) {
  constexpr int LDQ = HD + 8;
  constexpr int NF = HD / 16;
  constexpr bool NORM_IN = LAYOUT == WINDOWED;
  extern __shared__ __align__(128) unsigned char smem[];
  const int LP = geo.LP;
  const int L = geo.L;
  bf16* ks = reinterpret_cast<bf16*>(smem);  // the block's key rows [RW * 16, LDQ]
  bf16* vs = ks + RW * 16 * LDQ;             // their value rows
  bf16* ring = vs + RW * 16 * LDQ;           // two stages of (q tile, g tile)
  bf16* tiles = ring + 4 * 16 * LDQ;         // a 16 x 16 p16^T or dsb^T tile per warp
  float* stage = reinterpret_cast<float*>(tiles + RW * 16 * LDT);  // dv, then dkn, per warp
  float* scratch = stage + RW * 16 * HD;

  const Tile t = tile_of_block(geo);
  const int h = t.h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* cs = scratch + warp * 256;
  const int fr = lane >> 1;
  const int fc = (lane & 1) * 8;
  const int nqt = LP / 16;
  const int row0 = blockIdx.y * RW * 16;
  const bool active = row0 + warp * 16 < LP;
  const int krow = row0 + warp * 16 + fr;
  const bool kok = krow < L;
  const size_t wh_idx = static_cast<size_t>(window_index(geo, t)) * geo.heads + h;
  const float* rs = rstat + wh_idx * LP * 3;

  load_rows<LAYOUT, HD>(ks, k, geo.ldk, geo, t, row0, RW * 16);
  load_rows<LAYOUT, HD>(vs, v, geo.ldv, geo, t, row0, RW * 16);
  cp_async_commit();

  auto load_qg = [&](int qt) {
    bf16* st = ring + (qt & 1) * 2 * 16 * LDQ;
    load_rows<LAYOUT, HD>(st, q, geo.ldq, geo, t, qt * 16, 16);
    load_rows<LAYOUT, HD>(st + 16 * LDQ, gout, geo.ldo, geo, t, qt * 16, 16);
  };
  auto acquire = [&](int qt) -> const bf16* {
    if (qt == 0) {
      load_qg(0);
      cp_async_commit();
    }
    if (qt + 1 < nqt) load_qg(qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    return ring + (qt & 1) * 2 * 16 * LDQ;
  };

  const float sc = scale[h];
  const float* bh = BIAS ? bias + static_cast<size_t>(h) * L * L : nullptr;
  const float* mk = (mask != nullptr && t.wr == geo.nwh - 1) ? mask : nullptr;
  const bf16* kw = ks + warp * 16 * LDQ;
  const bf16* vw = vs + warp * 16 * LDQ;
  float* stw = stage + warp * 16 * HD;
  bf16* tw = tiles + warp * 16 * LDT;
  float z[8];
  auto tile_logits = [&](const bf16* qb, int qt) {
    Frag f;
    dot_rows<HD>(f, kw, qb);  // s^T [key][query]
    wmma::store_matrix_sync(cs, f, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) {  // query and key swap places in the lookups
      z[e] = logit(cs[fr * 16 + fc + e], qt * 16 + fc + e, krow, L, sc, bh, mk, bflag);
    }
    __syncwarp();
  };
  const size_t koff = kok ? row_offset<LAYOUT, HD>(geo, t, krow, geo.ldo) : 0;

  // two sweeps over the query tiles, one loop nest: sweep A dv += p16^T @ g16
  // tile by tile, then dv is written; sweep B dkn += dsb^T @ qn16
  if (active) zero_acc<HD>(stw);
  for (int sweep = 0; sweep < 2; ++sweep) {
    const bool sweep_b = sweep == 1;
    for (int qt = 0; qt < nqt; ++qt) {
      const bf16* qb = acquire(qt);
      if (active) {
        tile_logits(qb, qt);
        if (sweep_b) {
          Frag f;
          dot_rows<HD>(f, vw, qb + 16 * LDQ);  // dp^T [key][query] = v g^T
          wmma::store_matrix_sync(cs, f, 16, wmma::mem_row_major);
          __syncwarp();
        }
        float vals[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float* st = rs + (qt * 16 + fc + e) * 3;
          vals[e] = sweep_b ? dlogit<LAYOUT>(z[e], cs[fr * 16 + fc + e], st[0], st[1], st[2])
                            : prob<LAYOUT>(z[e], st[0], st[1]);
        }
        store8(tw + fr * LDT + fc, vals, [&](int, float a) { return sweep_b ? a * sc : a; });
        __syncwarp();
        accumulate_tile<HD>(stw, tw, sweep_b ? qb : qb + 16 * LDQ);
      }
      __syncthreads();
    }
    if (!sweep_b) {  // between the sweeps: dv out, the accumulator cleared
      if (active && kok) {
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          store8(dv + koff + j * 16 + fc, stw + fr * HD + j * 16 + fc,
                 [](int, float a) { return a; });
        }
      }
      __syncwarp();
      if (active) zero_acc<HD>(stw);
    }
  }

  // dk: K8 dkn as it is; K9 (dkn - kn <kn, dkn>) inv_k with the fp32 kn
  const size_t n_wh = static_cast<size_t>(geo.B) * geo.nwh * geo.nww * geo.heads;
  const float ik = (NORM_IN && kok) ? inv[(n_wh + wh_idx) * L + krow] : 1.0f;
  const bf16* kr =
      (NORM_IN && kok) ? kraw + row_offset<LAYOUT, HD>(geo, t, krow, geo.ldk) : nullptr;
  auto kn_at = [&](int d) -> float { return kok ? __bfloat162float(kr[d]) * ik : 0.0f; };
  float kd = 0.0f;
  if constexpr (NORM_IN) {
    if (active) {
#pragma unroll
      for (int j = 0; j < NF; ++j) {
#pragma unroll
        for (int e = 0; e < 8; ++e) kd += kn_at(j * 16 + fc + e) * stw[fr * HD + j * 16 + fc + e];
      }
    }
    kd += __shfl_xor_sync(0xffffffffu, kd, 1);
  }
  if (active && kok) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      store8(dk + koff + j * 16 + fc, stw + fr * HD + j * 16 + fc, [&](int e, float dkn) {
        if constexpr (NORM_IN) {
          return (dkn - kn_at(j * 16 + fc + e) * kd) * ik;
        } else {
          return dkn;
        }
      });
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct LargeBwdArgs {
  const void *q, *k, *v, *scale, *bias, *mask;  // q, k normalized (K9: the prepass's copies)
  float bflag;
  const void *g, *qraw, *kraw, *inv;  // qraw, kraw, inv: K9 only
  void *dq, *dk, *dv, *rstat, *dscale_part, *dbias_part, *dscale, *dbias;
};

template <class K>
int set_smem(K kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// dscale = the nchunks partials of each window summed in order (K8: divided
// by scale) and, with the bias, dbias = the windows' d(bias) partials summed
// in window order
inline int reduce_partials(const LargeBwdArgs& a, const AttnGeo& geo, int nchunks, bool grid,
                           cudaStream_t s) {
  const int n_win = geo.B * geo.nwh * geo.nww;
  attn_dscale_reduce_kernel<<<(geo.heads + 31) / 32, 32, 0, s>>>(
      static_cast<const float*>(a.dscale_part), n_win * nchunks, geo.heads,
      static_cast<const float*>(a.scale), grid ? 1 : 0, static_cast<float*>(a.dscale));
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0 || a.bias == nullptr) return code;
  const long long n_bias = static_cast<long long>(geo.heads) * geo.L * geo.L;
  dbias_reduce_kernel<<<static_cast<unsigned>((n_bias + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(a.dbias_part), n_win, geo.heads, geo.L, geo.LP,
      static_cast<float*>(a.dbias));
  return static_cast<int>(cudaGetLastError());
}

// K9's prepass: the scratch copies qn16, kn16 and the norms inv [2, Bw *
// heads * L] (q's rows, then k's)
template <int HD>
int normalize_qk(const void* q, const void* k, void* qn, void* kn, void* inv, const AttnGeo& g,
              cudaStream_t s) {
  const long long rows = static_cast<long long>(g.B) * g.nwh * g.nww * g.heads * g.L;
  normalize_kernel<HD><<<static_cast<unsigned>((2 * rows + 7) / 8), 256, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<bf16*>(qn),
      static_cast<bf16*>(kn), static_cast<float*>(inv), rows);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int LAYOUT, bool BIAS>
int launch_chunked_bwd(const LargeBwdArgs& a, const AttnGeo& geo, cudaStream_t s) {
  unsigned blocks;
  int code = n_blocks(geo, &blocks);
  if (code != 0) return code;
  const size_t smem = chunk_smem_bytes<HD>();
  const auto rows = &chunk_bwd_rows_kernel<HD, LAYOUT, BIAS>;
  const auto cols = &chunk_bwd_cols_kernel<HD, LAYOUT, BIAS>;
  code = set_smem(rows, smem);
  if (code != 0) return code;
  code = set_smem(cols, smem);
  if (code != 0) return code;
  const int nchunks = (geo.LP / 16 + RW - 1) / RW;
  const dim3 grid(blocks, nchunks);
  rows<<<grid, RW * 32, smem, s>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
      static_cast<const bf16*>(a.qraw), static_cast<const float*>(a.inv),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.bias),
      static_cast<const float*>(a.mask), a.bflag, static_cast<bf16*>(a.dq),
      static_cast<float*>(a.rstat), static_cast<float*>(a.dscale_part),
      static_cast<float*>(a.dbias_part), geo);
  code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  cols<<<grid, RW * 32, smem, s>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
      static_cast<const bf16*>(a.kraw), static_cast<const float*>(a.inv),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.bias),
      static_cast<const float*>(a.mask), a.bflag, static_cast<const float*>(a.rstat),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), geo);
  code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  return reduce_partials(a, geo, nchunks, LAYOUT == GRID, s);
}

template <int HD, int LAYOUT>
int launch_chunked_either(bool bias, const LargeBwdArgs& a, const AttnGeo& g, cudaStream_t s) {
  return bias ? launch_chunked_bwd<HD, LAYOUT, true>(a, g, s)
              : launch_chunked_bwd<HD, LAYOUT, false>(a, g, s);
}

// The chunked backward of either layout (head dims 32-256, any L).
template <int LAYOUT>
int dispatch_chunked_bwd(int hd, const LargeBwdArgs& a, const AttnGeo& g, cudaStream_t s) {
  const bool bias = a.bias != nullptr;
  if (bias && (a.dbias_part == nullptr || a.dbias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (hd) {
    case 32:
      return launch_chunked_either<32, LAYOUT>(bias, a, g, s);
    case 64:
      return launch_chunked_either<64, LAYOUT>(bias, a, g, s);
    case 96:
      return launch_chunked_either<96, LAYOUT>(bias, a, g, s);
    case 128:
      return launch_chunked_either<128, LAYOUT>(bias, a, g, s);
    case 256:
      return launch_chunked_either<256, LAYOUT>(bias, a, g, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace swin_qkv_attn_large
