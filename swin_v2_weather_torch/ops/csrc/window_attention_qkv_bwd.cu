// Backward of the qkv-fused scaled-cosine window attention, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel swin_v2_weather_tpu/ops/window_attention.py:
// _make_qkv_bwd_kernel (launched by _qkv_backward): recompute the qkv projection,
// the q/k normalization and the softmax; the attention backward; d(scale) through
// sum(ds * s) = sum(qn * dqn) / scale; the normalization VJP; and the projection
// backward dx = dqkv @ W^T, dW = bf16(x)^T @ dqkv, db = sum dqkv. Its BIAS
// instance (entry point swin_window_attention_qkv_bias_bwd, K7) replaces the
// same kernel with has_bias=True, reached through _build_qkv_bias: the
// recomputed logits are z = s * scale + badd[h][q][k] and it also returns
// d(bias)[h] = sum over windows of ds * (1 / scale_h).
//
// What bounds it on this card: at the flagship shape (x and g [1, 180, 360, 768]
// bf16, L = 162, 8 heads of 96) each (window, head) recomputes a [162, 768] x
// [768, 288] projection (72 MFLOP) and runs about ten [162, 162, 96] products;
// the projection backward adds two [64800, 2304] x [2304, 768]-sized GEMMs
// (230 GFLOP each). All of it is tensor-core work, so the instruction rate and
// the shared memory feeding it bound the kernels; the [L, L] scores and their
// cotangents must stay on chip (336 MB per block in fp32 if they did not).
//
// What the design does about it. The TPU kernel runs its grid in order and adds
// dW, db and dscale into VMEM-resident accumulators from step to step; blocks
// on this card run in parallel and in no order, so the work is split:
//
//  1. attention backward, one block per (image, window, head) as in the forward
//     kernel. It recomputes q, k, v for the head with the forward's projection
//     (window_attention_common.cuh) and loads the head's slice of g, keeping q16,
//     k16, v16 and g16 [LP, HD] in shared memory (146 KB at the flagship shape);
//     fp32 dq/dk/dv accumulators for the whole window would not also fit in the
//     227 KB, so the work is split FlashAttention-2 style. Pass 1: each warp owns
//     16 query rows; one sweep over key tiles gives the row sums of e and
//     u = sum(dp * e), a second recomputes e and dp and forms
//     ds = (dp - u r) e (r scale) in bf16 in a per-warp row buffer; then
//     dqn = ds @ kn16, the row's qd = <qn16, dqn>, dq = (dqn - qn16 qd) inv_q, and
//     the window's sum of qd (the d(scale) partial). Pass 2: each warp owns 16 key
//     rows and sweeps the query tiles twice, recomputing scores (and dp) tile by
//     tile from the saved row sums and u: dv = p16^T @ g16, then
//     dkn = ds^T @ qn16 and dk = (dkn - kn16 kd) inv_k. Recomputing the small
//     score products (about 5 MFLOP each) is cheaper than a second home for them.
//     dq, dk, dv go out in bf16 into a [B, H, W, 3C] grid-layout buffer.
//  2. projection backward on the tiled tensor-core GEMM of gemm_tile.cuh:
//     dx = dqkv @ W^T (W read transposed in place, bf16 out), and
//     dW = x^T @ dqkv split over S token ranges into fp32 partials [S, C_in, 3C].
//  3. fixed-order reductions, no atomics, so two runs give the same bits: the
//     column sums of dqkv over token ranges (db partials), then one kernel that
//     sums the dW and db partials in split order and the d(scale) partials in
//     window order, dividing by scale.
//
// d(bias) (BIAS only). The TPU kernel adds ds / scale into a VMEM-resident
// [heads * nc, L, L] accumulator from grid step to grid step; here the 400 x 8
// blocks of a flagship call run at once. The simple design is kept: in pass 1
// each warp, as it forms its 16 rows of ds, also stores ds * (1 / scale_h) in
// fp32 into the block's own [LP, LP] slice of a [B * nW, heads, LP, LP]
// workspace (padded rows and keys hold 0; row pitch LP keeps the stores
// 16-byte aligned). dbias_reduce_kernel then sums the slices in window order.
// At batch 1 the workspace is 400 x 8 x 176^2 x 4 B = 396 MB (0.5 % of the
// card), written once and read once, about 0.25 ms of HBM traffic; at larger
// batches a block could sum a group of windows first.
//
// Rounding sites (the TPU kernel's contract): qkv, qn16/kn16 as in the forward;
// g16 = bf16(g); p16 = bf16(e r); dv = p16^T g16 and dp = g16 v16^T in fp32;
// u = sum dp e; ds = (dp - u r) e (r scale), dsb = bf16(ds); dqn = dsb kn16 and
// dkn = dsb^T qn16 in fp32; dscale_h = sum qn16 dqn / scale_h (valid with the
// bias: the softmax VJP's rows sum to zero); dbias = sum ds * (1 / scale_h)
// with ds unrounded, in fp32; dq, dk as above;
// dqkv = bf16([dq | dk | dv]); dx = dqkv bf16(W)^T and dW = bf16(x)^T dqkv in
// fp32; db = sum dqkv in fp32.
//
// K10's backward (entry point swin_window_attention_qkv_padded_bwd) replaces
// the v6 TPU kernel swin_v2_weather_tpu/ops/window_attention.py:
// _make_qkv6_bwd_kernel (launched by _qkv6_backward): K2 with a head pitch
// HP = 128 (see window_attention_qkv.cu for why the padding costs nothing
// here). The attention pass reads the live HD columns of each head of the
// padded W and b, and g at its padded pitch (heads * 128; g's pad lanes are
// not read), and writes dqkv [T, 3 * heads * 128] with exact zeros in the pad
// lanes, so the projection backward returns dx, the padded dW with exact-zero
// pad columns, the padded db (zero pad entries) and dscale.
//
// K12's backwards (entry points swin_window_attention_qkv5_bwd and _qkv4_bwd)
// replace swin_v2_weather_tpu/ops/attic/window_attention_v45.py:
// _make_qkv5_bwd_kernel (launched by _qkv5_backward) and _make_qkv4_bwd_kernel
// (_qkv4_backward), as K2 with a variant template argument: v5 recomputes the
// projection from the reordered weight and takes dx and dW from the packed one,
// as the TPU kernel does (bit-equal to K2); v4 reads and writes the
// window-major rows (all lm of them, its pad query rows attending to the real
// keys as in the TPU kernel) and takes the fp32 qn = q * inv_q, not qn16, in
// qd = <qn, dqn>, in d(scale) and in the normalization VJP (likewise kn). The
// raw q and k rows are gone from shared memory once normalized in place, and
// there is no room to keep them beside q, k, v and g (225 KB at head dim 96),
// so each warp parks its raw rows in their dq and dk slots of dqkv (device
// memory, 2 x 99.5 MB at the flagship shape) and reads them back just before
// it overwrites them.
//
// Contract (checked by the Python wrapper): x [B, H, W, C_in], g [B, H, W, C]
// bf16; W [C_in, 3C] bf16; b [3C], scale [heads] fp32; mask [L, L] fp32 or null;
// bias [heads, L, L] fp32 (BIAS only);
// the workspaces as the wrapper allocates them; C_in % 32 == 0, head dim in
// {32, 64, 96, 128}, L <= 256, and the shared memory of pass 1/2 within 227 KB.

#include "qkv_projection_bwd.cuh"

namespace {

using namespace swin_attn;

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may opt into

template <int HD>
size_t bwd_smem_bytes(int LP) {
  const size_t nwarps = LP / 16;
  const size_t mats = 4u * LP * (HD + 8) * sizeof(bf16);  // q, k, v, g
  const size_t scratch = nwarps * 256 * sizeof(float);
  const size_t rows = nwarps * 16 * (LP + 8) * sizeof(bf16);
  const size_t staging = staging_bytes<HD>(LP);
  const size_t floats = (4u * LP + 16) * sizeof(float);  // inv_q, inv_k, r, u, warp sums
  return mats + scratch + (rows > staging ? rows : staging) + floats;
}

template <int HD, bool BIAS, int HP = HD, int VAR = QKV_V3>
__global__ void __launch_bounds__(MAX_LP * 2)
    attention_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const float* __restrict__ bqkv, const float* __restrict__ scale,
                         const float* __restrict__ bias, const float* __restrict__ mask,
                         float bflag, const bf16* __restrict__ gout, bf16* __restrict__ dqkv,
                         float* __restrict__ dscale_part, float* __restrict__ dbias_part,
                         Geometry geo) {
  constexpr int NF = HD / 16;
  constexpr int LDQ = HD + 8;

  extern __shared__ __align__(128) unsigned char smem[];
  const int LP = geo.LP;
  const int L = geo.L;
  const int LS = rows_of<VAR>(geo);  // rows read and written: L, or v4's lm
  const int nwarps = LP / 16;
  const int LDP = LP + 8;
  const int C3 = 3 * geo.C;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + LP * LDQ;
  bf16* vs = ks + LP * LDQ;
  bf16* gs = vs + LP * LDQ;
  float* scratch = reinterpret_cast<float*>(gs + LP * LDQ);
  unsigned char* region = reinterpret_cast<unsigned char*>(scratch + nwarps * 256);
  bf16* rowbuf = reinterpret_cast<bf16*>(region);  // passes 1-2: 16 x LDP per warp
  bf16* xs = reinterpret_cast<bf16*>(region);      // projection: staging ring
  bf16* wsm = xs + 2 * LP * LDX;
  const size_t region_bytes = static_cast<size_t>(nwarps) * 16 * LDP * sizeof(bf16) >
                                      staging_bytes<HD>(LP)
                                  ? static_cast<size_t>(nwarps) * 16 * LDP * sizeof(bf16)
                                  : staging_bytes<HD>(LP);
  float* inv_q = reinterpret_cast<float*>(region + region_bytes);
  float* inv_k = inv_q + LP;
  float* rr = inv_k + LP;   // 1 / sum(e) per query row
  float* uu = rr + LP;      // sum(dp * e) per query row
  float* wsum = uu + LP;    // per-warp sums of qd

  const Tile t = tile_of_block(geo);
  const int h = t.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* cs = scratch + warp * 256;
  const int fr = lane >> 1;       // fragment row this lane finishes
  const int fc = (lane & 1) * 8;  // first of its 8 fragment columns

  // the head's slice of the cotangent, padded rows zero-filled
  for (int idx = tid; idx < LP * (HD / 8); idx += blockDim.x) {
    const int l = idx / (HD / 8);
    const int c = (idx % (HD / 8)) * 8;
    const bool ok = l < LS;
    const size_t pix = ok ? token_of<VAR>(geo, t, l) : 0;
    cp_async16(gs + l * LDQ + c, gout + pix * geo.C + h * HP + c, ok);
  }
  cp_async_commit();

  project_qkv<HD, HP, VAR>(x, w, bqkv, geo, t, qs, ks, vs, xs, wsm, cs);  // waits for g too
  if constexpr (VAR == QKV_V4) {
    // v4 takes the fp32 qn = q * inv_q (not qn16) in qd, kd and the
    // normalization VJP: park this warp's raw q and k rows in their dq and dk
    // slots of dqkv, where passes 1 and 2 read them back before overwriting
    for (int idx = lane; idx < 16 * 2 * (HD / 8); idx += 32) {
      const int r = warp * 16 + idx / (2 * (HD / 8));
      const int role = (idx / (HD / 8)) & 1;
      const int c = (idx % (HD / 8)) * 8;
      if (r < LS) {
        *reinterpret_cast<uint4*>(dqkv + token_of<VAR>(geo, t, r) * C3 + role * geo.C + h * HP +
                                  c) = *reinterpret_cast<const uint4*>((role ? ks : qs) + r * LDQ + c);
      }
    }
    __syncwarp();
  }
  normalize_rows<HD>(qs, inv_q);
  normalize_rows<HD>(ks, inv_k);
  __syncthreads();

  const float sc = scale[h];
  const bool use_mask = mask != nullptr && t.wr == geo.nwh - 1;
  const int nkt = LP / 16;
  bf16* pw = rowbuf + warp * 16 * LDP;
  const int win = (t.bi * geo.nwh + t.wr) * geo.nww + t.wc;
  const float* bh = BIAS ? bias + static_cast<size_t>(h) * L * L : nullptr;

  // e = exp((s - 1) * scale (+ mask)), or exp(s * scale + badd (+ mask)), for
  // the lane's 8 entries of a score tile in cs; zero outside the L x L window
  // (v4: outside L keys and lm query rows, its pad query rows attending to
  // the real keys as in the TPU kernel)
  const int LQ = VAR == QKV_V4 ? LS : L;
  auto exp_tile = [&](int qrow, int key0, float (&ev)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int key = key0 + e;
      float val = 0.0f;
      if (key < L && qrow < LQ) {
        const float s = cs[fr * 16 + fc + e];
        float z;
        if constexpr (BIAS) {
          z = __fmul_rn(s, sc) + bh[qrow * L + key];
        } else {
          z = (s - 1.0f) * sc;
        }
        if (use_mask && (VAR != QKV_V4 || qrow < L)) z += bflag * mask[qrow * L + key];
        val = expf(z);
      }
      ev[e] = val;
    }
  };

  // ---------------- pass 1: this warp's 16 query rows ------------------------
  const int qrow = warp * 16 + fr;
  float rowsum = 0.0f, u = 0.0f;
  for (int kt = 0; kt < nkt; ++kt) {
    Frag s;
    dot_rows<HD>(s, qs + warp * 16 * LDQ, ks + kt * 16 * LDQ);
    wmma::store_matrix_sync(cs, s, 16, wmma::mem_row_major);
    __syncwarp();
    float ev[8];
    exp_tile(qrow, kt * 16 + fc, ev);
    __syncwarp();
    dot_rows<HD>(s, gs + warp * 16 * LDQ, vs + kt * 16 * LDQ);  // dp = g v^T
    wmma::store_matrix_sync(cs, s, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      rowsum += ev[e];
      u += cs[fr * 16 + fc + e] * ev[e];
    }
    __syncwarp();
  }
  rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);  // the two lanes of a row
  u += __shfl_xor_sync(0xffffffffu, u, 1);
  // padded query rows have e = 0 throughout; give them r = 0, not 1 / 0
  const float r = rowsum > 0.0f ? 1.0f / rowsum : 0.0f;
  if ((lane & 1) == 0) {
    rr[qrow] = r;
    uu[qrow] = u;
  }

  // this row of the block's d(bias) slice (BIAS only)
  float* drow = BIAS ? dbias_part + ((static_cast<size_t>(win) * geo.heads + h) * LP + qrow) * LP
                     : nullptr;
  const float rsc = 1.0f / sc;
  for (int kt = 0; kt < nkt; ++kt) {  // ds rows into the warp's row buffer
    Frag s;
    dot_rows<HD>(s, qs + warp * 16 * LDQ, ks + kt * 16 * LDQ);
    wmma::store_matrix_sync(cs, s, 16, wmma::mem_row_major);
    __syncwarp();
    float ev[8];
    exp_tile(qrow, kt * 16 + fc, ev);
    __syncwarp();
    dot_rows<HD>(s, gs + warp * 16 * LDQ, vs + kt * 16 * LDQ);
    wmma::store_matrix_sync(cs, s, 16, wmma::mem_row_major);
    __syncwarp();
    float ds[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) ds[e] = (cs[fr * 16 + fc + e] - u * r) * ev[e] * (r * sc);
    store8(pw + fr * LDP + kt * 16 + fc, ds, [](int, float v) { return v; });
    if constexpr (BIAS) {  // e = 0 outside the window, so padded entries get 0
      float4* dst = reinterpret_cast<float4*>(drow + kt * 16 + fc);
      dst[0] = make_float4(ds[0] * rsc, ds[1] * rsc, ds[2] * rsc, ds[3] * rsc);
      dst[1] = make_float4(ds[4] * rsc, ds[5] * rsc, ds[6] * rsc, ds[7] * rsc);
    }
    __syncwarp();
  }

  Frag acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int kt = 0; kt < nkt; ++kt) {  // dqn = ds @ kn16
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, pw + kt * 16, LDP);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, ks + kt * 16 * LDQ + j * 16, LDQ);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
  const float iq = inv_q[qrow];
  const size_t pix = qrow < LS ? token_of<VAR>(geo, t, qrow) : 0;
  // qn at column d of the row: qn16, or for v4 the fp32 q * inv_q from the
  // raw row parked in the dq slot (read by this lane before it writes there)
  const bf16* qraw = dqkv + pix * C3 + h * HP;
  auto qn_at = [&](int d) -> float {
    if constexpr (VAR == QKV_V4) {
      return qrow < LS ? __bfloat162float(qraw[d]) * iq : 0.0f;
    } else {
      return __bfloat162float(qs[qrow * LDQ + d]);
    }
  };
  float qd = 0.0f;  // <qn, dqn> of the row
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(cs, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) qd += qn_at(j * 16 + fc + e) * cs[fr * 16 + fc + e];
    __syncwarp();
  }
  qd += __shfl_xor_sync(0xffffffffu, qd, 1);
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(cs, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    if (qrow < LS) {
      store8(dqkv + pix * C3 + h * HP + j * 16 + fc, cs + fr * 16 + fc,
             [&](int e, float dqn) { return (dqn - qn_at(j * 16 + fc + e) * qd) * iq; });
    }
    __syncwarp();
  }
  // the window's d(scale) partial: sum of qd over its real rows (v4: its lm
  // rows), fixed tree
  float part = (qrow < LQ && (lane & 1) == 0) ? qd : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) wsum[warp] = part;
  __syncthreads();  // r, u of every query row and the warp sums are in place

  if (tid == 0) {
    float total = 0.0f;
    for (int i = 0; i < nwarps; ++i) total += wsum[i];
    dscale_part[static_cast<size_t>(win) * geo.heads + h] = total;
  }

  // ---------------- pass 2: this warp's 16 key rows --------------------------
  const int krow = warp * 16 + fr;
  const size_t kpix = krow < LS ? token_of<VAR>(geo, t, krow) : 0;
  bf16* pt = pw;  // one 16 x 16 bf16 tile, [query][key]

  // dv = p16^T @ g16
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int qt = 0; qt < nkt; ++qt) {
    Frag s;
    dot_rows<HD>(s, qs + qt * 16 * LDQ, ks + warp * 16 * LDQ);  // s[query][key]
    wmma::store_matrix_sync(cs, s, 16, wmma::mem_row_major);
    __syncwarp();
    const int qi = qt * 16 + fr;
    float ev[8];
    exp_tile(qi, warp * 16 + fc, ev);
    const float ri = rr[qi];
    store8(pt + fr * 16 + fc, cs, [&](int e, float) { return ev[e] * ri; });
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
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(cs, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    if (krow < LS) {
      store8(dqkv + kpix * C3 + 2 * geo.C + h * HP + j * 16 + fc, cs + fr * 16 + fc,
             [](int, float dv) { return dv; });
    }
    __syncwarp();
  }

  // dkn = ds^T @ qn16
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int qt = 0; qt < nkt; ++qt) {
    Frag s;
    dot_rows<HD>(s, qs + qt * 16 * LDQ, ks + warp * 16 * LDQ);
    wmma::store_matrix_sync(cs, s, 16, wmma::mem_row_major);
    __syncwarp();
    const int qi = qt * 16 + fr;
    float ev[8];
    exp_tile(qi, warp * 16 + fc, ev);
    __syncwarp();
    dot_rows<HD>(s, gs + qt * 16 * LDQ, vs + warp * 16 * LDQ);  // dp[query][key]
    wmma::store_matrix_sync(cs, s, 16, wmma::mem_row_major);
    __syncwarp();
    const float ri = rr[qi];
    const float ui = uu[qi];
    store8(pt + fr * 16 + fc, cs + fr * 16 + fc,
           [&](int e, float dp) { return (dp - ui * ri) * ev[e] * (ri * sc); });
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;  // ds^T
    wmma::load_matrix_sync(a, pt, 16);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, qs + qt * 16 * LDQ + j * 16, LDQ);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
    __syncwarp();
  }
  const float ik = inv_k[krow];
  const bf16* kraw = dqkv + kpix * C3 + geo.C + h * HP;  // v4: the parked raw k row
  auto kn_at = [&](int d) -> float {
    if constexpr (VAR == QKV_V4) {
      return krow < LS ? __bfloat162float(kraw[d]) * ik : 0.0f;
    } else {
      return __bfloat162float(ks[krow * LDQ + d]);
    }
  };
  float kd = 0.0f;  // <kn, dkn> of the row
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(cs, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) kd += kn_at(j * 16 + fc + e) * cs[fr * 16 + fc + e];
    __syncwarp();
  }
  kd += __shfl_xor_sync(0xffffffffu, kd, 1);
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(cs, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    if (krow < LS) {
      store8(dqkv + kpix * C3 + geo.C + h * HP + j * 16 + fc, cs + fr * 16 + fc,
             [&](int e, float dkn) { return (dkn - kn_at(j * 16 + fc + e) * kd) * ik; });
    }
    __syncwarp();
  }
  if constexpr (HP > HD) {  // K10: exact zeros in the pad lanes of dq, dk, dv
    const int prow = warp * 16 + fr;  // query rows (pass 1) and key rows (pass 2) coincide
    if (prow < LS) {
      const size_t ppix = token_of<VAR>(geo, t, prow);
#pragma unroll
      for (int role = 0; role < 3; ++role) {
#pragma unroll
        for (int j = 0; j < (HP - HD) / 16; ++j) {
          *reinterpret_cast<uint4*>(dqkv + ppix * C3 + role * geo.C + h * HP + HD + j * 16 + fc) =
              make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  }
}

template <int HD, bool BIAS, int HP = HD, int VAR = QKV_V3>
int launch_attention_bwd(const void* x, const void* w, const void* b, const void* scale,
                         const void* bias, const void* mask, float bflag, const void* g,
                         void* dqkv, void* dscale_part, void* dbias_part, const Geometry& geo,
                         cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<HD>(geo.LP);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<HD, BIAS, HP, VAR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(geo.B) * geo.nwh * geo.nww * geo.heads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  attention_bwd_kernel<HD, BIAS, HP, VAR>
      <<<static_cast<unsigned>(blocks), (geo.LP / 16) * 32, smem, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w),
          static_cast<const float*>(b), static_cast<const float*>(scale),
          static_cast<const float*>(bias), static_cast<const float*>(mask), bflag,
          static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
          static_cast<float*>(dscale_part), static_cast<float*>(dbias_part), geo);
  return static_cast<int>(cudaGetLastError());
}

// The whole backward; bias, dbias_part and dbias are read and written only
// when BIAS.
template <bool BIAS>
int backward(const void* x, const void* w, const void* b, const void* scale, const void* bias,
             const void* mask, float bflag, const void* g, void* dqkv, void* dw_part,
             void* db_part, void* dscale_part, void* dbias_part, void* dx, void* dw, void* db,
             void* dscale, void* dbias, int B, int H, int W, int Cin, int C, int heads, int wh,
             int ww, int dw_splits, int db_splits, void* stream) {
  Geometry geo;
  if (!make_geometry(geo, B, H, W, Cin, C, heads, wh, ww) || dw_splits < 1 || db_splits < 1 ||
      (BIAS && (bias == nullptr || dbias_part == nullptr || dbias == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code;
  switch (C / heads) {
    case 32:
      code = launch_attention_bwd<32, BIAS>(x, w, b, scale, bias, mask, bflag, g, dqkv,
                                            dscale_part, dbias_part, geo, s);
      break;
    case 64:
      code = launch_attention_bwd<64, BIAS>(x, w, b, scale, bias, mask, bflag, g, dqkv,
                                            dscale_part, dbias_part, geo, s);
      break;
    case 96:
      code = launch_attention_bwd<96, BIAS>(x, w, b, scale, bias, mask, bflag, g, dqkv,
                                            dscale_part, dbias_part, geo, s);
      break;
    case 128:
      code = launch_attention_bwd<128, BIAS>(x, w, b, scale, bias, mask, bflag, g, dqkv,
                                             dscale_part, dbias_part, geo, s);
      break;
    default:
      code = static_cast<int>(cudaErrorInvalidValue);
  }
  if (code != 0) return code;
  return swin_qkv_proj::projection_backward(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(dqkv),
      B * H * W, Cin, 3 * C, static_cast<float*>(dw_part), static_cast<float*>(db_part),
      static_cast<const float*>(dscale_part), B * geo.nwh * geo.nww, heads,
      static_cast<const float*>(scale), static_cast<bf16*>(dx), static_cast<float*>(dw),
      static_cast<float*>(db), static_cast<float*>(dscale),
      static_cast<const float*>(dbias_part), B * geo.nwh * geo.nww, geo.L, geo.LP,
      BIAS ? static_cast<float*>(dbias) : nullptr, dw_splits, db_splits, s);
}

// K10's backward: the attention pass at head pitch 128, then the projection
// backward over the padded columns.
int backward_padded(const void* x, const void* w, const void* b, const void* scale,
                    const void* mask, float bflag, const void* g, void* dqkv, void* dw_part,
                    void* db_part, void* dscale_part, void* dx, void* dw, void* db, void* dscale,
                    int B, int H, int W, int Cin, int heads, int hd, int wh, int ww, int dw_splits,
                    int db_splits, void* stream) {
  Geometry geo;
  const int C = heads * 128;
  if (!make_geometry(geo, B, H, W, Cin, C, heads, wh, ww) || dw_splits < 1 || db_splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code;
  switch (hd) {
    case 32:
      code = launch_attention_bwd<32, false, 128>(x, w, b, scale, nullptr, mask, bflag, g, dqkv,
                                                  dscale_part, nullptr, geo, s);
      break;
    case 64:
      code = launch_attention_bwd<64, false, 128>(x, w, b, scale, nullptr, mask, bflag, g, dqkv,
                                                  dscale_part, nullptr, geo, s);
      break;
    case 96:
      code = launch_attention_bwd<96, false, 128>(x, w, b, scale, nullptr, mask, bflag, g, dqkv,
                                                  dscale_part, nullptr, geo, s);
      break;
    case 128:
      code = launch_attention_bwd<128, false>(x, w, b, scale, nullptr, mask, bflag, g, dqkv,
                                              dscale_part, nullptr, geo, s);
      break;
    default:
      code = static_cast<int>(cudaErrorInvalidValue);
  }
  if (code != 0) return code;
  return swin_qkv_proj::projection_backward(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(dqkv),
      B * H * W, Cin, 3 * C, static_cast<float*>(dw_part), static_cast<float*>(db_part),
      static_cast<const float*>(dscale_part), B * geo.nwh * geo.nww, heads,
      static_cast<const float*>(scale), static_cast<bf16*>(dx), static_cast<float*>(dw),
      static_cast<float*>(db), static_cast<float*>(dscale), nullptr, 0, geo.L, geo.LP, nullptr,
      dw_splits, db_splits, s);
}

// K12's backwards (bias-free): the attention pass of variant VAR (v5: the
// reordered weight w5 for the recompute; v4: window-major rows, fp32 qn, and
// for padded heads the head pitch 128), then K2's projection backward on the
// packed W over the T rows of x (v4: B * nW * lm window-major rows).
template <int VAR>
int backward_k12(const void* x, const void* wr, const void* w, const void* b, const void* scale,
                 const void* mask, float bflag, const void* g, void* dqkv, void* dw_part,
                 void* db_part, void* dscale_part, void* dx, void* dw, void* db, void* dscale,
                 const Geometry& geo, int hd, int T, int dw_splits, int db_splits,
                 cudaStream_t s) {
  const bool padded = geo.C != geo.heads * hd;
  if (dw_splits < 1 || db_splits < 1 ||
      (padded && (VAR != QKV_V4 || geo.C != geo.heads * 128))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int code;
  switch (hd) {
#define SWIN_K12_CASE(HD)                                                                     \
  case HD:                                                                                    \
    if constexpr (VAR == QKV_V4 && HD < 128) {                                                \
      if (padded) {                                                                           \
        code = launch_attention_bwd<HD, false, 128, VAR>(x, wr, b, scale, nullptr, mask,      \
                                                         bflag, g, dqkv, dscale_part, nullptr, \
                                                         geo, s);                             \
        break;                                                                                \
      }                                                                                       \
    }                                                                                         \
    code = launch_attention_bwd<HD, false, HD, VAR>(x, wr, b, scale, nullptr, mask, bflag, g, \
                                                    dqkv, dscale_part, nullptr, geo, s);      \
    break;
    SWIN_K12_CASE(32)
    SWIN_K12_CASE(64)
    SWIN_K12_CASE(96)
    SWIN_K12_CASE(128)
#undef SWIN_K12_CASE
    default:
      code = static_cast<int>(cudaErrorInvalidValue);
  }
  if (code != 0) return code;
  const int n_win = geo.B * geo.nwh * geo.nww;
  return swin_qkv_proj::projection_backward(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(dqkv),
      T, geo.Cin, 3 * geo.C, static_cast<float*>(dw_part), static_cast<float*>(db_part),
      static_cast<const float*>(dscale_part), n_win, geo.heads, static_cast<const float*>(scale),
      static_cast<bf16*>(dx), static_cast<float*>(dw), static_cast<float*>(db),
      static_cast<float*>(dscale), nullptr, 0, geo.L, geo.LP, nullptr, dw_splits, db_splits, s);
}

}  // namespace

// K2. Workspaces (allocated by the caller): dqkv [B, H, W, 3C] bf16,
// dw_part [dw_splits, C_in, 3C], db_part [db_splits, 3C] and
// dscale_part [B * nW, heads] fp32. Outputs: dx [B, H, W, C_in] bf16,
// dw [C_in, 3C], db [3C], dscale [heads] fp32.
extern "C" int swin_window_attention_qkv_bwd(
    const void* x, const void* w, const void* b, const void* scale, const void* mask, float bflag,
    const void* g, void* dqkv, void* dw_part, void* db_part, void* dscale_part, void* dx,
    void* dw, void* db, void* dscale, int B, int H, int W, int Cin, int C, int heads, int wh,
    int ww, int dw_splits, int db_splits, void* stream) {
  return backward<false>(x, w, b, scale, nullptr, mask, bflag, g, dqkv, dw_part, db_part,
                         dscale_part, nullptr, dx, dw, db, dscale, nullptr, B, H, W, Cin, C,
                         heads, wh, ww, dw_splits, db_splits, stream);
}

// K7's backward: as K2, with the pre-folded CPB term bias [heads, L, L] fp32,
// the workspace dbias_part [B * nW, heads, LP, LP] fp32 (LP = L rounded up to
// 16) and the output dbias [heads, L, L] fp32.
extern "C" int swin_window_attention_qkv_bias_bwd(
    const void* x, const void* w, const void* b, const void* scale, const void* bias,
    const void* mask, float bflag, const void* g, void* dqkv, void* dw_part, void* db_part,
    void* dscale_part, void* dbias_part, void* dx, void* dw, void* db, void* dscale, void* dbias,
    int B, int H, int W, int Cin, int C, int heads, int wh, int ww, int dw_splits, int db_splits,
    void* stream) {
  return backward<true>(x, w, b, scale, bias, mask, bflag, g, dqkv, dw_part, db_part,
                        dscale_part, dbias_part, dx, dw, db, dscale, dbias, B, H, W, Cin, C,
                        heads, wh, ww, dw_splits, db_splits, stream);
}

// K10's backward. As K2 with head-padded W [C_in, 3 * heads * 128] and b, g
// [B, H, W, heads * 128], dqkv [B, H, W, 3 * heads * 128], dw_part
// [dw_splits, C_in, 3 * heads * 128], db_part [db_splits, 3 * heads * 128];
// outputs dx, the padded dw and db (zero in the pad columns) and dscale.
extern "C" int swin_window_attention_qkv_padded_bwd(
    const void* x, const void* w, const void* b, const void* scale, const void* mask, float bflag,
    const void* g, void* dqkv, void* dw_part, void* db_part, void* dscale_part, void* dx,
    void* dw, void* db, void* dscale, int B, int H, int W, int Cin, int heads, int hd, int wh,
    int ww, int dw_splits, int db_splits, void* stream) {
  return backward_padded(x, w, b, scale, mask, bflag, g, dqkv, dw_part, db_part, dscale_part, dx,
                         dw, db, dscale, B, H, W, Cin, heads, hd, wh, ww, dw_splits, db_splits,
                         stream);
}

// K12 v5's backward: K2 recomputing the projection from the reordered weight
// w5 [3 * heads, C_in, hd] and taking dx and dW from the packed W [C_in, 3C],
// as the TPU kernel does; workspaces and outputs as K2's.
extern "C" int swin_window_attention_qkv5_bwd(
    const void* x, const void* w5, const void* w, const void* b, const void* scale,
    const void* mask, float bflag, const void* g, void* dqkv, void* dw_part, void* db_part,
    void* dscale_part, void* dx, void* dw, void* db, void* dscale, int B, int H, int W, int Cin,
    int C, int heads, int wh, int ww, int dw_splits, int db_splits, void* stream) {
  Geometry geo;
  if (!make_geometry(geo, B, H, W, Cin, C, heads, wh, ww)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return backward_k12<QKV_V5>(x, w5, w, b, scale, mask, bflag, g, dqkv, dw_part, db_part,
                              dscale_part, dx, dw, db, dscale, geo, C / heads, B * H * W,
                              dw_splits, db_splits, static_cast<cudaStream_t>(stream));
}

// K12 v4's backward: xw and gw [B, nwh * nww, lm, *] window-major (rows >= L
// zero), W [C_in, 3C] bf16 and b [3C] (C = heads * hd, or heads * 128 with
// head-padded W, b and gw); dqkv [B * nW * lm, 3C] and the other workspaces as
// K2's -> dxw [B, nW, lm, C_in] bf16 (pad rows zero), dW [C_in, 3C], db [3C]
// (pad columns zero), dscale [heads].
extern "C" int swin_window_attention_qkv4_bwd(
    const void* xw, const void* w, const void* b, const void* scale, const void* mask,
    float bflag, const void* gw, void* dqkv, void* dw_part, void* db_part, void* dscale_part,
    void* dxw, void* dw, void* db, void* dscale, int B, int nwh, int nww, int lm, int Cin, int C,
    int heads, int hd, int wh, int ww, int dw_splits, int db_splits, void* stream) {
  Geometry geo;
  if (!make_geometry(geo, B, nwh * wh, nww * ww, Cin, C, heads, wh, ww) || lm < geo.L ||
      lm > geo.LP || lm % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  geo.lm = lm;
  return backward_k12<QKV_V4>(xw, w, w, b, scale, mask, bflag, gw, dqkv, dw_part, db_part,
                              dscale_part, dxw, dw, db, dscale, geo, hd, B * nwh * nww * lm,
                              dw_splits, db_splits, static_cast<cudaStream_t>(stream));
}
