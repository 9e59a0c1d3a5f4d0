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
// bf16, L = 162, 8 heads of 96) the recomputed projection and the projection
// backward are three [64800, 768] x [768, 2304]-sized GEMMs (230 GFLOP each),
// and each (window, head) runs about ten [162, 162, 96] products. All of it is
// tensor-core work, so the instruction rate and the registers and shared
// memory feeding it bound the kernels; the [L, L] scores and their cotangents
// must stay on chip (336 MB per block in fp32 if they did not).
//
// What the design does about it. The TPU kernel runs its grid in order and adds
// dW, db and dscale into VMEM-resident accumulators from step to step; blocks
// on this card run in parallel and in no order, so the work is split:
//
//  0. the recomputed projection qkv = bf16(x @ W + b) [T, 3C] on the Hopper
//     GEMM core (wgmma_gemm.cuh, through qkv_projection.cuh) into a
//     scratch the wrapper allocates. Recomputed inside each attention block
//     on wmma tiles it took 3.67 of the block's 5.99 ms at the flagship shape
//     (PERF.md section 6); on the core it is one 229-GFLOP product plus a
//     299 MB round trip through device memory.
//  1. attention backward, one block per (image, window, head) as in the forward
//     kernel. It loads the head's q, k, v from the scratch and its slice of g,
//     keeping q16, k16, v16 and g16 [LP, HD] in shared memory (146 KB at the
//     flagship shape); fp32 dq/dk/dv accumulators for the whole window would
//     not also fit, so the work is split FlashAttention-2 style, each warp
//     taking 16-row tiles in turn. Every product is an m16n8k16 mma on
//     ldmatrix fragments and every score-sized tile (s, e, dp, ds) stays in
//     the registers of the warp that forms it: no scratch tile, no row
//     buffer. Pass 1 (query rows): sweep A forms s and dp once per key tile,
//     keeps e of the first ZT key tiles in registers, and sums e and
//     u = sum(dp * e); sweep B forms ds = (dp - u r) e (r scale) from the
//     kept e (s and e recomputed past them) and a second dp, and
//     dqn = bf16(ds) @ kn16 from ds's accumulator fragments as the A operand;
//     then the row's qd = <qn16, dqn>, dq = (dqn - qn16 qd) inv_q, and the
//     window's sum of qd (the d(scale) partial). Pass 2 (key rows): one sweep
//     over the query tiles forms s^T and dp^T once each from the saved r and
//     u; p16^T = bf16(e r) feeds dv = p16^T @ g16 and ds^T feeds
//     dkn = ds^T @ qn16, then dk = (dkn - kn16 kd) inv_k. That is 8
//     score-sized products and 2 exp an entry. dq, dk, dv go out in bf16 into
//     a [rows, 3C] buffer.
//  2. projection backward on the Hopper GEMM core (wgmma_gemm.cuh, through
//     qkv_projection.cuh): dx = dqkv @ W^T (W read as stored, bf16 out),
//     and dW = x^T @ dqkv (x read as stored) split over S token ranges into
//     fp32 partials [S, C_in, 3C].
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
// 8-byte aligned). dbias_reduce_kernel then sums the slices in window order.
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
// HP = 128. The projection runs over the padded W (its pad columns give
// exact zeros plus the zero pad bias); the attention pass reads the live HD
// columns of each head of it, and g at its padded pitch (heads * 128; g's pad
// lanes are not read), and writes dqkv [T, 3 * heads * 128] with exact zeros in the pad
// lanes, so the projection backward returns dx, the padded dW with exact-zero
// pad columns, the padded db (zero pad entries) and dscale.
//
// K12's backwards (entry points swin_window_attention_qkv5_bwd and _qkv4_bwd)
// replace swin_v2_weather_tpu/ops/attic/window_attention_v45.py:
// _make_qkv5_bwd_kernel (launched by _qkv5_backward) and _make_qkv4_bwd_kernel
// (_qkv4_backward), as K2 with a variant template argument: v5 recomputes the
// projection from the reordered weight (one product per (role, head) slab, in
// the packed product's K order) and takes dx and dW from the packed one, as
// the TPU kernel does; v4 reads and writes the
// window-major rows (all lm of them, its pad query rows attending to the real
// keys as in the TPU kernel) and takes the fp32 qn = q * inv_q, not qn16, in
// qd = <qn, dqn>, in d(scale) and in the normalization VJP (likewise kn). The
// raw q and k rows are gone from shared memory once normalized in place, and
// there is no room to keep them beside q, k, v and g (225 KB at head dim 96),
// so they stay parked in device memory: the projection's scratch holds them,
// and each warp reads its rows back from there.
//
// Contract (checked by the Python wrapper): x [B, H, W, C_in], g [B, H, W, C]
// bf16; W [C_in, 3C] bf16; b [3C], scale [heads] fp32; mask [L, L] fp32 or null;
// bias [heads, L, L] fp32 (BIAS only);
// the workspaces as the wrapper allocates them; C_in % 32 == 0, head dim in
// {32, 64, 96}, L <= 256, and the shared memory of pass 1/2 within 227 KB.
// Head dims 128 and 256, and every head dim past L = 256, take the streamed
// variant (window_attention_qkv_large.cu): at head dim 128, L = 162 this
// kernel took 4.55 ms against the streamed variant's 4.42 on the H100.

#include "qkv_projection.cuh"

namespace {

using namespace swin_attn;

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may opt into

// The attention pass's block: WARPS warps, each taking 16-row tiles of the
// window in turn (one each at L = 162 below head dim 128); ZT: the 16-key
// tiles whose e a warp keeps in registers across pass 1 beside its [16, HD]
// dqn accumulator (the others recompute s and e in pass 1's second sweep).
// Registers: 168 a thread at 11 warps (three warps share a sub-partition's
// 16,384), 255 at 8; ZT and WARPS are what builds without spilling
// (-Xptxas -v, checked by chip_smoke.py).
template <int HD, bool BIAS = false, int HP = HD, int VAR = QKV_V3>
struct BwdShape {
  // the bias rows, the pad lanes, v4's raw rows read from device memory
  static constexpr bool TIGHT = BIAS || HP != HD || VAR == QKV_V4;
  // head dim 96 with any of those does not fit 168 registers (pass 2's dv and
  // dk accumulators beside them): 8 warps, 255 registers
  static constexpr bool WIDE = HD == 96 && TIGHT;
  static constexpr int WARPS = WIDE ? 8 : 11;
  static constexpr int ZT = WIDE ? 8 : (HD == 32 ? (TIGHT ? 8 : 11) : (HD == 64 ? (TIGHT ? 6 : 8) : 5));
};

// q, k, v, g [LP, HD + 8] bf16; inv_q, inv_k, r, u [LP] and the warps' d(scale)
// sums [16] fp32
template <int HD>
size_t bwd_smem_bytes(int LP) {
  return 4u * LP * (HD + 8) * sizeof(bf16) + (4u * LP + 16) * sizeof(float);
}

// qkv: the projection bf16(x @ W + b) [rows, 3C] from the GEMM core (head
// pitch HP within each role's C columns). Every product is an m16n8k16 mma
// on ldmatrix fragments, and every score-sized tile (s, e, dp, ds) lives in
// the registers of the warp that forms it; a lane holds rows g and g + 8 of
// a tile and two adjacent columns of each n8 tile, so row sums are quad
// shuffles.
template <int HD, bool BIAS, int HP = HD, int VAR = QKV_V3>
__global__ void __launch_bounds__(BwdShape<HD, BIAS, HP, VAR>::WARPS * 32, 1)
    attention_bwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ scale,
                         const float* __restrict__ bias, const float* __restrict__ mask,
                         float bflag, const bf16* __restrict__ gout, bf16* __restrict__ dqkv,
                         float* __restrict__ dscale_part, float* __restrict__ dbias_part,
                         Geometry geo) {
  constexpr int LDQ = HD + 8;
  constexpr int NO = HD / 8;  // n8 tiles of a [16, HD] accumulator
  constexpr int ZT = BwdShape<HD, BIAS, HP, VAR>::ZT;

  extern __shared__ __align__(128) unsigned char smem[];
  const int LP = geo.LP;
  const int L = geo.L;
  const int LS = rows_of<VAR>(geo);  // rows read and written: L, or v4's lm
  const int LQ = VAR == QKV_V4 ? LS : L;  // query rows that attend (v4: its pad rows too)
  const int ntiles = LP / 16;
  const int nw = blockDim.x >> 5;
  const int C3 = 3 * geo.C;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + LP * LDQ;
  bf16* vs = ks + LP * LDQ;
  bf16* gs = vs + LP * LDQ;
  float* inv_q = reinterpret_cast<float*>(gs + LP * LDQ);
  float* inv_k = inv_q + LP;
  float* rr = inv_k + LP;   // 1 / sum(e) per query row
  float* uu = rr + LP;      // sum(dp * e) per query row
  float* wsum = uu + LP;    // per-warp sums of qd

  const Tile t = tile_of_block(geo);
  const int h = t.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g4 = lane >> 2;        // the lane's rows of a tile: g4 and g4 + 8
  const int c2 = (lane & 3) * 2;   // its first column of an n8 tile
  // ldmatrix offsets in a 16-row tile: A operand (rows x k), B operand of
  // x y^T (16 rows of y: two n8 tiles), transposed B operand of p y (16 rows
  // of y as k, two n8 column tiles)
  const int aoff = (lane & 15) * LDQ + (lane >> 4) * 8;
  const int boff = ((lane >> 4) * 8 + (lane & 7)) * LDQ + ((lane >> 3) & 1) * 8;
  const int toff = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + (lane >> 4) * 8;

  // the head's q, k and v from the projection and its slice of the
  // cotangent; padded rows zero-filled
  for (int idx = tid; idx < 4 * LP * (HD / 8); idx += blockDim.x) {
    const int role = idx / (LP * (HD / 8));  // q, k, v, g
    const int l = (idx / (HD / 8)) % LP;
    const int c = (idx % (HD / 8)) * 8;
    const bool ok = l < LS;
    const size_t pix = ok ? token_of<VAR>(geo, t, l) : 0;
    const bf16* src = role < 3 ? qkv + pix * C3 + role * geo.C + h * HP + c
                               : gout + pix * geo.C + h * HP + c;
    cp_async16(qs + role * LP * LDQ + l * LDQ + c, src, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int tt = warp; tt < ntiles; tt += nw) {
    normalize_tile<HD>(qs, tt * 16, inv_q);
    normalize_tile<HD>(ks, tt * 16, inv_k);
  }
  __syncthreads();

  const float sc = scale[h];
  const float rsc = 1.0f / sc;
  const bool use_mask = mask != nullptr && t.wr == geo.nwh - 1;
  const int win = (t.bi * geo.nwh + t.wr) * geo.nww + t.wc;
  const float* bh = BIAS ? bias + static_cast<size_t>(h) * L * L : nullptr;

  // e = exp((s - 1) * scale (+ mask)), or exp(s * scale + badd (+ mask)), of
  // query q and key k; zero outside L keys and LQ query rows (v4's pad query
  // rows attend to the real keys, unmasked, as in the TPU kernel)
  auto exp_of = [&](int q, int k, float s) -> float {
    if (k >= L || q >= LQ) return 0.0f;
    float z;
    if constexpr (BIAS) {
      z = __fmul_rn(s, sc) + bh[q * L + k];
    } else {
      z = (s - 1.0f) * sc;
    }
    if (use_mask && (VAR != QKV_V4 || q < L)) z += bflag * mask[q * L + k];
    return expf(z);
  };
  // the raw (v4) or normalized row of q (role 0) or k (role 1) at column d:
  // qn16, or v4's fp32 q * inv_q from the raw row in the projection's scratch
  auto qk_at = [&](int role, int row, int d, float inv) -> float {
    if constexpr (VAR == QKV_V4) {
      return row < LS ? __bfloat162float(qkv[token_of<VAR>(geo, t, row) * C3 + role * geo.C +
                                             h * HP + d]) * inv
                      : 0.0f;
    } else {
      return __bfloat162float((role ? ks : qs)[row * LDQ + d]);
    }
  };

  // ---------------- pass 1: query rows -------------------------------------
  // sweep A forms s and dp once per key tile and keeps e (the first ZT tiles)
  // for r = 1 / sum e and u = sum(dp e); sweep B forms ds = (dp - u r) e
  // (r scale) from the kept e and a second dp, and dqn = ds @ kn16
  float part = 0.0f;  // this warp's sum of qd over its real rows
  for (int qt = warp; qt < ntiles; qt += nw) {
    const int q0 = qt * 16;
    const int qr[2] = {q0 + g4, q0 + g4 + 8};
    float E[ZT][2][4];
    float rowsum[2] = {0.0f, 0.0f}, u[2] = {0.0f, 0.0f};
    auto sweep_a = [&](int kt, float (&e)[2][4]) {
      float s[2][4], dp[2][4];
      score_tile<HD>(s, qs + q0 * LDQ, ks + kt * 16 * LDQ, aoff, boff);
      score_tile<HD>(dp, gs + q0 * LDQ, vs + kt * 16 * LDQ, aoff, boff);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          e[n][x] = exp_of(qr[x >> 1], kt * 16 + n * 8 + c2 + (x & 1), s[n][x]);
          rowsum[x >> 1] += e[n][x];
          u[x >> 1] += dp[n][x] * e[n][x];
        }
      }
    };
#pragma unroll
    for (int kt = 0; kt < ZT; ++kt) {
      if (kt < ntiles) sweep_a(kt, E[kt]);
    }
    for (int kt = ZT; kt < ntiles; ++kt) {
      float e[2][4];
      sweep_a(kt, e);
    }
    float r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the quad holds the row
      rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 1);
      rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 2);
      u[i] += __shfl_xor_sync(0xffffffffu, u[i], 1);
      u[i] += __shfl_xor_sync(0xffffffffu, u[i], 2);
      // padded query rows have e = 0 throughout; give them r = 0, not 1 / 0
      r[i] = rowsum[i] > 0.0f ? 1.0f / rowsum[i] : 0.0f;
    }
    if ((lane & 3) == 0) {
      rr[qr[0]] = r[0];
      uu[qr[0]] = u[0];
      rr[qr[1]] = r[1];
      uu[qr[1]] = u[1];
    }

    float acc[NO][4];  // dqn of the tile's rows
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[j][x] = 0.0f;
    }
    auto sweep_b = [&](int kt, const float (&e)[2][4]) {
      float dp[2][4];
      score_tile<HD>(dp, gs + q0 * LDQ, vs + kt * 16 * LDQ, aoff, boff);
      float ds[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = x >> 1;
          ds[n][x] = (dp[n][x] - u[i] * r[i]) * e[n][x] * (r[i] * sc);
        }
      }
      if constexpr (BIAS) {  // the block's d(bias) slice: ds / scale, fp32 (0 outside the window)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float* drow = dbias_part + ((static_cast<size_t>(win) * geo.heads + h) * LP + qr[i]) * LP;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            *reinterpret_cast<float2*>(drow + kt * 16 + n * 8 + c2) =
                make_float2(ds[n][2 * i] * rsc, ds[n][2 * i + 1] * rsc);
          }
        }
      }
      unsigned a[4];
      to_a(a, ds);  // dsb = bf16(ds)
      accumulate_rows<HD>(acc, a, ks + kt * 16 * LDQ, toff);
    };
#pragma unroll
    for (int kt = 0; kt < ZT; ++kt) {
      if (kt < ntiles) sweep_b(kt, E[kt]);
    }
    for (int kt = ZT; kt < ntiles; ++kt) {  // recompute e past the kept tiles
      float s[2][4], e[2][4];
      score_tile<HD>(s, qs + q0 * LDQ, ks + kt * 16 * LDQ, aoff, boff);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int x = 0; x < 4; ++x) e[n][x] = exp_of(qr[x >> 1], kt * 16 + n * 8 + c2 + (x & 1), s[n][x]);
      }
      sweep_b(kt, e);
    }

    // qd = <qn, dqn> of each row, then dq = (dqn - qn qd) inv_q
    const float iq[2] = {inv_q[qr[0]], inv_q[qr[1]]};
    float qd[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = x >> 1;
        qd[i] += qk_at(0, qr[i], j * 8 + c2 + (x & 1), iq[i]) * acc[j][x];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qd[i] += __shfl_xor_sync(0xffffffffu, qd[i], 1);
      qd[i] += __shfl_xor_sync(0xffffffffu, qd[i], 2);
      if ((lane & 3) == 0 && qr[i] < LQ) part += qd[i];
      if (qr[i] < LS) {
        bf16* dst = dqkv + token_of<VAR>(geo, t, qr[i]) * C3 + h * HP;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const int d = j * 8 + c2;
          *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(
              (acc[j][2 * i] - qk_at(0, qr[i], d, iq[i]) * qd[i]) * iq[i],
              (acc[j][2 * i + 1] - qk_at(0, qr[i], d + 1, iq[i]) * qd[i]) * iq[i]);
        }
      }
    }
  }
  // the window's d(scale) partial: the sum of qd over its real rows (v4:
  // its lm rows), in a fixed order (lanes, then warps)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) wsum[warp] = part;
  __syncthreads();  // r, u of every query row and the warp sums are in place
  if (tid == 0) {
    float total = 0.0f;
    for (int i = 0; i < nw; ++i) total += wsum[i];
    dscale_part[static_cast<size_t>(win) * geo.heads + h] = total;
  }

  // ---------------- pass 2: key rows ----------------------------------------
  // one sweep over the query tiles: s^T and dp^T once each, p16^T = bf16(e r)
  // into dv = p16^T @ g16 and ds^T into dkn = ds^T @ qn16
  for (int kt = warp; kt < ntiles; kt += nw) {
    const int k0 = kt * 16;
    const int kr[2] = {k0 + g4, k0 + g4 + 8};
    float dv[NO][4], dk[NO][4];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        dv[j][x] = 0.0f;
        dk[j][x] = 0.0f;
      }
    }
    for (int qt = 0; qt < ntiles; ++qt) {
      const int q0 = qt * 16;
      float s[2][4], dp[2][4];
      score_tile<HD>(s, ks + k0 * LDQ, qs + q0 * LDQ, aoff, boff);   // s^T [key][query]
      score_tile<HD>(dp, vs + k0 * LDQ, gs + q0 * LDQ, aoff, boff);  // dp^T [key][query]
      float p[2][4], ds[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = q0 + n * 8 + c2 + c;
          const float ri = rr[qi];
          const float ui = uu[qi];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = 2 * i + c;
            const float ev = exp_of(qi, kr[i], s[n][x]);
            p[n][x] = ev * ri;
            ds[n][x] = (dp[n][x] - ui * ri) * ev * (ri * sc);
          }
        }
      }
      unsigned a[4];
      to_a(a, p);  // p16^T
      accumulate_rows<HD>(dv, a, gs + q0 * LDQ, toff);
      to_a(a, ds);  // dsb^T
      accumulate_rows<HD>(dk, a, qs + q0 * LDQ, toff);
    }
    const float ik[2] = {inv_k[kr[0]], inv_k[kr[1]]};
    float kd[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = x >> 1;
        kd[i] += qk_at(1, kr[i], j * 8 + c2 + (x & 1), ik[i]) * dk[j][x];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      kd[i] += __shfl_xor_sync(0xffffffffu, kd[i], 1);
      kd[i] += __shfl_xor_sync(0xffffffffu, kd[i], 2);
      if (kr[i] < LS) {
        bf16* dst = dqkv + token_of<VAR>(geo, t, kr[i]) * C3 + h * HP;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const int d = j * 8 + c2;
          *reinterpret_cast<__nv_bfloat162*>(dst + geo.C + d) = __floats2bfloat162_rn(
              (dk[j][2 * i] - qk_at(1, kr[i], d, ik[i]) * kd[i]) * ik[i],
              (dk[j][2 * i + 1] - qk_at(1, kr[i], d + 1, ik[i]) * kd[i]) * ik[i]);
          *reinterpret_cast<__nv_bfloat162*>(dst + 2 * geo.C + d) =
              __floats2bfloat162_rn(dv[j][2 * i], dv[j][2 * i + 1]);
        }
        if constexpr (HP > HD) {  // K10: exact zeros in the pad lanes of dq, dk, dv
          for (int c = (lane & 3) * 8; c < HP - HD; c += 32) {
#pragma unroll
            for (int role = 0; role < 3; ++role) {
              *reinterpret_cast<uint4*>(dst + role * geo.C + HD + c) = make_uint4(0u, 0u, 0u, 0u);
            }
          }
        }
      }
    }
  }
}

template <int HD, bool BIAS, int HP = HD, int VAR = QKV_V3>
int launch_attention_bwd(const void* qkv, const void* scale, const void* bias, const void* mask,
                         float bflag, const void* g, void* dqkv, void* dscale_part,
                         void* dbias_part, const Geometry& geo, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<HD>(geo.LP);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<HD, BIAS, HP, VAR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(geo.B) * geo.nwh * geo.nww * geo.heads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kWarps = BwdShape<HD, BIAS, HP, VAR>::WARPS;
  const int warps = geo.LP / 16 < kWarps ? geo.LP / 16 : kWarps;
  attention_bwd_kernel<HD, BIAS, HP, VAR>
      <<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
          static_cast<const bf16*>(qkv), static_cast<const float*>(scale),
          static_cast<const float*>(bias), static_cast<const float*>(mask), bflag,
          static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
          static_cast<float*>(dscale_part), static_cast<float*>(dbias_part), geo);
  return static_cast<int>(cudaGetLastError());
}

// The attention pass at head dim hd (head pitch HP = hd, or 128 with PAD128)
// of variant VAR; false if no instance takes hd.
template <bool BIAS, int VAR, bool PAD128>
int dispatch_attention_bwd(int hd, const void* qkv, const void* scale, const void* bias,
                           const void* mask, float bflag, const void* g, void* dqkv,
                           void* dscale_part, void* dbias_part, const Geometry& geo,
                           cudaStream_t s) {
  switch (hd) {
#define SWIN_K2_CASE(HD)                                                                   \
  case HD:                                                                                 \
    return launch_attention_bwd<HD, BIAS, PAD128 ? 128 : HD, VAR>(                         \
        qkv, scale, bias, mask, bflag, g, dqkv, dscale_part, dbias_part, geo, s);
    SWIN_K2_CASE(32)
    SWIN_K2_CASE(64)
    SWIN_K2_CASE(96)
#undef SWIN_K2_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The whole backward of every variant: the projection on the GEMM core into
// the qkv scratch (v5: from the reordered weight wr, slab by slab), the
// attention pass, then the projection backward on the packed W over the T
// rows of x (v4: B * nW * lm window-major rows). bias, dbias_part and dbias
// are read and written only when BIAS.
template <bool BIAS, int VAR, bool PAD128>
int backward(const void* x, const void* wr, const void* w, const void* b, const void* scale,
             const void* bias, const void* mask, float bflag, const void* g, void* qkv,
             void* dqkv, void* dw_part, void* db_part, void* dscale_part, void* dbias_part,
             void* dx, void* dw, void* db, void* dscale, void* dbias, const Geometry& geo, int hd,
             int T, int dw_splits, int db_splits, cudaStream_t s) {
  if (dw_splits < 1 || db_splits < 1 ||
      (BIAS && (bias == nullptr || dbias_part == nullptr || dbias == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int N = 3 * geo.C;
  int code = swin_qkv_proj::project(static_cast<const bf16*>(x), static_cast<const bf16*>(wr),
                                    static_cast<const float*>(b), static_cast<bf16*>(qkv), T,
                                    geo.Cin, N, VAR == QKV_V5 ? hd : 0, s);
  if (code != 0) return code;
  code = dispatch_attention_bwd<BIAS, VAR, PAD128>(hd, qkv, scale, bias, mask, bflag, g, dqkv,
                                                   dscale_part, dbias_part, geo, s);
  if (code != 0) return code;
  const int n_win = geo.B * geo.nwh * geo.nww;
  return swin_qkv_proj::projection_backward(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(dqkv),
      T, geo.Cin, N, static_cast<float*>(dw_part), static_cast<float*>(db_part),
      static_cast<const float*>(dscale_part), n_win, geo.heads, static_cast<const float*>(scale),
      static_cast<bf16*>(dx), static_cast<float*>(dw), static_cast<float*>(db),
      static_cast<float*>(dscale), static_cast<const float*>(dbias_part), n_win, geo.L, geo.LP,
      BIAS ? static_cast<float*>(dbias) : nullptr, dw_splits, db_splits, s);
}

}  // namespace

// K2. Workspaces (allocated by the caller): qkv and dqkv [B, H, W, 3C] bf16,
// dw_part [dw_splits, C_in, 3C], db_part [db_splits, 3C] and
// dscale_part [B * nW, heads] fp32. Outputs: dx [B, H, W, C_in] bf16,
// dw [C_in, 3C], db [3C], dscale [heads] fp32.
extern "C" int swin_window_attention_qkv_bwd(
    const void* x, const void* w, const void* b, const void* scale, const void* mask, float bflag,
    const void* g, void* qkv, void* dqkv, void* dw_part, void* db_part, void* dscale_part,
    void* dx, void* dw, void* db, void* dscale, int B, int H, int W, int Cin, int C, int heads,
    int wh, int ww, int dw_splits, int db_splits, void* stream) {
  Geometry geo;
  if (!make_geometry(geo, B, H, W, Cin, C, heads, wh, ww)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return backward<false, QKV_V3, false>(x, w, w, b, scale, nullptr, mask, bflag, g, qkv, dqkv,
                                        dw_part, db_part, dscale_part, nullptr, dx, dw, db, dscale,
                                        nullptr, geo, C / heads, B * H * W, dw_splits, db_splits,
                                        static_cast<cudaStream_t>(stream));
}

// K7's backward: as K2, with the pre-folded CPB term bias [heads, L, L] fp32,
// the workspace dbias_part [B * nW, heads, LP, LP] fp32 (LP = L rounded up to
// 16) and the output dbias [heads, L, L] fp32.
extern "C" int swin_window_attention_qkv_bias_bwd(
    const void* x, const void* w, const void* b, const void* scale, const void* bias,
    const void* mask, float bflag, const void* g, void* qkv, void* dqkv, void* dw_part,
    void* db_part, void* dscale_part, void* dbias_part, void* dx, void* dw, void* db,
    void* dscale, void* dbias, int B, int H, int W, int Cin, int C, int heads, int wh, int ww,
    int dw_splits, int db_splits, void* stream) {
  Geometry geo;
  if (!make_geometry(geo, B, H, W, Cin, C, heads, wh, ww)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return backward<true, QKV_V3, false>(x, w, w, b, scale, bias, mask, bflag, g, qkv, dqkv,
                                       dw_part, db_part, dscale_part, dbias_part, dx, dw, db,
                                       dscale, dbias, geo, C / heads, B * H * W, dw_splits,
                                       db_splits, static_cast<cudaStream_t>(stream));
}

// K10's backward. As K2 with head-padded W [C_in, 3 * heads * 128] and b, g
// [B, H, W, heads * 128], qkv and dqkv [B, H, W, 3 * heads * 128], dw_part
// [dw_splits, C_in, 3 * heads * 128], db_part [db_splits, 3 * heads * 128];
// outputs dx, the padded dw and db (zero in the pad columns) and dscale.
extern "C" int swin_window_attention_qkv_padded_bwd(
    const void* x, const void* w, const void* b, const void* scale, const void* mask, float bflag,
    const void* g, void* qkv, void* dqkv, void* dw_part, void* db_part, void* dscale_part,
    void* dx, void* dw, void* db, void* dscale, int B, int H, int W, int Cin, int heads, int hd,
    int wh, int ww, int dw_splits, int db_splits, void* stream) {
  Geometry geo;
  if (!make_geometry(geo, B, H, W, Cin, heads * 128, heads, wh, ww)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return backward<false, QKV_V3, true>(x, w, w, b, scale, nullptr, mask, bflag, g, qkv, dqkv,
                                       dw_part, db_part, dscale_part, nullptr, dx, dw, db, dscale,
                                       nullptr, geo, hd, B * H * W, dw_splits, db_splits,
                                       static_cast<cudaStream_t>(stream));
}

// K12 v5's backward: K2 recomputing the projection from the reordered weight
// w5 [3 * heads, C_in, hd] and taking dx and dW from the packed W [C_in, 3C],
// as the TPU kernel does; workspaces and outputs as K2's.
extern "C" int swin_window_attention_qkv5_bwd(
    const void* x, const void* w5, const void* w, const void* b, const void* scale,
    const void* mask, float bflag, const void* g, void* qkv, void* dqkv, void* dw_part,
    void* db_part, void* dscale_part, void* dx, void* dw, void* db, void* dscale, int B, int H,
    int W, int Cin, int C, int heads, int wh, int ww, int dw_splits, int db_splits,
    void* stream) {
  Geometry geo;
  if (!make_geometry(geo, B, H, W, Cin, C, heads, wh, ww)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return backward<false, QKV_V5, false>(x, w5, w, b, scale, nullptr, mask, bflag, g, qkv, dqkv,
                                        dw_part, db_part, dscale_part, nullptr, dx, dw, db, dscale,
                                        nullptr, geo, C / heads, B * H * W, dw_splits, db_splits,
                                        static_cast<cudaStream_t>(stream));
}

// K12 v4's backward: xw and gw [B, nwh * nww, lm, *] window-major (rows >= L
// zero), W [C_in, 3C] bf16 and b [3C] (C = heads * hd, or heads * 128 with
// head-padded W, b and gw); qkv and dqkv [B * nW * lm, 3C] and the other
// workspaces as K2's -> dxw [B, nW, lm, C_in] bf16 (pad rows zero), dW
// [C_in, 3C], db [3C] (pad columns zero), dscale [heads].
extern "C" int swin_window_attention_qkv4_bwd(
    const void* xw, const void* w, const void* b, const void* scale, const void* mask,
    float bflag, const void* gw, void* qkv, void* dqkv, void* dw_part, void* db_part,
    void* dscale_part, void* dxw, void* dw, void* db, void* dscale, int B, int nwh, int nww,
    int lm, int Cin, int C, int heads, int hd, int wh, int ww, int dw_splits, int db_splits,
    void* stream) {
  Geometry geo;
  if (!make_geometry(geo, B, nwh * wh, nww * ww, Cin, C, heads, wh, ww) || lm < geo.L ||
      lm > geo.LP || lm % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  geo.lm = lm;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = B * nwh * nww * lm;
  if (C == heads * hd) {
    return backward<false, QKV_V4, false>(xw, w, w, b, scale, nullptr, mask, bflag, gw, qkv,
                                          dqkv, dw_part, db_part, dscale_part, nullptr, dxw, dw,
                                          db, dscale, nullptr, geo, hd, T, dw_splits, db_splits, s);
  }
  if (C != heads * 128) return static_cast<int>(cudaErrorInvalidValue);
  return backward<false, QKV_V4, true>(xw, w, w, b, scale, nullptr, mask, bflag, gw, qkv, dqkv,
                                       dw_part, db_part, dscale_part, nullptr, dxw, dw, db, dscale,
                                       nullptr, geo, hd, T, dw_splits, db_splits, s);
}
