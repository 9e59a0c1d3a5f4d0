// qkv-fused scaled-cosine window attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel swin_v2_weather_tpu/ops/window_attention.py:_make_qkv_kernel
// (the v3 forward, launched by _qkv_forward): the qkv projection, the windowing,
// per-head q/k L2 normalization, the max-free softmax of (s - 1) * scale (plus
// the shift mask on the last window row) and e @ v / rowsum, all in one kernel
// that reads the activation in its NHWC grid layout and writes the result back
// into grid positions. Its BIAS instance (entry point
// swin_window_attention_qkv_bias_fwd, K7) replaces the same kernel with
// has_bias=True, reached through _build_qkv_bias: the logits become
// z = s * scale + badd[h][q][k], badd the pre-folded CPB term
// (row-max-shifted bias - scale, fp32 [heads, L, L]). Each block reads its
// head's [L, L] slice (105 KB at L = 162) straight from global memory; the
// whole 0.84 MB array stays in L2 for the 400 x 8 blocks. The shift keeps the
// max-free softmax rigorous: z <= 0 with one z = 0 in every row.
//
// What bounds it on this card: at the flagship shape (x [1, 180, 360, 768] bf16,
// 9 x 18 windows so L = 162, 8 heads of 96) the work per (window, head) is a
// [162, 768] x [768, 288] projection (72 MFLOP) plus two [162, 162, 96] products
// (10 MFLOP) against 250 KB of window input that the 8 heads share through L2.
// The projection dominates, so the tensor-core instruction rate and the shared-memory
// traffic feeding it bound the kernel; the [L, L] scores must never reach device
// memory (400 windows x 8 heads x 162^2 fp32 = 336 MB per block if they did).
//
// What the design does about it: one block per (image, window, head), heads
// fastest in the grid so the 8 blocks of one window run together and hit L2 for
// x. Its LP / 16 warps (LP = L rounded up to 16, here 11 warps) each own 16
// token rows. The projection runs role by role (q, k, v) on nvcuda::wmma bf16
// fragments with fp32 accumulation, streaming 32-wide C_in slices of the window
// (gathered by index math from the grid, padded rows zero-filled) and of the
// head's W columns through a two-stage cp.async ring. Bias add and bf16 rounding
// stage q, k, v in shared memory; q and k are normalized in place (projection and
// normalization live in window_attention_common.cuh, shared with the backward
// kernel in window_attention_qkv_bwd.cu). Each warp then
// computes its 16 x LP score rows one 16-key tile at a time, turns them into
// e = exp(z) in registers (no running max: |s| <= 1 for unit q, k, so
// z <= 0 up to the mask), keeps the fp32 row sums, stores bf16(e) in a per-warp
// shared buffer and finishes with (e @ v) * (1 / rowsum). Padded keys get e = 0.
// wgmma/TMA and a persistent schedule come later; this version is the simple,
// correct baseline.
//
// Rounding sites (the TPU kernel's contract): qkv = bf16(bf16(x) @ bf16(W) + b)
// with fp32 accumulation; q16 = bf16(q * rsqrt(max(sum q^2, 1e-24))), same for k;
// s = q16 @ k16^T in fp32; z = (s - 1) * scale[h] (+ flag * mask on the last
// window row), with the bias z = fl(s * scale[h]) + badd[h][q][k] (+ the mask);
// e = exp(z); out = (bf16(e) @ v16 in fp32) * (1 / sum e).
//
// K10 (entry point swin_window_attention_qkv_padded_fwd) replaces the v6 TPU
// kernel swin_v2_weather_tpu/ops/window_attention.py:_make_qkv6_kernel
// (launched by _qkv6_forward, reached through fused_window_attention_qkv_padded):
// v3's math on weights whose per-head columns are zero-padded to 128 lanes,
// [C_in, 3 * heads * 128], writing [B, H, W, heads * 128] with the pad lanes
// exactly zero. The TPU pads because a 96-lane head slab is misaligned in its
// 128-lane vector registers; on this card a head dim of 96 is already a legal
// MMA width and the pad lanes are zero in q, k, v and out, so K10 is K1's
// instance with a head pitch HP = 128: it reads only the HD live columns of
// each head at their padded offsets in W and b, computes K1's arithmetic on
// them, writes the result at h * 128 and stores exact zeros in the pad lanes.
//
// K12 (entry points swin_window_attention_qkv5_fwd and _qkv4_fwd) replaces the
// v5 and v4 TPU kernels of swin_v2_weather_tpu/ops/attic/window_attention_v45.py
// (_make_qkv5_kernel, launched by _qkv5_forward; _make_qkv4_kernel, launched by
// _qkv4_forward), reached through fused_window_attention_qkv(impl='v5'/'v4').
// Both are this kernel with a variant template argument rather than a new
// pair, because they differ from K1 only in where they read and in one
// rounding site, and K1's tiling already suits this card:
//   * v5 (QKV_V5) reads each (role, head) slab of the weight reordered to
//     [3 * heads, C_in, hd] as one dense [C_in, hd] box (the TPU kernel's
//     point: no misaligned lane slices of a packed [*, 3C] slab). The C_in
//     loop and every sum keep K1's order, so v5's output equals K1's bit for
//     bit.
//   * v4 (QKV_V4) reads the window-major rows [B, nW, lm, C_in] (lm = L rounded
//     up to 8) that the wrapper prepares, as JAX prepares them outside its
//     kernel, and writes all lm rows of [B, nW, lm, C] (the pad rows' outputs
//     are thrown away by the caller; pad keys get e = 0). Its softmax rounds
//     p16 = bf16(e * (1 / sum e)) before p16 @ v, so the row sums take a first
//     sweep of the score tiles and p16 a second. Its padded-head instance
//     (QKV_PAD_HEADS) is the HP = 128 instance, as K10 is K1's.
//
// Contract (checked by the Python wrapper): x [B, H, W, C_in] bf16, W [C_in, 3C]
// bf16, both contiguous; b [3C] fp32; scale [heads] fp32; mask [L, L] fp32 or
// null; bias [heads, L, L] fp32 (BIAS only); C_in % 32 == 0; head dim in {32, 64, 96, 128}; H % wh == W % ww == 0;
// L <= 256.

#include "window_attention_common.cuh"

namespace {

using namespace swin_attn;

template <int HD>
size_t smem_bytes(int LP) {
  const size_t nwarps = LP / 16;
  const size_t qkv = 3u * LP * (HD + 8) * sizeof(bf16);
  const size_t scratch = nwarps * 256 * sizeof(float);
  const size_t p_buf = nwarps * 16 * (LP + 8) * sizeof(bf16);
  const size_t staging = staging_bytes<HD>(LP);
  return qkv + scratch + (p_buf > staging ? p_buf : staging);
}

template <int HD, bool BIAS, int HP = HD, int VAR = QKV_V3>
__global__ void __launch_bounds__(MAX_LP * 2)
    window_attention_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                const float* __restrict__ bqkv, const float* __restrict__ scale,
                                const float* __restrict__ bias, const float* __restrict__ mask,
                                float bflag, bf16* __restrict__ out, Geometry g) {
  constexpr int NF = HD / 16;    // 16-wide column fragments per head
  constexpr int LDQ = HD + 8;  // q/k/v row pitch: head dim + 8 spreads banks

  extern __shared__ __align__(128) unsigned char smem[];
  const int LP = g.LP;
  const int L = g.L;
  const int LS = rows_of<VAR>(g);  // rows written: L, or v4's lm
  const int nwarps = LP / 16;
  const int LDP = LP + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + LP * LDQ;
  bf16* vs = ks + LP * LDQ;
  float* scratch = reinterpret_cast<float*>(vs + LP * LDQ);
  unsigned char* region = reinterpret_cast<unsigned char*>(scratch + nwarps * 256);
  bf16* pbuf = reinterpret_cast<bf16*>(region);  // phase 2: bf16(e), 16 x LDP per warp
  bf16* xs = reinterpret_cast<bf16*>(region);    // phase 1: 2 stages of [LP, LDX]
  bf16* wsm = xs + 2 * LP * LDX;                 // phase 1: 2 stages of [KC, LDQ]

  const Tile t = tile_of_block(g);
  const int h = t.h;
  const int wr = t.wr;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* cs = scratch + warp * 256;
  const int fr = lane >> 1;        // fragment row this lane finishes
  const int fc = (lane & 1) * 8;   // first of its 8 fragment columns

  // ---------------- phase 1: qkv projection of the window, role by role ----
  project_qkv<HD, HP, VAR>(x, w, bqkv, g, t, qs, ks, vs, xs, wsm, cs);

  // ---------------- phase 1b: L2-normalize q and k rows in place -----------
  normalize_rows<HD>(qs, nullptr);
  normalize_rows<HD>(ks, nullptr);
  __syncthreads();  // every warp reads all k rows below

  // ---------------- phase 2: scores -> e = exp(z) -> bf16(e) @ v ------------
  const float sc = scale[h];
  const bool use_mask = mask != nullptr && wr == g.nwh - 1;
  const int qrow = warp * 16 + fr;
  // this query row of the head's bias slice (padded rows read none)
  const float* brow = BIAS && qrow < L ? bias + (static_cast<size_t>(h) * L + qrow) * L : nullptr;
  bf16* pw = pbuf + warp * 16 * LDP;
  const int nkt = LP / 16;

  // this warp's 16 x 16 score tile against key tile kt, into cs
  auto score_tile = [&](int kt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
    wmma::fill_fragment(s, 0.0f);
#pragma unroll
    for (int d = 0; d < NF; ++d) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, qs + warp * 16 * LDQ + d * 16, LDQ);
      wmma::load_matrix_sync(b, ks + kt * 16 * LDQ + d * 16, LDQ);
      wmma::mma_sync(s, a, b, s);
    }
    wmma::store_matrix_sync(cs, s, 16, wmma::mem_row_major);
    __syncwarp();
  };
  // e = exp(z) of the lane's 8 entries of that tile; 0 for padded keys
  auto exp8 = [&](int kt, float (&ev)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int key = kt * 16 + fc + e;
      ev[e] = 0.0f;
      if (key < L) {
        const float sv = cs[fr * 16 + fc + e];
        float z = (sv - 1.0f) * sc;
        if (BIAS && brow != nullptr) z = __fmul_rn(sv, sc) + brow[key];
        if (use_mask && qrow < L) z += bflag * mask[qrow * L + key];
        ev[e] = expf(z);
      }
    }
  };

  float rowsum = 0.0f;
  float rinv;
  if constexpr (VAR == QKV_V4) {
    // v4 rounds p16 = bf16(e * (1 / sum e)) before the p @ v product: the row
    // sums first, then the score tiles again for p16
    for (int kt = 0; kt < nkt; ++kt) {
      score_tile(kt);
      float ev[8];
      exp8(kt, ev);
#pragma unroll
      for (int e = 0; e < 8; ++e) rowsum += ev[e];
      __syncwarp();
    }
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);  // the two lanes of a row
    rinv = 1.0f / rowsum;
    for (int kt = 0; kt < nkt; ++kt) {
      score_tile(kt);
      float ev[8];
      exp8(kt, ev);
      store8(pw + fr * LDP + kt * 16 + fc, ev, [&](int, float v) { return v * rinv; });
      __syncwarp();
    }
  } else {
    for (int kt = 0; kt < nkt; ++kt) {
      score_tile(kt);
      float ev[8];
      exp8(kt, ev);
      __align__(16) bf16 pv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        rowsum += ev[e];
        pv[e] = __float2bfloat16(ev[e]);
      }
      *reinterpret_cast<uint4*>(pw + fr * LDP + kt * 16 + fc) =
          *reinterpret_cast<const uint4*>(pv);
      __syncwarp();
    }
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);  // the two lanes of a row
    rinv = 1.0f / rowsum;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(o[j], 0.0f);
  for (int kt = 0; kt < nkt; ++kt) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, pw + kt * 16, LDP);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, vs + kt * 16 * LDQ + j * 16, LDQ);
      wmma::mma_sync(o[j], a, b, o[j]);
    }
  }

  const size_t pix = qrow < LS ? token_of<VAR>(g, t, qrow) : 0;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(cs, o[j], 16, wmma::mem_row_major);
    __syncwarp();
    if (qrow < LS) {
      __align__(16) bf16 ov[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = cs[fr * 16 + fc + e];
        ov[e] = __float2bfloat16(VAR == QKV_V4 ? v : v * rinv);
      }
      *reinterpret_cast<uint4*>(out + pix * g.C + h * HP + j * 16 + fc) =
          *reinterpret_cast<const uint4*>(ov);
    }
    __syncwarp();
  }
  if constexpr (HP > HD) {  // K10: exact zeros in the head's pad lanes
    if (qrow < LS) {
#pragma unroll
      for (int j = 0; j < (HP - HD) / 16; ++j) {
        *reinterpret_cast<uint4*>(out + pix * g.C + h * HP + HD + j * 16 + fc) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
}

template <int HD, bool BIAS, int HP = HD, int VAR = QKV_V3>
int launch(const void* x, const void* w, const void* b, const void* scale, const void* bias,
           const void* mask, float bflag, void* out, const Geometry& g, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(g.LP);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(window_attention_qkv_kernel<HD, BIAS, HP, VAR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(g.B) * g.nwh * g.nww * g.heads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  window_attention_qkv_kernel<HD, BIAS, HP, VAR>
      <<<static_cast<unsigned>(blocks), (g.LP / 16) * 32, smem, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w),
          static_cast<const float*>(b), static_cast<const float*>(scale),
          static_cast<const float*>(bias), static_cast<const float*>(mask), bflag,
          static_cast<bf16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <bool BIAS>
int dispatch(const void* x, const void* w, const void* b, const void* scale, const void* bias,
             const void* mask, float bflag, void* out, int B, int H, int W, int Cin, int C,
             int heads, int wh, int ww, void* stream) {
  Geometry g;
  if (!make_geometry(g, B, H, W, Cin, C, heads, wh, ww) || (BIAS && bias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / heads) {
    case 32:
      return launch<32, BIAS>(x, w, b, scale, bias, mask, bflag, out, g, s);
    case 64:
      return launch<64, BIAS>(x, w, b, scale, bias, mask, bflag, out, g, s);
    case 96:
      return launch<96, BIAS>(x, w, b, scale, bias, mask, bflag, out, g, s);
    case 128:
      return launch<128, BIAS>(x, w, b, scale, bias, mask, bflag, out, g, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K1: the bias-free forward.
extern "C" int swin_window_attention_qkv_fwd(const void* x, const void* w, const void* b,
                                             const void* scale, const void* mask, float bflag,
                                             void* out, int B, int H, int W, int Cin, int C,
                                             int heads, int wh, int ww, void* stream) {
  return dispatch<false>(x, w, b, scale, nullptr, mask, bflag, out, B, H, W, Cin, C, heads, wh,
                         ww, stream);
}

// K7: the forward with the pre-folded CPB term bias [heads, L, L] fp32.
extern "C" int swin_window_attention_qkv_bias_fwd(const void* x, const void* w, const void* b,
                                                  const void* scale, const void* bias,
                                                  const void* mask, float bflag, void* out,
                                                  int B, int H, int W, int Cin, int C,
                                                  int heads, int wh, int ww, void* stream) {
  return dispatch<true>(x, w, b, scale, bias, mask, bflag, out, B, H, W, Cin, C, heads, wh, ww,
                        stream);
}

// K10: the v6 forward on head-padded weights W [C_in, 3 * heads * 128], b
// [3 * heads * 128]; out [B, H, W, heads * 128], pad lanes zero; hd the live
// head dim (32, 64, 96, or 128, which is K1's instance).
extern "C" int swin_window_attention_qkv_padded_fwd(const void* x, const void* w, const void* b,
                                                    const void* scale, const void* mask,
                                                    float bflag, void* out, int B, int H, int W,
                                                    int Cin, int heads, int hd, int wh, int ww,
                                                    void* stream) {
  Geometry g;
  if (!make_geometry(g, B, H, W, Cin, heads * 128, heads, wh, ww)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32, false, 128>(x, w, b, scale, nullptr, mask, bflag, out, g, s);
    case 64:
      return launch<64, false, 128>(x, w, b, scale, nullptr, mask, bflag, out, g, s);
    case 96:
      return launch<96, false, 128>(x, w, b, scale, nullptr, mask, bflag, out, g, s);
    case 128:
      return launch<128, false>(x, w, b, scale, nullptr, mask, bflag, out, g, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K12: the v5 (VAR = QKV_V5) and v4 (QKV_V4) forwards, bias-free. hd is the
// head dim; g.C is heads * hd, or heads * 128 for v4's padded heads.
template <int VAR>
int launch_k12(const void* x, const void* w, const void* b, const void* scale, const void* mask,
               float bflag, void* out, const Geometry& g, int hd, cudaStream_t s) {
  const bool padded = g.C != g.heads * hd;
  if (padded && (VAR != QKV_V4 || g.C != g.heads * 128)) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      if constexpr (VAR == QKV_V4) {
        if (padded) return launch<32, false, 128, VAR>(x, w, b, scale, nullptr, mask, bflag, out, g, s);
      }
      return launch<32, false, 32, VAR>(x, w, b, scale, nullptr, mask, bflag, out, g, s);
    case 64:
      if constexpr (VAR == QKV_V4) {
        if (padded) return launch<64, false, 128, VAR>(x, w, b, scale, nullptr, mask, bflag, out, g, s);
      }
      return launch<64, false, 64, VAR>(x, w, b, scale, nullptr, mask, bflag, out, g, s);
    case 96:
      if constexpr (VAR == QKV_V4) {
        if (padded) return launch<96, false, 128, VAR>(x, w, b, scale, nullptr, mask, bflag, out, g, s);
      }
      return launch<96, false, 96, VAR>(x, w, b, scale, nullptr, mask, bflag, out, g, s);
    case 128:
      return launch<128, false, 128, VAR>(x, w, b, scale, nullptr, mask, bflag, out, g, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K12 v5: K1 on the reordered weight w5 [3 * heads, C_in, hd] bf16 (b [3C] in
// the packed order, which is w5's slab order); the other operands as K1's.
extern "C" int swin_window_attention_qkv5_fwd(const void* x, const void* w5, const void* b,
                                              const void* scale, const void* mask, float bflag,
                                              void* out, int B, int H, int W, int Cin, int C,
                                              int heads, int wh, int ww, void* stream) {
  Geometry g;
  if (!make_geometry(g, B, H, W, Cin, C, heads, wh, ww)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_k12<QKV_V5>(x, w5, b, scale, mask, bflag, out, g, C / heads,
                            static_cast<cudaStream_t>(stream));
}

// K12 v4: xw [B, nwh * nww, lm, C_in] bf16 window-major (lm = L rounded up to
// 8, rows >= L zero), W [C_in, 3C] bf16, b [3C] fp32 (C = heads * hd, or
// heads * 128 with head-padded W and b), scale [heads], mask [L, L] fp32 or
// null -> out [B, nW, lm, C] bf16, every row written (pad lanes zero).
extern "C" int swin_window_attention_qkv4_fwd(const void* xw, const void* w, const void* b,
                                              const void* scale, const void* mask, float bflag,
                                              void* out, int B, int nwh, int nww, int lm, int Cin,
                                              int C, int heads, int hd, int wh, int ww,
                                              void* stream) {
  Geometry g;
  if (!make_geometry(g, B, nwh * wh, nww * ww, Cin, C, heads, wh, ww) || lm < g.L ||
      lm > g.LP || lm % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g.lm = lm;
  return launch_k12<QKV_V4>(xw, w, b, scale, mask, bflag, out, g, hd,
                            static_cast<cudaStream_t>(stream));
}

extern "C" const char* swin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
