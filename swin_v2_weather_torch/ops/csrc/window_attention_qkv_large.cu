// The backward of the qkv-fused scaled-cosine window attention at large head
// dims (128 and 256 where the one-block kernel does not fit, L <= 256), and
// at any head dim and any L in its chunked form, hand-written for Hopper
// (sm_90a): the large-head variant of K2 (and of K7's and K12's backwards;
// K10's and the padded v4's in the chunked form). The forward of every head
// dim is window_attention_qkv.cu's.
//
// Replaces the same TPU kernel as window_attention_qkv_bwd.cu
// (swin_v2_weather_tpu/ops/window_attention.py: _make_qkv_bwd_kernel /
// _qkv_backward, with has_bias through _build_qkv_bias) where its
// one-block-per-(window, head) layout does not fit: it keeps q, k, v and g
// [LP, HD] in shared memory at once, which at L = 162 (LP = 176) needs
// 374,592 B at head dim 256 (the e2048 family: embed 2048, 8 heads), against
// the 232,448 B a block may use. The wrappers pick this variant exactly
// where the smaller one does not fit (ops/window_attention.py, qkv_variant),
// and the chunked form (section 3) past L = 256.
//
// What bounds it on this card: at the e2048 shape (x [1, 180, 360, 2048] bf16,
// W [2048, 6144], 8 heads of 256, L = 162) the recomputed projection, dx and
// dW are three 1.63-TFLOP products and the five [162, 162, 256] products per
// (window, head) 0.23 TFLOP: tensor-core work, 5.16 ms at 989 TFLOP/s.
//
// Design: the fused projection is split off. Each call runs
//  1. the projection on the Hopper GEMM core (wgmma_gemm.cuh) whose epilogue
//     rounds qkv = bf16(fp32 acc + b) (K1's site) and L2-normalizes q and k
//     per head as the forward's does (qkv_projection.cuh, StoreNormBf16 with
//     KEEP), so the backward's qn16 is the forward's; it also keeps inv = 1 /
//     |q| (and 1 / |k|) of each token row and, for v4, parks the raw q and k
//     rows in their dq and dk slots of dqkv;
//  2. the streamed attention kernels of streamed_bwd.cuh (form FORM_QKV):
//     the rows kernel (r = 1 / sum e and u = sum(dp e), then ds, d(bias) and
//     dq = (dqn - qn qd) inv_q with its d(scale) partial) and the columns
//     kernel (dv and dk = (dkn - kn kd) inv_k), every score tile in mma
//     registers, 8 warps a block;
//  3. the projection backward (qkv_projection.cuh).
// The cost of the split: the [T, 3C] qkv buffer goes to device memory and
// back (796 MB each way at the full e2048 image, 0.24 ms each at 3.35 TB/s).
//
// Rounding sites: K2's (window_attention_qkv_bwd.cu); only the order of some
// fp32 sums differs (the projection's GEMM tiles, the row statistics per
// lane, quad and pair, qd per half of the head dim, the d(scale) partials
// per 64 rows). dW, db, dscale and d(bias) are summed in a fixed order, with
// no atomics.
//
// K12's large-head instances replace the same TPU kernels' v5 and v4
// backwards (swin_v2_weather_tpu/ops/attic/window_attention_v45.py:
// _make_qkv5_bwd_kernel, _make_qkv4_bwd_kernel) at the same head dims: v5
// (template variant QKV_V5) runs the projection per (role, head) slab of the
// reordered weight, in the packed product's K order, so its results are
// K2's; v4 (QKV_V4) reads window-major rows and takes the fp32 qn = q * inv_q
// in qd and the normalization VJP, the raw q and k rows parked in their dq
// and dk slots of dqkv (by the projection's epilogue; in the chunked form by
// the normalization kernel) and read back before they are overwritten.
//
// Contract (checked by the Python wrapper): K2's, with head dim 128 or 256,
// L <= 256 (the chunked form: head dims 32-256, any L, head pitch hd or
// 128), each kernel's shared memory within 232,448 B; the scratch buffers
// as the wrapper allocates them.

#include "qkv_projection.cuh"
#include "streamed_bwd.cuh"

namespace {

using namespace swin_attn;

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may opt into
constexpr int RW = 4;             // warps (16-row tiles) per block of the chunked kernels
// the d(scale) partials come one per window and 64 query rows from both
// designs (ops/window_attention.py, _row_chunks)
static_assert(swin_streamed_bwd::RT_MAX == RW, "one d(scale) partial per 64 rows");

// ---------------- 1. projection: qkv = bf16(x @ W + b) ----------------------

// ---------------- 2. per-head L2 normalization of q and k, in place ---------

// one warp per (token, role q or k, head); inv [T, 2, heads]. PARK (v4's
// backward): the raw row is first copied to the same place in park (dqkv,
// whose dq and dk slots the attention kernels read back for v4's fp32 qn
// before they overwrite them). HP: the head pitch (128 for K10 and padded v4,
// whose pad lanes are not read).
template <int HD, bool PARK = false, int HP = HD>
__global__ void normalize_qk_kernel(bf16* __restrict__ qkv, int T, int C, int heads,
                                    float* __restrict__ inv, bf16* __restrict__ park) {
  constexpr int NV = HD / 32;
  const long long wid = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= static_cast<long long>(T) * 2 * heads) return;
  const int h = static_cast<int>(wid % heads);
  const long long tr = wid / heads;  // token * 2 + role
  const long long tok = tr >> 1;
  const int role = static_cast<int>(tr & 1);
  bf16* rowp = qkv + tok * 3 * C + role * C + h * HP;
  float vals[NV];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float v = __bfloat162float(rowp[lane + 32 * i]);
    vals[i] = v;
    ss += v * v;
    if constexpr (PARK) park[tok * 3 * C + role * C + h * HP + lane + 32 * i] = rowp[lane + 32 * i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float iv = 1.0f / sqrtf(fmaxf(ss, 1e-24f));
#pragma unroll
  for (int i = 0; i < NV; ++i) rowp[lane + 32 * i] = __float2bfloat16(vals[i] * iv);
  if (lane == 0) inv[tr * heads + h] = iv;
}

// ---------------- shared pieces of the attention kernels --------------------

// window rows row0 .. row0 + nrows - 1 of the [T, ld] buffer src, HD columns
// from col0 (a head of q, k, v or g), into dst (pitch HD + 8); rows >= L
// zero-filled
template <int HD, int VAR = QKV_V3>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int ld,
                                          int col0, const Geometry& g, const Tile& t, int row0,
                                          int nrows) {
  constexpr int LDQ = HD + 8;
  for (int idx = threadIdx.x; idx < nrows * (HD / 8); idx += blockDim.x) {
    const int r = idx / (HD / 8);
    const int c = (idx % (HD / 8)) * 8;
    const int l = row0 + r;
    const bool ok = l < rows_of<VAR>(g);
    const size_t pix = ok ? token_of<VAR>(g, t, l) : 0;
    cp_async16(dst + r * LDQ + c, src + pix * ld + col0 + c, ok);
  }
}

// e = exp(z) for the lane's 8 entries (query qrow, keys key0 .. key0 + 7) of
// the score tile in cs, zero outside the L x L window (v4: query
// rows up to LQ = lm, its pad rows attending to the real keys); z as K1/K7
// form it
template <bool BIAS>
__device__ __forceinline__ void exp_row8(const float* cs, int qrow, int key0, int L, float sc,
                                         const float* bh, bool use_mask, const float* mask,
                                         float bflag, float (&ev)[8], int LQ = 0) {
  const int lane = threadIdx.x & 31;
  const int fr = lane >> 1;
  const int fc = (lane & 1) * 8;
  if (LQ == 0) LQ = L;
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
      if (use_mask && qrow < L) z += bflag * mask[qrow * L + key];
      val = expf(z);
    }
    ev[e] = val;
  }
}

// the same for a transposed tile: cs holds s^T (row = key krow, 8 queries
// from q0), so query and key swap places in the bias and mask lookups
template <bool BIAS>
__device__ __forceinline__ void exp_col8(const float* cs, int krow, int q0, int L, float sc,
                                         const float* bh, bool use_mask, const float* mask,
                                         float bflag, float (&ev)[8], int LQ = 0) {
  const int lane = threadIdx.x & 31;
  const int fr = lane >> 1;
  const int fc = (lane & 1) * 8;
  if (LQ == 0) LQ = L;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int qi = q0 + e;
    float val = 0.0f;
    if (qi < LQ && krow < L) {
      const float s = cs[fr * 16 + fc + e];
      float z;
      if constexpr (BIAS) {
        z = __fmul_rn(s, sc) + bh[qi * L + krow];
      } else {
        z = (s - 1.0f) * sc;
      }
      if (use_mask && qi < L) z += bflag * mask[qi * L + krow];
      val = expf(z);
    }
    ev[e] = val;
  }
}

// ---------------- 3. backward attention at any L: the chunked form ----------
//
// A row of ds (p^T and ds^T) per warp as long as the window would make
// shared memory grow with L. The chunked form keeps one 16 x 16 tile of it
// per warp instead: each
// key (query) tile's ds (or p) is formed, rounded to bf16 into the warp's
// tile and multiplied at once into an fp32 [16, HD] accumulator in shared
// memory (accumulate_tile: read, multiply-add, write back, in tile order), so
// its shared memory does not depend on L. Rows kernel: sweep 1 for r and u,
// then one sweep forming ds and dqn += dsb kn16 tile by tile. Columns
// kernel: one sweep for dv += p16^T g16, a second for dkn += ds^T qn16. The
// rounding sites are K2's, and every output element sums over the key (or
// query) tiles in order. Every head dim 32-256, any head
// pitch HP (128: K10 and padded v4, exact zeros into the pad lanes of dqkv).
// The kernels run only past L = 256 (qkv_variant); their speed is not the
// point yet.

template <int HD>
__host__ __device__ constexpr size_t chunk_smem_bytes() {
  return (2u * RW * 16 * (HD + 8) + 4u * 16 * (HD + 8) + RW * 16u * LDT) * sizeof(bf16) +
         (static_cast<size_t>(RW) * 16 * HD + RW * 256 + 16) * sizeof(float);
}

// exact zeros into the pad lanes [HD, HP) of a head's row (the lane pair fr
// of a 16-row tile shares it: 8 lanes each, 16 apart)
template <int HD, int HP>
__device__ __forceinline__ void zero_pad_lanes(bf16* head_row) {
  if constexpr (HP > HD) {
    for (int c = HD + ((threadIdx.x & 1) * 8); c < HP; c += 16) {
      *reinterpret_cast<uint4*>(head_row + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// one block per (window, head) [blockIdx.x] and 64 query rows [blockIdx.y];
// VAR = QKV_V4: window-major rows, and qd and the normalization VJP on the
// fp32 qn = q * inv_q, q's raw row read back from its dq slot of dqkv
template <int HD, bool BIAS, int VAR, int HP>
__global__ void __launch_bounds__(RW * 32, 1)
    chunk_bwd_rows_kernel(const bf16* __restrict__ qkv, const float* __restrict__ inv,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          const float* __restrict__ mask, float bflag,
                          const bf16* __restrict__ gout, bf16* __restrict__ dqkv,
                          float* __restrict__ rstat, float* __restrict__ dscale_part,
                          float* __restrict__ dbias_part, Geometry geo) {
  constexpr int LDQ = HD + 8;
  constexpr int NF = HD / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int LP = geo.LP;
  const int L = geo.L;
  const int C3 = 3 * geo.C;
  bf16* qs = reinterpret_cast<bf16*>(smem);   // the block's query rows [RW * 16, LDQ]
  bf16* gs = qs + RW * 16 * LDQ;              // their cotangent rows
  bf16* ring = gs + RW * 16 * LDQ;            // two stages of (k tile, v tile)
  bf16* tiles = ring + 4 * 16 * LDQ;          // a 16 x 16 ds tile per warp
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
  const int win = (t.bi * geo.nwh + t.wr) * geo.nww + t.wc;
  const size_t wh_idx = static_cast<size_t>(win) * geo.heads + h;
  const int LS = rows_of<VAR>(geo);

  for (int idx = tid; idx < RW * 16 * (HD / 8); idx += blockDim.x) {
    const int r = idx / (HD / 8);
    const int c = (idx % (HD / 8)) * 8;
    const int l = row0 + r;
    const bool ok = l < LS;
    const size_t pix = ok ? token_of<VAR>(geo, t, l) : 0;
    cp_async16(qs + r * LDQ + c, qkv + pix * C3 + h * HP + c, ok);
    cp_async16(gs + r * LDQ + c, gout + pix * geo.C + h * HP + c, ok);
  }
  cp_async_commit();

  auto load_kv = [&](int kt) {
    bf16* st = ring + (kt & 1) * 2 * 16 * LDQ;
    load_rows<HD, VAR>(st, qkv, C3, geo.C + h * HP, geo, t, kt * 16, 16);
    load_rows<HD, VAR>(st + 16 * LDQ, qkv, C3, 2 * geo.C + h * HP, geo, t, kt * 16, 16);
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
  const bool use_mask = mask != nullptr && t.wr == geo.nwh - 1;
  const float* bh = BIAS ? bias + static_cast<size_t>(h) * L * L : nullptr;
  const bf16* qw = qs + warp * 16 * LDQ;
  const bf16* gw = gs + warp * 16 * LDQ;
  const int LQ = VAR == QKV_V4 ? LS : L;
  // s, then e of the lane's 8 entries against key tile kt, and dp = g v^T
  // into cs
  auto tile_e_dp = [&](const bf16* kb, int kt, float (&ev)[8]) {
    Frag f;
    dot_rows<HD>(f, qw, kb);
    wmma::store_matrix_sync(cs, f, 16, wmma::mem_row_major);
    __syncwarp();
    exp_row8<BIAS>(cs, qrow, kt * 16 + fc, L, sc, bh, use_mask, mask, bflag, ev, LQ);
    __syncwarp();
    dot_rows<HD>(f, gw, kb + 16 * LDQ);
    wmma::store_matrix_sync(cs, f, 16, wmma::mem_row_major);
    __syncwarp();
  };

  // two sweeps over the key tiles, one loop nest (each helper has one call
  // site, so it is inlined): sweep 1 sums r = 1 / sum e and u = sum(dp e)
  // of each query row; sweep 2 forms each ds tile into the warp's tile (and
  // ds / scale into d(bias)), then dqn += ds @ kn16 of the tile
  float* stw = stage + warp * 16 * HD;
  bf16* tw = tiles + warp * 16 * LDT;
  float* drow = BIAS && active ? dbias_part + (wh_idx * LP + qrow) * LP : nullptr;
  const float rsc = 1.0f / sc;
  float rowsum = 0.0f, u = 0.0f, r = 0.0f;
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int kt = 0; kt < nkt; ++kt) {
      const bf16* kb = acquire(kt);
      if (active) {
        float ev[8];
        tile_e_dp(kb, kt, ev);
        if (sweep == 0) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            rowsum += ev[e];
            u += cs[fr * 16 + fc + e] * ev[e];
          }
          __syncwarp();
        } else {
          float ds[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) ds[e] = (cs[fr * 16 + fc + e] - u * r) * ev[e] * (r * sc);
          store8(tw + fr * LDT + fc, ds, [](int, float v) { return v; });
          if constexpr (BIAS) {
            float4* dst = reinterpret_cast<float4*>(drow + kt * 16 + fc);
            dst[0] = make_float4(ds[0] * rsc, ds[1] * rsc, ds[2] * rsc, ds[3] * rsc);
            dst[1] = make_float4(ds[4] * rsc, ds[5] * rsc, ds[6] * rsc, ds[7] * rsc);
          }
          __syncwarp();
          accumulate_tile<HD>(stw, tw, kb);
        }
      }
      __syncthreads();
    }
    if (sweep == 0) {  // between the sweeps: the row statistics
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
      u += __shfl_xor_sync(0xffffffffu, u, 1);
      r = rowsum > 0.0f ? 1.0f / rowsum : 0.0f;
      if (active && (lane & 1) == 0) {
        rstat[(wh_idx * LP + qrow) * 2] = r;
        rstat[(wh_idx * LP + qrow) * 2 + 1] = u;
      }
      if (active) zero_acc<HD>(stw);
    }
  }

  // qd = <qn, dqn> and dq = (dqn - qn qd) inv_q
  const bool qin = active && qrow < LS;
  const size_t qpix = qin ? token_of<VAR>(geo, t, qrow) : 0;
  const float iq = qin ? inv[(qpix * 2) * geo.heads + h] : 0.0f;
  const bf16* qraw = dqkv + qpix * C3 + h * HP;
  auto qn_at = [&](int d) -> float {
    if constexpr (VAR == QKV_V4) {
      return qin ? __bfloat162float(qraw[d]) * iq : 0.0f;
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
  if (qin) {
    bf16* dst = dqkv + qpix * C3 + h * HP;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      store8(dst + j * 16 + fc, stw + fr * HD + j * 16 + fc,
             [&](int e, float dqn) { return (dqn - qn_at(j * 16 + fc + e) * qd) * iq; });
    }
    zero_pad_lanes<HD, HP>(dst);
  }
  float part = (active && qrow < LQ && (lane & 1) == 0) ? qd : 0.0f;
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

// one block per (window, head) [blockIdx.x] and 64 key rows [blockIdx.y];
// VAR as the rows kernel's
template <int HD, bool BIAS, int VAR, int HP>
__global__ void __launch_bounds__(RW * 32, 1)
    chunk_bwd_cols_kernel(const bf16* __restrict__ qkv, const float* __restrict__ inv,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          const float* __restrict__ mask, float bflag,
                          const bf16* __restrict__ gout, const float* __restrict__ rstat,
                          bf16* __restrict__ dqkv, Geometry geo) {
  constexpr int LDQ = HD + 8;
  constexpr int NF = HD / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int LP = geo.LP;
  const int L = geo.L;
  const int C3 = 3 * geo.C;
  bf16* ks = reinterpret_cast<bf16*>(smem);  // the block's key rows [RW * 16, LDQ]
  bf16* vs = ks + RW * 16 * LDQ;             // their value rows
  bf16* ring = vs + RW * 16 * LDQ;           // two stages of (q tile, g tile)
  bf16* tiles = ring + 4 * 16 * LDQ;         // a 16 x 16 p^T or ds^T tile per warp
  float* stage = reinterpret_cast<float*>(tiles + RW * 16 * LDT);  // dv, then dkn, per warp
  float* scratch = stage + RW * 16 * HD;

  const Tile t = tile_of_block(geo);
  const int h = t.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* cs = scratch + warp * 256;
  const int fr = lane >> 1;
  const int fc = (lane & 1) * 8;
  const int nqt = LP / 16;
  const int row0 = blockIdx.y * RW * 16;
  const bool active = row0 + warp * 16 < LP;
  const int krow = row0 + warp * 16 + fr;
  const int win = (t.bi * geo.nwh + t.wr) * geo.nww + t.wc;
  const float* rs = rstat + (static_cast<size_t>(win) * geo.heads + h) * LP * 2;
  const int LS = rows_of<VAR>(geo);

  for (int idx = tid; idx < RW * 16 * (HD / 8); idx += blockDim.x) {
    const int r = idx / (HD / 8);
    const int c = (idx % (HD / 8)) * 8;
    const int l = row0 + r;
    const bool ok = l < LS;
    const size_t pix = ok ? token_of<VAR>(geo, t, l) : 0;
    cp_async16(ks + r * LDQ + c, qkv + pix * C3 + geo.C + h * HP + c, ok);
    cp_async16(vs + r * LDQ + c, qkv + pix * C3 + 2 * geo.C + h * HP + c, ok);
  }
  cp_async_commit();

  auto load_qg = [&](int qt) {
    bf16* st = ring + (qt & 1) * 2 * 16 * LDQ;
    load_rows<HD, VAR>(st, qkv, C3, h * HP, geo, t, qt * 16, 16);
    load_rows<HD, VAR>(st + 16 * LDQ, gout, geo.C, h * HP, geo, t, qt * 16, 16);
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
  const bool use_mask = mask != nullptr && t.wr == geo.nwh - 1;
  const float* bh = BIAS ? bias + static_cast<size_t>(h) * L * L : nullptr;
  const bf16* kw = ks + warp * 16 * LDQ;
  const bf16* vw = vs + warp * 16 * LDQ;
  const int LQ = VAR == QKV_V4 ? LS : L;
  float* stw = stage + warp * 16 * HD;
  bf16* tw = tiles + warp * 16 * LDT;
  // e^T of the lane's 8 entries of the transposed score tile against query
  // tile qt
  auto tile_e = [&](const bf16* qb, int qt, float (&ev)[8]) {
    Frag f;
    dot_rows<HD>(f, kw, qb);  // s^T [key][query]
    wmma::store_matrix_sync(cs, f, 16, wmma::mem_row_major);
    __syncwarp();
    exp_col8<BIAS>(cs, krow, qt * 16 + fc, L, sc, bh, use_mask, mask, bflag, ev, LQ);
    __syncwarp();
  };

  // two sweeps over the query tiles, one loop nest: sweep A dv += p16^T @ g16
  // tile by tile (p16^T = bf16(e r)^T), then dv is written; sweep B
  // dkn += ds^T @ qn16
  const bool kin = active && krow < LS;
  const size_t kpix = kin ? token_of<VAR>(geo, t, krow) : 0;
  if (active) zero_acc<HD>(stw);
  for (int sweep = 0; sweep < 2; ++sweep) {
    const bool sweep_b = sweep == 1;
    for (int qt = 0; qt < nqt; ++qt) {
      const bf16* qb = acquire(qt);
      if (active) {
        float ev[8], vals[8];
        tile_e(qb, qt, ev);
        if (sweep_b) {
          Frag f;
          dot_rows<HD>(f, vw, qb + 16 * LDQ);  // dp^T [key][query] = v g^T
          wmma::store_matrix_sync(cs, f, 16, wmma::mem_row_major);
          __syncwarp();
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int qi = qt * 16 + fc + e;
          const float ri = rs[qi * 2];
          vals[e] = sweep_b ? (cs[fr * 16 + fc + e] - rs[qi * 2 + 1] * ri) * ev[e] * (ri * sc)
                            : ev[e] * ri;
        }
        store8(tw + fr * LDT + fc, vals, [](int, float v) { return v; });
        __syncwarp();
        accumulate_tile<HD>(stw, tw, sweep_b ? qb : qb + 16 * LDQ);
      }
      __syncthreads();
    }
    if (!sweep_b) {  // between the sweeps: dv out, the accumulator cleared
      if (kin) {
        bf16* dst = dqkv + kpix * C3 + 2 * geo.C + h * HP;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          store8(dst + j * 16 + fc, stw + fr * HD + j * 16 + fc, [](int, float v) { return v; });
        }
        zero_pad_lanes<HD, HP>(dst);
      }
      __syncwarp();
      if (active) zero_acc<HD>(stw);
    }
  }

  // kd = <kn, dkn> and dk = (dkn - kn kd) inv_k
  const float ik = kin ? inv[(kpix * 2 + 1) * geo.heads + h] : 0.0f;
  const bf16* kraw = dqkv + kpix * C3 + geo.C + h * HP;
  auto kn_at = [&](int d) -> float {
    if constexpr (VAR == QKV_V4) {
      return kin ? __bfloat162float(kraw[d]) * ik : 0.0f;
    } else {
      return __bfloat162float(kw[fr * LDQ + d]);
    }
  };
  float kd = 0.0f;
  if (active) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
#pragma unroll
      for (int e = 0; e < 8; ++e) kd += kn_at(j * 16 + fc + e) * stw[fr * HD + j * 16 + fc + e];
    }
  }
  kd += __shfl_xor_sync(0xffffffffu, kd, 1);
  if (kin) {
    bf16* dst = dqkv + kpix * C3 + geo.C + h * HP;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      store8(dst + j * 16 + fc, stw + fr * HD + j * 16 + fc,
             [&](int e, float dkn) { return (dkn - kn_at(j * 16 + fc + e) * kd) * ik; });
    }
    zero_pad_lanes<HD, HP>(dst);
  }
}

// ---------------- host side ---------------------------------------------------

template <class K>
int set_smem(K kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes)));
}

// The rows of x, g and the outputs: the grid's pixels, or v4's window-major
// rows (lm a window).
template <int VAR>
int token_rows(const Geometry& g) {
  return VAR == QKV_V4 ? g.B * g.nwh * g.nww * g.lm : g.B * g.H * g.W;
}

// steps 1-2: qkv [T, 3C] bf16 = normalized q, k and v; inv [T, 2, heads].
// QKV_V5: w is the reordered [3 * heads, C_in, HD]; each (role, head) slab is
// its own [C_in, HD] GEMM operand, whose HD output columns are the slab's
// columns of the packed [T, 3C] (same K order, so the same sums). QKV_V4: T
// window-major rows; with park (the backward's dqkv) the raw q, k rows are
// parked there before the normalization.
template <int HD, int VAR = QKV_V3, int HP = HD>
int project_normalize(const void* x, const void* w, const void* b, void* qkv, void* inv,
                      const Geometry& g, cudaStream_t s, void* park = nullptr) {
  const int T = token_rows<VAR>(g);
  const int C3 = 3 * g.C;
  const int code = swin_qkv_proj::project(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(b),
      static_cast<bf16*>(qkv), T, g.Cin, C3, VAR == QKV_V5 ? HD : 0, s);
  if (code != 0) return code;
  const long long warps = static_cast<long long>(T) * 2 * g.heads;
  const unsigned nblk = static_cast<unsigned>((warps + 7) / 8);
  if (park != nullptr) {
    normalize_qk_kernel<HD, true, HP><<<nblk, 256, 0, s>>>(
        static_cast<bf16*>(qkv), T, g.C, g.heads, static_cast<float*>(inv),
        static_cast<bf16*>(park));
  } else {
    normalize_qk_kernel<HD, false, HP><<<nblk, 256, 0, s>>>(
        static_cast<bf16*>(qkv), T, g.C, g.heads, static_cast<float*>(inv), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// QKV_V5: wr is the reordered weight the recompute reads, w the packed one of
// the projection backward; otherwise both are the packed W. QKV_V4: the
// window-major rows, the raw q, k parked in dqkv for the fp32 qn. CHUNKED:
// the chunked attention kernels (head pitch HP) after project_normalize;
// else the recompute with the normalization in its epilogue (the forward's
// qn16, the norms kept in inv) and the streamed kernels (streamed_bwd.cuh).
template <int HD, bool BIAS, int VAR = QKV_V3, int HP = HD, bool CHUNKED = false>
int backward(const void* x, const void* wr, const void* w, const void* b, const void* scale,
             const void* bias, const void* mask, float bflag, const void* g, void* qkv,
             void* inv, void* rstat, void* dqkv, void* dw_part, void* db_part,
             void* dscale_part, void* dbias_part, void* dx, void* dw, void* db, void* dscale,
             void* dbias, const Geometry& geo, int dw_splits, int db_splits, cudaStream_t s) {
  const int nchunks = (geo.LP / 16 + RW - 1) / RW;
  int code;
  if constexpr (CHUNKED) {
    const size_t smem = chunk_smem_bytes<HD>();
    const auto rows = &chunk_bwd_rows_kernel<HD, BIAS, VAR, HP>;
    const auto cols = &chunk_bwd_cols_kernel<HD, BIAS, VAR, HP>;
    code = set_smem(rows, smem);
    if (code != 0) return code;
    code = set_smem(cols, smem);
    if (code != 0) return code;
    code = project_normalize<HD, VAR, HP>(x, wr, b, qkv, inv, geo, s,
                                          VAR == QKV_V4 ? dqkv : nullptr);
    if (code != 0) return code;
    const long long wh_blocks = static_cast<long long>(geo.B) * geo.nwh * geo.nww * geo.heads;
    if (wh_blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(wh_blocks), nchunks);
    rows<<<grid, RW * 32, smem, s>>>(
        static_cast<const bf16*>(qkv), static_cast<const float*>(inv),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<const float*>(mask), bflag, static_cast<const bf16*>(g),
        static_cast<bf16*>(dqkv), static_cast<float*>(rstat), static_cast<float*>(dscale_part),
        static_cast<float*>(dbias_part), geo);
    code = static_cast<int>(cudaGetLastError());
    if (code != 0) return code;
    cols<<<grid, RW * 32, smem, s>>>(
        static_cast<const bf16*>(qkv), static_cast<const float*>(inv),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<const float*>(mask), bflag, static_cast<const bf16*>(g),
        static_cast<const float*>(rstat), static_cast<bf16*>(dqkv), geo);
    code = static_cast<int>(cudaGetLastError());
  } else {
    static_assert(HP == HD, "the streamed kernels take no head pitch");
    namespace sb = swin_streamed_bwd;
    const int C = geo.C;
    const int C3 = 3 * C;
    bf16* qkv16 = static_cast<bf16*>(qkv);
    bf16* dqkv16 = static_cast<bf16*>(dqkv);
    code = swin_qkv_proj::project_normalized_keep(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wr), static_cast<const float*>(b),
        qkv16, token_rows<VAR>(geo), geo.Cin, C3, HD, VAR == QKV_V5 ? HD : 0,
        static_cast<float*>(inv), VAR == QKV_V4 ? dqkv16 : nullptr, s);
    if (code != 0) return code;
    const int ls = VAR == QKV_V4 ? geo.lm : geo.L;  // rows a window reads and writes
    const sb::Geo sg{geo.B, geo.H, geo.W, geo.heads, geo.wh, geo.ww, geo.nwh, geo.nww,
                     geo.L, geo.LP, ls, VAR == QKV_V4 ? ls : geo.L, VAR == QKV_V4 ? 1 : 0};
    const sb::Args sa{qkv16, qkv16 + C, qkv16 + 2 * C, static_cast<const bf16*>(g),
                      C3, C3, C3, C, dqkv16, dqkv16 + C, dqkv16 + 2 * C, C3,
                      static_cast<const float*>(scale), static_cast<const float*>(bias),
                      static_cast<const float*>(mask), bflag, static_cast<const float*>(inv),
                      static_cast<float*>(rstat), static_cast<float*>(dscale_part),
                      static_cast<float*>(dbias_part)};
    code = sb::launch<HD, sb::FORM_QKV, BIAS, VAR == QKV_V4>(sa, sg, s);
  }
  if (code != 0) return code;
  const int n_win = geo.B * geo.nwh * geo.nww;
  return swin_qkv_proj::projection_backward(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(dqkv),
      token_rows<VAR>(geo), geo.Cin, 3 * geo.C, static_cast<float*>(dw_part),
      static_cast<float*>(db_part), static_cast<const float*>(dscale_part), n_win * nchunks,
      geo.heads, static_cast<const float*>(scale), static_cast<bf16*>(dx),
      static_cast<float*>(dw), static_cast<float*>(db), static_cast<float*>(dscale),
      static_cast<const float*>(dbias_part), n_win, geo.L, geo.LP,
      BIAS ? static_cast<float*>(dbias) : nullptr, dw_splits, db_splits, s);
}

template <bool BIAS>
int dispatch_bwd(const void* x, const void* w, const void* b, const void* scale, const void* bias,
                 const void* mask, float bflag, const void* g, void* qkv, void* inv, void* rstat,
                 void* dqkv, void* dw_part, void* db_part, void* dscale_part, void* dbias_part,
                 void* dx, void* dw, void* db, void* dscale, void* dbias, int B, int H, int W,
                 int Cin, int C, int heads, int wh, int ww, int dw_splits, int db_splits,
                 void* stream) {
  Geometry geo;
  if (!make_geometry(geo, B, H, W, Cin, C, heads, wh, ww) || dw_splits < 1 || db_splits < 1 ||
      (BIAS && (bias == nullptr || dbias_part == nullptr || dbias == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / heads) {
    case 128:
      return backward<128, BIAS>(x, w, w, b, scale, bias, mask, bflag, g, qkv, inv, rstat, dqkv,
                                 dw_part, db_part, dscale_part, dbias_part, dx, dw, db, dscale,
                                 dbias, geo, dw_splits, db_splits, s);
    case 256:
      return backward<256, BIAS>(x, w, w, b, scale, bias, mask, bflag, g, qkv, inv, rstat, dqkv,
                                 dw_part, db_part, dscale_part, dbias_part, dx, dw, db, dscale,
                                 dbias, geo, dw_splits, db_splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K2 / K7 backward, large-head variant. Scratch: qkv [B, H, W, 3C] bf16, inv
// [B, H, W, 2, heads], rstat [B * nW, heads, LP, 2] fp32, dqkv [B, H, W, 3C]
// bf16, dw_part [dw_splits, C_in, 3C], db_part [db_splits, 3C], dscale_part
// [B * nW * ceil(LP / 64), heads], dbias_part [B * nW, heads, LP, LP] (bias
// only) fp32. Outputs as K2's (and dbias [heads, L, L] with the bias).
extern "C" int swin_window_attention_qkv_large_bwd(
    const void* x, const void* w, const void* b, const void* scale, const void* bias,
    const void* mask, float bflag, const void* g, void* qkv, void* inv, void* rstat, void* dqkv,
    void* dw_part, void* db_part, void* dscale_part, void* dbias_part, void* dx, void* dw,
    void* db, void* dscale, void* dbias, int B, int H, int W, int Cin, int C, int heads, int wh,
    int ww, int dw_splits, int db_splits, void* stream) {
  if (bias == nullptr) {
    return dispatch_bwd<false>(x, w, b, scale, nullptr, mask, bflag, g, qkv, inv, rstat, dqkv,
                               dw_part, db_part, dscale_part, nullptr, dx, dw, db, dscale,
                               nullptr, B, H, W, Cin, C, heads, wh, ww, dw_splits, db_splits,
                               stream);
  }
  return dispatch_bwd<true>(x, w, b, scale, bias, mask, bflag, g, qkv, inv, rstat, dqkv, dw_part,
                            db_part, dscale_part, dbias_part, dx, dw, db, dscale, dbias, B, H, W,
                            Cin, C, heads, wh, ww, dw_splits, db_splits, stream);
}

// K12 v5's backward, large-head variant: the recompute from w5, dx and dW
// from the packed W; scratch and outputs as swin_window_attention_qkv_large_bwd's.
extern "C" int swin_window_attention_qkv5_large_bwd(
    const void* x, const void* w5, const void* w, const void* b, const void* scale,
    const void* mask, float bflag, const void* g, void* qkv, void* inv, void* rstat, void* dqkv,
    void* dw_part, void* db_part, void* dscale_part, void* dx, void* dw, void* db, void* dscale,
    int B, int H, int W, int Cin, int C, int heads, int wh, int ww, int dw_splits, int db_splits,
    void* stream) {
  Geometry geo;
  if (!make_geometry(geo, B, H, W, Cin, C, heads, wh, ww) || dw_splits < 1 || db_splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / heads) {
    case 128:
      return backward<128, false, QKV_V5>(x, w5, w, b, scale, nullptr, mask, bflag, g, qkv, inv,
                                        rstat, dqkv, dw_part, db_part, dscale_part, nullptr, dx,
                                        dw, db, dscale, nullptr, geo, dw_splits, db_splits, s);
    case 256:
      return backward<256, false, QKV_V5>(x, w5, w, b, scale, nullptr, mask, bflag, g, qkv, inv,
                                        rstat, dqkv, dw_part, db_part, dscale_part, nullptr, dx,
                                        dw, db, dscale, nullptr, geo, dw_splits, db_splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K12 v4's backward, large-head variant: gw [B, nW, lm, C] window-major;
// scratch as the forward's plus rstat [B * nW, heads, LP, 2], dqkv
// [B * nW * lm, 3C] (the raw q, k rows are parked there first) and K2's
// workspaces -> dxw [B, nW, lm, C_in] (pad rows zero), dW, db, dscale.
extern "C" int swin_window_attention_qkv4_large_bwd(
    const void* xw, const void* w, const void* b, const void* scale, const void* mask,
    float bflag, const void* gw, void* qkv, void* inv, void* rstat, void* dqkv, void* dw_part,
    void* db_part, void* dscale_part, void* dxw, void* dw, void* db, void* dscale, int B, int nwh,
    int nww, int lm, int Cin, int C, int heads, int wh, int ww, int dw_splits, int db_splits,
    void* stream) {
  Geometry geo;
  if (!make_geometry(geo, B, nwh * wh, nww * ww, Cin, C, heads, wh, ww) || lm < geo.L ||
      lm > geo.LP || lm % 8 != 0 || dw_splits < 1 || db_splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  geo.lm = lm;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / heads) {
    case 128:
      return backward<128, false, QKV_V4>(xw, w, w, b, scale, nullptr, mask, bflag, gw, qkv, inv,
                                          rstat, dqkv, dw_part, db_part, dscale_part, nullptr,
                                          dxw, dw, db, dscale, nullptr, geo, dw_splits, db_splits,
                                          s);
    case 256:
      return backward<256, false, QKV_V4>(xw, w, w, b, scale, nullptr, mask, bflag, gw, qkv, inv,
                                          rstat, dqkv, dw_part, db_part, dscale_part, nullptr,
                                          dxw, dw, db, dscale, nullptr, geo, dw_splits, db_splits,
                                          s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

// The chunked backward of one variant at the live head dim hd (head pitch C /
// heads: hd, or 128 for K10 and padded v4).
template <int VAR, bool BIAS, bool PAD128>
int dispatch_chunked(int hd, const void* x, const void* wr, const void* w, const void* b,
                     const void* scale, const void* bias, const void* mask, float bflag,
                     const void* g, void* qkv, void* inv, void* rstat, void* dqkv, void* dw_part,
                     void* db_part, void* dscale_part, void* dbias_part, void* dx, void* dw,
                     void* db, void* dscale, void* dbias, const Geometry& geo, int dw_splits,
                     int db_splits, cudaStream_t s) {
  switch (hd) {
#define SWIN_CHUNKED_CASE(HD)                                                                 \
  case HD:                                                                                    \
    return backward<HD, BIAS, VAR, PAD128 ? 128 : HD, true>(                                  \
        x, wr, w, b, scale, bias, mask, bflag, g, qkv, inv, rstat, dqkv, dw_part, db_part,    \
        dscale_part, dbias_part, dx, dw, db, dscale, dbias, geo, dw_splits, db_splits, s);
    SWIN_CHUNKED_CASE(32)
    SWIN_CHUNKED_CASE(64)
    SWIN_CHUNKED_CASE(96)
#undef SWIN_CHUNKED_CASE
    case 128:
      if constexpr (PAD128) return static_cast<int>(cudaErrorInvalidValue);
      return backward<128, BIAS, VAR, 128, true>(
          x, wr, w, b, scale, bias, mask, bflag, g, qkv, inv, rstat, dqkv, dw_part, db_part,
          dscale_part, dbias_part, dx, dw, db, dscale, dbias, geo, dw_splits, db_splits, s);
    case 256:
      if constexpr (PAD128) return static_cast<int>(cudaErrorInvalidValue);
      return backward<256, BIAS, VAR, 256, true>(
          x, wr, w, b, scale, bias, mask, bflag, g, qkv, inv, rstat, dqkv, dw_part, db_part,
          dscale_part, dbias_part, dx, dw, db, dscale, dbias, geo, dw_splits, db_splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The chunked backward (any L; shared memory independent of L) of every
// qkv-fused variant: var 0 K2 (v3; K7 with bias, K10 with the head pitch
// C / heads = 128 above hd), 1 K12 v5 (wr the reordered [3 * heads, C_in, hd]
// weight of the recompute), 2 K12 v4 (x and g window-major [B, nW, lm, *],
// padded v4 with the head pitch 128). H = nwh * wh, W = nww * ww; lm is the
// rows a window holds (v4: L up to LP, a multiple of 8; else L). Scratch as
// swin_window_attention_qkv_large_bwd's (rstat [B * nW, heads, LP, 2],
// dscale_part [B * nW * ceil(LP / 64), heads]); outputs dx (v4: dxw), dW,
// db (zero pad columns), dscale and, with the bias, dbias.
extern "C" int swin_window_attention_qkv_chunked_bwd(
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
  if ((pad && (hp != 128 || hd > 128 || var == QKV_V5)) ||
      (with_bias && (var != QKV_V3 || pad || dbias_part == nullptr || dbias == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SWIN_CHUNKED_ARGS                                                                     \
  hd, x, wr, w, b, scale, bias, mask, bflag, g, qkv, inv, rstat, dqkv, dw_part, db_part,      \
      dscale_part, dbias_part, dx, dw, db, dscale, dbias, geo, dw_splits, db_splits, s
  if (var == QKV_V5) return dispatch_chunked<QKV_V5, false, false>(SWIN_CHUNKED_ARGS);
  if (var == QKV_V4) {
    return pad ? dispatch_chunked<QKV_V4, false, true>(SWIN_CHUNKED_ARGS)
               : dispatch_chunked<QKV_V4, false, false>(SWIN_CHUNKED_ARGS);
  }
  if (with_bias) return dispatch_chunked<QKV_V3, true, false>(SWIN_CHUNKED_ARGS);
  return pad ? dispatch_chunked<QKV_V3, false, true>(SWIN_CHUNKED_ARGS)
             : dispatch_chunked<QKV_V3, false, false>(SWIN_CHUNKED_ARGS);
#undef SWIN_CHUNKED_ARGS
}
