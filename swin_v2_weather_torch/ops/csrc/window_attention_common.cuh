// Pieces shared by the window-attention kernels (forward K1 in
// window_attention_qkv.cu, backward K2 in window_attention_qkv_bwd.cu, their
// K7, K10 and K12 instances, K8/K9 in qkv_attention.cuh): the geometry of one
// launch, the block -> (window, head) map, K1's in-kernel qkv projection, the
// q/k L2 normalization of 16-row tiles, the 16-row score product (wmma), the
// m16n8k16 mma and ldmatrix primitives, the 8-value bf16 store and the
// window-order d(bias) reduction.
//
// K1's projection recomputes qkv = bf16(bf16(x) @ bf16(W) + b) for the head's
// 3 x HD columns with fp32 accumulation, streaming 32-wide C_in slices of the
// window (gathered by index math from the NHWC grid, padded rows zero-filled)
// and of the head's W columns through a two-stage cp.async ring, one role
// (q, k, v) at a time so that a warp holds only HD / 16 accumulator fragments.
// Each of the LP / 16 warps owns 16 token rows.

#pragma once

#include <mma.h>

#include "cuda_common.cuh"

namespace swin_attn {

using namespace nvcuda;
using namespace swin_cuda;

constexpr int KC = 32;        // C_in slice per pipeline stage
constexpr int LDX = KC + 8;   // smem row pitch (elements) of the x slice
constexpr int MAX_LP = 256;   // at most 16 warps per block

// Variants of the qkv-fused kernels (the template parameter VAR):
constexpr int QKV_V3 = 0;  // K1/K2 (K7, K10): packed W [C_in, 3C], the NHWC grid
constexpr int QKV_V5 = 1;  // K12 v5: W reordered to [3 * heads, C_in, HD], the NHWC grid
constexpr int QKV_V4 = 2;  // K12 v4: packed W, window-major rows [B, nW, lm, *], v4's rounding

struct Geometry {
  int B, H, W, Cin, C, heads, wh, ww, L, LP, nwh, nww;
  int lm;  // QKV_V4: rows per window in memory (L rounded up to 8; rows >= L are padding)
};

// Fills the geometry from the launch arguments; false if they are not valid.
inline bool make_geometry(Geometry& g, int B, int H, int W, int Cin, int C, int heads, int wh,
                          int ww) {
  if (B < 1 || wh < 1 || ww < 1 || heads < 1 || H % wh != 0 || W % ww != 0 || Cin < KC ||
      Cin % KC != 0 || C % heads != 0) {
    return false;
  }
  g.B = B;
  g.H = H;
  g.W = W;
  g.Cin = Cin;
  g.C = C;
  g.heads = heads;
  g.wh = wh;
  g.ww = ww;
  g.L = wh * ww;
  g.LP = (g.L + 15) / 16 * 16;
  g.nwh = H / wh;
  g.nww = W / ww;
  g.lm = g.L;
  return g.LP <= MAX_LP;
}

// Block index -> (image, window row, window column, head); heads vary fastest
// so the blocks of one window run together and share x through L2. G is any
// geometry with heads, nww and nwh (Geometry here, AttnGeo of
// qkv_attention.cuh).
struct Tile {
  int bi, wr, wc, h;
};

template <class G>
__device__ __forceinline__ Tile tile_of_block(const G& g) {
  int bid = blockIdx.x;
  Tile t;
  t.h = bid % g.heads;
  bid /= g.heads;
  t.wc = bid % g.nww;
  bid /= g.nww;
  t.wr = bid % g.nwh;
  t.bi = bid / g.nwh;
  return t;
}

// Grid pixel (flat index into [B, H, W]) of window token l (< L).
__device__ __forceinline__ size_t pixel_of(const Geometry& g, const Tile& t, int l) {
  const int row = t.wr * g.wh + l / g.ww;
  const int col = t.wc * g.ww + l % g.ww;
  return (static_cast<size_t>(t.bi) * g.H + row) * g.W + col;
}

// Row (flat index into the token rows of x, g and the outputs) of window
// token l: the grid pixel, or for QKV_V4 the window-major row.
template <int VAR>
__device__ __forceinline__ size_t token_of(const Geometry& g, const Tile& t, int l) {
  if constexpr (VAR == QKV_V4) {
    return ((static_cast<size_t>(t.bi) * g.nwh + t.wr) * g.nww + t.wc) * g.lm + l;
  } else {
    return pixel_of(g, t, l);
  }
}

// Window rows that exist in memory: L, or lm for the window-major layout
// (whose pad rows are read and written like the others).
template <int VAR>
__device__ __forceinline__ int rows_of(const Geometry& g) {
  return VAR == QKV_V4 ? g.lm : g.L;
}

// Bytes of the projection's staging ring (two stages of x and W slices).
template <int HD>
__host__ __device__ constexpr size_t staging_bytes(int LP) {
  return (2u * LP * LDX + 2u * KC * (HD + 8)) * sizeof(bf16);
}

// qkv projection of the block's window for head t.h: q, k and v [LP, HD]
// (row pitch HD + 8) in shared memory, bf16(acc + b); padded rows hold
// bf16(b). xs / wsm is the staging ring (staging_bytes), cs a 16 x 16 fp32
// scratch tile of this warp. Ends with a block-wide barrier. HP is the head
// pitch of W's and b's columns: HD, or 128 for K10's padded weights (g.C is
// then heads * 128, and only the HD live columns of each head are read). VAR
// picks the layouts: QKV_V5 reads the (role, head) slab of the reordered W
// [3 * heads, C_in, HD] as one dense [C_in, HD] box (b is [3 * heads, HD],
// the packed [3C] order); QKV_V4 reads x's window-major rows (rows up to lm).
template <int HD, int HP = HD, int VAR = QKV_V3>
__device__ void project_qkv(const bf16* __restrict__ x, const bf16* __restrict__ w,
                            const float* __restrict__ bqkv, const Geometry& g, const Tile& t,
                            bf16* qs, bf16* ks, bf16* vs, bf16* xs, bf16* wsm, float* cs) {
  constexpr int NF = HD / 16;
  constexpr int LDQ = HD + 8;
  const int LP = g.LP;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nthreads = blockDim.x;
  const int C3 = 3 * g.C;
  const int fr = lane >> 1;
  const int fc = (lane & 1) * 8;

  const int nkc = g.Cin / KC;
  const int total = 3 * nkc;
  auto load_slice = [&](int it, int stage) {
    const int role = it / nkc;
    const int k0 = (it % nkc) * KC;
    bf16* xd = xs + stage * LP * LDX;
    for (int idx = tid; idx < LP * (KC / 8); idx += nthreads) {
      const int l = idx / (KC / 8);
      const int c = (idx % (KC / 8)) * 8;
      const bool ok = l < rows_of<VAR>(g);
      const size_t pix = ok ? token_of<VAR>(g, t, l) : 0;
      cp_async16(xd + l * LDX + c, x + pix * g.Cin + k0 + c, ok);
    }
    bf16* wd = wsm + stage * KC * LDQ;
    const int col0 = role * g.C + t.h * HP;
    // QKV_V5: the slab's rows k0.. of [C_in, HD]
    const bf16* w5 = w + (static_cast<size_t>(role * g.heads + t.h) * g.Cin + k0) * HD;
    for (int idx = tid; idx < KC * (HD / 8); idx += nthreads) {
      const int r = idx / (HD / 8);
      const int c = (idx % (HD / 8)) * 8;
      if constexpr (VAR == QKV_V5) {
        cp_async16(wd + r * LDQ + c, w5 + r * HD + c, true);
      } else {
        cp_async16(wd + r * LDQ + c, w + static_cast<size_t>(k0 + r) * C3 + col0 + c, true);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  load_slice(0, 0);
  cp_async_commit();
  for (int it = 0; it < total; ++it) {
    const int cur = it & 1;
    if (it + 1 < total) load_slice(it + 1, cur ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* xa = xs + cur * LP * LDX + warp * 16 * LDX;
    const bf16* wb = wsm + cur * KC * LDQ;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xa + kk, LDX);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, wb + kk * LDQ + j * 16, LDQ);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
    if ((it + 1) % nkc == 0) {
      // role done: + b in fp32, round to bf16, stage in shared memory
      const int role = it / nkc;
      bf16* dst = role == 0 ? qs : (role == 1 ? ks : vs);
      const float* bb = bqkv + role * g.C + t.h * HP;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::store_matrix_sync(cs, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        bf16* d = dst + (warp * 16 + fr) * LDQ + j * 16 + fc;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          d[e] = __float2bfloat16(cs[fr * 16 + fc + e] + bb[j * 16 + fc + e]);
        }
        __syncwarp();
        wmma::fill_fragment(acc[j], 0.0f);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// L2-normalize the 16 rows row0 .. row0 + 15 of t in place, one warp:
// t16 = bf16(t * inv), inv = 1 / sqrt(max(sum t^2, 1e-24)) in fp32.
// If inv_out is not null, the row's inv is stored there (indexed by row).
template <int HD>
__device__ void normalize_tile(bf16* t, int row0, float* inv_out) {
  constexpr int LDQ = HD + 8;
  constexpr int NV = (HD + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int rr = 0; rr < 16; ++rr) {
    const int row = row0 + rr;
    bf16* rowp = t + row * LDQ;
    float vals[NV];
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      const float v = d < HD ? __bfloat162float(rowp[d]) : 0.0f;
      vals[i] = v;
      ss += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float inv = 1.0f / sqrtf(fmaxf(ss, 1e-24f));
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) rowp[d] = __float2bfloat16(vals[i] * inv);
    }
    if (inv_out != nullptr && lane == 0) inv_out[row] = inv;
  }
}

// normalize_tile of this warp's 16 rows (warp w: rows 16 w ..)
template <int HD>
__device__ void normalize_rows(bf16* t, float* inv_out) {
  normalize_tile<HD>(t, (threadIdx.x >> 5) * 16, inv_out);
}

// c += a b on the tensor cores: m16n8k16, bf16 operands, fp32 accumulation;
// a the 16 x 16 row-major fragment, (b0, b1) the 16 x 8 column fragment.
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. ldsm4_t transposes each matrix.
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// s = a_rows [16, HD] @ b_rows [16, HD]^T (both row pitch HD + 8)
template <int HD>
__device__ __forceinline__ void dot_rows(Frag& s, const bf16* a_rows, const bf16* b_rows) {
  constexpr int LDQ = HD + 8;
  wmma::fill_fragment(s, 0.0f);
#pragma unroll
  for (int d = 0; d < HD / 16; ++d) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
    wmma::load_matrix_sync(a, a_rows + d * 16, LDQ);
    wmma::load_matrix_sync(b, b_rows + d * 16, LDQ);
    wmma::mma_sync(s, a, b, s);
  }
}

// Writes the lane's 8 values bf16(f(e, v[e])) as one 16-byte store.
template <class F>
__device__ __forceinline__ void store8(bf16* dst, const float* v, F f) {
  __align__(16) bf16 o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(f(e, v[e]));
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
}

// dbias[h, q, k] = sum over windows, in window order, of the blocks' partials
// part[win, h, q, k] (row pitch LP). Internal linkage: each source that
// includes this header launches its own copy.
static __global__ void dbias_reduce_kernel(const float* __restrict__ part, int n_win, int heads,
                                           int L, int LP, float* __restrict__ dbias) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(heads) * L * L) return;
  const int k = static_cast<int>(i % L);
  const int q = static_cast<int>((i / L) % L);
  const int hh = static_cast<int>(i / (static_cast<long long>(L) * L));
  const size_t stride = static_cast<size_t>(heads) * LP * LP;
  const float* p = part + (static_cast<size_t>(hh) * LP + q) * LP + k;
  float acc = 0.0f;
  for (int wi = 0; wi < n_win; ++wi) acc += p[wi * stride];
  dbias[i] = acc;
}

}  // namespace swin_attn
