// Pieces shared by the window-attention kernels (the qkv-fused backward K2 in
// window_attention_qkv_bwd.cu and its K7, K10 and K12 instances, the
// qkv-fused family's streamed backward, the K8/K9 forward and the qkv-fused
// forwards' pass in qkv_attention.cuh, and the streamed backwards of
// streamed_bwd.cuh): the geometry of one launch, the block -> (window, head)
// map, the q/k L2 normalization of 16-row tiles, the m16n8k16 mma and
// ldmatrix primitives with the register-resident score tile, accumulation
// and accumulator-to-A helpers (K2's one-block pass, the streamed
// backwards) and the window-order d(bias) reduction.

#pragma once

#include "cuda_common.cuh"

namespace swin_attn {

using namespace swin_cuda;

constexpr int KC = 32;        // the C_in granularity the qkv-fused backwards take
constexpr int MAX_LP = 256;   // at most 16 warps per block

// Variants of the qkv-fused kernels (the template parameter VAR):
constexpr int QKV_V3 = 0;  // K1/K2 (K7, K10): packed W [C_in, 3C], the NHWC grid
constexpr int QKV_V5 = 1;  // K12 v5: W reordered to [3 * heads, C_in, HD], the NHWC grid
constexpr int QKV_V4 = 2;  // K12 v4: packed W, window-major rows [B, nW, lm, *], v4's rounding

struct Geometry {
  int B, H, W, Cin, C, heads, wh, ww, L, LP, nwh, nww;
  int lm;  // QKV_V4: rows per window in memory (L rounded up to 8; rows >= L are padding)
};

// Fills the geometry from the launch arguments; false if they are not valid
// (L above MAX_LP only where any_l: the streamed backward's callers).
inline bool make_geometry(Geometry& g, int B, int H, int W, int Cin, int C, int heads, int wh,
                          int ww, bool any_l = false) {
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
  return any_l || g.LP <= MAX_LP;
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

// c = a_rows [16, HD] @ b_rows [16, HD]^T (pitch HD + 8) on m16n8k16 mma:
// the two n8 tiles of a 16 x 16 score tile, summed over HD in k16 order.
// aoff / boff: the lane's ldmatrix offsets of an A and a B operand.
template <int HD>
__device__ __forceinline__ void score_tile(float (&c)[2][4], const bf16* a_rows,
                                           const bf16* b_rows, int aoff, int boff) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    unsigned fa[4], fb[4];
    ldsm4(fa, a_rows + aoff + kk * 16);
    ldsm4(fb, b_rows + boff + kk * 16);
    mma16816(c[0], fa, fb[0], fb[1]);
    mma16816(c[1], fa, fb[2], fb[3]);
  }
}

// acc [16, HD] += a (a 16 x 16 A fragment) @ rows [16, HD] (pitch HD + 8):
// toff is the lane's offset of a transposed ldmatrix of the B operand
template <int HD>
__device__ __forceinline__ void accumulate_rows(float (&acc)[HD / 8][4], const unsigned (&a)[4],
                                                const bf16* rows, int toff) {
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    unsigned fb[4];
    ldsm4_t(fb, rows + toff + j * 16);
    mma16816(acc[2 * j], a, fb[0], fb[1]);
    mma16816(acc[2 * j + 1], a, fb[2], fb[3]);
  }
}

// The A fragment of a 16 x 16 tile held as two n8 accumulator tiles, rounded
// to bf16 (the accumulator-to-A identity of m16n8k16)
__device__ __forceinline__ void to_a(unsigned (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
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
