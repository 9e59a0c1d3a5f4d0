// The qkv projection of the qkv-fused window attention and its backward, on
// the Hopper GEMM core. project() writes qkv = bf16(x @ W + b) [T, N] for the
// one-block backwards (K2/K7/K10/K12 in window_attention_qkv_bwd.cu);
// project_normalized() the forwards' (window_attention_qkv.cu) and
// project_normalized_keep() the streamed backwards'
// (window_attention_qkv_large.cu). projection_backward(), shared by the
// backwards: given the bf16 cotangent of the projection output dqkv [T, N]
// (N = 3C, or 3 * heads * 128 for K10), compute
//   dx = dqkv @ W^T on the GEMM core (wgmma_gemm.cuh), W [C_in, N] read as
//        the K-major B operand in place, bf16 out,
//   dW = bf16(x)^T @ dqkv in fp32 on the core, x read as the MN-major A
//        operand in place, split over token ranges into fixed partials,
//   db = column sums of dqkv over token ranges,
// then one kernel that sums the dW and db partials in split order and the
// d(scale) partials in partial order, dividing by scale, and (with the CPB
// bias) the d(bias) partials in window order. No atomics: two calls give the
// same bits.

#pragma once

#include "wgmma_gemm.cuh"
#include "window_attention_common.cuh"

namespace swin_qkv_proj {

using swin_cuda::bf16;

// part[s, n] = sum of d[t, n] over token range s, in token order
static __global__ void column_sums_kernel(const bf16* __restrict__ d, int T, int N,
                                          int rows_per_split, float* __restrict__ part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(T, r0 + rows_per_split);
  float acc = 0.0f;
  for (int r = r0; r < r1; ++r) acc += __bfloat162float(d[static_cast<size_t>(r) * N + n]);
  part[static_cast<size_t>(blockIdx.y) * N + n] = acc;
}

// dW = sum of the split partials, db = sum of the column-sum partials (both in
// split order), dscale[h] = (sum over the n_part partials, in order) / scale[h]
static __global__ void reduce_kernel(const float* __restrict__ dw_part, int dw_splits, int n_dw,
                                     float* __restrict__ dw, const float* __restrict__ db_part,
                                     int db_splits, int n_db, float* __restrict__ db,
                                     const float* __restrict__ ds_part, int n_part, int heads,
                                     const float* __restrict__ scale,
                                     float* __restrict__ dscale) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_dw) {
    float acc = 0.0f;
    for (int s = 0; s < dw_splits; ++s) acc += dw_part[static_cast<size_t>(s) * n_dw + i];
    dw[i] = acc;
  } else if (i < n_dw + n_db) {
    const int j = static_cast<int>(i - n_dw);
    float acc = 0.0f;
    for (int s = 0; s < db_splits; ++s) acc += db_part[static_cast<size_t>(s) * n_db + j];
    db[j] = acc;
  } else if (i < n_dw + n_db + heads) {
    const int hh = static_cast<int>(i - n_dw - n_db);
    float acc = 0.0f;
    for (int k = 0; k < n_part; ++k) acc += ds_part[static_cast<size_t>(k) * heads + hh];
    dscale[hh] = acc / scale[hh];
  }
}

// The qkv projection of the qkv-fused backwards, split off their attention
// pass onto the GEMM core: qkv [T, N] = bf16(x [T, C_in] @ W + b), fp32
// accumulation and one rounding (K1's site). slab_hd = 0: W is the packed
// [C_in, N]. Otherwise W is v5's reordered [N / slab_hd, C_in, slab_hd] and
// b the packed [N]: each (role, head) slab is its own product, in the same K
// order, written to its slab_hd columns of qkv.
template <class = void>  // (a template: a source instantiates only the products it calls)
int project(const bf16* x, const bf16* w, const float* b, bf16* qkv, int T, int Cin, int N,
            int slab_hd, cudaStream_t s) {
  if (slab_hd == 0) {
    return swin_wg::launch_auto<false, true>(x, Cin, w, N, T, N, Cin, 1,
                                             swin_wg::StoreBiasBf16{b, qkv, N}, s);
  }
  int code = 0;
  for (int col0 = 0; col0 < N && code == 0; col0 += slab_hd) {
    code = swin_wg::launch_auto<false, true>(
        x, Cin, w + static_cast<size_t>(col0) * Cin, slab_hd, T, slab_hd, Cin, 1,
        swin_wg::StoreBiasBf16{b + col0, qkv + col0, N}, s);
  }
  return code;
}

// The forwards' projection epilogue (a kTile epilogue of the core): qkv =
// bf16(acc + b), then the q and k columns of each head L2-normalized in
// place, qn16 = bf16(q16 * inv) with inv = 1 / sqrt(max(sum q16^2, 1e-24))
// in fp32 (K1's rounding sites; the sum over the head's columns a lane
// holds, in column order, then across the quad), v as it is. UNIT is the
// head pitch in columns (hd, or 128 for the padded heads, whose pad
// columns are exact zeros); a tile of BN columns holds BN / UNIT whole
// heads. role0 is the packed column of this launch's column 0 (v5's slabs)
// and C the columns of one role: a head at packed column p is q or k where
// p / C < 2. KEEP (the streamed backward's recompute, so that its qn16 is
// the forward's): the inverse norms also go to norms [M, 2, C / UNIT] (row,
// q or k, head) and, where park is not null (v4), the raw q and k values to
// their places in park [M, ld].
template <int BN, int UNIT, bool KEEP = false>
struct StoreNormBf16 {
  static constexpr bool kTile = true;
  const float* b;  // [N] of this launch
  bf16* out;
  int ld, role0, C;
  float* norms = nullptr;  // KEEP
  bf16* park = nullptr;    // KEEP, v4 only
  __device__ void tile(float (&acc)[BN / 2], int r0, int c0, int M, int N) const {
    constexpr int G = UNIT / 8;  // the 8-column groups of a head
    const int n0 = c0 - 2 * (threadIdx.x & 3);
#pragma unroll
    for (int u = 0; u < BN / UNIT; ++u) {
      const bool live = n0 + u * UNIT < N;  // N holds whole heads
      const bool unit_norm = (role0 + n0 + u * UNIT) / C < 2;
      float ss[2] = {0.0f, 0.0f};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = u * G + g;
        const int col = c0 + 8 * j;
        const float b0 = live ? b[col] : 0.0f;
        const float b1 = live ? b[col + 1] : 0.0f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& v0 = acc[4 * j + 2 * r];
          float& v1 = acc[4 * j + 2 * r + 1];
          v0 = __bfloat162float(__float2bfloat16(v0 + b0));
          v1 = __bfloat162float(__float2bfloat16(v1 + b1));
          ss[r] = fmaf(v0, v0, ss[r]);
          ss[r] = fmaf(v1, v1, ss[r]);
        }
      }
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], 1);
        ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], 2);
        inv[r] = unit_norm ? 1.0f / sqrtf(fmaxf(ss[r], 1e-24f)) : 1.0f;
      }
      if (!live) continue;
      if constexpr (KEEP) {
        const int p = role0 + n0 + u * UNIT;  // the head's packed column
        if (unit_norm && (threadIdx.x & 3) == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (r0 + 8 * r < M) {
              norms[(static_cast<size_t>(r0 + 8 * r) * 2 + p / C) * (C / UNIT) + (p % C) / UNIT] =
                  inv[r];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = u * G + g;
        const int col = c0 + 8 * j;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (r0 + 8 * r < M) {
            const size_t off = static_cast<size_t>(r0 + 8 * r) * ld + col;
            *reinterpret_cast<__nv_bfloat162*>(out + off) =
                __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
            if constexpr (KEEP) {
              if (park != nullptr && unit_norm) {
                *reinterpret_cast<__nv_bfloat162*>(park + off) =
                    __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
              }
            }
          }
        }
      }
    }
  }
};

// The forwards' projection on the core with the normalizing epilogue:
// qkv [T, N] = bf16(x @ W + b) with q and k L2-normalized per head of
// `unit` columns (hd, or 128 padded) and C = N / 3. slab_hd as project's (v5:
// one product per (role, head) slab; each slab is one head). The block
// width holds whole heads: 192 at head dim 96, else 256 (128 where N <=
// 128).
// KEEP: the epilogue keeps the inverse norms in norms and (park not null)
// parks the raw q and k rows (StoreNormBf16).
template <int UNIT, bool KEEP = false>
int project_units(const bf16* x, const bf16* w, const float* b, bf16* qkv, int T, int Cin, int N,
                  int slab_hd, cudaStream_t s, float* norms = nullptr, bf16* park = nullptr) {
  const int C = N / 3;
  auto one = [&](const bf16* wp, int ldw, int n, int col0) {
    const float* bp = b + col0;
    bf16* op = qkv + col0;
    if constexpr (UNIT == 96) {
      if (n > 128) {
        return swin_wg::launch<192, false, true>(
            x, Cin, wp, ldw, T, n, Cin, 1,
            StoreNormBf16<192, 96, KEEP>{bp, op, N, col0, C, norms, park}, s);
      }
    }
    if constexpr (UNIT <= 128) {
      if (n <= 128) {
        return swin_wg::launch<128, false, true>(
            x, Cin, wp, ldw, T, n, Cin, 1,
            StoreNormBf16<128, UNIT, KEEP>{bp, op, N, col0, C, norms, park}, s);
      }
    }
    if constexpr (UNIT != 96) {
      return swin_wg::launch<256, false, true>(
          x, Cin, wp, ldw, T, n, Cin, 1,
          StoreNormBf16<256, UNIT, KEEP>{bp, op, N, col0, C, norms, park}, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (slab_hd == 0) return one(w, N, N, 0);
  int code = 0;
  for (int col0 = 0; col0 < N && code == 0; col0 += slab_hd) {
    code = one(w + static_cast<size_t>(col0) * Cin, slab_hd, slab_hd, col0);
  }
  return code;
}

template <class = void>
int project_normalized(const bf16* x, const bf16* w, const float* b, bf16* qkv, int T, int Cin,
                       int N, int unit, int slab_hd, cudaStream_t s) {
  switch (unit) {
    case 32:
      return project_units<32>(x, w, b, qkv, T, Cin, N, slab_hd, s);
    case 64:
      return project_units<64>(x, w, b, qkv, T, Cin, N, slab_hd, s);
    case 96:
      return project_units<96>(x, w, b, qkv, T, Cin, N, slab_hd, s);
    case 128:
      return project_units<128>(x, w, b, qkv, T, Cin, N, slab_hd, s);
    case 256:
      return project_units<256>(x, w, b, qkv, T, Cin, N, slab_hd, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The streamed backward's recompute (window_attention_qkv_large.cu):
// project_normalized whose epilogue also keeps the inverse norms, norms [T,
// 2, N / 3 / unit], and (park not null: v4) parks the raw q and k rows in
// park [T, N]. unit: the head dim, or 128 for the padded heads.
template <class = void>
int project_normalized_keep(const bf16* x, const bf16* w, const float* b, bf16* qkv, int T,
                            int Cin, int N, int unit, int slab_hd, float* norms, bf16* park,
                            cudaStream_t s) {
  switch (unit) {
#define SWIN_KEEP_CASE(U) \
  case U:                 \
    return project_units<U, true>(x, w, b, qkv, T, Cin, N, slab_hd, s, norms, park);
    SWIN_KEEP_CASE(32)
    SWIN_KEEP_CASE(64)
    SWIN_KEEP_CASE(96)
    SWIN_KEEP_CASE(128)
    SWIN_KEEP_CASE(256)
#undef SWIN_KEEP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Everything after the attention backward: dx, dW, db, dscale and (dbias
// non-null) dbias. dqkv [T, N] bf16; dw_part [dw_splits, C_in, N], db_part
// [db_splits, N] fp32; dscale_part [n_part, heads]; dbias_part [n_win, heads,
// LP, LP] (dbias only).
template <class = void>
int projection_backward(const bf16* x, const bf16* w, const bf16* dqkv, int T, int Cin, int N,
                        float* dw_part, float* db_part, const float* dscale_part, int n_part,
                        int heads, const float* scale, bf16* dx, float* dw, float* db,
                        float* dscale, const float* dbias_part, int n_win, int L, int LP,
                        float* dbias, int dw_splits, int db_splits, cudaStream_t s) {
  // dx [T, C_in] = dqkv [T, N] @ W^T: A K-major, B^T = W stored [C_in, N]
  int code = swin_wg::launch_auto<false, false>(dqkv, N, w, N, T, Cin, N, 1,
                                                swin_wg::StoreBf16{dx, Cin}, s);
  if (code != 0) return code;
  // dW [C_in, N] = x^T @ dqkv: A^T = x stored [T, C_in], B = dqkv stored [T, N]
  code = swin_wg::launch_auto<true, true>(
      x, Cin, dqkv, N, Cin, N, T, dw_splits,
      swin_wg::StoreSplitF32{dw_part, N, static_cast<size_t>(Cin) * N}, s);
  if (code != 0) return code;

  const int rows_per_split = (T + db_splits - 1) / db_splits;
  column_sums_kernel<<<dim3((N + 127) / 128, db_splits), 128, 0, s>>>(dqkv, T, N,
                                                                      rows_per_split, db_part);
  code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;

  const int n_dw = Cin * N;
  const long long n_all = static_cast<long long>(n_dw) + N + heads;
  reduce_kernel<<<static_cast<unsigned>((n_all + 255) / 256), 256, 0, s>>>(
      dw_part, dw_splits, n_dw, dw, db_part, db_splits, N, db, dscale_part, n_part, heads, scale,
      dscale);
  code = static_cast<int>(cudaGetLastError());
  if (code != 0 || dbias == nullptr) return code;

  const long long n_bias = static_cast<long long>(heads) * L * L;
  swin_attn::dbias_reduce_kernel<<<static_cast<unsigned>((n_bias + 255) / 256), 256, 0, s>>>(
      dbias_part, n_win, heads, L, LP, dbias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swin_qkv_proj
