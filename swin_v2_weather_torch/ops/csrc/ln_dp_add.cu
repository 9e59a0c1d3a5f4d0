// Fused LayerNorm + drop-path + residual add of the post-norm Swin branch,
// forward and backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels swin_v2_weather_tpu/ops/ln_kernels.py:
//   _make_fwd_kernel (launched by ln_dp_add_fwd_pallas):
//       out = bf16(x + bf16(bf16(LN(z) * gamma + beta) * bf16(m)))
//   _make_bwd_kernel (launched by ln_dp_add_bwd_pallas):
//       dz = bf16(rstd * (dh - mean(dh) - hhat * mean(dh * hhat))), dh = g * m * gamma,
//       dgamma = sum over rows of g * m * hhat, dbeta = sum over rows of g * m
// with per-row fp32 statistics in the two-pass form (mean, then the mean of the
// centred squares; rstd = 1 / sqrt(var + 1e-5)) and m the per-row drop-path
// multiplier (mask / keep, 1 when deterministic). The custom_vjp around them
// (_build) returns dx = g; no kernel is needed for it.
//
// What bounds them on this card: at the flagship shape, [64800, 768] bf16, the
// forward reads z and x and writes out (3 x 99.5 MB) and the backward reads z
// and g and writes dz (3 x 99.5 MB); about 10 FLOP a byte, far below the
// ridge, so each is bound by memory bandwidth (0.089 ms at 3.35 TB/s).
//
// What the design does about it: one warp per token row, the row held in
// registers (4 consecutive channels a lane per 128-wide chunk, read and written
// as 8-byte vectors, so a warp moves 256 contiguous bytes per access), so z is
// read once and the statistics never leave registers. The TPU kernel adds
// dgamma/dbeta into a VMEM-resident accumulator across its sequential grid;
// here blocks run in parallel, so each block owns a contiguous range of rows,
// its warps keep per-lane partial sums in registers, the warps add them into
// shared memory one after another (a fixed order), and the block writes one
// [2, C] partial; ln_dp_add_reduce_kernel sums the partials in block order. No
// atomics: two calls give the same bits. (CUDA C++ rather than Triton, because
// the build, the ctypes binding and the fixed-order reduction pattern of the
// other kernels are reused as they are.)
//
// Rows wider than 2048 channels (16 chunks of 128: 64 values a lane per
// operand) do not fit in registers; the WIDE entry points take them. One warp
// per row as before, but the row is streamed from device memory once per
// pass instead of held (the forward reads z three times and x once, the
// backward z and g four times; a row is at most a few KB, so the rereads hit
// L1/L2): the mean, then the centred squares, then the output. The per-lane
// sums run in the same channel order as the register form, so the statistics
// are the same bits. The backward writes each row's (mean, rstd) to a [T, 2]
// workspace, and dgamma / dbeta come from a column kernel that recomputes
// hhat and sums g m hhat and g m over each block's rows into the same [n_blocks,
// 2, C] partials, then ln_dp_add_reduce_kernel as before.
//
// Contract (checked by the Python wrapper): z, x, g, out, dz [T, C] bf16 and
// row-major contiguous; gamma, beta [C] fp32; m [T] fp32 (one multiplier a
// row); C % 128 == 0 (C <= 2048 for the register entry points); part
// [n_blocks, 2, C] fp32; stats [T, 2] fp32 (WIDE backward).

#include <type_traits>

#include "cuda_common.cuh"

namespace {

using namespace swin_cuda;

constexpr int kWarps = 8;  // rows in flight per block
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the lane's 4 channels of each 128-wide chunk of a bf16 row, as fp32
template <int NCH>
__device__ __forceinline__ void load_row(const bf16* row, int lane, float (&v)[NCH * 4]) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + ch * 128 + lane * 4);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(p[0]);
    const float2 b = __bfloat1622float2(p[1]);
    v[ch * 4 + 0] = a.x;
    v[ch * 4 + 1] = a.y;
    v[ch * 4 + 2] = b.x;
    v[ch * 4 + 3] = b.y;
  }
}

template <int NCH>
__device__ __forceinline__ void store_row(bf16* row, int lane, const float (&v)[NCH * 4]) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    uint2 raw;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
    p[0] = __floats2bfloat162_rn(v[ch * 4 + 0], v[ch * 4 + 1]);
    p[1] = __floats2bfloat162_rn(v[ch * 4 + 2], v[ch * 4 + 3]);
    *reinterpret_cast<uint2*>(row + ch * 128 + lane * 4) = raw;
  }
}

template <int NCH>
__device__ __forceinline__ void load_vec(const float* vec, int lane, float (&v)[NCH * 4]) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const float4 f = *reinterpret_cast<const float4*>(vec + ch * 128 + lane * 4);
    v[ch * 4 + 0] = f.x;
    v[ch * 4 + 1] = f.y;
    v[ch * 4 + 2] = f.z;
    v[ch * 4 + 3] = f.w;
  }
}

// centres v in place and returns rstd (two-pass statistics; the means are
// sums divided by C, as jnp.mean computes them)
template <int NCH>
__device__ __forceinline__ float centre(float (&v)[NCH * 4]) {
  constexpr float c = NCH * 128;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < NCH * 4; ++i) s += v[i];
  const float mean = warp_sum(s) / c;
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NCH * 4; ++i) {
    v[i] -= mean;
    ss += v[i] * v[i];
  }
  return 1.0f / sqrtf(warp_sum(ss) / c + kEps);
}

template <int NCH>
__global__ void __launch_bounds__(kWarps * 32)
    ln_dp_add_fwd_kernel(const bf16* __restrict__ z, const bf16* __restrict__ x,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         const float* __restrict__ m, bf16* __restrict__ out, int T) {
  constexpr int C = NCH * 128;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;
  float v[NCH * 4], xv[NCH * 4], gv[NCH * 4], bv[NCH * 4];
  load_row<NCH>(z + row * C, lane, v);
  load_row<NCH>(x + row * C, lane, xv);
  load_vec<NCH>(gamma, lane, gv);
  load_vec<NCH>(beta, lane, bv);
  const float rstd = centre<NCH>(v);
  const float mb = __bfloat162float(__float2bfloat16(m[row]));  // m in the compute dtype
#pragma unroll
  for (int i = 0; i < NCH * 4; ++i) {
    // ((z - mean) * rstd) * gamma + beta, each op rounded as the plain version's
    const float y = __bfloat162float(
        __float2bfloat16(__fadd_rn(__fmul_rn(__fmul_rn(v[i], rstd), gv[i]), bv[i])));
    const float yb = __bfloat162float(__float2bfloat16(y * mb));
    v[i] = xv[i] + yb;
  }
  store_row<NCH>(out + row * C, lane, v);
}

template <int NCH>
__global__ void __launch_bounds__(kWarps * 32)
    ln_dp_add_bwd_kernel(const bf16* __restrict__ z, const bf16* __restrict__ g,
                         const float* __restrict__ gamma, const float* __restrict__ m,
                         bf16* __restrict__ dz, float* __restrict__ part, int T,
                         int rows_per_block) {
  constexpr int C = NCH * 128;
  __shared__ float acc_s[2 * C];  // the block's [dgamma | dbeta] partial
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) acc_s[i] = 0.0f;

  float gm[NCH * 4], acc_g[NCH * 4], acc_b[NCH * 4];
  load_vec<NCH>(gamma, lane, gm);
#pragma unroll
  for (int i = 0; i < NCH * 4; ++i) acc_g[i] = acc_b[i] = 0.0f;

  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(static_cast<long long>(T), r0 + rows_per_block);
  for (long long row = r0 + warp; row < r1; row += kWarps) {
    float h[NCH * 4], dy[NCH * 4];
    load_row<NCH>(z + row * C, lane, h);
    load_row<NCH>(g + row * C, lane, dy);
    const float rstd = centre<NCH>(h);
    const float mf = m[row];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < NCH * 4; ++i) {
      h[i] *= rstd;  // hhat
      dy[i] *= mf;
      acc_g[i] += dy[i] * h[i];
      acc_b[i] += dy[i];
      dy[i] *= gm[i];  // dh
      s1 += dy[i] * h[i];
      s2 += dy[i];
    }
    const float t1 = warp_sum(s1) / C;  // mean(dh * hhat)
    const float t2 = warp_sum(s2) / C;  // mean(dh)
#pragma unroll
    for (int i = 0; i < NCH * 4; ++i) {
      dy[i] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(dy[i], t2), __fmul_rn(h[i], t1)));
    }
    store_row<NCH>(dz + row * C, lane, dy);
  }

  // the warps' partials into shared memory, warp 0 first, then the block's
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ch * 128 + lane * 4 + j;
          acc_s[c] += acc_g[ch * 4 + j];
          acc_s[C + c] += acc_b[ch * 4 + j];
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    part[static_cast<size_t>(blockIdx.x) * 2 * C + i] = acc_s[i];
  }
}

// dgamma[c] (i < C) and dbeta[c] (i >= C): the blocks' partials summed in block
// order
__global__ void ln_dp_add_reduce_kernel(const float* __restrict__ part, int n_blocks, int C,
                                        float* __restrict__ dgamma, float* __restrict__ dbeta) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * C) return;
  float acc = 0.0f;
  for (int b = 0; b < n_blocks; ++b) acc += part[static_cast<size_t>(b) * 2 * C + i];
  if (i < C) {
    dgamma[i] = acc;
  } else {
    dbeta[i - C] = acc;
  }
}

template <int NCH>
int launch_fwd(const void* z, const void* x, const void* gamma, const void* beta, const void* m,
               void* out, int T, cudaStream_t s) {
  ln_dp_add_fwd_kernel<NCH><<<(T + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      static_cast<const bf16*>(z), static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(m), static_cast<bf16*>(out), T);
  return static_cast<int>(cudaGetLastError());
}

template <int NCH>
int launch_bwd(const void* z, const void* g, const void* gamma, const void* m, void* dz,
               void* part, void* dgamma, void* dbeta, int T, int n_blocks, cudaStream_t s) {
  const int rows_per_block = (T + n_blocks - 1) / n_blocks;
  ln_dp_add_bwd_kernel<NCH><<<n_blocks, kWarps * 32, 0, s>>>(
      static_cast<const bf16*>(z), static_cast<const bf16*>(g), static_cast<const float*>(gamma),
      static_cast<const float*>(m), static_cast<bf16*>(dz), static_cast<float*>(part), T,
      rows_per_block);
  const int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  constexpr int C = NCH * 128;
  ln_dp_add_reduce_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), n_blocks, C, static_cast<float*>(dgamma),
      static_cast<float*>(dbeta));
  return static_cast<int>(cudaGetLastError());
}

// ---------------- rows wider than 2048 channels ---------------------------

// mean and rstd of the row (two-pass, the register form's sum order)
__device__ __forceinline__ void row_stats_wide(const bf16* row, int C, int lane, float& mean,
                                               float& rstd) {
  const int nch = C / 128;
  float s = 0.0f;
  for (int ch = 0; ch < nch; ++ch) {
    float v[4];
    load_row<1>(row + ch * 128, lane, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) s += v[j];
  }
  mean = warp_sum(s) / static_cast<float>(C);
  float ss = 0.0f;
  for (int ch = 0; ch < nch; ++ch) {
    float v[4];
    load_row<1>(row + ch * 128, lane, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float d = v[j] - mean;
      ss += d * d;
    }
  }
  rstd = 1.0f / sqrtf(warp_sum(ss) / static_cast<float>(C) + kEps);
}

__global__ void __launch_bounds__(kWarps * 32)
    ln_dp_add_fwd_wide_kernel(const bf16* __restrict__ z, const bf16* __restrict__ x,
                              const float* __restrict__ gamma, const float* __restrict__ beta,
                              const float* __restrict__ m, bf16* __restrict__ out, int T, int C) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;
  const bf16* zr = z + row * C;
  float mean, rstd;
  row_stats_wide(zr, C, lane, mean, rstd);
  const float mb = __bfloat162float(__float2bfloat16(m[row]));  // m in the compute dtype
  for (int ch = 0; ch < C / 128; ++ch) {
    float v[4], xv[4], gv[4], bv[4];
    load_row<1>(zr + ch * 128, lane, v);
    load_row<1>(x + row * C + ch * 128, lane, xv);
    load_vec<1>(gamma + ch * 128, lane, gv);
    load_vec<1>(beta + ch * 128, lane, bv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float y = __bfloat162float(__float2bfloat16(
          __fadd_rn(__fmul_rn(__fmul_rn(v[j] - mean, rstd), gv[j]), bv[j])));
      const float yb = __bfloat162float(__float2bfloat16(y * mb));
      v[j] = xv[j] + yb;
    }
    store_row<1>(out + row * C + ch * 128, lane, v);
  }
}

// dz of each row (one warp a row), and the row's (mean, rstd) into stats
__global__ void __launch_bounds__(kWarps * 32)
    ln_dp_add_bwd_wide_kernel(const bf16* __restrict__ z, const bf16* __restrict__ g,
                              const float* __restrict__ gamma, const float* __restrict__ m,
                              bf16* __restrict__ dz, float* __restrict__ stats, int T, int C) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;
  const bf16* zr = z + row * C;
  const bf16* gr = g + row * C;
  float mean, rstd;
  row_stats_wide(zr, C, lane, mean, rstd);
  const float mf = m[row];
  const int nch = C / 128;
  float s1 = 0.0f, s2 = 0.0f;
  for (int ch = 0; ch < nch; ++ch) {
    float h[4], dy[4], gm[4];
    load_row<1>(zr + ch * 128, lane, h);
    load_row<1>(gr + ch * 128, lane, dy);
    load_vec<1>(gamma + ch * 128, lane, gm);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float hh = (h[j] - mean) * rstd;  // hhat
      const float dh = dy[j] * mf * gm[j];
      s1 += dh * hh;
      s2 += dh;
    }
  }
  const float t1 = warp_sum(s1) / static_cast<float>(C);  // mean(dh * hhat)
  const float t2 = warp_sum(s2) / static_cast<float>(C);  // mean(dh)
  for (int ch = 0; ch < nch; ++ch) {
    float h[4], dy[4], gm[4];
    load_row<1>(zr + ch * 128, lane, h);
    load_row<1>(gr + ch * 128, lane, dy);
    load_vec<1>(gamma + ch * 128, lane, gm);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float hh = (h[j] - mean) * rstd;
      const float dh = dy[j] * mf * gm[j];
      dy[j] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(dh, t2), __fmul_rn(hh, t1)));
    }
    store_row<1>(dz + row * C + ch * 128, lane, dy);
  }
  if (lane == 0) {
    stats[row * 2] = mean;
    stats[row * 2 + 1] = rstd;
  }
}

// the block's [dgamma | dbeta] partial over its rows [r0, r1), in row order:
// one thread a column, hhat recomputed from the row's (mean, rstd)
__global__ void ln_dp_add_cols_wide_kernel(const bf16* __restrict__ z,
                                           const bf16* __restrict__ g,
                                           const float* __restrict__ m,
                                           const float* __restrict__ stats, int T, int C,
                                           int rows_per_block, float* __restrict__ part) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_block;
  const long long r1 = min(static_cast<long long>(T), r0 + rows_per_block);
  float acc_g = 0.0f, acc_b = 0.0f;
  for (long long r = r0; r < r1; ++r) {
    const float hh = (__bfloat162float(z[r * C + c]) - stats[r * 2]) * stats[r * 2 + 1];
    const float dy = __bfloat162float(g[r * C + c]) * m[r];
    acc_g += dy * hh;
    acc_b += dy;
  }
  part[static_cast<size_t>(blockIdx.y) * 2 * C + c] = acc_g;
  part[static_cast<size_t>(blockIdx.y) * 2 * C + C + c] = acc_b;
}

// calls launch(std::integral_constant<int, C / 128>) for C / 128 in 1..16
template <class F>
int by_width(int C, F launch) {
  if (C < 128 || C % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (C / 128) {
#define SWIN_LN_CASE(n) \
  case n:               \
    return launch(std::integral_constant<int, n>{});
    SWIN_LN_CASE(1) SWIN_LN_CASE(2) SWIN_LN_CASE(3) SWIN_LN_CASE(4)
    SWIN_LN_CASE(5) SWIN_LN_CASE(6) SWIN_LN_CASE(7) SWIN_LN_CASE(8)
    SWIN_LN_CASE(9) SWIN_LN_CASE(10) SWIN_LN_CASE(11) SWIN_LN_CASE(12)
    SWIN_LN_CASE(13) SWIN_LN_CASE(14) SWIN_LN_CASE(15) SWIN_LN_CASE(16)
#undef SWIN_LN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K11 forward: out [T, C] bf16.
extern "C" int swin_ln_dp_add_fwd(const void* z, const void* x, const void* gamma,
                                  const void* beta, const void* m, void* out, int T, int C,
                                  void* stream) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(C, [&](auto n) {
    return launch_fwd<decltype(n)::value>(z, x, gamma, beta, m, out, T, s);
  });
}

// K11 backward: dz [T, C] bf16, dgamma and dbeta [C] fp32, through the
// workspace part [n_blocks, 2, C] fp32.
extern "C" int swin_ln_dp_add_bwd(const void* z, const void* g, const void* gamma, const void* m,
                                  void* dz, void* part, void* dgamma, void* dbeta, int T, int C,
                                  int n_blocks, void* stream) {
  if (T < 1 || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(C, [&](auto n) {
    return launch_bwd<decltype(n)::value>(z, g, gamma, m, dz, part, dgamma, dbeta, T, n_blocks,
                                          s);
  });
}

// K11 forward for rows wider than 2048 channels (C % 128 == 0): out [T, C] bf16.
extern "C" int swin_ln_dp_add_wide_fwd(const void* z, const void* x, const void* gamma,
                                       const void* beta, const void* m, void* out, int T, int C,
                                       void* stream) {
  if (T < 1 || C < 128 || C % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  ln_dp_add_fwd_wide_kernel<<<(T + kWarps - 1) / kWarps, kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(z), static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(m), static_cast<bf16*>(out), T,
      C);
  return static_cast<int>(cudaGetLastError());
}

// K11 backward for rows wider than 2048 channels: dz [T, C] bf16, dgamma and
// dbeta [C] fp32, through the workspaces stats [T, 2] and part [n_blocks, 2,
// C] fp32.
extern "C" int swin_ln_dp_add_wide_bwd(const void* z, const void* g, const void* gamma,
                                       const void* m, void* dz, void* stats, void* part,
                                       void* dgamma, void* dbeta, int T, int C, int n_blocks,
                                       void* stream) {
  if (T < 1 || C < 128 || C % 128 != 0 || n_blocks < 1 || n_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ln_dp_add_bwd_wide_kernel<<<(T + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      static_cast<const bf16*>(z), static_cast<const bf16*>(g), static_cast<const float*>(gamma),
      static_cast<const float*>(m), static_cast<bf16*>(dz), static_cast<float*>(stats), T, C);
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  const int rows_per_block = (T + n_blocks - 1) / n_blocks;
  ln_dp_add_cols_wide_kernel<<<dim3((C + 255) / 256, n_blocks), 256, 0, s>>>(
      static_cast<const bf16*>(z), static_cast<const bf16*>(g), static_cast<const float*>(m),
      static_cast<const float*>(stats), T, C, rows_per_block, static_cast<float*>(part));
  code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  ln_dp_add_reduce_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), n_blocks, C, static_cast<float*>(dgamma),
      static_cast<float*>(dbeta));
  return static_cast<int>(cudaGetLastError());
}
