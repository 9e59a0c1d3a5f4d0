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
// operand) do not fit in registers; the WIDE entry points take them. The
// forward keeps one warp per row and streams the row from device memory once
// per pass instead of holding it (z three times and x once; a row is a few
// KB, so the rereads hit L1/L2): the mean, then the centred squares, then
// the output. The backward reads z and g from device memory once and writes
// dz once, all three by the copy engine (bulk copies, Hopper's TMA without a
// tensor map): a block stages R rows of z and g in shared memory through a
// two-stage ring (R = 8 up to C = 3200, fewer above), one warp a row
// computes the statistics from there, and then the block's threads form dz
// over z in the stage and add the staged rows to its [2, C] dgamma / dbeta
// partial in shared memory, column by column in row order; one bulk store
// writes the stage's dz rows while the next stage computes.
// ln_dp_add_reduce_kernel sums the partials as before. The per-lane sums of
// the statistics run in the same channel order as the register form, so
// they are the same bits. dz leaves by the copy engine because stores from
// the threads held the kernel to 0.595 ms at [64800, 3072], against 0.457
// with the bulk store and a 0.357 ms bound (PERF.md).
//
// Contract (checked by the Python wrapper): z, x, g, out, dz [T, C] bf16 and
// row-major contiguous; gamma, beta [C] fp32; m [T] fp32 (one multiplier a
// row); C % 128 == 0 (C <= 2048 for the register entry points; the WIDE
// backward up to the width whose one staged row fits: C <= 14464); part
// [n_blocks, 2, C] fp32.

#include <cstdint>
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

// mean and rstd of a row staged in shared memory: row_stats_wide's sums in
// its order, the loads unrolled ahead of them
__device__ __forceinline__ void staged_row_stats(const bf16* row, int C, int lane, float& mean,
                                                 float& rstd) {
  const int nch = C / 128;
  float s = 0.0f;
#pragma unroll 4
  for (int ch = 0; ch < nch; ++ch) {
    float v[4];
    load_row<1>(row + ch * 128, lane, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) s += v[j];
  }
  mean = warp_sum(s) / static_cast<float>(C);
  float ss = 0.0f;
#pragma unroll 4
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

// The backward's dynamic shared memory at width C (wide_bwd_plan in
// ops/ln_kernels.py mirrors it): two stages of R rows of z and g (bf16), the
// block's [dgamma | dbeta] partial (fp32) and each staged row's (mean, rstd,
// m, t1, t2) (8 words); R the most rows a stage (at most one a warp) that
// fit a block's shared memory beside 64 bytes of static (the stages'
// mbarriers), or 0 where not one does.
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may opt into
inline int wide_rows(int C) {
  const long long r = (kMaxSmem - 64 - 8LL * C - 32LL * kWarps) / (8LL * C);
  return static_cast<int>(r < 0 ? 0 : r > kWarps ? kWarps : r);
}
inline size_t wide_bwd_smem(int C, int R) {
  return 8ull * R * C + 8ull * C + 32ull * kWarps;
}

// The bulk copies (TMA, no tensor map) and their mbarriers: one thread
// copies a stage's rows of z and g, the barrier counts the bytes landed
__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The bulk store of a stage's dz rows (read from shared memory by the copy
// engine; each thread that wrote them fences its writes to it first), its
// commit, and the wait until the engine has read them
__device__ __forceinline__ void fence_to_copy_engine() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_store_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The backward of rows wider than 2048 channels, one pass over z and g: each
// block takes a contiguous range of rows, R rows a stage through a
// two-stage ring of bulk copies (one thread copies a stage's R rows of z and
// of g, each one contiguous span; the next stage's copies are in flight
// while this one computes). Warp w takes staged row w: its statistics,
// mean(dh) and mean(dh hhat) from shared memory in the register form's
// per-lane order (the same bits). Then every thread takes 4 consecutive
// columns at a time of the staged rows: it forms dz (an elementwise
// function of the row's statistics, the register form's arithmetic) over
// z in the stage, and adds g m hhat and g m to the block's [dgamma | dbeta]
// partial in shared memory in row order, so each column sums the block's
// rows in row order; one thread then hands the stage's dz rows to a bulk
// store, which must have read them before the stage is loaded again. The
// block writes its partial; ln_dp_add_reduce_kernel sums the partials in
// block order.
__global__ void __launch_bounds__(kWarps * 32, 1)
    ln_dp_add_bwd_wide_kernel(const bf16* __restrict__ z, const bf16* __restrict__ g,
                              const float* __restrict__ gamma, const float* __restrict__ m,
                              bf16* __restrict__ dz, float* __restrict__ part, int T, int C,
                              int rows_per_block, int R) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bars[2];  // a stage's copies landed
  bf16* stage0 = reinterpret_cast<bf16*>(smem);  // [2][z R rows | g R rows]
  float* acc = reinterpret_cast<float*>(stage0 + 4ll * R * C);  // [dgamma | dbeta] partial
  float* st = acc + 2 * C;  // [kWarps][8]: mean, rstd, m, mean(dh hhat), mean(dh)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) acc[i] = 0.0f;
  if (threadIdx.x == 0) {
    bar_init(smem_u32(&bars[0]));
    bar_init(smem_u32(&bars[1]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(static_cast<long long>(T), r0 + rows_per_block);
  const int ngroups = r1 > r0 ? static_cast<int>((r1 - r0 + R - 1) / R) : 0;
  // the group's rows of z and g into stage (grp & 1)
  auto load = [&](int grp) {
    const long long row = r0 + static_cast<long long>(grp) * R;
    const int nr = static_cast<int>(min(static_cast<long long>(R), r1 - row));
    bf16* zs = stage0 + static_cast<size_t>(grp & 1) * 2 * R * C;
    const uint32_t bar = smem_u32(&bars[grp & 1]);
    const uint32_t bytes = static_cast<uint32_t>(nr) * C * 2;
    bar_expect(bar, 2 * bytes);
    bulk_load(zs, z + row * C, bytes, bar);
    bulk_load(zs + static_cast<size_t>(R) * C, g + row * C, bytes, bar);
  };
  if (threadIdx.x == 0 && ngroups > 0) load(0);
  for (int grp = 0; grp < ngroups; ++grp) {
    if (threadIdx.x == 0 && grp + 1 < ngroups) {
      bulk_store_read_wait();  // the stage's last dz rows have left it
      load(grp + 1);
    }
    bar_wait(smem_u32(&bars[grp & 1]), (grp >> 1) & 1);
    const long long row0 = r0 + static_cast<long long>(grp) * R;
    const int nr = static_cast<int>(min(static_cast<long long>(R), r1 - row0));
    bf16* zs = stage0 + static_cast<size_t>(grp & 1) * 2 * R * C;
    const bf16* gs = zs + static_cast<size_t>(R) * C;
    if (warp < nr) {  // row row0 + warp's statistics, as the register form sums them
      const bf16* zr = zs + static_cast<size_t>(warp) * C;
      const bf16* gr = gs + static_cast<size_t>(warp) * C;
      float mean, rstd;
      staged_row_stats(zr, C, lane, mean, rstd);
      const float mf = m[row0 + warp];
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 4
      for (int ch = 0; ch < C / 128; ++ch) {
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
      if (lane == 0) {
        float* sr = st + warp * 8;
        sr[0] = mean;
        sr[1] = rstd;
        sr[2] = mf;
        sr[3] = t1;
        sr[4] = t2;
      }
    }
    __syncthreads();
    // dz of the staged rows (written over their z in the stage) and their
    // terms of the block's partial, 4 columns a thread at a time, the rows in
    // order: dgamma += (g m) hhat, dbeta += g m
    for (int c = 4 * threadIdx.x; c < C; c += 4 * blockDim.x) {
      float gm[4], ag[4], ab[4];
      load_vec<1>(gamma + c, 0, gm);
      load_vec<1>(acc + c, 0, ag);
      load_vec<1>(acc + C + c, 0, ab);
#pragma unroll 2
      for (int r = 0; r < nr; ++r) {
        const float* sr = st + r * 8;
        const float mean = sr[0], rstd = sr[1], mf = sr[2], t1 = sr[3], t2 = sr[4];
        float zv[4], gv[4];
        load_row<1>(zs + static_cast<size_t>(r) * C + c, 0, zv);
        load_row<1>(gs + static_cast<size_t>(r) * C + c, 0, gv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float hh = (zv[j] - mean) * rstd;
          const float dy = gv[j] * mf;
          ag[j] += dy * hh;
          ab[j] += dy;
          zv[j] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(dy * gm[j], t2), __fmul_rn(hh, t1)));
        }
        store_row<1>(zs + static_cast<size_t>(r) * C + c, 0, zv);
      }
      *reinterpret_cast<float4*>(acc + c) = make_float4(ag[0], ag[1], ag[2], ag[3]);
      *reinterpret_cast<float4*>(acc + C + c) = make_float4(ab[0], ab[1], ab[2], ab[3]);
    }
    fence_to_copy_engine();
    __syncthreads();  // the stage and the statistics are free for the next group
    if (threadIdx.x == 0) {  // the group's dz rows, one contiguous span
      bulk_store(dz + row0 * C, zs, static_cast<uint32_t>(nr) * C * 2);
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    part[static_cast<size_t>(blockIdx.x) * 2 * C + i] = acc[i];
  }
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
// dbeta [C] fp32, through the workspace part [n_blocks, 2, C] fp32; one
// kernel over z and g, then the partials' reduction. Refuses a width whose
// one staged row does not fit a block's shared memory (wide_rows).
extern "C" int swin_ln_dp_add_wide_bwd(const void* z, const void* g, const void* gamma,
                                       const void* m, void* dz, void* part, void* dgamma,
                                       void* dbeta, int T, int C, int n_blocks, void* stream) {
  const int R = C >= 128 ? wide_rows(C) : 0;
  if (T < 1 || C < 128 || C % 128 != 0 || R < 1 || n_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = wide_bwd_smem(C, R);
  int code = static_cast<int>(cudaFuncSetAttribute(
      ln_dp_add_bwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (code != 0) return code;
  const int rows_per_block = (T + n_blocks - 1) / n_blocks;
  ln_dp_add_bwd_wide_kernel<<<n_blocks, kWarps * 32, smem, s>>>(
      static_cast<const bf16*>(z), static_cast<const bf16*>(g), static_cast<const float*>(gamma),
      static_cast<const float*>(m), static_cast<bf16*>(dz), static_cast<float*>(part), T, C,
      rows_per_block, R);
  code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  ln_dp_add_reduce_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), n_blocks, C, static_cast<float*>(dgamma),
      static_cast<float*>(dbeta));
  return static_cast<int>(cudaGetLastError());
}
