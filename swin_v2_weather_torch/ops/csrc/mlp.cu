// The whole Swin MLP (fc1 + exact-erf GELU + fc2), forward and backward,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels swin_v2_weather_tpu/ops/mlp_kernels.py:
//   _make_mlp_fwd_kernel (launched by mlp_fwd_pallas), K5:
//     out = bf16(bf16(gelu(bf16(x @ W1 + b1))) @ W2) + bf16(b2)
//   _make_mlp_bwd_kernel (launched by mlp_bwd_pallas), K6:
//     pre = bf16(x @ W1 + b1);  a = bf16(gelu(pre));  dpre = bf16((g @ W2^T) * gelu'(pre))
// The rounding sites are those of the TPU kernels (flax Dense(dtype=bf16)
// rounds each product, then adds the bias in bf16).
//
// What bounds them on this card: at the flagship shape (T = 64800 tokens,
// C = 768, hidden = 3072) each is two chained GEMMs, 2 T hidden (C_in + C_out)
// = 612 GFLOP, 0.62 ms at 989 TFLOP/s. K5 moves about 0.21 GB (x, W1, W2,
// out: 0.06 ms at 3.35 TB/s), K6 about 1.0 GB (x, g, W1, W2 in; a and dpre
// out: 0.30 ms). Both are tensor-core bound.
//
// What the designs do about it:
//   K5 keeps the [T, hidden] activation out of device memory, which is the
//   point of the TPU kernel (it is what lets the multi-step fine-tune keep no
//   [T, hidden] tensor per block). A block owns 32 token rows and all C_out
//   output columns, so fc1 is never recomputed; its [32, C_out] fp32 output
//   accumulator lives in registers (8 warps x 32 x 96 at C_out = 768, twelve
//   16x16 wmma fragments a thread) across a loop over 128-wide hidden chunks.
//   Per chunk: the [32, 128] pre-activation runs over K = C_in against the x
//   tile, which stays in shared memory for the whole block; bias, bf16
//   rounding and GELU turn it into a bf16 [32, 128] tile in shared memory,
//   which is the A operand of its product with W2[chunk, :]. W1 slices (128
//   rows deep at C_in = 768) and W2 slices (32 rows of all C_out columns)
//   stream through one three-stage cp.async ring, so two slices load while
//   one multiplies; a deep W1 slice gives each warp 16 MMAs between barriers
//   (32-deep slices gave 4 and left the load latency exposed: 10.9 ms at the
//   flagship shape). Each block re-reads W1 and W2 (4.7 MB each
//   in bf16); they stay in the 50 MB L2, and that L2 traffic (about 19 GB at
//   the flagship shape, 2025 blocks) is the price of one block per 32 rows.
//   Rows wider than 768 columns (the e2048 family: C_in = C_out = 2048,
//   hidden 4096) would need a [32, C_out] accumulator no block's registers
//   hold (256 KB at 2048), and the x tile [32, C_in + 8] plus whole W2 slices
//   [32, C_out + 8] no block's shared memory holds. The WIDE instance takes
//   them: the output columns are tiled across blocks, 768 per block (the
//   same accumulator layout; the last tile ragged), and x is no longer kept
//   whole but streamed in K-slices beside each W1 slice. Each column tile
//   recomputes fc1 for its 32 rows: ceil(C_out / 768) times the fc1 work in
//   all (3 x at C_out = 2048, so the call does 3 x fc1 + fc2 = 2 x the
//   minimal FLOPs), the price of keeping [T, hidden] out of device memory.
//   The narrow layout is taken whenever it fits (C_out <= 768 and its shared
//   memory within 227 KB); the rounding sites are the same in both.
//   K6 is K4's tile GEMM (gemm_tile.cuh) run twice on one 128 x 128 output
//   tile: x @ W1 first, whose epilogue writes a to memory and keeps the bf16
//   pre-activation in shared memory, then g @ W2^T (W2 read transposed in
//   place) into the same accumulators, whose epilogue forms dpre. One set of
//   accumulators, so the register budget is K4's.
// wgmma/TMA pipelines come later; this version is the simple, correct one.
//
// Contract (checked by the Python wrapper): x [T, C_in], W1 [C_in, hidden],
// W2 [hidden, C_out], g and out [T, C_out], a and dpre [T, hidden], all bf16
// row-major contiguous; b1 [hidden] and b2 [C_out] fp32; C_in % 32 == 0,
// hidden % 128 == 0, C_out % 32 == 0; any T >= 1 (the ragged last token
// tile is zero-filled and masked).

#include "gemm_tile.cuh"

namespace {

using namespace swin_gemm;

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.0f + erff(z * kInvSqrt2));
}

// gelu'(z) = Phi(z) + z * phi(z)
__device__ __forceinline__ float gelu_grad(float z) {
  const float phi = expf(z * z * -0.5f) * kInvSqrt2Pi;
  const float cdf = 0.5f * (1.0f + erff(z * kInvSqrt2));
  return cdf + z * phi;
}

// ---------------------------------------------------------------------------
// K5: the MLP forward
// ---------------------------------------------------------------------------

namespace k5 {

constexpr int TM = 32;      // token rows per block
constexpr int HC = 128;     // hidden columns per chunk
constexpr int KS = 32;      // depth of a W2 slice (rows of the chunk)
constexpr int MAX_KS1 = 128;  // depth of a W1 slice: the largest of 128, 64, 32 dividing C_in
constexpr int STAGES = 3;
constexpr int MAX_NF = 6;   // output column fragments per warp: C_out <= 8 * 6 * 16
constexpr int MAX_COUT = (THREADS / 32) * MAX_NF * 16;
constexpr int W1_LD = HC + 8;  // shared-memory pitches, in elements
constexpr int A_LD = HC + 8;
constexpr int P_LD = HC + 4;   // fp32

// Shared memory: the x tile [TM][C_in + 8]; a three-stage ring whose stage
// holds either a W1 slice [ks1][HC + 8] or a W2 slice [KS][C_out + 8]; the bf16
// activation chunk [TM][A_LD]; the fp32 pre-activation chunk [TM][P_LD], which
// is also the output epilogue's scratch. Every offset is a multiple of 32
// bytes. At C_in = C_out = 768: 49.7 + 149.0 + 8.7 + 16.9 KB = 224.3 KB.
// WIDE: no x tile; a W1 stage also holds the x slice [TM][ks1 + 8] after the
// W1 slice, and a W2 slice is [KS][768 + 8] (one column tile). At C_in =
// C_out = 2048: 149.0 + 8.7 + 16.9 KB = 174.6 KB.
struct Layout {
  int x_ld, w2_ld, ks1, stage_elems, xs_off;
  size_t ring_off, a_off, p_off, bytes;
};

__host__ __device__ inline Layout layout(int c_in, int c_out, bool wide) {
  Layout l;
  l.ks1 = c_in % MAX_KS1 == 0 ? MAX_KS1 : (c_in % 64 == 0 ? 64 : 32);
  l.x_ld = wide ? l.ks1 + 8 : c_in + 8;
  l.w2_ld = (wide ? MAX_COUT : c_out) + 8;
  l.xs_off = l.ks1 * W1_LD;  // WIDE: the x slice's offset in a W1 stage
  const int w1_elems = l.ks1 * W1_LD + (wide ? TM * l.x_ld : 0);
  const int w2_elems = KS * l.w2_ld;
  l.stage_elems = w1_elems > w2_elems ? w1_elems : w2_elems;
  l.ring_off = wide ? 0 : static_cast<size_t>(TM) * l.x_ld * sizeof(bf16);
  l.a_off = l.ring_off + STAGES * static_cast<size_t>(l.stage_elems) * sizeof(bf16);
  l.p_off = l.a_off + static_cast<size_t>(TM) * A_LD * sizeof(bf16);
  l.bytes = l.p_off + static_cast<size_t>(TM) * P_LD * sizeof(float);
  return l;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;

// WIDE: block (blockIdx.x, blockIdx.y) owns output columns [768 blockIdx.x,
// + 768) of token rows [32 blockIdx.y, + 32); otherwise blockIdx.x is the
// row block and the block owns all columns.
template <bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
    mlp_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const float* __restrict__ b2, bf16* __restrict__ out, int T, int c_in,
                   int hidden, int c_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = layout(c_in, c_out, WIDE);
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + l.ring_off);
  bf16* as = reinterpret_cast<bf16*>(smem + l.a_off);
  float* ps = reinterpret_cast<float*>(smem + l.p_off);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = (WIDE ? blockIdx.y : blockIdx.x) * TM;
  const int n0 = WIDE ? blockIdx.x * MAX_COUT : 0;  // first output column of the block
  const int n_cols = WIDE ? min(MAX_COUT, c_out - n0) : c_out;
  const int ks1 = l.ks1;
  const int n_k1 = c_in / ks1;             // W1 slices per chunk, then HC / KS W2 slices
  const int per_chunk = n_k1 + HC / KS;
  const int n_slices = (hidden / HC) * per_chunk;
  const int f_total = n_cols / 16;         // output column fragments; warp owns warp + 8 j

  if constexpr (!WIDE) {
    // the x tile, zero-filled past T; it joins the first slice's copy group
    const int xv = c_in / 8;
    for (int idx = tid; idx < TM * xv; idx += THREADS) {
      const int r = idx / xv, c = (idx % xv) * 8;
      const bool ok = m0 + r < T;
      cp_async16(xs + r * l.x_ld + c, ok ? x + static_cast<size_t>(m0 + r) * c_in + c : x, ok);
    }
  }

  auto load_slice = [&](int s) {
    bf16* dst = ring + (s % STAGES) * l.stage_elems;
    const int chunk = s / per_chunk, r = s % per_chunk;
    if (r < n_k1) {  // W1[r ks1 : +ks1, chunk HC : +HC]
      const bf16* src = w1 + static_cast<size_t>(r * ks1) * hidden + chunk * HC;
      for (int idx = tid; idx < ks1 * (HC / 8); idx += THREADS) {
        const int row = idx / (HC / 8), c = (idx % (HC / 8)) * 8;
        cp_async16(dst + row * W1_LD + c, src + static_cast<size_t>(row) * hidden + c, true);
      }
      if constexpr (WIDE) {  // and x[:, r ks1 : +ks1], zero-filled past T
        const int xv = ks1 / 8;
        for (int idx = tid; idx < TM * xv; idx += THREADS) {
          const int row = idx / xv, c = (idx % xv) * 8;
          const bool ok = m0 + row < T;
          cp_async16(dst + l.xs_off + row * l.x_ld + c,
                     ok ? x + static_cast<size_t>(m0 + row) * c_in + r * ks1 + c : x, ok);
        }
      }
    } else {  // W2[chunk HC + (r - n_k1) KS : +KS, n0 : n0 + n_cols]
      const bf16* src = w2 + static_cast<size_t>(chunk * HC + (r - n_k1) * KS) * c_out + n0;
      const int cv = n_cols / 8;
      for (int idx = tid; idx < KS * cv; idx += THREADS) {
        const int row = idx / cv, c = (idx % cv) * 8;
        cp_async16(dst + row * l.w2_ld + c, src + static_cast<size_t>(row) * c_out + c, true);
      }
    }
  };

  Acc acc[2][MAX_NF];  // rows i * 16, columns (warp + 8 j) * 16 of the output tile
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MAX_NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  Acc pre[2];  // this warp's [16, 32] of the chunk's pre-activation
  const int pr = (warp >> 2) * 16;
  const int pc = (warp & 3) * 32;

  // the x tile and slices 0 and 1 in flight; slice s + 2 loads while s multiplies
  load_slice(0);
  cp_async_commit();
  if (n_slices > 1) load_slice(1);
  cp_async_commit();
  for (int s = 0; s < n_slices; ++s) {
    if (s + 2 < n_slices) load_slice(s + 2);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const bf16* st = ring + (s % STAGES) * l.stage_elems;
    const int chunk = s / per_chunk, r = s % per_chunk;
    if (r < n_k1) {  // fc1: pre += x[:, r ks1 : +ks1] @ W1 slice
      if (r == 0) {
        wmma::fill_fragment(pre[0], 0.0f);
        wmma::fill_fragment(pre[1], 0.0f);
      }
      // the A operand: the x tile at column r ks1, or (WIDE) the stage's x slice
      const bf16* xa = WIDE ? st + l.xs_off + pr * l.x_ld : xs + pr * l.x_ld + r * ks1;
#pragma unroll 4
      for (int kk = 0; kk < ks1; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, xa + kk, l.x_ld);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB fb;
          wmma::load_matrix_sync(fb, st + kk * W1_LD + pc + j * 16, W1_LD);
          wmma::mma_sync(pre[j], fa, fb, pre[j]);
        }
      }
      if (r == n_k1 - 1) {
        // the chunk's activation: bf16(gelu(bf16(pre + b1))), into shared memory
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(ps + pr * P_LD + pc + j * 16, pre[j], P_LD, wmma::mem_row_major);
        __syncthreads();
        for (int idx = tid; idx < TM * (HC / 8); idx += THREADS) {
          const int row = idx / (HC / 8), c = (idx % (HC / 8)) * 8;
          const float* pv = ps + row * P_LD + c;
          const float* bv = b1 + chunk * HC + c;
          __align__(16) bf16 o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(gelu(round_bf16(pv[e] + bv[e])));
          *reinterpret_cast<uint4*>(as + row * A_LD + c) = *reinterpret_cast<const uint4*>(o);
        }
        // the barrier that ends this iteration orders these stores before fc2 reads them
      }
    } else {  // fc2: acc += a[:, k0 : k0 + KS] @ W2 slice
      const int k0 = (r - n_k1) * KS;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        FragA fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], as + i * 16 * A_LD + k0 + kk, A_LD);
#pragma unroll
        for (int j = 0; j < MAX_NF; ++j) {
          const int f = warp + 8 * j;
          if (f < f_total) {
            FragB fb;
            wmma::load_matrix_sync(fb, st + kk * l.w2_ld + f * 16, l.w2_ld);
#pragma unroll
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // out = bf16(acc) + bf16(b2): the product rounds, then the bias adds in bf16
  // (an fp32 add of the two bf16 values, rounded once)
  float* cs = ps + warp * 256;
  const int rr = lane >> 1;
  const int c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < MAX_NF; ++j) {
      const int f = warp + 8 * j;
      if (f < f_total) {
        wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int grow = m0 + i * 16 + rr;
        const int gcol = n0 + f * 16 + c0;
        if (grow < T) {
          __align__(16) bf16 o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] = __float2bfloat16(round_bf16(cs[rr * 16 + c0 + e]) + round_bf16(b2[gcol + e]));
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(grow) * c_out + gcol) =
              *reinterpret_cast<const uint4*>(o);
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace k5

// ---------------------------------------------------------------------------
// K6: the MLP backward's recompute kernel
// ---------------------------------------------------------------------------

namespace k6 {

constexpr int max3(int a, int b, int c) { return a > b ? (a > c ? a : c) : (b > c ? b : c); }

// the operand ring of either product, and the epilogue's 8 KB scratch
constexpr int RING_BYTES =
    max3(Tiles<false, false>::BYTES, Tiles<false, true>::BYTES, THREADS / 32 * 256 * 4);
constexpr int PRE_LD = BN + 8;  // the tile's bf16 pre-activation, [BM][PRE_LD]
constexpr int SMEM_BYTES = RING_BYTES + BM * PRE_LD * static_cast<int>(sizeof(bf16));

// after x @ W1: a = bf16(gelu(pre)) to memory; pre = bf16(acc + b1) kept in
// shared memory (exactly, since it is rounded to bf16 anyway)
struct PreEpilogue {
  const float* bias;
  bf16* a;
  bf16* pre_s;
  int N, m0, n0;
  __device__ void operator()(int row, int col, const float* v) const {
    __align__(16) bf16 p[8];
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float z = round_bf16(v[e] + bias[col + e]);
      p[e] = __float2bfloat16(z);
      o[e] = __float2bfloat16(gelu(z));
    }
    *reinterpret_cast<uint4*>(a + static_cast<size_t>(row) * N + col) =
        *reinterpret_cast<const uint4*>(o);
    *reinterpret_cast<uint4*>(pre_s + (row - m0) * PRE_LD + (col - n0)) =
        *reinterpret_cast<const uint4*>(p);
  }
};

// after g @ W2^T: dpre = bf16(da * gelu'(pre)), da in fp32
struct DpreEpilogue {
  const bf16* pre_s;
  bf16* dpre;
  int N, m0, n0;
  __device__ void operator()(int row, int col, const float* v) const {
    __align__(16) bf16 p[8];
    *reinterpret_cast<uint4*>(p) =
        *reinterpret_cast<const uint4*>(pre_s + (row - m0) * PRE_LD + (col - n0));
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(v[e] * gelu_grad(__bfloat162float(p[e])));
    *reinterpret_cast<uint4*>(dpre + static_cast<size_t>(row) * N + col) =
        *reinterpret_cast<const uint4*>(o);
  }
};

__global__ void __launch_bounds__(THREADS)
    mlp_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const bf16* __restrict__ g, bf16* __restrict__ a, bf16* __restrict__ dpre, int T,
                   int c_in, int hidden, int c_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* pre_s = reinterpret_cast<bf16*>(smem + RING_BYTES);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  Acc acc[2][4];
  mainloop<false, false>(x, c_in, w1, hidden, T, hidden, 0, c_in, m0, n0, smem, acc);
  epilogue(acc, reinterpret_cast<float*>(smem), T, hidden, m0, n0,
           PreEpilogue{b1, a, pre_s, hidden, m0, n0});
  // the epilogue's scratch is the ring the second product loads into; every
  // lane reads back only the pre values it wrote itself
  __syncthreads();
  // da = g @ W2^T: W2 [hidden, C_out] is the transposed B operand [N, K]
  mainloop<false, true>(g, c_out, w2, c_out, T, hidden, 0, c_out, m0, n0, smem, acc);
  epilogue(acc, reinterpret_cast<float*>(smem), T, hidden, m0, n0,
           DpreEpilogue{pre_s, dpre, hidden, m0, n0});
}

}  // namespace k6

bool valid_shape(int T, int c_in, int hidden, int c_out) {
  return T >= 1 && c_in >= BK && c_in % BK == 0 && hidden >= k5::HC && hidden % k5::HC == 0 &&
         c_out >= BK && c_out % BK == 0;
}

constexpr size_t kMaxSmem = 232448;

}  // namespace

extern "C" int swin_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, int T, int c_in, int hidden, int c_out,
                            void* stream) {
  if (!valid_shape(T, c_in, hidden, c_out)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const k5::Layout narrow = k5::layout(c_in, c_out, false);
  const int m_blocks = (T + k5::TM - 1) / k5::TM;
  if (c_out <= k5::MAX_COUT && narrow.bytes <= kMaxSmem) {
    cudaError_t err = cudaFuncSetAttribute(k5::mlp_fwd_kernel<false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(narrow.bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    k5::mlp_fwd_kernel<false><<<m_blocks, THREADS, narrow.bytes, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out), T,
        c_in, hidden, c_out);
    return static_cast<int>(cudaGetLastError());
  }
  const k5::Layout wide = k5::layout(c_in, c_out, true);
  if (wide.bytes > kMaxSmem || m_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(k5::mlp_fwd_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(wide.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c_out + k5::MAX_COUT - 1) / k5::MAX_COUT, m_blocks);
  k5::mlp_fwd_kernel<true><<<grid, THREADS, wide.bytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out), T,
      c_in, hidden, c_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int swin_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* g, void* a, void* dpre, int T, int c_in, int hidden,
                            int c_out, void* stream) {
  if (!valid_shape(T, c_in, hidden, c_out)) return static_cast<int>(cudaErrorInvalidValue);
  const int m_tiles = (T + BM - 1) / BM;
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(k6::mlp_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         k6::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(hidden / BN, m_tiles);
  k6::mlp_bwd_kernel<<<grid, THREADS, k6::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(g), static_cast<bf16*>(a),
      static_cast<bf16*>(dpre), T, c_in, hidden, c_out);
  return static_cast<int>(cudaGetLastError());
}
