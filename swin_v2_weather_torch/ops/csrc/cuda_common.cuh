// Helpers shared by every kernel of the port: the bf16 type and the cp.async
// (global -> shared, 16 bytes, zero-fill) primitives.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace swin_cuda {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills the destination if !valid
// (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace swin_cuda
