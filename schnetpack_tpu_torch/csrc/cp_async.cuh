// 4-byte asynchronous copies global -> shared (cp.async), in commit
// groups: the message kernels (colblock_message.cuh) and the cfconv
// kernels (schnet_columns.cu) stage a chunk's indices and channels with
// them while the previous chunk runs.  Internal linkage; each source includes
// it once.
#pragma once

#include <cuda_runtime.h>

namespace {

// 4-byte asynchronous copies global -> shared, in commit groups
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
