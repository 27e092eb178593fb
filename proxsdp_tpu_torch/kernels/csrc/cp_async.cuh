// Asynchronous global -> shared copies (cp.async), shared by the tiled
// kernels that stage their operands through shared memory (K5, K7).
//
// Everything lives in an unnamed namespace, as in reduce.cuh: each .cu
// file gets its own copy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one element (4 or 8 bytes), zero-filled unless ``ok`` (then ``src`` is
// not read)
template <typename T>
__device__ __forceinline__ void cp_elem(T* dst, const T* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(static_cast<int>(sizeof(T))),
               "r"(ok ? static_cast<int>(sizeof(T)) : 0));
}

// 16 bytes, of which ``bytes`` are read (the rest zero-filled)
__device__ __forceinline__ void cp_16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// close this thread's group of copies issued since the last commit
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
