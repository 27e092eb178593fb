// Deterministic block reductions shared by the port's reduction kernels.
//
// Every reduction here is two-pass: pass 1 writes one partial per block
// (a fixed-order shared-memory tree inside the block), pass 2 is a single
// block that folds the partials in a fixed order.  The grid of pass 1 is
// a function of the problem size only, so the summation order -- and the
// result, bit for bit -- is the same from run to run.  Atomics would make
// it depend on block scheduling and break iteration parity with the JAX
// reference (a linesearch accept test sits on these sums).
//
// Max-type slots propagate NaN like jnp.max / torch.amax (fmax would
// drop it and hide a diverged iterate from the control logic).
//
// Everything lives in an unnamed namespace: each .cu file gets its own
// copy of the template kernels, so the shared library never registers
// one kernel symbol from two translation units.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace proxsdp {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

// pass-1 grid: one thread per element up to kMaxBlocks blocks, then a
// grid-stride loop
inline int reduce_grid(int64_t n) {
  int64_t g = (n + kThreads - 1) / kThreads;
  if (g < 1) g = 1;
  if (g > kMaxBlocks) g = kMaxBlocks;
  return static_cast<int>(g);
}

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (isnan(a) || a > b) ? a : b;
}

template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (isnan(a) || a < b) ? a : b;
}

// Reduce K per-thread values over the block.  Bit k of MaxMask selects max
// (else sum) for slot k.  The result is valid in thread 0 only.  Requires
// blockDim.x == kThreads.
template <typename T, int K, unsigned MaxMask>
__device__ void block_reduce(T (&acc)[K]) {
  __shared__ T sh[K][kThreads];
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) sh[k][t] = acc[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T a = sh[k][t], b = sh[k][t + s];
        sh[k][t] = ((MaxMask >> k) & 1u) ? nan_max(a, b) : a + b;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = sh[k][0];
}

// Pass 2 in one block of kThreads threads: fold nparts partials (laid
// out part-major, K per part) into acc, valid in thread 0.  Every thread
// of the block must call it.  K19 (control.cu) folds K3's and K20a's
// partials with it, so its sums are finalize_kernel's bit for bit.
template <typename T, int K, unsigned MaxMask>
__device__ void fold_partials(const T* __restrict__ partials, int64_t nparts,
                              T (&acc)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    acc[k] = ((MaxMask >> k) & 1u) ? static_cast<T>(-INFINITY) : T(0);
  for (int64_t i = threadIdx.x; i < nparts; i += kThreads) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T v = partials[i * K + k];
      acc[k] = ((MaxMask >> k) & 1u) ? nan_max(acc[k], v) : acc[k] + v;
    }
  }
  block_reduce<T, K, MaxMask>(acc);
}

// Pass 2: fold nparts partials into out[0..K).  Launched with one block
// of kThreads threads.
template <typename T, int K, unsigned MaxMask>
__global__ void finalize_kernel(const T* __restrict__ partials, int nparts,
                                T* __restrict__ out) {
  T acc[K];
  fold_partials<T, K, MaxMask>(partials, nparts, acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = acc[k];
  }
}

}  // namespace
}  // namespace proxsdp
