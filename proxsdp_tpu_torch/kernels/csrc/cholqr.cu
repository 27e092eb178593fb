// K7: one CholeskyQR pass on a tall-skinny Y (side, k).
//
// Replaces one call of `one` inside proxsdp_tpu/ops/cones.py:_cholqr2
// (243-263):
//   G = Y^T Y
//   L = chol(G + eps * (tr(G) / k + 1) * I)      (lower, G = L L^T)
//   Q = Y L^{-T}                                  (solve_triangular)
// with eps the jitter of the compute type (1e-6 in f32, 1e-12 in f64).
// _cholqr2 is two passes.  A non-positive (or NaN) pivot makes the whole
// factor NaN, as jnp.linalg.cholesky does, so Q comes out NaN and the
// callers' finite guards fire.
//
// Bound on the H100: at side 250, k = 24 the pass moves 48 KB and does
// ~0.3 MFLOP -- nothing; it is latency-bound (k sequential pivot steps).
// Design: a single CTA.  G lives in dynamic shared memory (k*k words; the
// wrapper refuses what does not fit) and is factored in place by a
// right-looking Cholesky, one pivot column per step with the trailing
// update spread over the block.  G's entries are independent sums over the
// rows of Y (read from L1/L2, 24 KB at k = 24) in row order with fused
// multiply-adds, so G is exactly symmetric; each thread then solves its
// own rows of Q by forward substitution.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cholqr_kernel(const T* __restrict__ y, T* __restrict__ q, int64_t side,
              int k, T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* G = reinterpret_cast<T*>(smem_raw);  // k x k, row-major; L in place
  __shared__ int s_bad;
  const int t = threadIdx.x;
  for (int e = t; e < k * k; e += kThreads) {
    const int a = e / k, b = e % k;
    T acc = T(0);
    for (int64_t r = 0; r < side; ++r) acc = fma_rn(y[r * k + a], y[r * k + b], acc);
    G[e] = acc;
  }
  __syncthreads();
  if (t == 0) {
    T tr = T(0);
    for (int j = 0; j < k; ++j) tr += G[j * k + j];
    const T jit = eps * (tr / static_cast<T>(k) + T(1));
    for (int j = 0; j < k; ++j) G[j * k + j] += jit;
    s_bad = 0;
  }
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    const T d = G[j * k + j];
    if (!(d > T(0))) {  // NaN too
      if (t == 0) s_bad = 1;
      break;  // uniform: every thread read the same d
    }
    const T ljj = sqrt(d);
    __syncthreads();  // all threads have read G[j][j]
    if (t == 0) G[j * k + j] = ljj;
    for (int i = j + 1 + t; i < k; i += kThreads) G[i * k + j] /= ljj;
    __syncthreads();
    // trailing update of the lower triangle: G[i][c] -= L[i][j] * L[c][j]
    const int m = k - j - 1;
    for (int e = t; e < m * m; e += kThreads) {
      const int i = j + 1 + e / m, c = j + 1 + e % m;
      if (c <= i) G[i * k + c] = fma_rn(-G[i * k + j], G[c * k + j], G[i * k + c]);
    }
    __syncthreads();
  }
  __syncthreads();
  const bool bad = s_bad != 0;
  for (int64_t r = t; r < side; r += kThreads) {
    for (int j = 0; j < k; ++j) {
      if (bad) {
        q[r * k + j] = static_cast<T>(NAN);
        continue;
      }
      T acc = y[r * k + j];
      for (int p = 0; p < j; ++p) acc = fma_rn(-G[j * k + p], q[r * k + p], acc);
      q[r * k + j] = acc / G[j * k + j];
    }
  }
}

template <typename T>
int launch(const void* y, void* q, int64_t side, int64_t k, double eps,
           void* stream) {
  const size_t smem = static_cast<size_t>(k) * k * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      cholqr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cholqr_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<T*>(q), side,
      static_cast<int>(k), static_cast<T>(eps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y and q are contiguous (side, k); k * k * sizeof(T) bytes of shared
// memory must fit the block (the wrapper checks).
extern "C" int proxsdp_cholqr_f32(const void* y, void* q, int64_t side,
                                  int64_t k, double eps, void* stream) {
  return launch<float>(y, q, side, k, eps, stream);
}

extern "C" int proxsdp_cholqr_f64(const void* y, void* q, int64_t side,
                                  int64_t k, double eps, void* stream) {
  return launch<double>(y, q, side, k, eps, stream);
}
