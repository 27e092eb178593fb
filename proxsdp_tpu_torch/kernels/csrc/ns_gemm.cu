// K5: a dense GEMM with an axpby epilogue, out = alpha * C + beta * (A @ B).
//
// Replaces the matrix products of proxsdp_tpu/ops/cones.py:polar_psd
// (62-109) and polar_reseed (265-314): every Newton-Schulz step
//   A = Y @ Y                      (alpha = 0, beta = 1)
//   B = QB * A + QC * (A @ A)      (C = A)
//   Y = QA * Y + Y @ B             (C = Y, beta = 1)
//   Y = 1.5 * Y - 0.5 * (Y @ A)    (the cubic polish)
// the projection P = 0.5 * X + 0.5 * (S @ X), and the sign projectors
// applied to the warm basis, 0.5 * W +- 0.5 * (S @ W).  A is (M, K), B is
// (K, N), C and out are (M, N); every row stride is an argument, so a
// column slice of the warm basis is read in place.
//
// Rounding: the sum over K runs in index order with an explicit fused
// multiply-add per term (the library is built with -fmad=false, so the
// epilogue below is never contracted): alpha * C and beta * acc are each
// rounded, then added, exactly as the JAX expression rounds them.  f32
// runs on the CUDA cores in IEEE single precision -- the tensor cores have
// no IEEE f32 mode (TF32 keeps 10 mantissa bits).
//
// Bound on the H100: operations.  At side 250 one product is 31.25 MFLOP,
// 0.47 us at the 67 TFLOP/s f32 CUDA-core peak; a polar projection is 30
// products.  Design (simple first): 32 x 32 output tiles, one 256-thread
// block each, 2 x 2 outputs per thread, A and B staged through shared
// memory 32 deep along K.  At side 250 that is 64 blocks on 132 SMs, so
// the card is under-filled; wgmma does not apply (no IEEE f32), and a
// persistent split-K or register-blocked version is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kDim = 16;  // blockDim = (kDim, kDim); 2 x 2 outputs each

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
__global__ void gemm_axpby_kernel(const T* __restrict__ A, int64_t lda,
                                  const T* __restrict__ B, int64_t ldb,
                                  const T* __restrict__ C, int64_t ldc,
                                  T* __restrict__ out, int64_t M, int64_t N,
                                  int64_t K, T alpha, T beta) {
  __shared__ T As[kTile][kTile + 1];  // As[row][k]
  __shared__ T Bs[kTile][kTile + 1];  // Bs[k][col]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kDim + tx;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTile;
  T acc[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
  for (int64_t k0 = 0; k0 < K; k0 += kTile) {
    for (int e = tid; e < kTile * kTile; e += kDim * kDim) {
      const int i = e / kTile, j = e % kTile;  // j fastest: coalesced rows
      const int64_t ar = r0 + i, ak = k0 + j;
      As[i][j] = (ar < M && ak < K) ? A[ar * lda + ak] : T(0);
      const int64_t bk = k0 + i, bc = c0 + j;
      Bs[i][j] = (bk < K && bc < N) ? B[bk * ldb + bc] : T(0);
    }
    __syncthreads();
    const int kn = static_cast<int>(K - k0 < kTile ? K - k0 : kTile);
    for (int kk = 0; kk < kn; ++kk) {
      const T a0 = As[ty][kk], a1 = As[ty + kDim][kk];
      const T b0 = Bs[kk][tx], b1 = Bs[kk][tx + kDim];
      acc[0][0] = fma_rn(a0, b0, acc[0][0]);
      acc[0][1] = fma_rn(a0, b1, acc[0][1]);
      acc[1][0] = fma_rn(a1, b0, acc[1][0]);
      acc[1][1] = fma_rn(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int64_t r = r0 + ty + u * kDim, c = c0 + tx + v * kDim;
      if (r < M && c < N) {
        const T prod = beta * acc[u][v];
        out[r * N + c] = C ? alpha * C[r * ldc + c] + prod : prod;
      }
    }
  }
}

template <typename T>
int launch(const void* A, int64_t lda, const void* B, int64_t ldb,
           const void* C, int64_t ldc, void* out, int64_t M, int64_t N,
           int64_t K, double alpha, double beta, void* stream) {
  const dim3 grid(static_cast<unsigned>((N + kTile - 1) / kTile),
                  static_cast<unsigned>((M + kTile - 1) / kTile));
  gemm_axpby_kernel<T><<<grid, dim3(kDim, kDim), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), lda, static_cast<const T*>(B), ldb,
      static_cast<const T*>(C), ldc, static_cast<T*>(out), M, N, K,
      static_cast<T>(alpha), static_cast<T>(beta));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C may be null (then out = beta * (A @ B)); out is contiguous (M, N).
extern "C" int proxsdp_ns_gemm_f32(const void* A, int64_t lda, const void* B,
                                   int64_t ldb, const void* C, int64_t ldc,
                                   void* out, int64_t M, int64_t N, int64_t K,
                                   double alpha, double beta, void* stream) {
  return launch<float>(A, lda, B, ldb, C, ldc, out, M, N, K, alpha, beta,
                       stream);
}

extern "C" int proxsdp_ns_gemm_f64(const void* A, int64_t lda, const void* B,
                                   int64_t ldb, const void* C, int64_t ldc,
                                   void* out, int64_t M, int64_t N, int64_t K,
                                   double alpha, double beta, void* stream) {
  return launch<double>(A, lda, B, ldb, C, ldc, out, M, N, K, alpha, beta,
                        stream);
}
