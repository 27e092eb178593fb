// K9: batched dense PSD projection of small symmetric matrices by a cyclic
// parallel-order Jacobi eigensolver.
//
// Replaces: proxsdp_tpu/ops/cones.py:622-675 (psd_projection_small_batch)
// and the vmapped full_path of cones.py:204-211 that the batch driver
// (proxsdp_tpu/parallel/batch.py:141) runs for every instance: for each of
// B symmetric s x s matrices X_b (s <= 118 in f64, 168 in f32), with X_b = V diag(w) V^T and w
// ascending,
//   Xp_b   = V diag(max(w, 0)) V^T     (written symmetric: Xp_ij = Xp_ji)
//   w_b    = w
//   rank_b = #{k : w_k > tol_psd}
//   warm_b = V[:, s - 1], the eigenvector of the largest eigenvalue.
// A matrix with a non-finite entry gives NaN in Xp_b, w_b and warm_b and
// rank 0 for that instance alone (jnp.linalg.eigh's NaN, which the
// solver's finite guards read; torch.linalg.eigh would raise).
//
// Bound on the H100: the function moves X in and Xp, w, rank and warm out
// (~4.5 MB in f64 at B = 1024, s = 16, ~1.3 us at 3.35 TB/s) and needs
// ~10.5 s^3 flops per matrix (an eigendecomposition ~9 s^3, the
// reconstruction ~1.5 s^3), so bytes set its bound up to s ~ 30 in f64 and
// s ~ 16 in f32.  Jacobi spends ~9 s^3 flops on every sweep, and its real
// cost is the chain of s - 1 dependent rotation rounds per sweep, each
// ending in a barrier.  Design: one CTA per instance (no tensor cores:
// IEEE arithmetic in the instance's own type), the matrix A and the
// accumulated rotations V in dynamic shared memory, 2 n^2 words for the
// side padded to even n: the largest side whose block fits the card's
// 227 KB a block is 118 in f64 (218 KB) and 168 in f32 (221 KB), checked
// by the wrapper (kernels.EIGH_MAX_SIDE).  The Jacobi sweeps are
// jacobi.cuh's (shared with K12).  The eigenvalues are then ranked in
// shared memory (ties by index) and the reconstruction sums over them in
// ascending order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "jacobi.cuh"

namespace {

using proxsdp::jacobi_eigh;
using proxsdp::jacobi_rank;

constexpr int kThreads = 128;
// 227 KB of dynamic shared memory a block (H100), less the static red[]
constexpr size_t kMaxSmem = 232448 - kThreads * sizeof(double);

template <typename T>
__global__ void __launch_bounds__(kThreads)
    batched_psd_eigh_kernel(const T* __restrict__ X, T* __restrict__ Xp,
                            T* __restrict__ w_out,
                            int32_t* __restrict__ rank_out,
                            T* __restrict__ warm_out, int s,
                            double tol_psd) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red[kThreads];
  const int n = s + (s & 1);  // padded to even
  const int half = n / 2;
  T* A = reinterpret_cast<T*>(smem);  // n * n, row-major
  T* V = A + n * n;                   // n * n, columns = eigenvectors
  T* cs = V + n * n;                  // half cosines of the round
  T* sn = cs + half;                  // half sines
  T* wsort = sn + half;               // s eigenvalues, ascending
  int* perm = reinterpret_cast<int*>(wsort + n);  // sorted slot -> index

  const int64_t b = blockIdx.x;
  const T* Xb = X + b * s * s;
  const int t = threadIdx.x;

  // ---- load, identity V, finiteness
  int bad = 0;
  for (int e = t; e < n * n; e += kThreads) {
    const int i = e / n, j = e % n;
    T v = T(0);
    if (i < s && j < s) {
      v = Xb[i * s + j];
      if (!isfinite(v)) bad = 1;
    }
    A[e] = v;
    V[e] = i == j ? T(1) : T(0);
  }
  if (__syncthreads_or(bad)) {
    const T nan = static_cast<T>(NAN);
    for (int e = t; e < s * s; e += kThreads) Xp[b * s * s + e] = nan;
    for (int i = t; i < s; i += kThreads) {
      w_out[b * s + i] = nan;
      warm_out[b * s + i] = nan;
    }
    if (t == 0) rank_out[b] = 0;
    return;
  }

  // ---- the Jacobi sweeps, then the eigenvalues ranked ascending
  jacobi_eigh<kThreads, T>(A, V, n, cs, sn, red);
  jacobi_rank<kThreads, T>(A, n, s, wsort, perm);

  for (int k = t; k < s; k += kThreads) {
    w_out[b * s + k] = wsort[k];
    warm_out[b * s + k] = V[k * n + perm[s - 1]];
  }
  if (t == 0) {
    int rank = 0;
    for (int k = 0; k < s; ++k) rank += wsort[k] > static_cast<T>(tol_psd);
    rank_out[b] = rank;
  }
  // Xp_ij = sum_k (V_ik max(w_k, 0)) V_jk over the upper triangle, mirrored
  T* Xpb = Xp + b * s * s;
  for (int e = t; e < s * s; e += kThreads) {
    const int i = e / s, j = e % s;
    if (i > j) continue;
    T acc = T(0);
    for (int k = 0; k < s; ++k) {
      const int col = perm[k];
      const T pos = wsort[k] > T(0) ? wsort[k] : T(0);
      acc += (V[i * n + col] * pos) * V[j * n + col];
    }
    Xpb[i * s + j] = acc;
    Xpb[j * s + i] = acc;
  }
}

template <typename T>
size_t smem_bytes(int s) {
  const int n = s + (s & 1);
  return (2 * static_cast<size_t>(n) * n + n + n) * sizeof(T) +
         n * sizeof(int);
}

template <typename T>
int launch(const void* X, void* Xp, void* w, void* rank, void* warm,
           int64_t B, int64_t s, double tol_psd, void* stream) {
  if (s < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes<T>(static_cast<int>(s));
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(
      batched_psd_eigh_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  batched_psd_eigh_kernel<T><<<static_cast<unsigned>(B), kThreads, bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<T*>(Xp), static_cast<T*>(w),
      static_cast<int32_t*>(rank), static_cast<T*>(warm),
      static_cast<int>(s), tol_psd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X, Xp: (B, s, s) row-major; w, warm: (B, s); rank: (B,) int32; s <= 118
// (f64) or 168 (f32): smem_bytes within kMaxSmem.
extern "C" int proxsdp_batched_psd_eigh_f64(const void* X, void* Xp, void* w,
                                            void* rank, void* warm, int64_t B,
                                            int64_t s, double tol_psd,
                                            void* stream) {
  return launch<double>(X, Xp, w, rank, warm, B, s, tol_psd, stream);
}

extern "C" int proxsdp_batched_psd_eigh_f32(const void* X, void* Xp, void* w,
                                            void* rank, void* warm, int64_t B,
                                            int64_t s, double tol_psd,
                                            void* stream) {
  return launch<float>(X, Xp, w, rank, warm, B, s, tol_psd, stream);
}
