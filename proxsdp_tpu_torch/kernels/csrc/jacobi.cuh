// The cyclic parallel-order Jacobi eigensolver of one small symmetric
// matrix held by one CTA in shared memory: K9 (batched_eigh.cu) runs it on
// each instance's side x side block, K12 (batched_subspace.cu) on each
// instance's k x k Rayleigh-Ritz matrix.
//
// A is n x n (n even; an odd side is padded with a zero row and column
// that never rotates), row-major; V starts as the identity and
// accumulates the rotations, so on return A's diagonal holds the
// eigenvalues and V's columns the eigenvectors.  Each round applies n/2
// disjoint rotations at once (round-robin pairing): the angles from the
// current A (Golub & Van Loan sym.schur2), then A <- A J and V <- V J
// column-wise, then A <- J^T A row-wise, which also stores the annihilated
// pair as 0.  Sweeps stop when the off-diagonal Frobenius norm is at most
// eps * ||A||_F (norms summed in f64 in a fixed order, so a run repeats
// bit for bit), or at a fixed sweep cap.  Emulated in NumPy on random and
// rank-deficient matrices, the f64 test holds within 15 sweeps up to
// side 168 (9 on full-rank inputs), f32 within 10.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace proxsdp {
namespace {

template <typename T>
struct JacobiLimits;
template <>
struct JacobiLimits<double> {
  static constexpr double eps = 2.220446049250313e-16;
  static constexpr int max_sweeps = 20;
};
template <>
struct JacobiLimits<float> {
  static constexpr double eps = 1.1920928955078125e-07;
  static constexpr int max_sweeps = 15;
};

// round r (0 <= r < n - 1) of a round-robin tournament on n (even) indices:
// pair k (0 <= k < n / 2) is (p, q) with p < q; every pair meets once in
// n - 1 rounds, and the pairs of one round are disjoint
__device__ __forceinline__ void round_pair(int r, int k, int n, int& p,
                                           int& q) {
  const int m = n - 1;
  int a, b;
  if (k == 0) {
    a = m;
    b = r;
  } else {
    a = (r + k) % m;
    b = (r - k + m) % m;
  }
  p = a < b ? a : b;
  q = a < b ? b : a;
}

// fixed-order tree sum over the block; red holds kThreads doubles
template <int kThreads>
__device__ double block_sum(double v, double* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int st = kThreads / 2; st > 0; st >>= 1) {
    if (threadIdx.x < st) red[threadIdx.x] += red[threadIdx.x + st];
    __syncthreads();
  }
  const double out = red[0];
  __syncthreads();
  return out;
}

template <typename T>
__device__ __forceinline__ T sqrt_t(T v);
template <>
__device__ __forceinline__ double sqrt_t<double>(double v) {
  return sqrt(v);
}
template <>
__device__ __forceinline__ float sqrt_t<float>(float v) {
  return sqrtf(v);
}

// Diagonalise A in place (see above); cs and sn hold n / 2 values each.
// Every thread of the block calls it; it ends on a barrier.
template <int kThreads, typename T>
__device__ void jacobi_eigh(T* A, T* V, int n, T* cs, T* sn, double* red) {
  const int t = threadIdx.x;
  const int half = n / 2;
  double part = 0.0;
  for (int e = t; e < n * n; e += kThreads) {
    const double v = static_cast<double>(A[e]);
    part += v * v;
  }
  // ||A||_F^2 is invariant under the rotations
  const double fro2 = block_sum<kThreads>(part, red);
  const double eps = JacobiLimits<T>::eps;
  const double thresh = eps * eps * fro2;

  for (int sweep = 0; sweep < JacobiLimits<T>::max_sweeps; ++sweep) {
    double off = 0.0;
    for (int e = t; e < n * n; e += kThreads) {
      if (e / n != e % n) {
        const double v = static_cast<double>(A[e]);
        off += v * v;
      }
    }
    if (block_sum<kThreads>(off, red) <= thresh) break;
    for (int r = 0; r < n - 1; ++r) {
      // angles of the round's n/2 rotations
      for (int k = t; k < half; k += kThreads) {
        int p, q;
        round_pair(r, k, n, p, q);
        const T apq = A[p * n + q];
        T c = T(1), sv = T(0);
        if (apq != T(0)) {
          const T tau = (A[q * n + q] - A[p * n + p]) / (T(2) * apq);
          const T abs_tau = tau >= T(0) ? tau : -tau;
          const T tt = (tau >= T(0) ? T(1) : T(-1)) /
                       (abs_tau + sqrt_t<T>(T(1) + tau * tau));
          c = T(1) / sqrt_t<T>(T(1) + tt * tt);
          sv = tt * c;
        }
        cs[k] = c;
        sn[k] = sv;
      }
      __syncthreads();
      // A <- A J and V <- V J: columns p and q of every row
      for (int e = t; e < n * half; e += kThreads) {
        const int i = e / half, k = e % half;
        int p, q;
        round_pair(r, k, n, p, q);
        const T c = cs[k], sv = sn[k];
        const T aip = A[i * n + p], aiq = A[i * n + q];
        A[i * n + p] = c * aip - sv * aiq;
        A[i * n + q] = sv * aip + c * aiq;
        const T vip = V[i * n + p], viq = V[i * n + q];
        V[i * n + p] = c * vip - sv * viq;
        V[i * n + q] = sv * vip + c * viq;
      }
      __syncthreads();
      // A <- J^T A: rows p and q of every column; the pair is annihilated
      for (int e = t; e < n * half; e += kThreads) {
        const int j = e / half, k = e % half;
        int p, q;
        round_pair(r, k, n, p, q);
        const T c = cs[k], sv = sn[k];
        const T apj = A[p * n + j], aqj = A[q * n + j];
        A[p * n + j] = j == q ? T(0) : c * apj - sv * aqj;
        A[q * n + j] = j == p ? T(0) : sv * apj + c * aqj;
      }
      __syncthreads();
    }
  }
}

// Rank the s leading diagonal entries of the diagonalised A ascending
// (ties by index): wsort[pos] = the eigenvalue, perm[pos] = its column of
// V.  Ends on a barrier.
template <int kThreads, typename T>
__device__ void jacobi_rank(const T* A, int n, int s, T* wsort, int* perm) {
  for (int i = threadIdx.x; i < s; i += kThreads) {
    const T wi = A[i * n + i];
    int pos = 0;
    for (int j = 0; j < s; ++j) {
      const T wj = A[j * n + j];
      pos += (wj < wi || (wj == wi && j < i)) ? 1 : 0;
    }
    wsort[pos] = wi;
    perm[pos] = i;
  }
  __syncthreads();
}

}  // namespace
}  // namespace proxsdp
