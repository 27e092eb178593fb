// K9: batched dense PSD projection of small symmetric matrices by a cyclic
// parallel-order Jacobi eigensolver.
//
// Replaces: proxsdp_tpu/ops/cones.py:622-675 (psd_projection_small_batch)
// and the vmapped full_path of cones.py:204-211 that the batch driver
// (proxsdp_tpu/parallel/batch.py:141) runs for every instance: for each of
// B symmetric s x s matrices X_b (s <= 64), with X_b = V diag(w) V^T and w
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
// accumulated rotations V in shared memory (2 * 64 * 64 * 8 = 64 KB at
// most, dynamic shared memory).  Each round applies s/2 disjoint rotations
// at once (round-robin pairing; an odd side is padded with a zero row and
// column that never rotates): the angles from the current A, then A <- A J
// and V <- V J column-wise, then A <- J^T A row-wise, which also stores the
// annihilated pair as 0.  Sweeps stop when the off-diagonal Frobenius norm
// is at most eps * ||A||_F (norms summed in f64), or at a fixed sweep cap.
// The eigenvalues are then ranked in shared memory (ties by index) and the
// reconstruction sums over them in ascending order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSide = 64;

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

  // ---- ||A||_F^2 (invariant under the rotations), in f64
  double part = 0.0;
  for (int e = t; e < n * n; e += kThreads) {
    const double v = static_cast<double>(A[e]);
    part += v * v;
  }
  const double fro2 = block_sum(part, red);
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
    if (block_sum(off, red) <= thresh) break;
    for (int r = 0; r < n - 1; ++r) {
      // angles of the round's s/2 rotations (Golub & Van Loan sym.schur2)
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

  // ---- rank the eigenvalues ascending (ties by index)
  for (int i = t; i < s; i += kThreads) {
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
  if (s < 1 || s > kMaxSide) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const size_t bytes = smem_bytes<T>(static_cast<int>(s));
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

// X, Xp: (B, s, s) row-major; w, warm: (B, s); rank: (B,) int32; s <= 64.
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
