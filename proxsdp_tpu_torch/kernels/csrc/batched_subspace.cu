// K12: the batch driver's accept-always subspace step -- one Rayleigh-Ritz
// step on each instance's warm basis, the whole batch in one launch.
//
// Replaces: proxsdp_tpu/ops/cones.py:427-510 (_subspace_body with its
// subspace_accept_always branch 497-510, _cholqr2 243-263 and the
// packed-triangle pack/unpack 166-175), vmapped over the instances by
// proxsdp_tpu/parallel/batch.py:141.  For each instance b, with X the
// symmetric s x s matrix of the packed scaled triangle v_b (K10's
// scaling: off-diagonal entries stored as sqrt(2) X_ij) and V the warm
// s x k basis:
//   Q = cholqr2(X V)                 (two CholeskyQR passes, K7's jitter)
//   Z = X Q,  Bm = (Q^T Z + Z^T Q) / 2,  (theta, U) = eigh(Bm) ascending
//   W = Q U,  XW = Z U
//   in the mixed mode (f64 in and out, f32 basis): Q, Z, Bm, U and Q U in
//   f32; W = (Q U) cast to f64, XW = X W in f64 and theta_j the f64
//   Rayleigh quotient W_j^T XW_j / W_j^T W_j (cones.py:435-441)
//   rn_j  = ||XW_j - theta_j W_j||
//   stats = [max_{theta>0} rn / max(max|theta|, 1), min theta, #theta>0]
//   Xp    = W diag(max(theta, 0)) W^T, written as a packed scaled triangle
//   min_eig = min theta, rank = #theta > tol_psd, warm = W, columns reversed
//   NaN guard: if an entry of Xp is not finite, X goes out (packed again)
//   with the old basis and the flag set.
// Where X V is exactly 0 (a cold start's first projection: X = 0), Y = V:
// the JAX step would zero the basis for good there, and only XLA's
// rounding noise on that 0 keeps its run alive (ROADMAP C11).
// A non-finite Bm (a NaN basis, an infinite X) makes theta NaN, as
// jnp.linalg.eigh does: min_eig NaN, rank 0, stats [NaN, NaN, 0], flagged.
//
// Bound on the H100: per instance ~6 s^2 k + 14 s k^2 + 10 k^3 flops (the
// X products, the reconstruction, CholeskyQR twice, the rotations and
// Jacobi) against reading the packed block and the basis and writing
// both: at s = 40, k = 16, B = 256 that is ~87 MFLOP and ~6.5 MB, so bytes
// bound it (~2 us).  Its real cost is latency: k dependent pivot steps
// twice and ~10 Jacobi sweeps of k - 1 barrier-ended rounds.  Design: one
// CTA per instance, so the batch is one launch (the driver's cost is host
// launches, ~25 us each).  X is read from the packed triangle in global
// memory (L1/L2-resident: 40 KB at s = 100 in f64) with the index map
// computed in place (K10 folded in); the four s x k panels (Y/Q, Z, W,
// XW) and the k x k matrices live in dynamic shared memory.  The k x k
// eigh is jacobi.cuh's (K9's).  No tensor cores: IEEE arithmetic in the
// instance's own types, fused multiply-adds in fixed order, so a run
// repeats bit for bit.
//
// K12L (the "_large" entry points) is the same step on a second layout,
// for a working set above one block's 227 KB (f64 with k = 48 above side
// ~120, f32 with k = 32 above side ~440) or k above 64, up to 256 (the
// largest subspace bucket): the four s x k panels and theta go to a
// per-instance workspace in device memory (2.6 MB an instance at s = 500,
// k = 128 in f64: B = 16 of them stay in the 50 MB L2), the k x k
// matrices and Jacobi's scratch stay in shared memory where they fit (f32
// to k = 128, f64 to k = 112), else join the panels.  Every access goes through the same code, so the two layouts
// give the same bits.  One CTA per instance as in K12; at side 500 the
// X products (~2 s^2 k flops each, three of them) dominate, each thread
// reading X's row from L2 and a panel column from L1.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "jacobi.cuh"

namespace {

using proxsdp::jacobi_eigh;
using proxsdp::jacobi_rank;

constexpr int kThreads = 256;
// 227 KB of dynamic shared memory a block (H100), less the static red[]
// and the block's flags
constexpr size_t kMaxSmem = 232448 - kThreads * sizeof(double) - 64;

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (isnan(a) || a > b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (isnan(a) || a < b) ? a : b;
}

// X_il of the packed scaled triangle (column-major upper: (i, l), i <= l,
// at l (l + 1) / 2 + i), unscaled off the diagonal as K10 does
template <typename T>
__device__ __forceinline__ T x_at(const T* __restrict__ v, int i, int l,
                                  T inv_sqrt2) {
  const int a = i < l ? i : l, c = i < l ? l : i;
  const T x = v[c * (c + 1) / 2 + a];
  return i == l ? x : x * inv_sqrt2;
}

// out (s x k) = X P, X read from the packed triangle in type T and cast to
// C, P in shared memory; sums over l in order
template <typename T, typename C>
__device__ void x_times(const T* __restrict__ v, const C* P, C* out, int s,
                        int k, T inv_sqrt2) {
  for (int e = threadIdx.x; e < s * k; e += kThreads) {
    const int i = e / k, j = e % k;
    C acc = C(0);
    for (int l = 0; l < s; ++l)
      acc = fma_rn(static_cast<C>(x_at(v, i, l, inv_sqrt2)), P[l * k + j],
                   acc);
    out[e] = acc;
  }
  __syncthreads();
}

// One CholeskyQR pass in place on Y (s x k) with G a k x k scratch (K7's
// arithmetic): G = Y^T Y, L = chol(G + eps (tr G / k + 1) I), Y <- Y L^-T;
// NaN everywhere on a non-positive pivot
template <typename C>
__device__ void cholqr_pass(C* Y, C* G, int s, int k, C eps, int* s_bad) {
  const int t = threadIdx.x;
  for (int e = t; e < k * k; e += kThreads) {
    const int a = e / k, c = e % k;
    C acc = C(0);
    for (int r = 0; r < s; ++r) acc = fma_rn(Y[r * k + a], Y[r * k + c], acc);
    G[e] = acc;
  }
  __syncthreads();
  if (t == 0) {
    C tr = C(0);
    for (int j = 0; j < k; ++j) tr += G[j * k + j];
    const C jit = eps * (tr / static_cast<C>(k) + C(1));
    for (int j = 0; j < k; ++j) G[j * k + j] += jit;
    *s_bad = 0;
  }
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    const C d = G[j * k + j];
    if (!(d > C(0))) {  // NaN too
      if (t == 0) *s_bad = 1;
      break;  // uniform: every thread read the same d
    }
    const C ljj = proxsdp::sqrt_t<C>(d);
    __syncthreads();  // all threads have read G[j][j]
    if (t == 0) G[j * k + j] = ljj;
    for (int i = j + 1 + t; i < k; i += kThreads) G[i * k + j] /= ljj;
    __syncthreads();
    const int m = k - j - 1;
    for (int e = t; e < m * m; e += kThreads) {
      const int i = j + 1 + e / m, c = j + 1 + e % m;
      if (c <= i) G[i * k + c] = fma_rn(-G[i * k + j], G[c * k + j], G[i * k + c]);
    }
    __syncthreads();
  }
  __syncthreads();
  const bool bad = *s_bad != 0;
  // each thread solves its own rows by forward substitution, in place
  for (int r = t; r < s; r += kThreads) {
    for (int j = 0; j < k; ++j) {
      if (bad) {
        Y[r * k + j] = static_cast<C>(NAN);
        continue;
      }
      C acc = Y[r * k + j];
      for (int p = 0; p < j; ++p) acc = fma_rn(-G[j * k + p], Y[r * k + p], acc);
      Y[r * k + j] = acc / G[j * k + j];
    }
  }
  __syncthreads();
}

struct Layout {
  // the panels: byte offsets from the panel base, their size
  size_t p3, p4, th, lam, p1, p2, panels;
  // the k x k matrices and Jacobi's scratch: offsets from the small base
  size_t g, u, cs, sn, ws, perm, small;
};

// byte offsets of the regions: the T arrays first, then the C arrays,
// then the ints (each region stays aligned to its type).  K12 puts the
// small regions right after the panels in shared memory.
template <typename T, typename C>
__host__ __device__ Layout smem_layout(int s, int k) {
  const size_t sk = static_cast<size_t>(s) * k;
  const size_t n = k + (k & 1);
  Layout L;
  L.p3 = 0;
  L.p4 = L.p3 + sk * sizeof(T);
  L.th = L.p4 + sk * sizeof(T);
  L.lam = L.th + k * sizeof(T);
  L.p1 = L.lam + k * sizeof(T);
  L.p2 = L.p1 + sk * sizeof(C);
  L.panels = L.p2 + sk * sizeof(C);
  L.g = 0;
  L.u = L.g + n * n * sizeof(C);
  L.cs = L.u + n * n * sizeof(C);
  L.sn = L.cs + (n / 2) * sizeof(C);
  L.ws = L.sn + (n / 2) * sizeof(C);
  L.perm = L.ws + n * sizeof(C);
  L.small = L.perm + n * sizeof(int);
  return L;
}

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
    batched_subspace_kernel(const T* __restrict__ v, int64_t vstride,
                            const T* __restrict__ warm_in, T* __restrict__ out,
                            T* __restrict__ me_out,
                            int32_t* __restrict__ rank_out,
                            T* __restrict__ warm_out,
                            uint8_t* __restrict__ bad_out,
                            T* __restrict__ stats_out, int s, int k,
                            double tol_psd, double eps, double inv_sqrt2_d,
                            double sqrt2_d, unsigned char* gws,
                            int64_t gws_stride, int small_global) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red[kThreads];
  __shared__ int s_flag;
  const Layout L = smem_layout<T, C>(s, k);
  // K12: everything in shared memory; K12L: the panels (and, with
  // small_global, the k x k regions after them) in the workspace
  unsigned char* pb = gws ? gws + blockIdx.x * gws_stride : smem;
  unsigned char* sb = gws && !small_global ? smem : pb + L.panels;
  T* W = reinterpret_cast<T*>(pb + L.p3);    // V as C first, then W
  T* XW = reinterpret_cast<T*>(pb + L.p4);
  T* th = reinterpret_cast<T*>(pb + L.th);   // theta
  T* lam = reinterpret_cast<T*>(pb + L.lam); // max(theta, 0)
  C* Q = reinterpret_cast<C*>(pb + L.p1);    // Y, then Q
  C* Z = reinterpret_cast<C*>(pb + L.p2);
  C* G = reinterpret_cast<C*>(sb + L.g);     // Gram, then Bm / Jacobi A
  C* U = reinterpret_cast<C*>(sb + L.u);     // Q^T Z, then rotations
  C* cs = reinterpret_cast<C*>(sb + L.cs);
  C* sn = reinterpret_cast<C*>(sb + L.sn);
  C* ws = reinterpret_cast<C*>(sb + L.ws);
  int* perm = reinterpret_cast<int*>(sb + L.perm);

  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int n = k + (k & 1);
  const int sk = s * k;
  const int tl = s * (s + 1) / 2;
  const T inv_sqrt2 = static_cast<T>(inv_sqrt2_d);
  const T sqrt2 = static_cast<T>(sqrt2_d);
  const T* vb = v + b * vstride;
  const T* wb = warm_in + b * sk;
  T* ob = out + b * tl;
  T* wo = warm_out + b * sk;

  // ---- Y = X V (basis type C)
  C* Vc = reinterpret_cast<C*>(W);
  for (int e = t; e < sk; e += kThreads) Vc[e] = static_cast<C>(wb[e]);
  __syncthreads();
  x_times<T, C>(vb, Vc, Q, s, k, inv_sqrt2);
  // Y exactly 0 (a cold start's first projection, X = 0): Y = V, so the
  // old basis survives (ROADMAP C11)
  int live = 0;
  for (int e = t; e < sk; e += kThreads) live |= Q[e] != C(0);
  if (!__syncthreads_or(live)) {
    for (int e = t; e < sk; e += kThreads) Q[e] = Vc[e];
    __syncthreads();
  }
  // ---- Q = cholqr2(Y); Z = X Q
  cholqr_pass<C>(Q, G, s, k, static_cast<C>(eps), &s_flag);
  cholqr_pass<C>(Q, G, s, k, static_cast<C>(eps), &s_flag);
  x_times<T, C>(vb, Q, Z, s, k, inv_sqrt2);
  // ---- Bm = sym(Q^T Z) into G (n x n, zero-padded); U = I
  for (int e = t; e < k * k; e += kThreads) {
    const int a = e / k, c = e % k;
    C acc = C(0);
    for (int r = 0; r < s; ++r) acc = fma_rn(Q[r * k + a], Z[r * k + c], acc);
    U[e] = acc;
  }
  __syncthreads();
  int nonfinite = 0;
  for (int e = t; e < n * n; e += kThreads) {
    const int a = e / n, c = e % n;
    C val = C(0);
    if (a < k && c < k) {
      val = C(0.5) * (U[a * k + c] + U[c * k + a]);
      if (!isfinite(val)) nonfinite = 1;
    }
    G[e] = val;
  }
  __syncthreads();
  for (int e = t; e < n * n; e += kThreads) U[e] = e / n == e % n ? C(1) : C(0);
  const bool nan_theta = __syncthreads_or(nonfinite) != 0;

  bool bad = nan_theta;
  if (!nan_theta) {
    // ---- (theta, U) = eigh(Bm), ascending
    jacobi_eigh<kThreads, C>(G, U, n, cs, sn, red);
    jacobi_rank<kThreads, C>(G, n, k, ws, perm);
    // ---- W = Q U (cast to T), XW = Z U or, mixed, X W in T
    for (int e = t; e < sk; e += kThreads) {
      const int i = e / k, j = e % k, col = perm[j];
      C aw = C(0), az = C(0);
      for (int m = 0; m < k; ++m) {
        aw = fma_rn(Q[i * k + m], U[m * n + col], aw);
        az = fma_rn(Z[i * k + m], U[m * n + col], az);
      }
      W[e] = static_cast<T>(aw);
      XW[e] = static_cast<T>(az);
    }
    __syncthreads();
    constexpr bool kMixed = sizeof(C) < sizeof(T);
    if (kMixed) x_times<T, T>(vb, W, XW, s, k, inv_sqrt2);
    // ---- theta, residual norms (one thread a column, rows in order)
    for (int j = t; j < k; j += kThreads) {
      T thj;
      if (kMixed) {
        T num = T(0), den = T(0);
        for (int i = 0; i < s; ++i) {
          num = fma_rn(W[i * k + j], XW[i * k + j], num);
          den = fma_rn(W[i * k + j], W[i * k + j], den);
        }
        thj = num / den;
      } else {
        thj = static_cast<T>(ws[j]);
      }
      T rn2 = T(0);
      for (int i = 0; i < s; ++i) {
        const T d = XW[i * k + j] - W[i * k + j] * thj;
        rn2 = fma_rn(d, d, rn2);
      }
      th[j] = thj;
      lam[j] = isnan(thj) ? thj : (thj > T(0) ? thj : T(0));
      XW[j] = sqrt(rn2);  // XW's first row is read no more: rn_j
    }
    __syncthreads();
    // ---- Xp = W diag(lam) W^T, the upper triangle packed and scaled
    int nf = 0;
    for (int q = t; q < tl; q += kThreads) {
      int j = static_cast<int>((sqrtf(8.0f * q + 1.0f) - 1.0f) * 0.5f);
      while ((j + 1) * (j + 2) / 2 <= q) ++j;
      while (j * (j + 1) / 2 > q) --j;
      const int i = q - j * (j + 1) / 2;
      T acc = T(0);
      for (int m = 0; m < k; ++m)
        acc = fma_rn(W[i * k + m] * lam[m], W[j * k + m], acc);
      if (!isfinite(acc)) nf = 1;
      ob[q] = i == j ? acc : acc * sqrt2;
    }
    bad = __syncthreads_or(nf) != 0;
    if (t == 0) {
      T scale = T(1), rnmax = T(0), tmin = th[0];
      int npos = 0, rank = 0;
      for (int j = 0; j < k; ++j) {
        const T a = th[j] < T(0) ? -th[j] : th[j];
        scale = nan_max(isnan(th[j]) ? th[j] : a, scale);
        if (th[j] > T(0)) {
          rnmax = nan_max(XW[j], rnmax);
          ++npos;
        }
        rank += th[j] > static_cast<T>(tol_psd);
        tmin = nan_min(th[j], tmin);
      }
      stats_out[b * 3 + 0] = rnmax / scale;
      stats_out[b * 3 + 1] = tmin;
      stats_out[b * 3 + 2] = static_cast<T>(npos);
      me_out[b] = tmin;
      rank_out[b] = rank;
    }
  } else if (t == 0) {
    const T nan = static_cast<T>(NAN);
    stats_out[b * 3 + 0] = nan;
    stats_out[b * 3 + 1] = nan;
    stats_out[b * 3 + 2] = T(0);
    me_out[b] = nan;
    rank_out[b] = 0;
  }
  if (bad) {
    // X, packed again (K10's round trip), and the old basis
    for (int q = t; q < tl; q += kThreads) {
      int j = static_cast<int>((sqrtf(8.0f * q + 1.0f) - 1.0f) * 0.5f);
      while ((j + 1) * (j + 2) / 2 <= q) ++j;
      while (j * (j + 1) / 2 > q) --j;
      const int i = q - j * (j + 1) / 2;
      const T x = x_at(vb, i, j, inv_sqrt2);
      ob[q] = i == j ? x : x * sqrt2;
    }
    for (int e = t; e < sk; e += kThreads) wo[e] = wb[e];
  } else {
    for (int e = t; e < sk; e += kThreads) {
      const int i = e / k, j = e % k;
      wo[e] = W[i * k + (k - 1 - j)];
    }
  }
  if (t == 0) bad_out[b] = bad ? 1 : 0;
}

template <typename T, typename C>
int launch(const void* v, int64_t vstride, const void* warm_in, void* out,
           void* me, void* rank, void* warm_out, void* bad, void* stats,
           void* gws, int64_t gws_stride, int64_t B, int64_t s, int64_t k,
           double tol_psd, double eps, double inv_sqrt2, double sqrt2,
           void* stream) {
  const bool large = gws != nullptr;
  if (s < 2 || k < 1 || k > (large ? 256 : 64) || k > s)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L =
      smem_layout<T, C>(static_cast<int>(s), static_cast<int>(k));
  size_t bytes = L.panels + L.small;
  int small_global = 0;
  if (large) {
    // the caller's stride must hold the panels, and the k x k regions
    // where they exceed shared memory (kernels.subspace_large_bytes)
    small_global = L.small > kMaxSmem;
    bytes = small_global ? 0 : L.small;
    if (gws_stride % 256 != 0 ||
        static_cast<size_t>(gws_stride) <
            L.panels + (small_global ? L.small : 0))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (bytes > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(
      batched_subspace_kernel<T, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  batched_subspace_kernel<T, C><<<static_cast<unsigned>(B), kThreads, bytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), vstride, static_cast<const T*>(warm_in),
      static_cast<T*>(out), static_cast<T*>(me), static_cast<int32_t*>(rank),
      static_cast<T*>(warm_out), static_cast<uint8_t*>(bad),
      static_cast<T*>(stats), static_cast<int>(s), static_cast<int>(k),
      tol_psd, eps, inv_sqrt2, sqrt2, static_cast<unsigned char*>(gws),
      gws_stride, small_global);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v: B rows of vstride values, the packed triangle (s (s + 1) / 2) first;
// warm_in, warm_out: (B, s, k); out: (B, s (s + 1) / 2); me: (B,); rank:
// (B,) int32; bad: (B,) bool bytes; stats: (B, 3).  eps is the basis
// type's CholeskyQR jitter; inv_sqrt2 and sqrt2 are K10's scales.  The
// _large entries (K12L) take the workspace gws, B blocks of gws_stride
// bytes (kernels.subspace_large_bytes), k <= 256.
#define PROXSDP_SUBSPACE_ENTRY(SFX, T, C)                                      \
  extern "C" int proxsdp_batched_subspace_##SFX(                              \
      const void* v, int64_t vstride, const void* warm_in, void* out,         \
      void* me, void* rank, void* warm_out, void* bad, void* stats,           \
      int64_t B, int64_t s, int64_t k, double tol_psd, double eps,            \
      double inv_sqrt2, double sqrt2, void* stream) {                         \
    return launch<T, C>(v, vstride, warm_in, out, me, rank, warm_out, bad,    \
                        stats, nullptr, 0, B, s, k, tol_psd, eps, inv_sqrt2,  \
                        sqrt2, stream);                                       \
  }                                                                           \
  extern "C" int proxsdp_batched_subspace_large_##SFX(                        \
      const void* v, int64_t vstride, const void* warm_in, void* out,         \
      void* me, void* rank, void* warm_out, void* bad, void* stats,           \
      void* gws, int64_t gws_stride, int64_t B, int64_t s, int64_t k,         \
      double tol_psd, double eps, double inv_sqrt2, double sqrt2,             \
      void* stream) {                                                         \
    if (gws == nullptr) return static_cast<int>(cudaErrorInvalidValue);      \
    return launch<T, C>(v, vstride, warm_in, out, me, rank, warm_out, bad,    \
                        stats, gws, gws_stride, B, s, k, tol_psd, eps,        \
                        inv_sqrt2, sqrt2, stream);                            \
  }

PROXSDP_SUBSPACE_ENTRY(f64, double, double)
PROXSDP_SUBSPACE_ENTRY(f32, float, float)
// the mixed mode: f64 blocks, bases and Ritz values, an f32 basis build
PROXSDP_SUBSPACE_ENTRY(f64_f32, double, float)
