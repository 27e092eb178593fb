// K8: the acceptance test of one subspace (Rayleigh-Ritz) projection step.
//
// Replaces proxsdp_tpu/ops/cones.py:_subspace_body (443-489) from the Ritz
// basis on: with W (side, k) the Ritz vectors and XW = X @ W,
//   theta = sum(W * XW, 0) / sum(W * W, 0)   (mixed f64 mode; otherwise
//                                             the eigh's theta is given)
//   rn    = sqrt(sum((XW - W * theta)^2, 0))
//   pos   = theta > 0;  scale = max(max |theta|, 1)
//   thresh = max(tol, accept_tol)             (accept_tol may be absent)
//   ok    = all(pos ? rn <= thresh * scale : true)
//   covers = min theta <= tol_psd
//   conv_ok = ok & covers & !force_full
// and writes lam = max(theta, 0) (the reconstruction's weights), stats =
// [max(pos ? rn : 0) / scale, min theta, count(pos)] (PsdProjResult's
// sub_stats) and flags = [conv_ok, count(theta > tol_psd)].  The host
// reads flags[0] only, to choose between the reconstruction and the
// fallback; everything else stays on the device.
//
// Bound on the H100: device-memory bytes, two reads of 2 * side * k words
// (0.1 MB at side 250, k = 16, f64): launch-bound.  Design: a single CTA,
// one warp per column (columns strided over the warps), a fixed-order
// shuffle tree per column, then one thread folds the k columns in index
// order -- so the test sees the same bits on every run.  Maxima and minima
// propagate NaN like jnp.max / jnp.min, so a NaN basis is rejected.
#include "reduce.cuh"

namespace {

constexpr int kThreadsK8 = 1024;
constexpr int kMaxK = 256;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreadsK8)
ritz_accept_kernel(const T* __restrict__ w, const T* __restrict__ xw,
                   const T* __restrict__ theta_in,
                   const T* __restrict__ accept_tol, int64_t side, int k,
                   T tol, T tol_psd, int force_full, T* __restrict__ lam,
                   T* __restrict__ stats, int* __restrict__ flags) {
  __shared__ T s_theta[kMaxK];
  __shared__ T s_rn[kMaxK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int c = warp; c < k; c += nwarps) {
    T th;
    if (theta_in) {
      th = theta_in[c];
    } else {
      T swx = T(0), sww = T(0);
      for (int64_t r = lane; r < side; r += 32) {
        const T wv = w[r * k + c];
        swx += wv * xw[r * k + c];
        sww += wv * wv;
      }
      swx = warp_sum(swx);
      sww = warp_sum(sww);
      th = __shfl_sync(0xffffffffu, swx / sww, 0);
    }
    T ss = T(0);
    for (int64_t r = lane; r < side; r += 32) {
      const T d = xw[r * k + c] - w[r * k + c] * th;
      ss += d * d;
    }
    ss = warp_sum(ss);
    if (lane == 0) {
      s_theta[c] = th;
      s_rn[c] = sqrt(ss);
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  T amax = T(0), tmin = static_cast<T>(INFINITY), rmax = T(0);
  int npos = 0, cur = 0;
  for (int c = 0; c < k; ++c) {
    const T th = s_theta[c];
    amax = proxsdp::nan_max(amax, fabs(th));
    tmin = proxsdp::nan_min(tmin, th);
    if (th > T(0)) {
      ++npos;
      rmax = proxsdp::nan_max(rmax, s_rn[c]);
    }
    if (th > tol_psd) ++cur;
    lam[c] = (isnan(th) || th > T(0)) ? th : T(0);
  }
  const T scale = proxsdp::nan_max(amax, T(1));
  T thresh = tol;
  if (accept_tol) thresh = proxsdp::nan_max(*accept_tol, thresh);
  bool ok = true;
  for (int c = 0; c < k; ++c)
    if (s_theta[c] > T(0) && !(s_rn[c] <= thresh * scale)) ok = false;
  const bool covers = tmin <= tol_psd;
  stats[0] = rmax / scale;
  stats[1] = tmin;
  stats[2] = static_cast<T>(npos);
  flags[0] = (ok && covers && !force_full) ? 1 : 0;
  flags[1] = cur;
}

template <typename T>
int launch(const void* w, const void* xw, const void* theta,
           const void* accept_tol, int64_t side, int64_t k, double tol,
           double tol_psd, int64_t force_full, void* lam, void* stats,
           void* flags, void* stream) {
  ritz_accept_kernel<T><<<1, kThreadsK8, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const T*>(xw),
      static_cast<const T*>(theta), static_cast<const T*>(accept_tol), side,
      static_cast<int>(k), static_cast<T>(tol), static_cast<T>(tol_psd),
      static_cast<int>(force_full), static_cast<T*>(lam),
      static_cast<T*>(stats), static_cast<int*>(flags));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w, xw contiguous (side, k), k <= 256; theta (k,) or null (then the
// Rayleigh quotients are computed); accept_tol a 0-d tensor or null; lam
// (k,), stats (3,), flags int32 (2,).
extern "C" int proxsdp_ritz_accept_f32(const void* w, const void* xw,
                                       const void* theta,
                                       const void* accept_tol, int64_t side,
                                       int64_t k, double tol, double tol_psd,
                                       int64_t force_full, void* lam,
                                       void* stats, void* flags,
                                       void* stream) {
  return launch<float>(w, xw, theta, accept_tol, side, k, tol, tol_psd,
                       force_full, lam, stats, flags, stream);
}

extern "C" int proxsdp_ritz_accept_f64(const void* w, const void* xw,
                                       const void* theta,
                                       const void* accept_tol, int64_t side,
                                       int64_t k, double tol, double tol_psd,
                                       int64_t force_full, void* lam,
                                       void* stats, void* flags,
                                       void* stream) {
  return launch<double>(w, xw, theta, accept_tol, side, k, tol, tol_psd,
                        force_full, lam, stats, flags, stream);
}
