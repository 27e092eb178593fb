// K2: one Malitsky-Pock linesearch trial's dual update, and the squared
// distances of its accept test.
//
// Replaces: proxsdp_tpu/solver.py:452-463 (the _linesearch body) with
// proxsdp_tpu/ops/cones.py:26-40 (box_projection), and reused by
// _dual_step (solver.py:484-490) with theta = 1.  Per row i < p + m:
//   y_half = y + bp * ((1 + theta) * Mx - theta * Mx_old)
//   proj   = b[i]                     for equality rows   (i <  p)
//            min(y_half / bp, h[i-p]) for inequality rows (i >= p)
//   y_temp = y_half - bp * proj
// and sum_i (y_temp - y_old)^2.  sq_dist gives sum_i (a - b)^2, which the
// accept test needs for M'y_temp - M'y_old after K1.
//
// The step scalars bp and theta are read from device memory, so a trial
// needs no host round trip to launch; the host syncs once per trial, on
// the accept flag.
//
// Bound on the H100: device-memory bytes (6 reads, 1 write per row, all
// coalesced) -- at p + m = 250 the launch dominates; sq_dist over the
// n = 62,500 primal vector reads 1 MB.  Design: grid-stride elementwise
// pass that also folds the squared distance into per-block partials, then
// the fixed-order second pass of reduce.cuh (no atomics: the accept test
// must see the same bits on every run).
#include "reduce.cuh"

namespace {

using proxsdp::kThreads;

template <typename T>
__global__ void ls_dual_update_kernel(
    const T* __restrict__ y, const T* __restrict__ Mx,
    const T* __restrict__ Mx_old, const T* __restrict__ b,
    const T* __restrict__ h, const T* __restrict__ y_old,
    const T* __restrict__ bp_ptr, const T* __restrict__ theta_ptr,
    T* __restrict__ y_temp, T* __restrict__ partials, int64_t p, int64_t m) {
  const T bp = *bp_ptr;
  const T theta = *theta_ptr;
  const T one_theta = T(1) + theta;
  T acc[1] = {T(0)};
  const int64_t n = p + m;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T yh = y[i] + bp * (one_theta * Mx[i] - theta * Mx_old[i]);
    const T proj = i < p ? b[i] : proxsdp::nan_min(yh / bp, h[i - p]);
    const T yt = yh - bp * proj;
    y_temp[i] = yt;
    const T d = yt - y_old[i];
    acc[0] += d * d;
  }
  proxsdp::block_reduce<T, 1, 0u>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc[0];
}

template <typename T>
__global__ void sq_dist_kernel(const T* __restrict__ a,
                               const T* __restrict__ b,
                               T* __restrict__ partials, int64_t n) {
  T acc[1] = {T(0)};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T d = a[i] - b[i];
    acc[0] += d * d;
  }
  proxsdp::block_reduce<T, 1, 0u>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc[0];
}

template <typename T>
int launch_update(const void* y, const void* Mx, const void* Mx_old,
                  const void* b, const void* h, const void* y_old,
                  const void* bp, const void* theta, void* y_temp,
                  void* partials, void* out_sq, int64_t p, int64_t m,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = proxsdp::reduce_grid(p + m);
  ls_dual_update_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(Mx),
      static_cast<const T*>(Mx_old), static_cast<const T*>(b),
      static_cast<const T*>(h), static_cast<const T*>(y_old),
      static_cast<const T*>(bp), static_cast<const T*>(theta),
      static_cast<T*>(y_temp), static_cast<T*>(partials), p, m);
  proxsdp::finalize_kernel<T, 1, 0u><<<1, kThreads, 0, s>>>(
      static_cast<const T*>(partials), grid, static_cast<T*>(out_sq));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sq_dist(const void* a, const void* b, void* partials, void* out,
                   int64_t n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = proxsdp::reduce_grid(n);
  sq_dist_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(partials), n);
  proxsdp::finalize_kernel<T, 1, 0u><<<1, kThreads, 0, s>>>(
      static_cast<const T*>(partials), grid, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int proxsdp_ls_dual_update_f64(
    const void* y, const void* Mx, const void* Mx_old, const void* b,
    const void* h, const void* y_old, const void* bp, const void* theta,
    void* y_temp, void* partials, void* out_sq, int64_t p, int64_t m,
    void* stream) {
  return launch_update<double>(y, Mx, Mx_old, b, h, y_old, bp, theta, y_temp,
                               partials, out_sq, p, m, stream);
}

extern "C" int proxsdp_ls_dual_update_f32(
    const void* y, const void* Mx, const void* Mx_old, const void* b,
    const void* h, const void* y_old, const void* bp, const void* theta,
    void* y_temp, void* partials, void* out_sq, int64_t p, int64_t m,
    void* stream) {
  return launch_update<float>(y, Mx, Mx_old, b, h, y_old, bp, theta, y_temp,
                              partials, out_sq, p, m, stream);
}

extern "C" int proxsdp_sq_dist_f64(const void* a, const void* b,
                                   void* partials, void* out, int64_t n,
                                   void* stream) {
  return launch_sq_dist<double>(a, b, partials, out, n, stream);
}

extern "C" int proxsdp_sq_dist_f32(const void* a, const void* b,
                                   void* partials, void* out, int64_t n,
                                   void* stream) {
  return launch_sq_dist<float>(a, b, partials, out, n, stream);
}

// ---- the batch driver's entry points (the vmapped trial of
// proxsdp_tpu/parallel/batch.py:141): B instances, each with its own b, h
// and step scalars bp[b], theta[b], one launch per batch.  One CTA per
// instance: its threads stride over the instance's rows and fold the
// squared distance with the fixed-order block tree of reduce.cuh, so the
// per-instance sums need no second pass.
namespace {

template <typename T>
__global__ void ls_dual_update_batch_kernel(
    const T* __restrict__ y, const T* __restrict__ Mx,
    const T* __restrict__ Mx_old, const T* __restrict__ b,
    const T* __restrict__ h, const T* __restrict__ y_old,
    const T* __restrict__ bp_ptr, const T* __restrict__ theta_ptr,
    T* __restrict__ y_temp, T* __restrict__ out_sq, int64_t p, int64_t m) {
  const int64_t inst = blockIdx.x;
  const int64_t n = p + m;
  const int64_t base = inst * n;
  const T bp = bp_ptr[inst];
  const T theta = theta_ptr[inst];
  const T one_theta = T(1) + theta;
  const T* bb = b + inst * p;
  const T* hb = h + inst * m;
  T acc[1] = {T(0)};
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t e = base + i;
    const T yh = y[e] + bp * (one_theta * Mx[e] - theta * Mx_old[e]);
    const T proj = i < p ? bb[i] : proxsdp::nan_min(yh / bp, hb[i - p]);
    const T yt = yh - bp * proj;
    y_temp[e] = yt;
    const T d = yt - y_old[e];
    acc[0] += d * d;
  }
  proxsdp::block_reduce<T, 1, 0u>(acc);
  if (threadIdx.x == 0) out_sq[inst] = acc[0];
}

template <typename T>
__global__ void sq_dist_batch_kernel(const T* __restrict__ a,
                                     const T* __restrict__ b,
                                     T* __restrict__ out, int64_t n) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;
  T acc[1] = {T(0)};
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    const T d = a[base + i] - b[base + i];
    acc[0] += d * d;
  }
  proxsdp::block_reduce<T, 1, 0u>(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc[0];
}

template <typename T>
int launch_update_batch(const void* y, const void* Mx, const void* Mx_old,
                        const void* b, const void* h, const void* y_old,
                        const void* bp, const void* theta, void* y_temp,
                        void* out_sq, int64_t B, int64_t p, int64_t m,
                        void* stream) {
  if (B > 0) {
    ls_dual_update_batch_kernel<T><<<static_cast<unsigned>(B), kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(y), static_cast<const T*>(Mx),
        static_cast<const T*>(Mx_old), static_cast<const T*>(b),
        static_cast<const T*>(h), static_cast<const T*>(y_old),
        static_cast<const T*>(bp), static_cast<const T*>(theta),
        static_cast<T*>(y_temp), static_cast<T*>(out_sq), p, m);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sq_dist_batch(const void* a, const void* b, void* out, int64_t B,
                         int64_t n, void* stream) {
  if (B > 0) {
    sq_dist_batch_kernel<T><<<static_cast<unsigned>(B), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, Mx, Mx_old, y_old, y_temp: (B, p + m); b: (B, p); h: (B, m);
// bp, theta, out_sq: (B,).
extern "C" int proxsdp_ls_dual_update_batch_f64(
    const void* y, const void* Mx, const void* Mx_old, const void* b,
    const void* h, const void* y_old, const void* bp, const void* theta,
    void* y_temp, void* out_sq, int64_t B, int64_t p, int64_t m,
    void* stream) {
  return launch_update_batch<double>(y, Mx, Mx_old, b, h, y_old, bp, theta,
                                     y_temp, out_sq, B, p, m, stream);
}

extern "C" int proxsdp_ls_dual_update_batch_f32(
    const void* y, const void* Mx, const void* Mx_old, const void* b,
    const void* h, const void* y_old, const void* bp, const void* theta,
    void* y_temp, void* out_sq, int64_t B, int64_t p, int64_t m,
    void* stream) {
  return launch_update_batch<float>(y, Mx, Mx_old, b, h, y_old, bp, theta,
                                    y_temp, out_sq, B, p, m, stream);
}

// a, b: (B, n); out: (B,).
extern "C" int proxsdp_sq_dist_batch_f64(const void* a, const void* b,
                                         void* out, int64_t B, int64_t n,
                                         void* stream) {
  return launch_sq_dist_batch<double>(a, b, out, B, n, stream);
}

extern "C" int proxsdp_sq_dist_batch_f32(const void* a, const void* b,
                                         void* out, int64_t B, int64_t n,
                                         void* stream) {
  return launch_sq_dist_batch<float>(a, b, out, B, n, stream);
}
