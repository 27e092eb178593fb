// K3: the reductions of one residual-and-gap evaluation, in one pass.
//
// Replaces: proxsdp_tpu/solver.py:545-612 (_residuals_and_gap).  With
// Px = x - tau*Mty, Px_old = x_old - tau*Mty_old, Py = y - sigma*Mx,
// Py_old = y_old - sigma*Mx_old, w = sqrt(2) on the off-diagonal
// positions of every square PSD block (1 elsewhere, solver.py:545-557)
// and r the row scale (1/E of an equilibrated problem, solver.py:582-597;
// 1 where the pointer is null), it writes nine scalars:
//   out[0] = max |w (Px - Px_old)|     out[1] = max |w Px_old|
//   out[2] = max |Py - Py_old|         out[3] = max |Py_old|
//   out[4] = max |(Mx[:p] - b) r[:p]|  out[5] = max ((Mx[p:] - h) r[p:])
//   out[6] = c . x                     out[7] = b . y[:p]
//   out[8] = h . y[p:]
// The weight comes from the index and a block table, not from a host
// array: nblk square blocks laid end to end, blk_off[k] the start of block
// k (blk_off[nblk] the end of the last), blk_side[k] its side; a binary
// search finds an entry's block.  Empty ranges give 0 for out[0..4] and
// -inf for out[5]; the caller keeps its previous value then, as the JAX
// code does.
//
// Bound on the H100: device-memory bytes -- 5 reads per primal entry and
// 6 or 7 per dual row, about 2.5 MB per call at the max-cut slice's shapes
// (n = 62,500, p = 250, f64), i.e. ~0.75 us at 3.35 TB/s, so the launch
// and the second pass dominate.  Design: one grid-stride pass that keeps
// all nine accumulators in registers and writes per-block partials, then
// the fixed-order single-block second pass of reduce.cuh (no atomics, so
// the gap and feasibility bits repeat from run to run).
//
// f32 programs follow the JAX f32 program (solver.py:512-537) instead: the
// maxima run on the f32 values (they carry no accumulation error), and
// each dot is taken in two stages -- f32 products summed in chunks of 128
// consecutive elements of the dot's own range, then the chunk sums added
// in f64 (a plain f32 dot over 62,500 terms carries ~1e-4 relative noise,
// the solver's own tolerance).  All nine outputs are f64.  One warp takes
// one chunk: lane l sums its elements l, l+32, l+64, l+96 in that order,
// then a shuffle tree with offsets 16, 8, 4, 2, 1 folds the lanes -- the
// plain version (kernels/__init__.py:_chunk_dot) repeats exactly this
// order, so kernel and plain version agree on every chunk sum bit for bit.
#include "reduce.cuh"

namespace {

using proxsdp::kThreads;
using proxsdp::nan_max;

constexpr int kSlots = 9;
constexpr unsigned kMaxMask = 0x3Fu;  // slots 0..5 are maxima, 6..8 sums

// whether entry i of x is an off-diagonal position of a square block of
// the table (see the header)
__device__ __forceinline__ bool off_diagonal(int64_t i,
                                             const int64_t* __restrict__ off,
                                             const int64_t* __restrict__ side,
                                             int64_t nblk) {
  if (nblk == 0 || i < off[0] || i >= off[nblk]) return false;
  int64_t lo = 0, hi = nblk - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (off[mid] <= i) lo = mid; else hi = mid - 1;
  }
  const int64_t q = i - off[lo], s = side[lo];
  return q / s != q % s;
}

template <typename T>
__global__ void residuals_kernel(
    const T* __restrict__ x, const T* __restrict__ x_old,
    const T* __restrict__ Mty, const T* __restrict__ Mty_old,
    const T* __restrict__ tau_ptr, const T* __restrict__ y,
    const T* __restrict__ y_old, const T* __restrict__ Mx,
    const T* __restrict__ Mx_old, const T* __restrict__ sigma_ptr,
    const T* __restrict__ b, const T* __restrict__ h,
    const T* __restrict__ c, const T* __restrict__ rs,
    const int64_t* __restrict__ blk_off, const int64_t* __restrict__ blk_side,
    T* __restrict__ partials, int64_t n, int64_t p, int64_t m, int64_t nblk) {
  const T tau = *tau_ptr;
  const T sigma = *sigma_ptr;
  const T sqrt2 = static_cast<T>(1.4142135623730951);
  T acc[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = T(0);
  acc[5] = static_cast<T>(-INFINITY);
  const int64_t pm = p + m;
  const int64_t total = n > pm ? n : pm;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    if (i < n) {
      const T w = off_diagonal(i, blk_off, blk_side, nblk) ? sqrt2 : T(1);
      const T px_old = x_old[i] - tau * Mty_old[i];
      const T px = x[i] - tau * Mty[i];
      acc[0] = nan_max(acc[0], fabs((px - px_old) * w));
      acc[1] = nan_max(acc[1], fabs(px_old * w));
      acc[6] += c[i] * x[i];
    }
    if (i < pm) {
      const T py_old = y_old[i] - sigma * Mx_old[i];
      const T py = y[i] - sigma * Mx[i];
      acc[2] = nan_max(acc[2], fabs(py - py_old));
      acc[3] = nan_max(acc[3], fabs(py_old));
      if (i < p) {
        const T r = Mx[i] - b[i];
        acc[4] = nan_max(acc[4], fabs(rs ? r * rs[i] : r));
        acc[7] += b[i] * y[i];
      } else {
        const T r = Mx[i] - h[i - p];
        acc[5] = nan_max(acc[5], rs ? r * rs[i] : r);
        acc[8] += h[i - p] * y[i];
      }
    }
  }
  proxsdp::block_reduce<T, kSlots, kMaxMask>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      partials[static_cast<int64_t>(blockIdx.x) * kSlots + k] = acc[k];
  }
}

constexpr int kChunk = 128;  // the JAX f32 program's dot chunk

// f32 elementwise terms, f64 outputs: see the header.  The work list is
// the 128-element chunks of three ranges -- [0, n) for the primal slots,
// [0, p) and [p, p + m) for the dual ones -- one warp per chunk.
__global__ void residuals_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ x_old,
    const float* __restrict__ Mty, const float* __restrict__ Mty_old,
    const float* __restrict__ tau_ptr, const float* __restrict__ y,
    const float* __restrict__ y_old, const float* __restrict__ Mx,
    const float* __restrict__ Mx_old, const float* __restrict__ sigma_ptr,
    const float* __restrict__ b, const float* __restrict__ h,
    const float* __restrict__ c, const float* __restrict__ rs,
    const int64_t* __restrict__ blk_off, const int64_t* __restrict__ blk_side,
    double* __restrict__ partials, int64_t n, int64_t p, int64_t m,
    int64_t nblk) {
  const float tau = *tau_ptr;
  const float sigma = *sigma_ptr;
  const float sqrt2 = 1.4142135623730951f;
  float mx[6] = {0.f, 0.f, 0.f, 0.f, 0.f, -INFINITY};
  double dots[3] = {0.0, 0.0, 0.0};
  const int lane = threadIdx.x & 31;
  const int64_t nx = (n + kChunk - 1) / kChunk;
  const int64_t nb = (p + kChunk - 1) / kChunk;
  const int64_t nh = (m + kChunk - 1) / kChunk;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t t = warp; t < nx + nb + nh; t += nwarps) {
    float s = 0.f;
    int slot;
    if (t < nx) {
      slot = 0;
      for (int j = 0; j < 4; ++j) {
        const int64_t i = t * kChunk + lane + 32 * j;
        float prod = 0.f;
        if (i < n) {
          const float w =
              off_diagonal(i, blk_off, blk_side, nblk) ? sqrt2 : 1.f;
          const float px_old = x_old[i] - tau * Mty_old[i];
          const float px = x[i] - tau * Mty[i];
          mx[0] = nan_max(mx[0], fabsf((px - px_old) * w));
          mx[1] = nan_max(mx[1], fabsf(px_old * w));
          prod = c[i] * x[i];
        }
        s = j ? s + prod : prod;
      }
    } else {
      const bool eq = t < nx + nb;
      slot = eq ? 1 : 2;
      const int64_t base = (eq ? t - nx : t - nx - nb) * kChunk;
      const int64_t len = eq ? p : m;
      for (int j = 0; j < 4; ++j) {
        const int64_t r = base + lane + 32 * j;
        float prod = 0.f;
        if (r < len) {
          const int64_t i = eq ? r : p + r;
          const float py_old = y_old[i] - sigma * Mx_old[i];
          const float py = y[i] - sigma * Mx[i];
          mx[2] = nan_max(mx[2], fabsf(py - py_old));
          mx[3] = nan_max(mx[3], fabsf(py_old));
          if (eq) {
            const float d = Mx[i] - b[r];
            mx[4] = nan_max(mx[4], fabsf(rs ? d * rs[i] : d));
            prod = b[r] * y[i];
          } else {
            const float d = Mx[i] - h[r];
            mx[5] = nan_max(mx[5], rs ? d * rs[i] : d);
            prod = h[r] * y[i];
          }
        }
        s = j ? s + prod : prod;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) dots[slot] += static_cast<double>(s);
  }
  double acc[kSlots];
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[k] = static_cast<double>(mx[k]);
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[6 + k] = dots[k];
  proxsdp::block_reduce<double, kSlots, kMaxMask>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      partials[static_cast<int64_t>(blockIdx.x) * kSlots + k] = acc[k];
  }
}

// the f32 kernel's grid: one warp per chunk, capped like reduce_grid
inline int f32_grid(int64_t n, int64_t p, int64_t m) {
  const int64_t chunks = (n + kChunk - 1) / kChunk + (p + kChunk - 1) / kChunk +
                         (m + kChunk - 1) / kChunk;
  return proxsdp::reduce_grid(32 * chunks);
}

template <typename T>
int launch(const void* x, const void* x_old, const void* Mty,
           const void* Mty_old, const void* tau, const void* y,
           const void* y_old, const void* Mx, const void* Mx_old,
           const void* sigma, const void* b, const void* h, const void* c,
           const void* rs, const void* blk_off, const void* blk_side,
           void* partials, void* out, int64_t n, int64_t p, int64_t m,
           int64_t nblk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = proxsdp::reduce_grid(n > p + m ? n : p + m);
  residuals_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(x_old),
      static_cast<const T*>(Mty), static_cast<const T*>(Mty_old),
      static_cast<const T*>(tau), static_cast<const T*>(y),
      static_cast<const T*>(y_old), static_cast<const T*>(Mx),
      static_cast<const T*>(Mx_old), static_cast<const T*>(sigma),
      static_cast<const T*>(b), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const T*>(rs),
      static_cast<const int64_t*>(blk_off),
      static_cast<const int64_t*>(blk_side), static_cast<T*>(partials), n, p,
      m, nblk);
  if (out)  // else K19 folds the partials (control.cu)
    proxsdp::finalize_kernel<T, kSlots, kMaxMask><<<1, kThreads, 0, s>>>(
        static_cast<const T*>(partials), grid, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partials holds reduce_grid(max(n, p + m)) * 9 entries; out holds 9, or
// is null: then the second pass is left to the caller (K19 folds the
// partials in the same order).
// rs: null or p + m row scales; blk_off: nblk + 1 int64 offsets and
// blk_side: nblk int64 sides of the square blocks (null when nblk = 0).
extern "C" int proxsdp_residuals_f64(
    const void* x, const void* x_old, const void* Mty, const void* Mty_old,
    const void* tau, const void* y, const void* y_old, const void* Mx,
    const void* Mx_old, const void* sigma, const void* b, const void* h,
    const void* c, const void* rs, const void* blk_off, const void* blk_side,
    void* partials, void* out, int64_t n, int64_t p, int64_t m, int64_t nblk,
    void* stream) {
  return launch<double>(x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old,
                        sigma, b, h, c, rs, blk_off, blk_side, partials, out,
                        n, p, m, nblk, stream);
}

// f32 inputs; partials (f32_grid(n, p, m) * 9 doubles) and out (9
// doubles) are f64.
extern "C" int proxsdp_residuals_f32(
    const void* x, const void* x_old, const void* Mty, const void* Mty_old,
    const void* tau, const void* y, const void* y_old, const void* Mx,
    const void* Mx_old, const void* sigma, const void* b, const void* h,
    const void* c, const void* rs, const void* blk_off, const void* blk_side,
    void* partials, void* out, int64_t n, int64_t p, int64_t m, int64_t nblk,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = f32_grid(n, p, m);
  residuals_f32_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(x_old),
      static_cast<const float*>(Mty), static_cast<const float*>(Mty_old),
      static_cast<const float*>(tau), static_cast<const float*>(y),
      static_cast<const float*>(y_old), static_cast<const float*>(Mx),
      static_cast<const float*>(Mx_old), static_cast<const float*>(sigma),
      static_cast<const float*>(b), static_cast<const float*>(h),
      static_cast<const float*>(c), static_cast<const float*>(rs),
      static_cast<const int64_t*>(blk_off),
      static_cast<const int64_t*>(blk_side), static_cast<double*>(partials),
      n, p, m, nblk);
  if (out)  // else K19 folds the partials (control.cu)
    proxsdp::finalize_kernel<double, kSlots, kMaxMask><<<1, kThreads, 0, s>>>(
        static_cast<const double*>(partials), grid,
        static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ---- the batch driver's entry point (the vmapped _residuals_and_gap of
// proxsdp_tpu/parallel/batch.py:141 on the packed-triangle layout, where
// solver.py:545-554 applies no off-diagonal weight): the same nine values
// for B instances, each with its own tau[b], sigma[b], b, h and c, written
// to out[b, 0..9) in f64, one launch per batch.  One CTA per instance,
// which also takes the place of the second pass: f64 instances stride
// their threads over the entries, f32 instances give each 128-element
// chunk to one of the CTA's warps in the order of the f32 kernel above
// (the chunk sums are bit for bit the plain version's; the chunk sums are
// then added in the block tree's order).
namespace {

template <typename T>
__global__ void residuals_batch_kernel(
    const T* __restrict__ x, const T* __restrict__ x_old,
    const T* __restrict__ Mty, const T* __restrict__ Mty_old,
    const T* __restrict__ tau_ptr, const T* __restrict__ y,
    const T* __restrict__ y_old, const T* __restrict__ Mx,
    const T* __restrict__ Mx_old, const T* __restrict__ sigma_ptr,
    const T* __restrict__ b, const T* __restrict__ h,
    const T* __restrict__ c, double* __restrict__ out, int64_t n, int64_t p,
    int64_t m) {
  const int64_t inst = blockIdx.x;
  const int64_t pm = p + m;
  const int64_t xo = inst * n, yo = inst * pm;
  const T tau = tau_ptr[inst];
  const T sigma = sigma_ptr[inst];
  const T* bb = b + inst * p;
  const T* hb = h + inst * m;
  T acc[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = T(0);
  acc[5] = static_cast<T>(-INFINITY);
  const int64_t total = n > pm ? n : pm;
  for (int64_t i = threadIdx.x; i < total; i += blockDim.x) {
    if (i < n) {
      const int64_t e = xo + i;
      const T px_old = x_old[e] - tau * Mty_old[e];
      const T px = x[e] - tau * Mty[e];
      acc[0] = nan_max(acc[0], fabs(px - px_old));
      acc[1] = nan_max(acc[1], fabs(px_old));
      acc[6] += c[e] * x[e];
    }
    if (i < pm) {
      const int64_t e = yo + i;
      const T py_old = y_old[e] - sigma * Mx_old[e];
      const T py = y[e] - sigma * Mx[e];
      acc[2] = nan_max(acc[2], fabs(py - py_old));
      acc[3] = nan_max(acc[3], fabs(py_old));
      if (i < p) {
        acc[4] = nan_max(acc[4], fabs(Mx[e] - bb[i]));
        acc[7] += bb[i] * y[e];
      } else {
        acc[5] = nan_max(acc[5], Mx[e] - hb[i - p]);
        acc[8] += hb[i - p] * y[e];
      }
    }
  }
  proxsdp::block_reduce<T, kSlots, kMaxMask>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      out[inst * kSlots + k] = static_cast<double>(acc[k]);
  }
}

__global__ void residuals_batch_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ x_old,
    const float* __restrict__ Mty, const float* __restrict__ Mty_old,
    const float* __restrict__ tau_ptr, const float* __restrict__ y,
    const float* __restrict__ y_old, const float* __restrict__ Mx,
    const float* __restrict__ Mx_old, const float* __restrict__ sigma_ptr,
    const float* __restrict__ b, const float* __restrict__ h,
    const float* __restrict__ c, double* __restrict__ out, int64_t n,
    int64_t p, int64_t m) {
  const int64_t inst = blockIdx.x;
  const int64_t pm = p + m;
  const int64_t xo = inst * n, yo = inst * pm;
  const float tau = tau_ptr[inst];
  const float sigma = sigma_ptr[inst];
  const float* bb = b + inst * p;
  const float* hb = h + inst * m;
  float mx[6] = {0.f, 0.f, 0.f, 0.f, 0.f, -INFINITY};
  double dots[3] = {0.0, 0.0, 0.0};
  const int lane = threadIdx.x & 31;
  const int64_t nx = (n + kChunk - 1) / kChunk;
  const int64_t nb = (p + kChunk - 1) / kChunk;
  const int64_t nh = (m + kChunk - 1) / kChunk;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int64_t t = warp; t < nx + nb + nh; t += nwarps) {
    float s = 0.f;
    int slot;
    if (t < nx) {
      slot = 0;
      for (int j = 0; j < 4; ++j) {
        const int64_t i = t * kChunk + lane + 32 * j;
        float prod = 0.f;
        if (i < n) {
          const int64_t e = xo + i;
          const float px_old = x_old[e] - tau * Mty_old[e];
          const float px = x[e] - tau * Mty[e];
          mx[0] = nan_max(mx[0], fabsf(px - px_old));
          mx[1] = nan_max(mx[1], fabsf(px_old));
          prod = c[e] * x[e];
        }
        s = j ? s + prod : prod;
      }
    } else {
      const bool eq = t < nx + nb;
      slot = eq ? 1 : 2;
      const int64_t base = (eq ? t - nx : t - nx - nb) * kChunk;
      const int64_t len = eq ? p : m;
      for (int j = 0; j < 4; ++j) {
        const int64_t r = base + lane + 32 * j;
        float prod = 0.f;
        if (r < len) {
          const int64_t e = yo + (eq ? r : p + r);
          const float py_old = y_old[e] - sigma * Mx_old[e];
          const float py = y[e] - sigma * Mx[e];
          mx[2] = nan_max(mx[2], fabsf(py - py_old));
          mx[3] = nan_max(mx[3], fabsf(py_old));
          if (eq) {
            mx[4] = nan_max(mx[4], fabsf(Mx[e] - bb[r]));
            prod = bb[r] * y[e];
          } else {
            mx[5] = nan_max(mx[5], Mx[e] - hb[r]);
            prod = hb[r] * y[e];
          }
        }
        s = j ? s + prod : prod;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) dots[slot] += static_cast<double>(s);
  }
  double acc[kSlots];
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[k] = static_cast<double>(mx[k]);
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[6 + k] = dots[k];
  proxsdp::block_reduce<double, kSlots, kMaxMask>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) out[inst * kSlots + k] = acc[k];
  }
}

}  // namespace

// x, x_old, Mty, Mty_old, c: (B, n); y, y_old, Mx, Mx_old: (B, p + m);
// b: (B, p); h: (B, m); tau, sigma: (B,); out: (B, 9) doubles.
extern "C" int proxsdp_residuals_batch_f64(
    const void* x, const void* x_old, const void* Mty, const void* Mty_old,
    const void* tau, const void* y, const void* y_old, const void* Mx,
    const void* Mx_old, const void* sigma, const void* b, const void* h,
    const void* c, void* out, int64_t B, int64_t n, int64_t p, int64_t m,
    void* stream) {
  if (B > 0) {
    residuals_batch_kernel<double><<<static_cast<unsigned>(B), kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(x), static_cast<const double*>(x_old),
        static_cast<const double*>(Mty), static_cast<const double*>(Mty_old),
        static_cast<const double*>(tau), static_cast<const double*>(y),
        static_cast<const double*>(y_old), static_cast<const double*>(Mx),
        static_cast<const double*>(Mx_old), static_cast<const double*>(sigma),
        static_cast<const double*>(b), static_cast<const double*>(h),
        static_cast<const double*>(c), static_cast<double*>(out), n, p, m);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int proxsdp_residuals_batch_f32(
    const void* x, const void* x_old, const void* Mty, const void* Mty_old,
    const void* tau, const void* y, const void* y_old, const void* Mx,
    const void* Mx_old, const void* sigma, const void* b, const void* h,
    const void* c, void* out, int64_t B, int64_t n, int64_t p, int64_t m,
    void* stream) {
  if (B > 0) {
    residuals_batch_f32_kernel<<<static_cast<unsigned>(B), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(x_old),
        static_cast<const float*>(Mty), static_cast<const float*>(Mty_old),
        static_cast<const float*>(tau), static_cast<const float*>(y),
        static_cast<const float*>(y_old), static_cast<const float*>(Mx),
        static_cast<const float*>(Mx_old), static_cast<const float*>(sigma),
        static_cast<const float*>(b), static_cast<const float*>(h),
        static_cast<const float*>(c), static_cast<double*>(out), n, p, m);
  }
  return static_cast<int>(cudaGetLastError());
}
