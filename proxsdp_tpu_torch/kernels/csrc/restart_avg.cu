// K20: the adaptive restart-to-average, split around K19 (control.cu).
//
// Replaces: proxsdp_tpu/solver.py:809-897 (the restart-to-average of
// _control) and parallel/batch.py:141's vmap of it.
//
// K20a (proxsdp_restart_average_*, before K19) forms the new running sums
//   avg_x' = avg_x + tau x,   avg_Mty' = avg_Mty + tau Mty,
//   avg_y' = avg_y + tau y,   avg_Mx'  = avg_Mx  + tau Mx
// into fresh outputs, and in the same pass the reductions K19's restart
// test reads, over the average v_bar = avg' / wsum with
// wsum = clamp_min(avg_w + tau, 1e-30) (in the program's dtype):
//   red[0] = c . x_bar          red[1] = b . y_bar[:p]
//   red[2] = h . y_bar[p:]      red[3] = max |Mx_bar[:p] - b|
//   red[4] = max (Mx_bar[p:] - h)
// as f64 partials: the dots sum exact f64 products of the program-dtype
// factors in reduce.cuh's fixed order (so an f32 program's dots are more
// accurate than the plain twin's f32 torch.dot, within 1e-6 of it); the
// maxima are program-dtype values (exact in any order, NaN propagated).
// One instance: a grid-stride pass over reduce_grid(max(n, p + m))
// blocks writing one partial row a block, which K19 folds with
// finalize_kernel's order.  A batch: a CTA an instance, its row the folded
// values.
//
// K20b (proxsdp_restart_adopt_*, after K19) reads K19's stalled flag and
// wsum: where stalled, x = avg_x' / wsum (and y, Mx, Mty alike) and every
// sum times keep = 0; elsewhere the iterate and the sums stand.  It writes
// fresh outputs (x, Mty, avg_x, avg_Mty) and (y, Mx, avg_y, avg_Mx), as
// the plain twin does: after _residuals_and_gap x_old is x (one tensor),
// and a batch step keeps its input state for the freeze, so nothing is
// written in place.
//
// Bound on the H100: device-memory bytes.  K20a reads 4 iterates, 4 sums
// and c, b, h and writes 4 sums: ~13 values a primal entry, ~4 MB at the
// side-250 max-cut in f64 (~1.2 us at 3.35 TB/s); K20b reads 8 and writes
// 8 vectors (~4 MB, ~1.2 us).  Both are elementwise passes at full
// coalescing; the launch dominates below side ~1000.
#include "reduce.cuh"

namespace {

using proxsdp::kThreads;
using proxsdp::nan_max;

constexpr int kSlots = 5;
constexpr unsigned kMaxMask = 0x18u;  // slots 3, 4 are maxima

__device__ __forceinline__ float tabs(float a) { return fabsf(a); }
__device__ __forceinline__ double tabs(double a) { return fabs(a); }

template <typename T, bool Batched>
__global__ void __launch_bounds__(kThreads) restart_average_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ Mx,
    const T* __restrict__ Mty, const T* __restrict__ avg_x,
    const T* __restrict__ avg_y, const T* __restrict__ avg_Mx,
    const T* __restrict__ avg_Mty, const T* __restrict__ avg_w,
    const T* __restrict__ ps, const T* __restrict__ c,
    const T* __restrict__ b, const T* __restrict__ h, T* __restrict__ out_x,
    T* __restrict__ out_y, double* __restrict__ partials, int64_t B,
    int64_t n, int64_t p, int64_t m) {
  const int64_t pm = p + m;
  const int64_t inst = Batched ? blockIdx.x : 0;
  const int64_t start = Batched ? threadIdx.x
                                : static_cast<int64_t>(blockIdx.x) * kThreads +
                                      threadIdx.x;
  const int64_t stride = Batched ? kThreads
                                 : static_cast<int64_t>(gridDim.x) * kThreads;
  const T tau = ps[inst];
  T wsum = avg_w[inst] + tau;
  const T wfloor = static_cast<T>(1e-30);
  wsum = wsum < wfloor ? wfloor : wsum;  // clamp_min, NaN kept
  const int64_t xo = inst * n, yo = inst * pm;
  double acc[kSlots] = {0.0, 0.0, 0.0, -INFINITY, -INFINITY};
  const int64_t N = n > pm ? n : pm;
  for (int64_t i = start; i < N; i += stride) {
    if (i < n) {
      const T ax = avg_x[xo + i] + tau * x[xo + i];
      const T amty = avg_Mty[xo + i] + tau * Mty[xo + i];
      out_x[xo + i] = ax;
      out_x[B * n + xo + i] = amty;
      const T xb = ax / wsum;
      acc[0] += static_cast<double>(c[xo + i]) * static_cast<double>(xb);
    }
    if (i < pm) {
      const T ay = avg_y[yo + i] + tau * y[yo + i];
      const T amx = avg_Mx[yo + i] + tau * Mx[yo + i];
      out_y[yo + i] = ay;
      out_y[B * pm + yo + i] = amx;
      const T yb = ay / wsum, mb = amx / wsum;
      if (i < p) {
        const T bi = b[inst * p + i];
        acc[1] += static_cast<double>(bi) * static_cast<double>(yb);
        acc[3] = nan_max(acc[3], static_cast<double>(tabs(mb - bi)));
      } else {
        const T hi = h[inst * m + (i - p)];
        acc[2] += static_cast<double>(hi) * static_cast<double>(yb);
        acc[4] = nan_max(acc[4], static_cast<double>(mb - hi));
      }
    }
  }
  proxsdp::block_reduce<double, kSlots, kMaxMask>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      partials[static_cast<int64_t>(blockIdx.x) * kSlots + k] = acc[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) restart_adopt_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ Mx,
    const T* __restrict__ Mty, const T* __restrict__ avg_x,
    const T* __restrict__ avg_y, const T* __restrict__ avg_Mx,
    const T* __restrict__ avg_Mty, const T* __restrict__ wsum,
    const int* __restrict__ stalled, T* __restrict__ ox, T* __restrict__ oy,
    int64_t B, int64_t n, int64_t pm) {
  const int64_t nx = B * n, ny = B * pm;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < nx + ny; i += stride) {
    if (i < nx) {
      const int64_t inst = i / n;
      const bool st = stalled[inst] != 0;
      const T keep = st ? static_cast<T>(0.0) : static_cast<T>(1.0);
      const T w = wsum[inst];
      ox[i] = st ? avg_x[i] / w : x[i];
      ox[nx + i] = st ? avg_Mty[i] / w : Mty[i];
      ox[2 * nx + i] = avg_x[i] * keep;
      ox[3 * nx + i] = avg_Mty[i] * keep;
    } else {
      const int64_t j = i - nx;
      const int64_t inst = j / pm;
      const bool st = stalled[inst] != 0;
      const T keep = st ? static_cast<T>(0.0) : static_cast<T>(1.0);
      const T w = wsum[inst];
      oy[j] = st ? avg_y[j] / w : y[j];
      oy[ny + j] = st ? avg_Mx[j] / w : Mx[j];
      oy[2 * ny + j] = avg_y[j] * keep;
      oy[3 * ny + j] = avg_Mx[j] * keep;
    }
  }
}

template <typename T, bool Batched>
int launch_average(const void* x, const void* y, const void* Mx,
                   const void* Mty, const void* avg_x, const void* avg_y,
                   const void* avg_Mx, const void* avg_Mty, const void* avg_w,
                   const void* ps, const void* c, const void* b, const void* h,
                   void* out_x, void* out_y, void* partials, int64_t B,
                   int64_t n, int64_t p, int64_t m, void* stream) {
  const int64_t N = n > p + m ? n : p + m;
  const int grid = Batched ? static_cast<int>(B) : proxsdp::reduce_grid(N);
  if (grid > 0) {
    restart_average_kernel<T, Batched>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<const T*>(y),
            static_cast<const T*>(Mx), static_cast<const T*>(Mty),
            static_cast<const T*>(avg_x), static_cast<const T*>(avg_y),
            static_cast<const T*>(avg_Mx), static_cast<const T*>(avg_Mty),
            static_cast<const T*>(avg_w), static_cast<const T*>(ps),
            static_cast<const T*>(c), static_cast<const T*>(b),
            static_cast<const T*>(h), static_cast<T*>(out_x),
            static_cast<T*>(out_y), static_cast<double*>(partials), B, n, p,
            m);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_adopt(const void* x, const void* y, const void* Mx, const void* Mty,
                 const void* avg_x, const void* avg_y, const void* avg_Mx,
                 const void* avg_Mty, const void* wsum, const void* stalled,
                 void* ox, void* oy, int64_t B, int64_t n, int64_t pm,
                 void* stream) {
  const int64_t total = B * (n + pm);
  int64_t grid = (total + kThreads - 1) / kThreads;
  if (grid > 4096) grid = 4096;
  if (grid > 0) {
    restart_adopt_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const T*>(Mx), static_cast<const T*>(Mty),
        static_cast<const T*>(avg_x), static_cast<const T*>(avg_y),
        static_cast<const T*>(avg_Mx), static_cast<const T*>(avg_Mty),
        static_cast<const T*>(wsum), static_cast<const int*>(stalled),
        static_cast<T*>(ox), static_cast<T*>(oy), B, n, pm);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K20a.  x, Mty, avg_x, avg_Mty, c: (B, n); y, Mx, avg_y, avg_Mx: (B, p + m);
// b: (B, p); h: (B, m); avg_w, ps: (B,) (0-d for one instance, B = 1);
// out_x: (2, B, n) = [avg_x', avg_Mty']; out_y: (2, B, p + m) = [avg_y',
// avg_Mx']; partials: (reduce_grid(max(n, p + m)), 5) f64 for one
// instance, (B, 5) for a batch.
#define PROXSDP_AVERAGE(NAME, T, BATCHED)                                    \
  extern "C" int NAME(const void* x, const void* y, const void* Mx,          \
                      const void* Mty, const void* avg_x, const void* avg_y, \
                      const void* avg_Mx, const void* avg_Mty,               \
                      const void* avg_w, const void* ps, const void* c,      \
                      const void* b, const void* h, void* out_x,             \
                      void* out_y, void* partials, int64_t B, int64_t n,     \
                      int64_t p, int64_t m, void* stream) {                  \
    return launch_average<T, BATCHED>(x, y, Mx, Mty, avg_x, avg_y, avg_Mx,   \
                                      avg_Mty, avg_w, ps, c, b, h, out_x,    \
                                      out_y, partials, B, n, p, m, stream);  \
  }
PROXSDP_AVERAGE(proxsdp_restart_average_f64, double, false)
PROXSDP_AVERAGE(proxsdp_restart_average_f32, float, false)
PROXSDP_AVERAGE(proxsdp_restart_average_batch_f64, double, true)
PROXSDP_AVERAGE(proxsdp_restart_average_batch_f32, float, true)

// K20b.  stalled: (B,) int32 and wsum: (B,) from K19; ox: (4, B, n) =
// [x, Mty, avg_x, avg_Mty]; oy: (4, B, p + m) = [y, Mx, avg_y, avg_Mx].
#define PROXSDP_ADOPT(NAME, T)                                               \
  extern "C" int NAME(const void* x, const void* y, const void* Mx,          \
                      const void* Mty, const void* avg_x, const void* avg_y, \
                      const void* avg_Mx, const void* avg_Mty,               \
                      const void* wsum, const void* stalled, void* ox,       \
                      void* oy, int64_t B, int64_t n, int64_t pm,            \
                      void* stream) {                                        \
    return launch_adopt<T>(x, y, Mx, Mty, avg_x, avg_y, avg_Mx, avg_Mty,     \
                           wsum, stalled, ox, oy, B, n, pm, stream);         \
  }
PROXSDP_ADOPT(proxsdp_restart_adopt_f64, double)
PROXSDP_ADOPT(proxsdp_restart_adopt_f32, float)
PROXSDP_ADOPT(proxsdp_restart_adopt_batch_f64, double)
PROXSDP_ADOPT(proxsdp_restart_adopt_batch_f32, float)
