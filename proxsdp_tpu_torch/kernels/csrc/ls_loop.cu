// K15 and K15b: the Malitsky-Pock linesearch's whole trial loop in one
// launch.
//
// Replaces: the lax.while_loop of proxsdp_tpu/solver.py:436-482
// (_linesearch; K15) and its vmap over a batch of instances,
// proxsdp_tpu/parallel/batch.py:141 (K15b).  From the state's primal step
// tau, its old step tau_old, theta and beta, ps = tau sqrt(1 + theta) and,
// for each trial until one is accepted or max_steps have run:
//   theta  = ps / tau_old,  bp = beta ps
//   y_temp = the dual update with the box projection (K2's rows)
//   Mty    = M' y_temp                        (K1 / K14 / a dense M')
//   accept = sqrt(beta) ps ||Mty - Mty_old|| <= delta ||y_temp - y_old||
//   ps     = accept ? ps : ps * decay
// Outputs: the last trial's y_temp, Mty and theta, the final ps and the
// number of trials.  The host reads nothing inside the loop: the port's
// host loop (kernels.linesearch_loop_plain) launched K2, the product and
// sq_dist and read one accept flag per trial.
//
// Every value is computed as that three-kernel sequence computes it
// (-fmad=false, the same expressions), and every sum in its order: the
// squared distances over the same 256-element virtual blocks as
// reduce.cuh's pass-1 grid (reduce_grid of the vector's length), each
// partial folded as finalize_kernel folds them.  So in f64 (and in f32)
// the result equals the sequence's bit for bit.  The product's order is
// K1's (one output, terms in table order), K14's (a warp per column
// segment, lane-strided, then a shuffle tree) or, for a dense M, the rows
// in order, a column per thread.
//
// Bound on the H100: device-memory bytes.  A trial reads y, Mx, Mx_old,
// y_old, b, h and writes y_temp (p + m rows), reads the operator's column
// tables (or the dense matrix) and the gathered y_temp, writes Mty and
// reads Mty_old (n); at the max-cut side 250 (n = 62,500, p = 250) about
// 1.6 MB in f64, 0.5 us at 3.35 TB/s.  The sequence it replaces paid four
// launches and a host read per trial; this kernel pays two or three grid
// barriers per trial.
//
// K15 design: one cooperative launch of the co-resident blocks (at most
// two per SM, no more than the largest phase needs).  Per trial: the dual
// update over the virtual blocks of p + m -> a grid barrier -> every
// block folds the dual distance; the product and its squared distance
// over the virtual blocks of n (ELL, dense; COO first writes Mty a warp
// per segment, then a barrier) -> a grid barrier -> every block folds the
// primal distance and takes the accept test, so every block holds the same
// bits and leaves the loop together.  Values written by another block in
// this launch are read with ld.global.cg (L2, never a stale L1 line).
//
// K15b design: one block per instance of the batch, which runs that
// instance's trials alone over its own M': the operator's values of
// instance b start at vals + b * vstride -- vstride 0 for one operator
// shared by every instance (ELL, COO or dense), the (n, width) ELL values
// or the (p + m, n) dense matrix of each instance for the per-instance
// operators of an "ell_batched" / "dense_batched" sweep
// (proxsdp_tpu/parallel/batch.py:129-136, 241-256).  K2b's rows
// and K1b's products strided over the block's threads, each squared
// distance folded by reduce.cuh's block tree (K2b's and sq_dist_batch's
// order).  The COO form (a shared CooOp, K14b's M' y) sums each column
// segment with one of the block's warps in K14's order (lane-strided,
// then the shuffle tree), a barrier, then the squared distance as the
// other forms take it.  No grid barrier: the launch ends when the last
// instance has accepted or run max_steps trials.  An inactive instance
// runs no trial and keeps its values (y, Mty, theta, tau).
#include <cooperative_groups.h>

#include "reduce.cuh"

namespace cg = cooperative_groups;

namespace {

using proxsdp::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 2;

// the operator's form: the M' product's tables
constexpr int kEll = 0;    // idx (n, width) int32, vals (n, width)
constexpr int kCoo = 1;    // ptr (n + 1) int64, idx, vals (ptr[n])
constexpr int kDense = 2;  // vals: the (p + m, n) row-major matrix

// a value written by another block during this launch
template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return __ldcg(p);
}

// the block's sum of v in reduce.cuh's tree, in every thread
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  T acc[1] = {v};
  proxsdp::block_reduce<T, 1, 0u>(acc);
  __syncthreads();  // the next call reuses block_reduce's shared buffer
  return acc[0];
}

// finalize_kernel's fold of nparts partials, in every thread
template <typename T>
__device__ T fold(const T* parts, int nparts) {
  T acc = T(0);
  for (int i = threadIdx.x; i < nparts; i += kThreads) acc += ld(parts + i);
  return block_sum(acc);
}

// K2's row i: the dual update and the box projection
template <typename T>
__device__ __forceinline__ T dual_row(int64_t i, int64_t p, const T* y,
                                      const T* Mx, const T* Mx_old,
                                      const T* b, const T* h, T bp, T theta,
                                      T one_theta) {
  const T yh = y[i] + bp * (one_theta * Mx[i] - theta * Mx_old[i]);
  const T proj = i < p ? b[i] : proxsdp::nan_min(yh / bp, h[i - p]);
  return yh - bp * proj;
}

// (M' v)[j] for ELL (K1's order) or a dense M (rows in order, from 0)
template <typename T, int F>
__device__ __forceinline__ T product(int64_t j, const int32_t* idx,
                                     const T* vals, const T* v, int64_t rows,
                                     int64_t n, int64_t width) {
  if (F == kEll) {
    const int32_t* ri = idx + j * width;
    const T* rv = vals + j * width;
    T acc = rv[0] * ld(v + ri[0]);
    for (int64_t k = 1; k < width; ++k) acc += rv[k] * ld(v + ri[k]);
    return acc;
  }
  T acc = T(0);  // no row is read where there are none (p + m = 0)
  for (int64_t r = 0; r < rows; ++r) acc += vals[r * n + j] * ld(v + r);
  return acc;
}

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
ls_loop_kernel(const T* __restrict__ y, const T* __restrict__ Mx,
               const T* __restrict__ Mx_old, const T* __restrict__ b,
               const T* __restrict__ h, const T* __restrict__ y_old,
               const T* __restrict__ Mty_old, const T* __restrict__ tau_p,
               const T* __restrict__ tau_old_p, const T* __restrict__ theta_p,
               const T* __restrict__ beta_p, const int64_t* __restrict__ ptr,
               const int32_t* __restrict__ idx, const T* __restrict__ vals,
               T* y_temp, T* Mty, T* theta_out, T* ps_out,
               int32_t* trials_out, T* part_y, T* part_m, int64_t p,
               int64_t m, int64_t n, int64_t width, int g1, int g2, T delta,
               T decay, int64_t max_steps) {
  // g1, g2: reduce_grid(p + m) and reduce_grid(n), the virtual blocks
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, lane = t & 31;
  const int64_t rows = p + m;
  const T beta = *beta_p, tau_old = *tau_old_p;
  const T sqrt_beta = sqrt(beta);
  T theta = *theta_p;
  T ps = *tau_p * sqrt(T(1) + theta);
  int32_t trials = 0;
  while (trials < max_steps) {
    theta = ps / tau_old;
    const T bp = beta * ps;
    const T one_theta = T(1) + theta;
    // ---- y_temp and its squared distance to y_old (K2)
    for (int vb = blockIdx.x; vb < g1; vb += gridDim.x) {
      T acc = T(0);
      for (int64_t i = static_cast<int64_t>(vb) * kThreads + t; i < rows;
           i += static_cast<int64_t>(g1) * kThreads) {
        const T yt = dual_row(i, p, y, Mx, Mx_old, b, h, bp, theta,
                              one_theta);
        y_temp[i] = yt;
        const T d = yt - y_old[i];
        acc += d * d;
      }
      acc = block_sum(acc);
      if (t == 0) part_y[vb] = acc;
    }
    grid.sync();
    const T dy = fold(part_y, g1);
    // ---- Mty = M' y_temp and its squared distance to Mty_old (the
    // product, then sq_dist)
    if (F == kCoo) {
      const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarps;
      for (int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + (t >> 5);
           s < n; s += nwarps) {
        const int64_t end = ptr[s + 1];
        T acc = T(0);
        for (int64_t k = ptr[s] + lane; k < end; k += 32)
          acc += vals[k] * ld(y_temp + idx[k]);
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (lane == 0) Mty[s] = acc;
      }
      grid.sync();
    }
    for (int vb = blockIdx.x; vb < g2; vb += gridDim.x) {
      T acc = T(0);
      for (int64_t j = static_cast<int64_t>(vb) * kThreads + t; j < n;
           j += static_cast<int64_t>(g2) * kThreads) {
        T v;
        if (F == kCoo) {
          v = ld(Mty + j);
        } else {
          v = product<T, F>(j, idx, vals, y_temp, rows, n, width);
          Mty[j] = v;
        }
        const T d = v - Mty_old[j];
        acc += d * d;
      }
      acc = block_sum(acc);
      if (t == 0) part_m[vb] = acc;
    }
    grid.sync();
    const T dM = fold(part_m, g2);
    ++trials;
    // the same accept test in every block: they leave the loop together
    if (sqrt_beta * ps * sqrt(dM) <= delta * sqrt(dy)) break;
    ps = ps * decay;
  }
  if (blockIdx.x == 0 && t == 0) {
    *theta_out = theta;
    *ps_out = ps;
    *trials_out = trials;
  }
}

cudaError_t cooperative(const void* fn, void** args, int64_t need,
                        cudaStream_t stream) {
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  int64_t grid = static_cast<int64_t>(nsm) *
                 (per_sm < kBlocksPerSM ? per_sm : kBlocksPerSM);
  if (need < grid) grid = need < 1 ? 1 : need;
  return cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(grid)),
                                     dim3(kThreads), args, 0, stream);
}

template <typename T, int F>
int launch_form(const void* y, const void* Mx, const void* Mx_old,
                const void* b, const void* h, const void* y_old,
                const void* Mty_old, const void* tau, const void* tau_old,
                const void* theta, const void* beta, const void* ptr,
                const void* idx, const void* vals, void* y_temp, void* Mty,
                void* theta_out, void* ps_out, void* trials, void* part_y,
                void* part_m, int64_t p, int64_t m, int64_t n, int64_t width,
                double delta, double decay, int64_t max_steps,
                void* stream) {
  const T *y_ = static_cast<const T*>(y), *Mx_ = static_cast<const T*>(Mx),
          *Mxo_ = static_cast<const T*>(Mx_old),
          *b_ = static_cast<const T*>(b), *h_ = static_cast<const T*>(h),
          *yo_ = static_cast<const T*>(y_old),
          *Mtyo_ = static_cast<const T*>(Mty_old),
          *tau_ = static_cast<const T*>(tau),
          *tauo_ = static_cast<const T*>(tau_old),
          *th_ = static_cast<const T*>(theta),
          *beta_ = static_cast<const T*>(beta),
          *vals_ = static_cast<const T*>(vals);
  const int64_t* ptr_ = static_cast<const int64_t*>(ptr);
  const int32_t* idx_ = static_cast<const int32_t*>(idx);
  T *yt_ = static_cast<T*>(y_temp), *Mty_ = static_cast<T*>(Mty),
    *tho_ = static_cast<T*>(theta_out), *pso_ = static_cast<T*>(ps_out),
    *py_ = static_cast<T*>(part_y), *pm_ = static_cast<T*>(part_m);
  int32_t* tr_ = static_cast<int32_t*>(trials);
  T delta_ = static_cast<T>(delta), decay_ = static_cast<T>(decay);
  int g1 = proxsdp::reduce_grid(p + m), g2 = proxsdp::reduce_grid(n);
  void* args[] = {&y_,   &Mx_,  &Mxo_,  &b_,     &h_,    &yo_,   &Mtyo_,
                  &tau_, &tauo_, &th_,  &beta_,  &ptr_,  &idx_,  &vals_,
                  &yt_,  &Mty_, &tho_,  &pso_,   &tr_,   &py_,   &pm_,
                  &p,    &m,    &n,     &width,  &g1,    &g2,    &delta_,
                  &decay_, &max_steps};
  int64_t need = g1 > g2 ? g1 : g2;
  if (F == kCoo && (n + kWarps - 1) / kWarps > need)
    need = (n + kWarps - 1) / kWarps;
  cudaError_t err = cooperative(
      reinterpret_cast<const void*>(ls_loop_kernel<T, F>), args, need,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* y, const void* Mx, const void* Mx_old, const void* b,
           const void* h, const void* y_old, const void* Mty_old,
           const void* tau, const void* tau_old, const void* theta,
           const void* beta, const void* ptr, const void* idx,
           const void* vals, void* y_temp, void* Mty, void* theta_out,
           void* ps_out, void* trials, void* part_y, void* part_m, int64_t p,
           int64_t m, int64_t n, int64_t width, int64_t form,
           int64_t max_steps, double delta, double decay, void* stream) {
#define PROXSDP_LS_FORM(F)                                                  \
  return launch_form<T, F>(y, Mx, Mx_old, b, h, y_old, Mty_old, tau,       \
                           tau_old, theta, beta, ptr, idx, vals, y_temp,    \
                           Mty, theta_out, ps_out, trials, part_y, part_m,  \
                           p, m, n, width, delta, decay, max_steps, stream)
  switch (form) {
    case kEll:
      PROXSDP_LS_FORM(kEll);
    case kCoo:
      PROXSDP_LS_FORM(kCoo);
    case kDense:
      PROXSDP_LS_FORM(kDense);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PROXSDP_LS_FORM
}

// ---- K15b: the batch (one block per instance)

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
ls_loop_batch_kernel(const T* __restrict__ y, const T* __restrict__ Mx,
                     const T* __restrict__ Mx_old, const T* __restrict__ b,
                     const T* __restrict__ h, const T* __restrict__ y_old,
                     const T* __restrict__ Mty_in,
                     const T* __restrict__ Mty_old,
                     const T* __restrict__ tau_p,
                     const T* __restrict__ tau_old_p,
                     const T* __restrict__ theta_p,
                     const T* __restrict__ beta_p,
                     const bool* __restrict__ active,
                     const int64_t* __restrict__ ptr,
                     const int32_t* __restrict__ idx,
                     const T* __restrict__ vals, T* y_temp, T* Mty,
                     T* theta_out, T* ps_out, int32_t* trials_out, int64_t p,
                     int64_t m, int64_t n, int64_t width, int64_t vstride,
                     T delta, T decay, int64_t max_steps) {
  const int64_t inst = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t rows = p + m;
  const T* yi = y + inst * rows;
  const T* Mxi = Mx + inst * rows;
  const T* Mxoi = Mx_old + inst * rows;
  const T* yoi = y_old + inst * rows;
  const T* bi = b + inst * p;
  const T* hi = h + inst * m;
  const T* Mtyoi = Mty_old + inst * n;
  T* yti = y_temp + inst * rows;
  T* Mtyi = Mty + inst * n;
  const T* valsi = vals + inst * vstride;
  if (!active[inst]) {  // no trial: the instance keeps its values
    for (int64_t i = t; i < rows; i += kThreads) yti[i] = yi[i];
    for (int64_t j = t; j < n; j += kThreads) Mtyi[j] = Mty_in[inst * n + j];
    if (t == 0) {
      theta_out[inst] = theta_p[inst];
      ps_out[inst] = tau_p[inst];
      trials_out[inst] = 0;
    }
    return;
  }
  const T beta = beta_p[inst], tau_old = tau_old_p[inst];
  const T sqrt_beta = sqrt(beta);
  T theta = theta_p[inst];
  T ps = tau_p[inst] * sqrt(T(1) + theta);
  int32_t trials = 0;
  while (trials < max_steps) {
    theta = ps / tau_old;
    const T bp = beta * ps;
    const T one_theta = T(1) + theta;
    T acc = T(0);
    for (int64_t i = t; i < rows; i += kThreads) {
      const T yt = dual_row(i, p, yi, Mxi, Mxoi, bi, hi, bp, theta,
                            one_theta);
      yti[i] = yt;
      const T d = yt - yoi[i];
      acc += d * d;
    }
    // block_sum's barriers also make y_temp visible to the whole block
    const T dy = block_sum(acc);
    if (F == kCoo) {  // K14's column segments, a warp each
      const int lane = t & 31;
      for (int64_t s = t >> 5; s < n; s += kWarps) {
        const int64_t end = ptr[s + 1];
        T a = T(0);
        for (int64_t k = ptr[s] + lane; k < end; k += 32)
          a += valsi[k] * ld(yti + idx[k]);
        for (int off = 16; off > 0; off >>= 1)
          a += __shfl_down_sync(0xffffffffu, a, off);
        if (lane == 0) Mtyi[s] = a;
      }
      __syncthreads();  // every segment's sum before the distance
    }
    acc = T(0);
    for (int64_t j = t; j < n; j += kThreads) {
      T v;
      if (F == kCoo) {
        v = ld(Mtyi + j);
      } else {
        v = product<T, F>(j, idx, valsi, yti, rows, n, width);
        Mtyi[j] = v;
      }
      const T d = v - Mtyoi[j];
      acc += d * d;
    }
    const T dM = block_sum(acc);
    ++trials;
    if (sqrt_beta * ps * sqrt(dM) <= delta * sqrt(dy)) break;
    ps = ps * decay;
  }
  if (t == 0) {
    theta_out[inst] = theta;
    ps_out[inst] = ps;
    trials_out[inst] = trials;
  }
}

template <typename T, int F>
void launch_batch_form(const void* y, const void* Mx, const void* Mx_old,
                       const void* b, const void* h, const void* y_old,
                       const void* Mty_in, const void* Mty_old,
                       const void* tau, const void* tau_old,
                       const void* theta, const void* beta,
                       const void* active, const void* ptr, const void* idx,
                       const void* vals, void* y_temp, void* Mty,
                       void* theta_out, void* ps_out, void* trials, int64_t B,
                       int64_t p, int64_t m, int64_t n, int64_t width,
                       int64_t vstride, double delta, double decay,
                       int64_t max_steps, cudaStream_t stream) {
  ls_loop_batch_kernel<T, F><<<static_cast<unsigned>(B), kThreads, 0,
                               stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(Mx),
      static_cast<const T*>(Mx_old), static_cast<const T*>(b),
      static_cast<const T*>(h), static_cast<const T*>(y_old),
      static_cast<const T*>(Mty_in), static_cast<const T*>(Mty_old),
      static_cast<const T*>(tau), static_cast<const T*>(tau_old),
      static_cast<const T*>(theta), static_cast<const T*>(beta),
      static_cast<const bool*>(active), static_cast<const int64_t*>(ptr),
      static_cast<const int32_t*>(idx),
      static_cast<const T*>(vals), static_cast<T*>(y_temp),
      static_cast<T*>(Mty), static_cast<T*>(theta_out),
      static_cast<T*>(ps_out), static_cast<int32_t*>(trials), p, m, n, width,
      vstride, static_cast<T>(delta), static_cast<T>(decay), max_steps);
}

template <typename T>
int launch_batch(const void* y, const void* Mx, const void* Mx_old,
                 const void* b, const void* h, const void* y_old,
                 const void* Mty_in, const void* Mty_old, const void* tau,
                 const void* tau_old, const void* theta, const void* beta,
                 const void* active, const void* ptr, const void* idx,
                 const void* vals, void* y_temp, void* Mty, void* theta_out,
                 void* ps_out, void* trials, int64_t B, int64_t p, int64_t m,
                 int64_t n, int64_t width, int64_t vstride, int64_t form,
                 int64_t max_steps, double delta, double decay,
                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PROXSDP_LS_BATCH_FORM(F)                                             \
  launch_batch_form<T, F>(y, Mx, Mx_old, b, h, y_old, Mty_in, Mty_old, tau,  \
                          tau_old, theta, beta, active, ptr, idx, vals,      \
                          y_temp, Mty, theta_out, ps_out, trials, B, p, m,   \
                          n, width, vstride, delta, decay, max_steps, s)
  if (B > 0) {
    switch (form) {
      case kEll:
        PROXSDP_LS_BATCH_FORM(kEll);
        break;
      case kCoo:
        PROXSDP_LS_BATCH_FORM(kCoo);
        break;
      case kDense:
        PROXSDP_LS_BATCH_FORM(kDense);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef PROXSDP_LS_BATCH_FORM
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K15.  y, Mx, Mx_old, y_old, y_temp: p + m; b: p; h: m; Mty_old, Mty: n;
// tau, tau_old, theta, beta, theta_out, ps_out: one value each; trials:
// one int32; part_y, part_m: reduce_grid(p + m) and reduce_grid(n) values
// of scratch.  form: 0 ELL (idx, vals: the (n, width) column tables), 1
// COO (ptr: n + 1 int64 column starts; idx, vals: the column-sorted
// triplets), 2 dense (vals: the (p + m, n) matrix).  max_steps >= 1.
#define PROXSDP_LS_ENTRY(SFX, T)                                             \
  extern "C" int proxsdp_linesearch_loop_##SFX(                             \
      const void* y, const void* Mx, const void* Mx_old, const void* b,     \
      const void* h, const void* y_old, const void* Mty_old,                \
      const void* tau, const void* tau_old, const void* theta,              \
      const void* beta, const void* ptr, const void* idx, const void* vals, \
      void* y_temp, void* Mty, void* theta_out, void* ps_out, void* trials, \
      void* part_y, void* part_m, int64_t p, int64_t m, int64_t n,          \
      int64_t width, int64_t form, int64_t max_steps, double delta,         \
      double decay, void* stream) {                                         \
    return launch<T>(y, Mx, Mx_old, b, h, y_old, Mty_old, tau, tau_old,     \
                     theta, beta, ptr, idx, vals, y_temp, Mty, theta_out,   \
                     ps_out, trials, part_y, part_m, p, m, n, width, form,  \
                     max_steps, delta, decay, stream);                      \
  }
PROXSDP_LS_ENTRY(f64, double)
PROXSDP_LS_ENTRY(f32, float)
#undef PROXSDP_LS_ENTRY

// K15b.  Rows of B instances: y, Mx, Mx_old, y_old, y_temp (B, p + m); b
// (B, p); h (B, m); Mty_in, Mty_old, Mty (B, n); tau, tau_old, theta, beta,
// theta_out, ps_out (B,); active (B,) bool; trials (B,) int32.  form: 0
// ELL (idx: the shared (n, width) column indices; vals: their values), 1
// COO (ptr: n + 1 int64 column starts; idx, vals: the column-sorted
// triplets) or 2 dense (vals: the (p + m, n) matrix).  vals holds one
// operator's values (vstride 0) or B of them, instance b's at vals + b *
// vstride.  max_steps >= 1.
#define PROXSDP_LS_BATCH_ENTRY(SFX, T)                                       \
  extern "C" int proxsdp_linesearch_loop_batch_##SFX(                       \
      const void* y, const void* Mx, const void* Mx_old, const void* b,     \
      const void* h, const void* y_old, const void* Mty_in,                 \
      const void* Mty_old, const void* tau, const void* tau_old,            \
      const void* theta, const void* beta, const void* active,              \
      const void* ptr, const void* idx, const void* vals, void* y_temp,     \
      void* Mty, void* theta_out, void* ps_out, void* trials, int64_t B,    \
      int64_t p, int64_t m, int64_t n, int64_t width, int64_t vstride,      \
      int64_t form, int64_t max_steps, double delta, double decay,          \
      void* stream) {                                                       \
    return launch_batch<T>(y, Mx, Mx_old, b, h, y_old, Mty_in, Mty_old,     \
                           tau, tau_old, theta, beta, active, ptr, idx,     \
                           vals, y_temp, Mty, theta_out, ps_out, trials, B, \
                           p, m, n, width, vstride, form, max_steps, delta, \
                           decay, stream);                                  \
  }
PROXSDP_LS_BATCH_ENTRY(f64, double)
PROXSDP_LS_BATCH_ENTRY(f32, float)
#undef PROXSDP_LS_BATCH_ENTRY
