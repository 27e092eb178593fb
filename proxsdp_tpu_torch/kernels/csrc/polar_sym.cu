// K6: the elementwise and reduction work around K5's products in a polar
// (Newton-Schulz) PSD projection.
//
// Replaces, in proxsdp_tpu/ops/cones.py:polar_psd (62-109) and
// polar_reseed (265-314):
//   fro_scale:  Xc = X.astype(ct); Y = Xc / (||Xc||_F + 1e-30)      (85-86)
//   sym:        S = 0.5 * (Y + Y^T)                                  (94)
//   sym_guard:  Xp = 0.5 * (P + P^T) cast to the output type, then the
//               finite guard and the rank rule                  (96-109)
//                 bad  = any(!isfinite(Xp))
//                 Xp   = bad ? X : Xp
//                 rank = bad ? side : clip(round(0.5 * (side + tr S)), 0, side)
// with ct the compute type (f32 in the race, and in the f64 polish's
// f32-compute reseed, where fro_scale also writes the f32 copy Xc of the
// f64 X that K5's projection product reads).
//
// Bound on the H100: device-memory bytes, ~4 bytes per entry per pass at
// f32 (0.25 MB per side-250 matrix, ~0.1 us at 3.35 TB/s): launches
// dominate.  Design: the sums are the deterministic two-pass reductions of
// reduce.cuh, but the second pass is folded into the kernel that consumes
// the sum -- every block of the scaling pass folds the same partials in
// the same order, so all blocks see the same bits and no third launch is
// needed.  The transposes go through K4's 32 x 33 shared-memory tiles, so
// the row and the mirrored read are both coalesced.  The guard is a
// per-tile flag pass plus one small pass that folds the flags, writes the
// rank and, only if a value was not finite, copies X over Xp.
#include "reduce.cuh"

namespace {

using proxsdp::kThreads;

constexpr int kTile = 32;
constexpr int kRows = 8;  // blockDim = (kTile, kRows)

// ---- fro_scale, pass 1: per-block sums of squares in the compute type
template <typename In, typename Ct>
__global__ void sumsq_kernel(const In* __restrict__ x, Ct* __restrict__ partials,
                             int64_t n) {
  Ct acc[1] = {Ct(0)};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const Ct v = static_cast<Ct>(x[i]);
    acc[0] += v * v;
  }
  proxsdp::block_reduce<Ct, 1, 0u>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc[0];
}

// ---- fro_scale, pass 2: fold the partials (same order in every block),
// then Y = Xc / (sqrt(sum) + 1e-30); xc (may be null) gets the cast copy
template <typename In, typename Ct>
__global__ void scale_kernel(const In* __restrict__ x,
                             const Ct* __restrict__ partials, int nparts,
                             Ct* __restrict__ y, Ct* __restrict__ xc,
                             int64_t n) {
  __shared__ Ct s_scale;
  Ct acc[1] = {Ct(0)};
  for (int i = threadIdx.x; i < nparts; i += kThreads) acc[0] += partials[i];
  proxsdp::block_reduce<Ct, 1, 0u>(acc);
  if (threadIdx.x == 0) s_scale = sqrt(acc[0]) + static_cast<Ct>(1e-30);
  __syncthreads();
  const Ct s = s_scale;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const Ct v = static_cast<Ct>(x[i]);
    y[i] = v / s;
    if (xc) xc[i] = v;
  }
}

// ---- sym: S = 0.5 * (Y + Y^T) through a transposed shared tile
template <typename T>
__global__ void sym_kernel(const T* __restrict__ y, T* __restrict__ s,
                           int64_t side) {
  __shared__ T tile[kTile][kTile + 1];
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int tx = threadIdx.x;
  for (int k = threadIdx.y; k < kTile; k += kRows) {
    const int64_t r = c0 + k, col = r0 + tx;
    if (r < side && col < side) tile[k][tx] = y[r * side + col];
  }
  __syncthreads();
  for (int k = threadIdx.y; k < kTile; k += kRows) {
    const int64_t r = r0 + k, col = c0 + tx;
    if (r < side && col < side) {
      const int64_t q = r * side + col;
      s[q] = T(0.5) * (y[q] + tile[tx][k]);
    }
  }
}

// ---- sym_guard, pass 1: Xp = (Out)(0.5 * (P + P^T)), one finite flag per
// tile (1 = a value of this tile is not finite)
template <typename Ct, typename Out>
__global__ void sym_flag_kernel(const Ct* __restrict__ p, Out* __restrict__ xp,
                                int* __restrict__ flags, int64_t side) {
  __shared__ Ct tile[kTile][kTile + 1];
  __shared__ int s_bad;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int tx = threadIdx.x;
  if (tx == 0 && threadIdx.y == 0) s_bad = 0;
  for (int k = threadIdx.y; k < kTile; k += kRows) {
    const int64_t r = c0 + k, col = r0 + tx;
    if (r < side && col < side) tile[k][tx] = p[r * side + col];
  }
  __syncthreads();
  int bad = 0;
  for (int k = threadIdx.y; k < kTile; k += kRows) {
    const int64_t r = r0 + k, col = c0 + tx;
    if (r < side && col < side) {
      const int64_t q = r * side + col;
      const Out v = static_cast<Out>(Ct(0.5) * (p[q] + tile[tx][k]));
      xp[q] = v;
      bad |= !isfinite(v);
    }
  }
  if (bad) atomicOr(&s_bad, 1);  // an OR: the order of arrival is irrelevant
  __syncthreads();
  if (tx == 0 && threadIdx.y == 0)
    flags[static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x] = s_bad;
}

// ---- sym_guard, pass 2: fold the flags; block 0 writes the rank and the
// flag; if a value was not finite every block copies its slice of X to Xp
template <typename Ct, typename Out>
__global__ void guard_kernel(const int* __restrict__ flags, int nflags,
                             const Ct* __restrict__ s, const Out* __restrict__ x,
                             Out* __restrict__ xp, int* __restrict__ rank,
                             unsigned char* __restrict__ bad_out,
                             int64_t side) {
  __shared__ int s_bad;
  if (threadIdx.x == 0) s_bad = 0;
  __syncthreads();
  int any = 0;
  for (int i = threadIdx.x; i < nflags; i += kThreads) any |= flags[i];
  if (any) atomicOr(&s_bad, 1);
  __syncthreads();
  const int bad = s_bad;
  if (blockIdx.x == 0) {
    Ct acc[1] = {Ct(0)};
    for (int64_t i = threadIdx.x; i < side; i += kThreads) acc[0] += s[i * side + i];
    proxsdp::block_reduce<Ct, 1, 0u>(acc);
    if (threadIdx.x == 0) {
      const Ct half = Ct(0.5) * (static_cast<Ct>(side) + acc[0]);
      Ct r = rint(half);  // round half to even, as jnp.round
      r = r < Ct(0) ? Ct(0) : (r > static_cast<Ct>(side) ? static_cast<Ct>(side) : r);
      *rank = bad ? static_cast<int>(side) : static_cast<int>(r);
      *bad_out = static_cast<unsigned char>(bad);
    }
  }
  if (!bad) return;
  const int64_t n = side * side;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    xp[i] = x[i];
}

dim3 tile_grid(int64_t side) {
  const unsigned nt = static_cast<unsigned>((side + kTile - 1) / kTile);
  return dim3(nt, nt);
}

template <typename In, typename Ct>
int launch_fro_scale(const void* x, void* partials, void* y, void* xc,
                     int64_t n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = proxsdp::reduce_grid(n);
  sumsq_kernel<In, Ct><<<grid, kThreads, 0, st>>>(
      static_cast<const In*>(x), static_cast<Ct*>(partials), n);
  scale_kernel<In, Ct><<<grid, kThreads, 0, st>>>(
      static_cast<const In*>(x), static_cast<const Ct*>(partials), grid,
      static_cast<Ct*>(y), static_cast<Ct*>(xc), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sym(const void* y, void* s, int64_t side, void* stream) {
  sym_kernel<T><<<tile_grid(side), dim3(kTile, kRows), 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<T*>(s), side);
  return static_cast<int>(cudaGetLastError());
}

template <typename Ct, typename Out>
int launch_sym_guard(const void* p, const void* s, const void* x, void* xp,
                     void* flags, void* rank, void* bad, int64_t side,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 g = tile_grid(side);
  sym_flag_kernel<Ct, Out><<<g, dim3(kTile, kRows), 0, st>>>(
      static_cast<const Ct*>(p), static_cast<Out*>(xp),
      static_cast<int*>(flags), side);
  guard_kernel<Ct, Out><<<proxsdp::reduce_grid(side * side), kThreads, 0, st>>>(
      static_cast<const int*>(flags), static_cast<int>(g.x * g.y),
      static_cast<const Ct*>(s), static_cast<const Out*>(x),
      static_cast<Out*>(xp), static_cast<int*>(rank),
      static_cast<unsigned char*>(bad), side);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fro_scale: partials holds reduce_grid(n) compute-type entries; xc may be
// null (it is written only when the input type differs from the compute
// type).  sym_guard: flags holds ceil(side/32)^2 ints, rank an int32, bad
// one byte (a torch.bool).
extern "C" int proxsdp_fro_scale_f32(const void* x, void* partials, void* y,
                                     void* xc, int64_t n, void* stream) {
  return launch_fro_scale<float, float>(x, partials, y, xc, n, stream);
}
extern "C" int proxsdp_fro_scale_f64(const void* x, void* partials, void* y,
                                     void* xc, int64_t n, void* stream) {
  return launch_fro_scale<double, double>(x, partials, y, xc, n, stream);
}
extern "C" int proxsdp_fro_scale_f64_f32(const void* x, void* partials,
                                         void* y, void* xc, int64_t n,
                                         void* stream) {
  return launch_fro_scale<double, float>(x, partials, y, xc, n, stream);
}

extern "C" int proxsdp_sym_f32(const void* y, void* s, int64_t side,
                               void* stream) {
  return launch_sym<float>(y, s, side, stream);
}
extern "C" int proxsdp_sym_f64(const void* y, void* s, int64_t side,
                               void* stream) {
  return launch_sym<double>(y, s, side, stream);
}

extern "C" int proxsdp_sym_guard_f32(const void* p, const void* s,
                                     const void* x, void* xp, void* flags,
                                     void* rank, void* bad, int64_t side,
                                     void* stream) {
  return launch_sym_guard<float, float>(p, s, x, xp, flags, rank, bad, side,
                                        stream);
}
extern "C" int proxsdp_sym_guard_f64(const void* p, const void* s,
                                     const void* x, void* xp, void* flags,
                                     void* rank, void* bad, int64_t side,
                                     void* stream) {
  return launch_sym_guard<double, double>(p, s, x, xp, flags, rank, bad, side,
                                          stream);
}
extern "C" int proxsdp_sym_guard_f32_f64(const void* p, const void* s,
                                         const void* x, void* xp, void* flags,
                                         void* rank, void* bad, int64_t side,
                                         void* stream) {
  return launch_sym_guard<float, double>(p, s, x, xp, flags, rank, bad, side,
                                         stream);
}
