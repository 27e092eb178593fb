// K13: projection of every second-order-cone block, and the largest cone
// gap after it, in one launch.
//
// Replaces: proxsdp_tpu/ops/cones.py:43-56 (soc_projection_block, one
// call per block) and its gap at proxsdp_tpu/solver.py:414-419.  The
// blocks lie end to end, block k at off[k] with length off[k+1] - off[k]
// (>= 1), laid out [s, v_1 .. v_{len-1}].  With nv = ||v||:
//   nv <= -s:  (s, v) -> 0                          (the polar cone)
//   nv <=  s:  (s, v) -> (s, v)                     (inside the cone)
//   else:      (s, v) -> a (nv, v), a = (1 + s / nv) / 2
// (nv = 0 divides by 1, as the JAX code does), and gap = max over blocks
// of ||v'|| - s' on the projected (s', v').
//
// Bound on the H100: device-memory bytes -- each entry is read once and
// written once (16 bytes in f64) and 2 flops of the norm, ~4.3 flops an
// entry in all: ~1.3 flops a byte, far below the card's ~20 f64 flops a
// byte.  Design: one warp per block.  Lane l sums the squares of its
// entries v_l, v_{l+32}, ... in that order and a shuffle tree with
// offsets 16, 8, 4, 2, 1 folds the lanes, the same order for ||v|| and
// ||v'||; the plain version (kernels/__init__.py:_warp_sq_norms) repeats
// it, so kernel and plain version agree bit for bit (-fmad=false).  The
// gap is a fixed-order max: lane 0 of each warp, then the CTA's warps in
// order into one partial per CTA, then reduce.cuh's single-block pass --
// no atomics on floats, so a run repeats bit for bit.
//
// K13b: the same projection for every instance of a batch, x (B, ldx)
// rows whose first off[nblk] entries are the instance's SOC blocks
// (replaces the vmap of proxsdp_tpu/solver.py:413-419 over instances,
// proxsdp_tpu/parallel/batch.py:141).  Grid (CTAs per instance, B): a
// CTA's warps project that instance's blocks exactly as K13 does, so each
// row's output is K13's bit for bit; each CTA writes one gap partial per
// instance and a second kernel folds each instance's partials in order
// (max, exact in any order), gap (B,).  Bound: bytes, as K13.
#include "reduce.cuh"

namespace {

constexpr int kWarps = proxsdp::kThreads / 32;  // blocks per CTA at a time

// the lanes' sums of squares of v[l], v[l + 32], ... folded onto lane 0,
// then broadcast
template <typename T>
__device__ __forceinline__ T warp_sq_norm(T acc) {
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  return __shfl_sync(0xffffffffu, acc, 0);
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

// one warp projects the block at o of length len (x and out offset to the
// instance); returns its gap ||v'|| - s' in every lane
template <typename T>
__device__ __forceinline__ T project_block(const T* __restrict__ x,
                                           T* __restrict__ out, int64_t o,
                                           int64_t len, int lane) {
  const T s = x[o];
  const T* v = x + o + 1;
  T acc = T(0);
  for (int64_t j = lane; j < len - 1; j += 32) acc += v[j] * v[j];
  const T nv = sqrt_t<T>(warp_sq_norm<T>(acc));
  const T scale = T(0.5) * (T(1) + s / (nv == T(0) ? T(1) : nv));
  const bool in_cone = nv <= s;
  const bool in_polar = nv <= -s;
  const T new_s = in_polar ? T(0) : (in_cone ? s : scale * nv);
  const T f = in_polar ? T(0) : (in_cone ? T(1) : scale);
  T acc2 = T(0);
  for (int64_t j = lane; j < len - 1; j += 32) {
    const T e = f * v[j];
    out[o + 1 + j] = e;
    acc2 += e * e;
  }
  if (lane == 0) out[o] = new_s;
  return sqrt_t<T>(warp_sq_norm<T>(acc2)) - new_s;
}

// the CTA's blocks blockIdx.x * kWarps + warp, + gridDim.x * kWarps, ...;
// the CTA's largest gap goes to *partial
template <typename T>
__device__ __forceinline__ void project_blocks(const T* __restrict__ x,
                                               T* __restrict__ out,
                                               const int64_t* __restrict__ off,
                                               int64_t nblk,
                                               T* __restrict__ partial) {
  __shared__ T warp_gap[kWarps];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarps;
  T gmax = static_cast<T>(-INFINITY);
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kWarps + wid; k < nblk;
       k += nwarps) {
    const T gap = project_block<T>(x, out, off[k], off[k + 1] - off[k], lane);
    if (lane == 0) gmax = proxsdp::nan_max(gmax, gap);
  }
  if (lane == 0) warp_gap[wid] = gmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    T g = warp_gap[0];
    for (int w = 1; w < kWarps; ++w) g = proxsdp::nan_max(g, warp_gap[w]);
    *partial = g;
  }
}

template <typename T>
__global__ void soc_proj_kernel(const T* __restrict__ x, T* __restrict__ out,
                                const int64_t* __restrict__ off,
                                int64_t nblk, T* __restrict__ partials) {
  project_blocks<T>(x, out, off, nblk, partials + blockIdx.x);
}

// K13b: instance blockIdx.y's row of x (stride ldx) into its row of out
// (stride off[nblk]); partials (B, gridDim.x)
template <typename T>
__global__ void soc_proj_batch_kernel(const T* __restrict__ x, int64_t ldx,
                                      T* __restrict__ out,
                                      const int64_t* __restrict__ off,
                                      int64_t nblk, T* __restrict__ partials) {
  const int64_t inst = blockIdx.y;
  project_blocks<T>(x + inst * ldx, out + inst * off[nblk], off, nblk,
                    partials + inst * gridDim.x + blockIdx.x);
}

// each instance's gap: the max of its nparts partials (one CTA each)
template <typename T>
__global__ void gap_rows_kernel(const T* __restrict__ partials, int nparts,
                                T* __restrict__ gap) {
  const T* p = partials + static_cast<int64_t>(blockIdx.x) * nparts;
  T acc[1] = {static_cast<T>(-INFINITY)};
  for (int i = threadIdx.x; i < nparts; i += proxsdp::kThreads)
    acc[0] = proxsdp::nan_max(acc[0], p[i]);
  proxsdp::block_reduce<T, 1, 1u>(acc);
  if (threadIdx.x == 0) gap[blockIdx.x] = acc[0];
}

inline int grid_of(int64_t nblk) {
  int64_t g = (nblk + kWarps - 1) / kWarps;
  if (g < 1) g = 1;
  if (g > proxsdp::kMaxBlocks) g = proxsdp::kMaxBlocks;
  return static_cast<int>(g);
}

template <typename T>
int launch(const void* x, void* out, const void* off, int64_t nblk,
           void* partials, void* gap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = grid_of(nblk);
  soc_proj_kernel<T><<<grid, proxsdp::kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const int64_t*>(off), nblk, static_cast<T*>(partials));
  proxsdp::finalize_kernel<T, 1, 1u><<<1, proxsdp::kThreads, 0, s>>>(
      static_cast<const T*>(partials), grid, static_cast<T*>(gap));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_batch(const void* x, int64_t ldx, void* out, const void* off,
                 int64_t nblk, int64_t B, void* partials, void* gap,
                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1) return static_cast<int>(cudaGetLastError());
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = grid_of(nblk);
  soc_proj_batch_kernel<T><<<dim3(grid, static_cast<unsigned>(B)),
                             proxsdp::kThreads, 0, s>>>(
      static_cast<const T*>(x), ldx, static_cast<T*>(out),
      static_cast<const int64_t*>(off), nblk, static_cast<T*>(partials));
  gap_rows_kernel<T><<<static_cast<unsigned>(B), proxsdp::kThreads, 0, s>>>(
      static_cast<const T*>(partials), grid, static_cast<T*>(gap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: the blocks' entries, off[nblk] of them (two buffers); off:
// nblk + 1 int64 offsets from off[0] = 0; partials: grid_of(nblk) words
// (min(ceil(nblk / 8), 1024)); gap: one word.
extern "C" int proxsdp_soc_projection_f64(const void* x, void* out, const void* off,
                                    int64_t nblk, void* partials, void* gap,
                                    void* stream) {
  return launch<double>(x, out, off, nblk, partials, gap, stream);
}

extern "C" int proxsdp_soc_projection_f32(const void* x, void* out, const void* off,
                                    int64_t nblk, void* partials, void* gap,
                                    void* stream) {
  return launch<float>(x, out, off, nblk, partials, gap, stream);
}

// K13b.  x: B rows of stride ldx, the SOC blocks in the first off[nblk]
// entries of each; out: (B, off[nblk]); off: nblk + 1 int64 offsets from
// off[0] = 0; partials: B * grid_of(nblk) words; gap: B words.  B <=
// 65535.
extern "C" int proxsdp_soc_projection_batch_f64(
    const void* x, int64_t ldx, void* out, const void* off, int64_t nblk,
    int64_t B, void* partials, void* gap, void* stream) {
  return launch_batch<double>(x, ldx, out, off, nblk, B, partials, gap,
                              stream);
}

extern "C" int proxsdp_soc_projection_batch_f32(
    const void* x, int64_t ldx, void* out, const void* off, int64_t nblk,
    int64_t B, void* partials, void* gap, void* stream) {
  return launch_batch<float>(x, ldx, out, off, nblk, B, partials, gap,
                             stream);
}
