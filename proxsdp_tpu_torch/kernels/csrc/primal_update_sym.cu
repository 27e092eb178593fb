// K4: primal gradient step fused with the symmetrisation of the PSD block.
//
// Replaces: proxsdp_tpu/solver.py:308 (x - tau * (M'y + c)) with
// proxsdp_tpu/ops/cones.py:172-173 (X = 0.5 * (X + X^T) on the square
// block).  With u = x - tau * (Mty + c):
//   out[i*side + j] = 0.5 * (u[i*side + j] + u[j*side + i])  inside the block
//   out[k]          = u[k]                                   after it
// The block starts at offset 0 of the primal vector (PSD blocks come first
// in the cone-first layout, problem.py) and is stored row-major.
//
// Bound on the H100: device-memory bytes -- 3 reads and 1 write per entry,
// 2 MB per call for the max-cut slice's 250 x 250 f64 block.  The
// transpose read is the hazard: read column-wise from global memory it is
// uncoalesced.  Design: 32 x 32 tiles; each block computes u for the
// mirrored tile with coalesced row reads, parks it in shared memory
// (padded to 33 columns against bank conflicts), and reads it back
// transposed, so every global access is coalesced.
#include "reduce.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // blockDim = (kTile, kRows)

template <typename T>
__global__ void sym_tile_kernel(const T* __restrict__ x,
                                const T* __restrict__ Mty,
                                const T* __restrict__ c,
                                const T* __restrict__ tau_ptr,
                                T* __restrict__ out, int64_t side) {
  __shared__ T tile[kTile][kTile + 1];
  const T tau = *tau_ptr;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kTile;  // out rows
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTile;  // out cols
  const int tx = threadIdx.x;
  // mirrored tile: rows c0.., columns r0.. ; tile[k][tx] = u(c0 + k, r0 + tx)
  for (int k = threadIdx.y; k < kTile; k += kRows) {
    const int64_t r = c0 + k, col = r0 + tx;
    if (r < side && col < side) {
      const int64_t q = r * side + col;
      tile[k][tx] = x[q] - tau * (Mty[q] + c[q]);
    }
  }
  __syncthreads();
  for (int k = threadIdx.y; k < kTile; k += kRows) {
    const int64_t r = r0 + k, col = c0 + tx;
    if (r < side && col < side) {
      const int64_t q = r * side + col;
      const T u = x[q] - tau * (Mty[q] + c[q]);
      out[q] = T(0.5) * (u + tile[tx][k]);  // tile[tx][k] = u(col, r)
    }
  }
}

template <typename T>
__global__ void update_tail_kernel(const T* __restrict__ x,
                                   const T* __restrict__ Mty,
                                   const T* __restrict__ c,
                                   const T* __restrict__ tau_ptr,
                                   T* __restrict__ out, int64_t start,
                                   int64_t n) {
  const T tau = *tau_ptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = start + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    out[i] = x[i] - tau * (Mty[i] + c[i]);
}

template <typename T>
int launch(const void* x, const void* Mty, const void* c, const void* tau,
           void* out, int64_t n, int64_t side, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* mp = static_cast<const T*>(Mty);
  const T* cp = static_cast<const T*>(c);
  const T* tp = static_cast<const T*>(tau);
  T* op = static_cast<T*>(out);
  if (side > 0) {
    const unsigned nt = static_cast<unsigned>((side + kTile - 1) / kTile);
    sym_tile_kernel<T><<<dim3(nt, nt), dim3(kTile, kRows), 0, s>>>(
        xp, mp, cp, tp, op, side);
  }
  const int64_t start = side * side;
  if (n > start) {
    int64_t g = (n - start + proxsdp::kThreads - 1) / proxsdp::kThreads;
    if (g > 65535) g = 65535;
    update_tail_kernel<T><<<static_cast<int>(g), proxsdp::kThreads, 0, s>>>(
        xp, mp, cp, tp, op, start, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int proxsdp_primal_update_sym_f64(const void* x, const void* Mty,
                                             const void* c, const void* tau,
                                             void* out, int64_t n,
                                             int64_t side, void* stream) {
  return launch<double>(x, Mty, c, tau, out, n, side, stream);
}

extern "C" int proxsdp_primal_update_sym_f32(const void* x, const void* Mty,
                                             const void* c, const void* tau,
                                             void* out, int64_t n,
                                             int64_t side, void* stream) {
  return launch<float>(x, Mty, c, tau, out, n, side, stream);
}

// ---- the batch driver's entry point: the packed-triangle layout has no
// square block to symmetrise, so the update is u = x - tau * (Mty + c)
// alone (proxsdp_tpu/solver.py:308 under the vmap of parallel/batch.py:141),
// for B rows with a step tau[b] per instance, in one launch.  Bound:
// bytes, 3 reads and 1 write per entry; a grid-stride loop over B * n.
namespace {

template <typename T>
__global__ void primal_update_batch_kernel(const T* __restrict__ x,
                                           const T* __restrict__ Mty,
                                           const T* __restrict__ c,
                                           const T* __restrict__ tau,
                                           T* __restrict__ out, int64_t total,
                                           int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride)
    out[e] = x[e] - tau[e / n] * (Mty[e] + c[e]);
}

template <typename T>
int launch_batch(const void* x, const void* Mty, const void* c,
                 const void* tau, void* out, int64_t B, int64_t n,
                 void* stream) {
  const int64_t total = B * n;
  if (total > 0) {
    int64_t g = (total + proxsdp::kThreads - 1) / proxsdp::kThreads;
    if (g > 65535) g = 65535;
    primal_update_batch_kernel<T><<<static_cast<int>(g), proxsdp::kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(Mty),
        static_cast<const T*>(c), static_cast<const T*>(tau),
        static_cast<T*>(out), total, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, Mty, c, out: (B, n); tau: (B,).
extern "C" int proxsdp_primal_update_batch_f64(const void* x, const void* Mty,
                                               const void* c, const void* tau,
                                               void* out, int64_t B, int64_t n,
                                               void* stream) {
  return launch_batch<double>(x, Mty, c, tau, out, B, n, stream);
}

extern "C" int proxsdp_primal_update_batch_f32(const void* x, const void* Mty,
                                               const void* c, const void* tau,
                                               void* out, int64_t B, int64_t n,
                                               void* stream) {
  return launch_batch<float>(x, Mty, c, tau, out, B, n, stream);
}
