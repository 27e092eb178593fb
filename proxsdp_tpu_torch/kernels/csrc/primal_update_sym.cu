// K4: primal gradient step fused with the symmetrisation of the PSD blocks.
//
// Replaces: proxsdp_tpu/solver.py:308 (x - tau * (M'y + c)) with
// proxsdp_tpu/ops/cones.py:172-173 (X = 0.5 * (X + X^T) on each square
// block).  With u = x - tau * (Mty + c) and a block of side s at offset o:
//   out[o + i*s + j] = 0.5 * (u[o + i*s + j] + u[o + j*s + i])  inside it
//   out[k]           = u[k]                    after the last block
// The square blocks lie end to end from offset 0, row-major (PSD blocks
// come first in the cone-first layout, problem.py).
//
// Bound on the H100: device-memory bytes -- 3 reads and 1 write per entry,
// 2 MB per call for the max-cut slice's 250 x 250 f64 block.  The
// transpose read is the hazard: read column-wise from global memory it is
// uncoalesced.  Design: 32 x 32 tiles; a host table lists every tile of
// every block as (offset, side, first row, first column); the CTA of a
// tile computes u for the mirrored tile with coalesced row reads, parks it
// in shared memory (padded to 33 columns against bank conflicts), and
// reads it back transposed, so every global access is coalesced.  The
// CTAs past the table's tiles run a grid-stride loop over the entries
// after the last block: one launch covers the whole vector.
#include "reduce.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // blockDim = (kTile, kRows)

template <typename T>
__global__ void update_sym_kernel(const T* __restrict__ x,
                                  const T* __restrict__ Mty,
                                  const T* __restrict__ c,
                                  const T* __restrict__ tau_ptr,
                                  T* __restrict__ out,
                                  const int64_t* __restrict__ tiles,
                                  int64_t ntiles, int64_t start, int64_t n) {
  __shared__ T tile[kTile][kTile + 1];
  const T tau = *tau_ptr;
  const int tx = threadIdx.x;
  if (blockIdx.x >= ntiles) {  // the entries after the last block
    const int64_t nthreads = (gridDim.x - ntiles) * kTile * kRows;
    for (int64_t i = start + (blockIdx.x - ntiles) * kTile * kRows +
                     threadIdx.y * kTile + tx;
         i < n; i += nthreads)
      out[i] = x[i] - tau * (Mty[i] + c[i]);
    return;
  }
  const int64_t* tl = tiles + 4 * static_cast<int64_t>(blockIdx.x);
  const int64_t o = tl[0], side = tl[1];
  const int64_t r0 = tl[2];  // out rows
  const int64_t c0 = tl[3];  // out cols
  const T* xb = x + o;
  const T* mb = Mty + o;
  const T* cb = c + o;
  // mirrored tile: rows c0.., columns r0.. ; tile[k][tx] = u(c0 + k, r0 + tx)
  for (int k = threadIdx.y; k < kTile; k += kRows) {
    const int64_t r = c0 + k, col = r0 + tx;
    if (r < side && col < side) {
      const int64_t q = r * side + col;
      tile[k][tx] = xb[q] - tau * (mb[q] + cb[q]);
    }
  }
  __syncthreads();
  for (int k = threadIdx.y; k < kTile; k += kRows) {
    const int64_t r = r0 + k, col = c0 + tx;
    if (r < side && col < side) {
      const int64_t q = r * side + col;
      const T u = xb[q] - tau * (mb[q] + cb[q]);
      out[o + q] = T(0.5) * (u + tile[tx][k]);  // tile[tx][k] = u(col, r)
    }
  }
}

template <typename T>
int launch(const void* x, const void* Mty, const void* c, const void* tau,
           void* out, const void* tiles, int64_t ntiles, int64_t start,
           int64_t n, void* stream) {
  int64_t tail = (n - start + kTile * kRows - 1) / (kTile * kRows);
  if (tail > 65535) tail = 65535;
  if (tail < 0) tail = 0;
  if (ntiles + tail > 0) {
    update_sym_kernel<T><<<static_cast<unsigned>(ntiles + tail),
                           dim3(kTile, kRows), 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(Mty),
        static_cast<const T*>(c), static_cast<const T*>(tau),
        static_cast<T*>(out), static_cast<const int64_t*>(tiles), ntiles,
        start, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tiles: ntiles x 4 int64 (block offset, side, first row, first column of
// a 32 x 32 tile); start: the end of the last block; x, Mty, c, out: (n,).
extern "C" int proxsdp_primal_update_sym_f64(const void* x, const void* Mty,
                                             const void* c, const void* tau,
                                             void* out, const void* tiles,
                                             int64_t ntiles, int64_t start,
                                             int64_t n, void* stream) {
  return launch<double>(x, Mty, c, tau, out, tiles, ntiles, start, n, stream);
}

extern "C" int proxsdp_primal_update_sym_f32(const void* x, const void* Mty,
                                             const void* c, const void* tau,
                                             void* out, const void* tiles,
                                             int64_t ntiles, int64_t start,
                                             int64_t n, void* stream) {
  return launch<float>(x, Mty, c, tau, out, tiles, ntiles, start, n, stream);
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
