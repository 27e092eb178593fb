// K18: rows [r0, r1) of the dense-eigh PSD reconstruction V diag(w+) V^T.
//
// Replaces the reconstruction of proxsdp_tpu/ops/cones.py:full_path
// (204-211) and full_path_sub (223-232):
//   Xp = (V * max(w, 0)[None, :]) @ V.T, cast to the program's dtype
// after the block's dense eigh (w ascending, V its eigenvectors).  Under
// tensor parallelism (proxsdp_tpu/parallel/sharded.py, the row layout of
// cones.py:177-191) every rank holds the whole eigendecomposition and
// reconstructs only its own rows [r0, r1); one all_gather assembles Xp.
//
// out[i, j] = sum_k (V[r0 + i, k] * max(w[k], 0)) * V[j, k], (r1 - r0, n)
// row-major, computed in V's type and rounded to the output's type at
// the store (the mixed projection's f64 eigenpairs into an f32 block:
// the "f64_f32" entry).  max(w, 0) keeps a NaN eigenvalue (w < 0 ? 0 : w),
// as jnp.maximum and torch.clamp_min do, so a failed eigh stays NaN.
//
// Rounding: the clamp is applied to the left panel as it is loaded (one
// rounded product per term, as the plain version's V * w+), then the sum
// over k runs in index order with an explicit fused multiply-add per term
// (the library is built with -fmad=false; IEEE f32, no TF32).  A k-tile
// whose 32 clamped eigenvalues are all 0 adds only zero terms and is
// skipped: the low-rank iterates of a max-cut solve reconstruct from a
// few positive eigenvalues, so the work is 2 (r1 - r0) n r for r positive
// ones.  Each output entry's sum depends on neither r0 nor the tile it
// falls in, so a rank's rows equal the same rows of the full product bit
// for bit.
//
// Bound on the H100: bytes at the low ranks of the solver's path (V read
// once, n^2 words; side 250 f64: 0.5 MB, 0.15 us), operations at full
// rank (2 n^3 flops, 0.47 us at side 250 against 67 TFLOP/s).  Design
// (simple first, as K5): 32 x 32 output tiles, one 256-thread block each,
// 2 x 2 outputs per thread, both panels staged through shared memory 32
// deep along k; nothing of size n^2 is written before the product.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kDim = 16;  // blockDim = (kDim, kDim); 2 x 2 outputs each

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T, typename O>
__global__ void psd_reconstruct_kernel(const T* __restrict__ V,
                                       const T* __restrict__ w,
                                       O* __restrict__ out, int64_t n,
                                       int64_t r0, int64_t rows) {
  __shared__ T As[kTile][kTile + 1];  // As[row][k]: V[r0 + row, k] * w+[k]
  __shared__ T Bs[kTile][kTile + 1];  // Bs[k][col]: V[col, k]
  __shared__ T Ps[kTile];             // w+ of the k-tile
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kDim + tx;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kTile;  // slab row
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kTile;  // column
  T acc[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
  for (int64_t k0 = 0; k0 < n; k0 += kTile) {
    int live = 0;
    if (tid < kTile) {
      const int64_t k = k0 + tid;
      T p = T(0);
      if (k < n) {
        const T wk = w[k];
        p = wk < T(0) ? T(0) : wk;
      }
      Ps[tid] = p;
      live = p != T(0);  // NaN counts as live
    }
    if (!__syncthreads_or(live)) continue;  // only zero terms in this tile
    for (int e = tid; e < kTile * kTile; e += kDim * kDim) {
      const int a = e / kTile, b = e % kTile;  // b fastest: coalesced rows
      const int64_t k = k0 + b;
      const int64_t ar = i0 + a, bc = j0 + a;
      As[a][b] = (ar < rows && k < n) ? V[(r0 + ar) * n + k] * Ps[b] : T(0);
      // Bs is stored transposed: Bs[k][col] = V[col, k]
      Bs[b][a] = (bc < n && k < n) ? V[bc * n + k] : T(0);
    }
    __syncthreads();
    const int kn = static_cast<int>(n - k0 < kTile ? n - k0 : kTile);
    for (int kk = 0; kk < kn; ++kk) {
      const T a0 = As[ty][kk], a1 = As[ty + kDim][kk];
      const T b0 = Bs[kk][tx], b1 = Bs[kk][tx + kDim];
      acc[0][0] = fma_rn(a0, b0, acc[0][0]);
      acc[0][1] = fma_rn(a0, b1, acc[0][1]);
      acc[1][0] = fma_rn(a1, b0, acc[1][0]);
      acc[1][1] = fma_rn(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int64_t r = i0 + ty + u * kDim, c = j0 + tx + v * kDim;
      if (r < rows && c < n) out[r * n + c] = static_cast<O>(acc[u][v]);
    }
  }
}

template <typename T, typename O>
int launch(const void* V, const void* w, void* out, int64_t n, int64_t r0,
           int64_t rows, void* stream) {
  if (n < 1 || rows < 1 || r0 < 0 || r0 + rows > n ||
      (rows + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile),
                  static_cast<unsigned>((rows + kTile - 1) / kTile));
  psd_reconstruct_kernel<T, O><<<grid, dim3(kDim, kDim), 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(V), static_cast<const T*>(w),
      static_cast<O*>(out), n, r0, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// V (n, n) and w (n,) contiguous; out contiguous (rows, n), rows >= 1.
extern "C" int proxsdp_psd_reconstruct_f64(const void* V, const void* w,
                                           void* out, int64_t n, int64_t r0,
                                           int64_t rows, void* stream) {
  return launch<double, double>(V, w, out, n, r0, rows, stream);
}

extern "C" int proxsdp_psd_reconstruct_f32(const void* V, const void* w,
                                           void* out, int64_t n, int64_t r0,
                                           int64_t rows, void* stream) {
  return launch<float, float>(V, w, out, n, r0, rows, stream);
}

// f64 eigenpairs, f32 output (the mixed projection of an f32 program)
extern "C" int proxsdp_psd_reconstruct_f64_f32(const void* V, const void* w,
                                               void* out, int64_t n,
                                               int64_t r0, int64_t rows,
                                               void* stream) {
  return launch<double, float>(V, w, out, n, r0, rows, stream);
}
