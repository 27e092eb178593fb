// K1: ELLPACK sparse matrix-vector product, out[r] = sum_j vals[r,j] * v[idx[r,j]].
//
// Replaces: proxsdp_tpu/ops/linop.py:123-127 (EllOp.matvec / EllOp.rmatvec,
// gather + row reduce).  One kernel serves both directions: matvec runs it
// on the row tables, rmatvec on the column tables.  Padding entries point
// at index 0 with value 0 and contribute nothing.
//
// Bound on the H100: device-memory bytes.  Per row it reads width indices,
// width values and width gathered entries of v, and writes one value: at
// the max-cut slice's shapes (62,500 x 1 column tables, 250 x 1 row
// tables, f64) that is under 2 MB per call, so the launch itself is the
// real cost.  Design: one thread per row, the terms summed in column order
// (the same order as the plain version); for width-1 tables the reads are
// fully coalesced.  A warp per row for wide tables is later work.
#include "reduce.cuh"

namespace {

template <typename T>
__global__ void ell_spmv_kernel(const int32_t* __restrict__ idx,
                                const T* __restrict__ vals,
                                const T* __restrict__ v, T* __restrict__ out,
                                int64_t nrows, int64_t width) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < nrows; r += stride) {
    const int32_t* ri = idx + r * width;
    const T* rv = vals + r * width;
    T acc = rv[0] * v[ri[0]];
    for (int64_t j = 1; j < width; ++j) acc += rv[j] * v[ri[j]];
    out[r] = acc;
  }
}

template <typename T>
int launch(const void* idx, const void* vals, const void* v, void* out,
           int64_t nrows, int64_t width, void* stream) {
  if (nrows > 0) {
    int64_t g = (nrows + proxsdp::kThreads - 1) / proxsdp::kThreads;
    if (g > 65535) g = 65535;
    ell_spmv_kernel<T><<<static_cast<int>(g), proxsdp::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(idx), static_cast<const T*>(vals),
        static_cast<const T*>(v), static_cast<T*>(out), nrows, width);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int proxsdp_ell_spmv_f64(const void* idx, const void* vals,
                                    const void* v, void* out, int64_t nrows,
                                    int64_t width, void* stream) {
  return launch<double>(idx, vals, v, out, nrows, width, stream);
}

extern "C" int proxsdp_ell_spmv_f32(const void* idx, const void* vals,
                                    const void* v, void* out, int64_t nrows,
                                    int64_t width, void* stream) {
  return launch<float>(idx, vals, v, out, nrows, width, stream);
}

// ---- the batch driver's entry point (proxsdp_tpu/parallel/batch.py:141,
// the vmapped EllOp product): out[b, r] = sum_j vals[b, r, j] *
// v[b, idx[r, j]] for B rows of v, one launch for the batch.  The index
// tables are shared; the values are instance b's at vals + b * vstride:
// vstride 0 for one operator shared by every instance (batch.py:133's
// M = None axes), nrows * width for the stacked per-instance values of an
// "ell_batched" sweep (EllOp(None, 0, None, 0), batch.py:133, 241-248).
// One thread per (instance, row), rows of one instance on neighbouring
// threads, terms in column order as above.
namespace {

template <typename T>
__global__ void ell_spmv_batch_kernel(const int32_t* __restrict__ idx,
                                      const T* __restrict__ vals,
                                      const T* __restrict__ v,
                                      T* __restrict__ out, int64_t total,
                                      int64_t nrows, int64_t width,
                                      int64_t ncols, int64_t vstride) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int64_t b = e / nrows, r = e % nrows;
    const int32_t* ri = idx + r * width;
    const T* rv = vals + b * vstride + r * width;
    const T* vb = v + b * ncols;
    T acc = rv[0] * vb[ri[0]];
    for (int64_t j = 1; j < width; ++j) acc += rv[j] * vb[ri[j]];
    out[e] = acc;
  }
}

template <typename T>
int launch_batch(const void* idx, const void* vals, const void* v, void* out,
                 int64_t B, int64_t nrows, int64_t width, int64_t ncols,
                 int64_t vstride, void* stream) {
  const int64_t total = B * nrows;
  if (total > 0) {
    int64_t g = (total + proxsdp::kThreads - 1) / proxsdp::kThreads;
    if (g > 65535) g = 65535;
    ell_spmv_batch_kernel<T><<<static_cast<int>(g), proxsdp::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(idx), static_cast<const T*>(vals),
        static_cast<const T*>(v), static_cast<T*>(out), total, nrows, width,
        ncols, vstride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v: (B, ncols); out: (B, nrows); vals: (nrows, width) with vstride 0, or
// (B, nrows, width) with vstride nrows * width.
extern "C" int proxsdp_ell_spmv_batch_f64(const void* idx, const void* vals,
                                          const void* v, void* out, int64_t B,
                                          int64_t nrows, int64_t width,
                                          int64_t ncols, int64_t vstride,
                                          void* stream) {
  return launch_batch<double>(idx, vals, v, out, B, nrows, width, ncols,
                              vstride, stream);
}

extern "C" int proxsdp_ell_spmv_batch_f32(const void* idx, const void* vals,
                                          const void* v, void* out, int64_t B,
                                          int64_t nrows, int64_t width,
                                          int64_t ncols, int64_t vstride,
                                          void* stream) {
  return launch_batch<float>(idx, vals, v, out, B, nrows, width, ncols,
                             vstride, stream);
}
