// K14: the COO operator's products as segmented sums,
// out[s] = sum_{k in [ptr[s], ptr[s+1])} vals[k] * v[idx[k]].
//
// Replaces: proxsdp_tpu/ops/linop.py:81-90 (CooOp.matvec, a segment_sum
// over the row-sorted triplets, and CooOp.rmatvec, a scatter-add over the
// columns).  The operator keeps the triplets twice, sorted by row (matvec:
// segments are rows, idx the columns) and sorted by column (rmatvec:
// segments are columns, idx the rows), so both products are the same
// gather-and-segment-reduce and neither needs an atomic: each output is
// summed by one warp in a fixed order and a run repeats bit for bit.
//
// Bound on the H100: device-memory bytes -- per nonzero an index (4
// bytes), a value and a gathered entry of v, per segment its pointer and
// one output; 2 flops a nonzero.  The JAX package picks this form where a
// row or column is too dense for the ELL tables (more than 32 nonzeros)
// and the matrix too large for the dense form: a Lovasz-theta SDP's trace
// row, or a constraint touching a fixed share of the variables.  Design:
// one warp per segment; lane l sums the terms ptr[s] + l, + 32, ... in
// turn, then a shuffle tree with offsets 16, 8, 4, 2, 1 folds the lanes.
// A segment of one or two terms leaves most of its warp idle (the theta
// SDP's columns): a thread per short segment is later work.
//
// K14b: the same products for B rows at once, out[i, s] = sum_k vals[k] *
// V[i, idx[k]], one operator shared by every instance (replaces the
// vmap of CooOp.matvec / rmatvec over a batch, proxsdp_tpu/parallel/
// batch.py:141 with the operator broadcast, :229-231).  A warp per
// (segment, group of kRows instances): lane l reads the triplets ptr[s] +
// l, + 32, ... once and adds each into kRows accumulators, one per row of
// the group, in K14's order; the shuffle tree folds each as K14 does, so
// every row of the output is K14's bit for bit.  Bound: device-memory
// bytes -- the triplets (12 bytes a term in f64) read once per group of
// kRows rows, the gathered V entries once per row.
#include "reduce.cuh"

namespace {

constexpr int kWarps = proxsdp::kThreads / 32;

template <typename T>
__global__ void seg_spmv_kernel(const int64_t* __restrict__ ptr,
                                const int32_t* __restrict__ idx,
                                const T* __restrict__ vals,
                                const T* __restrict__ v, T* __restrict__ out,
                                int64_t nseg) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       s < nseg; s += nwarps) {
    const int64_t end = ptr[s + 1];
    T acc = T(0);
    for (int64_t k = ptr[s] + lane; k < end; k += 32)
      acc += vals[k] * v[idx[k]];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[s] = acc;
  }
}

constexpr int kRows = 8;  // K14b: rows of V a warp sums at once

template <typename T>
__global__ void seg_spmv_batch_kernel(const int64_t* __restrict__ ptr,
                                      const int32_t* __restrict__ idx,
                                      const T* __restrict__ vals,
                                      const T* __restrict__ V, int64_t ldv,
                                      T* __restrict__ out, int64_t nseg,
                                      int64_t B) {
  const int lane = threadIdx.x & 31;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kRows;
  const int rows = B - i0 < kRows ? static_cast<int>(B - i0) : kRows;
  const T* Vi = V + i0 * ldv;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       s < nseg; s += nwarps) {
    const int64_t end = ptr[s + 1];
    T acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = T(0);
    for (int64_t k = ptr[s] + lane; k < end; k += 32) {
      const T val = vals[k];
      const int64_t c = idx[k];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) acc[r] += val * Vi[r * ldv + c];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      T a = acc[r];
      for (int off = 16; off > 0; off >>= 1)
        a += __shfl_down_sync(0xffffffffu, a, off);
      if (lane == 0 && r < rows) out[(i0 + r) * nseg + s] = a;
    }
  }
}

template <typename T>
int launch_batch(const void* ptr, const void* idx, const void* vals,
                 const void* V, int64_t ldv, void* out, int64_t nseg,
                 int64_t B, void* stream) {
  if (nseg > 0 && B > 0) {
    const int64_t groups = (B + kRows - 1) / kRows;
    if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
    int64_t g = (nseg + kWarps - 1) / kWarps;
    if (g > 65535) g = 65535;
    seg_spmv_batch_kernel<T><<<dim3(static_cast<unsigned>(g),
                                    static_cast<unsigned>(groups)),
                               proxsdp::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(ptr), static_cast<const int32_t*>(idx),
        static_cast<const T*>(vals), static_cast<const T*>(V), ldv,
        static_cast<T*>(out), nseg, B);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* ptr, const void* idx, const void* vals, const void* v,
           void* out, int64_t nseg, void* stream) {
  if (nseg > 0) {
    int64_t g = (nseg + kWarps - 1) / kWarps;
    if (g > 65535) g = 65535;
    seg_spmv_kernel<T><<<static_cast<int>(g), proxsdp::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(ptr), static_cast<const int32_t*>(idx),
        static_cast<const T*>(vals), static_cast<const T*>(v),
        static_cast<T*>(out), nseg);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptr: nseg + 1 int64 segment starts; idx: ptr[nseg] int32 indices into v;
// vals: ptr[nseg] values; out: nseg.
extern "C" int proxsdp_coo_spmv_f64(const void* ptr, const void* idx,
                                    const void* vals, const void* v, void* out,
                                    int64_t nseg, void* stream) {
  return launch<double>(ptr, idx, vals, v, out, nseg, stream);
}

extern "C" int proxsdp_coo_spmv_f32(const void* ptr, const void* idx,
                                    const void* vals, const void* v, void* out,
                                    int64_t nseg, void* stream) {
  return launch<float>(ptr, idx, vals, v, out, nseg, stream);
}

// K14b.  V: B rows of stride ldv (entries idx[k] in range); out: (B,
// nseg); ptr, idx, vals as K14's.  ceil(B / 8) <= 65535.
extern "C" int proxsdp_coo_spmv_batch_f64(const void* ptr, const void* idx,
                                          const void* vals, const void* V,
                                          int64_t ldv, void* out,
                                          int64_t nseg, int64_t B,
                                          void* stream) {
  return launch_batch<double>(ptr, idx, vals, V, ldv, out, nseg, B, stream);
}

extern "C" int proxsdp_coo_spmv_batch_f32(const void* ptr, const void* idx,
                                          const void* vals, const void* V,
                                          int64_t ldv, void* out,
                                          int64_t nseg, int64_t B,
                                          void* stream) {
  return launch_batch<float>(ptr, idx, vals, V, ldv, out, nseg, B, stream);
}
