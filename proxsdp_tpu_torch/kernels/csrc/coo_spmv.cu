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
