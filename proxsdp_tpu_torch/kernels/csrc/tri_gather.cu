// K10: the packed-triangle <-> square gathers of a batch of PSD blocks.
//
// Replaces: proxsdp_tpu/ops/tri.py:39-52 (tri_to_square / square_to_tri,
// vmapped over the instances by proxsdp_tpu/parallel/batch.py:141 and run
// by every projection of the packed-triangle layout, cones.py:166-175).
// One gather with a static index map and a static scale serves both
// directions, for each instance b and output position q:
//   out[b, q] = in[b * in_stride + idx[q]] * scale[q]
//   tri -> square: idx = the triangle position of square entry q, scale =
//                  1/sqrt(2) off the diagonal (the scaled triangle stores
//                  sqrt(2) X_ij), 1 on it; out is (B, s*s)
//   square -> tri: idx = the square position (i, j), i <= j, of triangle
//                  entry q, scale = sqrt(2) off the diagonal; out is
//                  (B, s(s+1)/2)
// The maps are built once per side on the host (ops/tri.py:_maps) and
// kept on the card.  in_stride lets the tri -> square direction read the
// leading block of a longer primal vector in place.
//
// Bound on the H100: device-memory bytes -- one read of the input entry,
// the map and the scale (both cached: they are shared by every instance)
// and one write per output entry, about 3.5 MB per direction at B = 1024,
// s = 16 in f64, i.e. ~1 us at 3.35 TB/s.  Design: a grid-stride loop over
// the B * len outputs, so consecutive threads write consecutive entries;
// the one multiply rounds exactly as the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void gather_scale_kernel(const T* __restrict__ in,
                                    const int32_t* __restrict__ idx,
                                    const T* __restrict__ scale,
                                    T* __restrict__ out, int64_t total,
                                    int64_t out_len, int64_t in_stride) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int64_t b = e / out_len, q = e % out_len;
    out[e] = in[b * in_stride + idx[q]] * scale[q];
  }
}

template <typename T>
int launch(const void* in, const void* idx, const void* scale, void* out,
           int64_t B, int64_t out_len, int64_t in_stride, void* stream) {
  const int64_t total = B * out_len;
  if (total > 0) {
    int64_t g = (total + kThreads - 1) / kThreads;
    if (g > 65535) g = 65535;
    gather_scale_kernel<T><<<static_cast<int>(g), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(in), static_cast<const int32_t*>(idx),
        static_cast<const T*>(scale), static_cast<T*>(out), total, out_len,
        in_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: B rows of in_stride entries (the block at the start of each row);
// idx (int32), scale: (out_len,); out: (B, out_len).
extern "C" int proxsdp_tri_to_square_f64(const void* in, const void* idx,
                                         const void* scale, void* out,
                                         int64_t B, int64_t out_len,
                                         int64_t in_stride, void* stream) {
  return launch<double>(in, idx, scale, out, B, out_len, in_stride, stream);
}

extern "C" int proxsdp_tri_to_square_f32(const void* in, const void* idx,
                                         const void* scale, void* out,
                                         int64_t B, int64_t out_len,
                                         int64_t in_stride, void* stream) {
  return launch<float>(in, idx, scale, out, B, out_len, in_stride, stream);
}

extern "C" int proxsdp_square_to_tri_f64(const void* in, const void* idx,
                                         const void* scale, void* out,
                                         int64_t B, int64_t out_len,
                                         int64_t in_stride, void* stream) {
  return launch<double>(in, idx, scale, out, B, out_len, in_stride, stream);
}

extern "C" int proxsdp_square_to_tri_f32(const void* in, const void* idx,
                                         const void* scale, void* out,
                                         int64_t B, int64_t out_len,
                                         int64_t in_stride, void* stream) {
  return launch<float>(in, idx, scale, out, B, out_len, in_stride, stream);
}
