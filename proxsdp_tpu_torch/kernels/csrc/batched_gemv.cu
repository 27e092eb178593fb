// K16: batched GEMV over a stack of per-instance matrices,
//   out[b, r] = sum_j M[b, r, j] x[b, j]        (batched_gemv)
//   out[b, j] = sum_r M[b, r, j] y[b, r]        (batched_gemv_t)
// for M of shape (B, R, n), row-major, in f64 and f32.
//
// Replaces: proxsdp_tpu/ops/linop.py:44-48 (DenseOp.matvec / rmatvec)
// vmapped under DenseOp(0), proxsdp_tpu/parallel/batch.py:129-136: the
// "dense_batched" operator of a sweep whose instances carry their own
// constraint matrices (randsdp's dense A_k), batch.py:249-256.
//
// Bound on the H100: device-memory bytes.  Each product reads every
// instance's matrix once (B R n values) and the vectors; at phase K1's
// shape (B = 64, R = 20, n = 820, f64) that is 8.4 MB, 2.5 us at
// 3.35 TB/s, against 2 B R n flops (0.03 us at 67 TFLOP/s).
//
// Design: the sums run in a fixed order, so a result is the same from
// run to run (the accept tests of the linesearch sit on these products).
//   batched_gemv:   one warp per (instance, row); lane l sums the columns
//                   l, l + 32, ... in order, coalesced along the row, then
//                   a shuffle tree (offsets 16, 8, 4, 2, 1) adds the lanes.
//   batched_gemv_t: one thread per (instance, column); the rows in order
//                   (r = 0, 1, ..., R - 1), neighbouring threads on
//                   neighbouring columns, so each row's loads coalesce.
//                   This is the order of K15b's dense M' product
//                   (ls_loop.cu), so the two give the same bits.
// The vectors are re-read from L1/L2 (x once per row, y once per column);
// tiling them through shared memory is later work.
#include "reduce.cuh"

namespace {

using proxsdp::kThreads;
constexpr int kWarpsPerBlock = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
batched_gemv_kernel(const T* __restrict__ M, const T* __restrict__ x,
                    T* __restrict__ out, int64_t total, int64_t R,
                    int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                   (threadIdx.x >> 5);
       e < total; e += nwarps) {
    const T* row = M + e * n;  // (b R + r) n
    const T* xb = x + (e / R) * n;
    T acc = T(0);
    for (int64_t j = lane; j < n; j += 32) acc += row[j] * xb[j];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[e] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
batched_gemv_t_kernel(const T* __restrict__ M, const T* __restrict__ y,
                      T* __restrict__ out, int64_t total, int64_t R,
                      int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int64_t b = e / n, j = e % n;
    const T* Mb = M + b * R * n + j;
    const T* yb = y + b * R;
    T acc = T(0);
    for (int64_t r = 0; r < R; ++r) acc += Mb[r * n] * yb[r];
    out[e] = acc;
  }
}

int grid_of(int64_t work_items, int64_t per_block) {
  int64_t g = (work_items + per_block - 1) / per_block;
  if (g < 1) g = 1;
  if (g > 65535) g = 65535;
  return static_cast<int>(g);
}

template <typename T>
int launch(const void* M, const void* v, void* out, int64_t B, int64_t R,
           int64_t n, bool trans, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = B * (trans ? n : R);
  if (total > 0) {
    if (trans)
      batched_gemv_t_kernel<T><<<grid_of(total, kThreads), kThreads, 0, s>>>(
          static_cast<const T*>(M), static_cast<const T*>(v),
          static_cast<T*>(out), total, R, n);
    else
      batched_gemv_kernel<T><<<grid_of(total, kWarpsPerBlock), kThreads, 0,
                               s>>>(static_cast<const T*>(M),
                                    static_cast<const T*>(v),
                                    static_cast<T*>(out), total, R, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// M: (B, R, n) row-major.  batched_gemv: x (B, n), out (B, R);
// batched_gemv_t: y (B, R), out (B, n).
extern "C" int proxsdp_batched_gemv_f64(const void* M, const void* x,
                                        void* out, int64_t B, int64_t R,
                                        int64_t n, void* stream) {
  return launch<double>(M, x, out, B, R, n, false, stream);
}

extern "C" int proxsdp_batched_gemv_f32(const void* M, const void* x,
                                        void* out, int64_t B, int64_t R,
                                        int64_t n, void* stream) {
  return launch<float>(M, x, out, B, R, n, false, stream);
}

extern "C" int proxsdp_batched_gemv_t_f64(const void* M, const void* y,
                                          void* out, int64_t B, int64_t R,
                                          int64_t n, void* stream) {
  return launch<double>(M, y, out, B, R, n, true, stream);
}

extern "C" int proxsdp_batched_gemv_t_f32(const void* M, const void* y,
                                          void* out, int64_t B, int64_t R,
                                          int64_t n, void* stream) {
  return launch<float>(M, y, out, B, R, n, true, stream);
}
