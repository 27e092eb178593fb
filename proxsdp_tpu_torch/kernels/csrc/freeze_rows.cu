// K21: the batch's masked freeze, out[b] = mask[b] ? new[b] : old[b], over
// every field of the batched State in one launch.
//
// Replaces: proxsdp_tpu/parallel/batch.py:149-155 (the while_loop body's
// jnp.where over the state tree), which the port ran as one torch.where
// per field (parallel/batch.py:_where_rows, 46 and more launches a step
// once any instance has finished).
//
// The table -- for each field its new, old and out rows and the row
// length in 32-bit words -- travels in the kernel's parameters (up to
// kMaxFields fields a launch; the wrapper takes more launches past that).
// A field is copied as words, whatever its dtype (f64, f32, int32), so
// the select is exact bit for bit.  Each output is fresh: the fields of a
// step alias (x_old is x after _residuals_and_gap) and the old state is
// the step's input.  grid.y is the field; grid.x strides over B rows of
// that field.
//
// Bound on the H100: device-memory bytes, every row read twice (new and
// old, one of which the select keeps) and written once: ~3 x the state's
// size, ~2.3 MB at phase D's B = 1024, side 16 (~0.7 us at 3.35 TB/s).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 96;  // kernels/iteration_control.py: FREEZE_MAX_FIELDS

struct Entry {
  const uint32_t* nw;
  const uint32_t* old;
  uint32_t* out;
  int64_t words;  // a row's length
};

struct Table {
  Entry e[kMaxFields];
};

__global__ void __launch_bounds__(kThreads)
freeze_rows_kernel(const unsigned char* __restrict__ mask, const Table t,
                   int64_t B) {
  const Entry e = t.e[blockIdx.y];
  const int64_t total = B * e.words;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride)
    e.out[i] = mask[i / e.words] ? e.nw[i] : e.old[i];
}

}  // namespace

// mask: (B,) bool (one byte each); table: nfields x (new, old, out, words)
// int64 host values.  One entry point for every dtype: the rows are
// copied as 32-bit words.
extern "C" int proxsdp_freeze_rows_u32(const void* mask, const int64_t* table,
                                       int64_t nfields, int64_t B,
                                       void* stream) {
  if (nfields < 1 || nfields > kMaxFields) return cudaErrorInvalidValue;
  Table t;
  int64_t most = 0;
  for (int64_t f = 0; f < nfields; ++f) {
    const int64_t* row = table + 4 * f;
    t.e[f].nw = reinterpret_cast<const uint32_t*>(row[0]);
    t.e[f].old = reinterpret_cast<const uint32_t*>(row[1]);
    t.e[f].out = reinterpret_cast<uint32_t*>(row[2]);
    t.e[f].words = row[3];
    if (row[3] < 1) return cudaErrorInvalidValue;
    if (B * row[3] > most) most = B * row[3];
  }
  int64_t gx = (most + kThreads - 1) / kThreads;
  if (gx > 1024) gx = 1024;
  if (gx > 0) {
    freeze_rows_kernel<<<dim3(static_cast<unsigned>(gx),
                              static_cast<unsigned>(nfields)),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(mask), t, B);
  }
  return static_cast<int>(cudaGetLastError());
}
