// K5: a dense GEMM with an axpby epilogue, out = alpha * C + beta * (A @ B).
//
// Replaces the matrix products of proxsdp_tpu/ops/cones.py:polar_psd
// (84-95) and polar_reseed (285-297), and the Ritz rotation of
// proxsdp_tpu/ops/lanczos.py:105: every Newton-Schulz step
//   A = Y @ Y                      (alpha = 0, beta = 1)
//   B = QB * A + QC * (A @ A)      (C = A)
//   Y = QA * Y + Y @ B             (C = Y, beta = 1)
//   Y = 1.5 * Y - 0.5 * (Y @ A)    (the cubic polish)
// the projection P = 0.5 * X + 0.5 * (S @ X), and the sign projectors
// applied to the warm basis, 0.5 * W +- 0.5 * (S @ W).  A is (M, K), B is
// (K, N), C and out are (M, N); every row stride is an argument, so a
// column slice of the warm basis (row stride k, not 16-byte aligned) or a
// row slab of a tensor-parallel rank is read in place.
//
// Rounding (the numeric contract): each output is the sum over K in index
// order, one explicit fused multiply-add per term from +0, then alpha * C
// and beta * acc are each rounded and added (the library is built with
// -fmad=false, so the epilogue is never contracted), exactly as the JAX
// expression rounds them.  No tiling below regroups a sum -- no split-K,
// no tensor cores (TF32 keeps 10 mantissa bits; f64 DMMA's accumulation
// order is not documented) -- so every output has the bits of the one-CTA-
// per-32x32-tile kernel this file held before.
//
// Bound on the H100: operations.  A side-2000 square product is 16 GFLOP:
// 239 us at the 67 TFLOP/s f32 CUDA-core peak, 470 us at f64's 34.  At side
// 250 one product is 31.25 MFLOP, 0.47 us; a polar projection is 30.
//
// What held it back: 32 x 32 tiles with 2 x 2 outputs a thread, so the
// inner loop issued one shared load a multiply-add (shared-memory bound,
// 15 % of the bound at side 2000); synchronous tile loads exposed the
// global latency every 32 of K; and at side 250 only 64 CTAs ran on 132
// SMs.  The design: register-blocked tiles from a shape table -- 128 x 128
// with 8 x 8 outputs a thread (256 threads, one CTA an SM) for large
// products, 64 x 64 with 4 x 4, and 16 x 32 with 2 x 2 (128 threads) where
// the larger tiles would leave the card under-filled (side 250: 128 CTAs).
// Slabs of K (8 to 32 deep) are staged through shared memory by cp.async,
// as many in flight as 64 KB holds (up to 8), one barrier a slab; A is
// stored transposed (one 4- or 8-byte copy an element, any alignment) so
// a thread reads its rows of A and its columns of B as 8- or 16-byte
// vectors, each thread's rows and columns in groups of one vector so a
// warp's loads do not conflict.  B is copied 16 bytes at a time where its
// pointer, row stride and instance stride allow it, else an element at a
// time (the strided basis slices): a load path inside the kernel, not a
// fallback.  Interior slabs copy without bounds; the epilogue reads C and
// writes out a vector at a time where their rows are aligned.
//
// K5b (the _batch entry points) replaces the same products of the batch
// driver's vmapped polar_psd (cones.py:62-109 under
// proxsdp_tpu/parallel/batch.py:141): one launch a product for the whole
// batch, grid z over the instances, each operand at its own instance
// stride; every instance's product is rounded as K5 rounds it.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "cp_async.cuh"

namespace {

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// W consecutive shared values (W * sizeof(T) <= 16 bytes, so aligned)
template <int W>
__device__ __forceinline__ void lds_vec(float* d, const float* s) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  } else if constexpr (W == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    d[0] = v.x, d[1] = v.y;
  } else {
    d[0] = s[0];
  }
}
template <int W>
__device__ __forceinline__ void lds_vec(double* d, const double* s) {
  if constexpr (W == 2) {
    const double2 v = *reinterpret_cast<const double2*>(s);
    d[0] = v.x, d[1] = v.y;
  } else {
    d[0] = s[0];
  }
}

// W consecutive global values as one vector (aligned to W * sizeof(T))
template <int W, typename T>
__device__ __forceinline__ void ldg_vec(T* d, const T* s) {
  if constexpr (W * sizeof(T) == 16) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    memcpy(d, &v, 16);
  } else if constexpr (W * sizeof(T) == 8) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    memcpy(d, &v, 8);
  } else {
    d[0] = s[0];
  }
}
template <int W, typename T>
__device__ __forceinline__ void stg_vec(T* d, const T* s) {
  if constexpr (W * sizeof(T) == 16) {
    float4 v;
    memcpy(&v, s, 16);
    *reinterpret_cast<float4*>(d) = v;
  } else if constexpr (W * sizeof(T) == 8) {
    float2 v;
    memcpy(&v, s, 8);
    *reinterpret_cast<float2*>(d) = v;
  } else {
    d[0] = s[0];
  }
}

// A thread's TM rows (or TN columns) of a BM-row tile, in groups of W
// consecutive ones (one 16-byte vector at most), the groups BM / (TM / W)
// apart: neighbouring threads read neighbouring vectors, so a warp's
// vector loads do not conflict
template <int TM, int BM, int W>
__device__ __forceinline__ int frag_index(int t, int i) {
  return (i / W) * (BM / (TM / W)) + t * W + (i % W);
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
struct Tile {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLdA = BM + kChunk;  // rows of A^T stay 16-byte aligned
  // the vector width of a thread's fragment groups
  static constexpr int kW = TM < kChunk ? TM : kChunk;
  static constexpr int kWn = TN < kChunk ? TN : kChunk;
  // 8 x 8 outputs a thread take the registers of one CTA an SM
  static constexpr int kMinBlocks = TM * TN >= 64 ? 1 : 2;
  // slabs in flight: as many as 64 KB of shared memory holds, <= 8
  static constexpr int kStageBytes =
      BK * (kLdA + BN) * static_cast<int>(sizeof(T));
  static constexpr int kStages =
      64 * 1024 / kStageBytes > 8 ? 8 : 64 * 1024 / kStageBytes;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kStages >= 2, "two slabs at least");
  static_assert(kThreads % BK == 0 && (BM * BK) % kThreads == 0 &&
                    kThreads % BN == 0 && (BK * BN) % kThreads == 0 &&
                    kThreads % (BN / kChunk) == 0 &&
                    (BK * BN / kChunk) % kThreads == 0,
                "tile copies must divide over the threads");
};

template <typename T, int BM, int BN, int BK, int TM, int TN, bool kVecB>
__global__ void __launch_bounds__((Tile<T, BM, BN, BK, TM, TN>::kThreads),
                                  (Tile<T, BM, BN, BK, TM, TN>::kMinBlocks))
gemm_axpby_kernel(const T* __restrict__ A, int64_t lda,
                  const T* __restrict__ B, int64_t ldb,
                  const T* __restrict__ C, int64_t ldc, T* __restrict__ out,
                  int64_t M, int64_t N, int64_t K, T alpha, T beta,
                  int64_t sa, int64_t sb, int64_t sc) {
  using Cfg = Tile<T, BM, BN, BK, TM, TN>;
  constexpr int kThreads = Cfg::kThreads, kStages = Cfg::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // kStages slabs of A^T (As[k][row]), then of B (Bs[k][col])
  T(*const As)[BK][Cfg::kLdA] =
      reinterpret_cast<T(*)[BK][Cfg::kLdA]>(smem_raw);
  T(*const Bs)[BK][BN] = reinterpret_cast<T(*)[BK][BN]>(
      smem_raw + kStages * BK * Cfg::kLdA * sizeof(T));
  // instance blockIdx.z of a batch (K5b; z = 0 for K5)
  const int64_t z = blockIdx.z;
  A += z * sa;
  B += z * sb;
  if (C) C += z * sc;
  out += z * M * N;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * BN;

  // this thread's copies of a slab at k0: A's rows a_row + u * kARows of
  // the tile at column a_col (a warp reads whole runs of a row), stored
  // transposed; B's rows b_row + u * kBRows at column b_col
  constexpr int kARows = kThreads / BK;
  const int a_row = tid / BK, a_col = tid % BK;
  const T* const a_src = A + (r0 + a_row) * lda + a_col;
  constexpr int kBPer = kVecB ? BN / Cfg::kChunk : BN;  // copies a row
  constexpr int kBRows = kThreads / kBPer;
  const int b_row = tid / kBPer;
  const int b_col = (tid % kBPer) * (kVecB ? Cfg::kChunk : 1);
  const T* const b_src = B + static_cast<int64_t>(b_row) * ldb + c0 + b_col;
  // B's columns this thread copies that lie inside N
  const int64_t b_left = N - c0 - b_col;
  const int b_valid = static_cast<int>(
      b_left < 0 ? 0 : (b_left > Cfg::kChunk ? Cfg::kChunk : b_left));

  auto stage = [&](int64_t k0, int buf) {
#pragma unroll
    for (int u = 0; u < BM * BK / kThreads; ++u) {
      const int m = a_row + u * kARows;
      const bool ok = r0 + m < M && k0 + a_col < K;
      cp_elem(&As[buf][a_col][m], ok ? a_src + u * kARows * lda + k0 : A, ok);
    }
#pragma unroll
    for (int u = 0; u < BK * BN / (kVecB ? Cfg::kChunk : 1) / kThreads; ++u) {
      const int kk = b_row + u * kBRows;
      const T* const src = b_src + (k0 + u * kBRows) * ldb;
      if constexpr (kVecB) {
        const int bytes = k0 + kk < K ? b_valid * static_cast<int>(sizeof(T))
                                      : 0;
        cp_16(&Bs[buf][kk][b_col], bytes ? src : B, bytes);
      } else {
        const bool ok = k0 + kk < K && b_left > 0;
        cp_elem(&Bs[buf][kk][b_col], ok ? src : B, ok);
      }
    }
    cp_commit();
  };

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  // one k of the slab: the thread's TM x TN multiply-adds
  auto step = [&](int buf, int kk) {
    T a[TM], b[TN];
#pragma unroll
    for (int g = 0; g < TM; g += Cfg::kW)
      lds_vec<Cfg::kW>(a + g,
                       &As[buf][kk][frag_index<TM, BM, Cfg::kW>(ty, g)]);
#pragma unroll
    for (int g = 0; g < TN; g += Cfg::kWn)
      lds_vec<Cfg::kWn>(b + g,
                        &Bs[buf][kk][frag_index<TN, BN, Cfg::kWn>(tx, g)]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fma_rn(a[i], b[j], acc[i][j]);
  };

  // kStages - 1 slabs in flight ahead of the one computed, one copy
  // group each (empty past the end), one barrier a slab
  const int64_t nslab = (K + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nslab) {
      stage(st * BK, st);
    } else {
      cp_commit();
    }
  }
  for (int64_t s = 0; s < nslab; ++s) {
    cp_wait<kStages - 2>();  // slab s has landed (this thread's copies)
    __syncthreads();         // ... everyone's; slab s - 1's buffer is free
    const int64_t next = s + kStages - 1;
    if (next < nslab) {
      stage(next * BK, static_cast<int>(next % kStages));
    } else {
      cp_commit();
    }
    const int buf = static_cast<int>(s % kStages);
    const int64_t left = K - s * BK;
    if (left >= BK) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) step(buf, kk);
    } else {  // the last, partial slab: only its own terms, in order
      for (int kk = 0; kk < static_cast<int>(left); ++kk) step(buf, kk);
    }
  }

  // the epilogue, a group of kWn columns as one vector where the rows of
  // out and C allow it; alpha * C and beta * acc rounded, then added
  constexpr int kWn = Cfg::kWn;
  const bool vec_out =
      N % kWn == 0 &&
      (!C || (ldc % kWn == 0 && (gridDim.z < 2 || sc % kWn == 0) &&
              reinterpret_cast<uintptr_t>(C) % (kWn * sizeof(T)) == 0));
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = r0 + frag_index<TM, BM, Cfg::kW>(ty, i);
    if (r >= M) continue;
#pragma unroll
    for (int g = 0; g < TN; g += kWn) {
      const int64_t c = c0 + frag_index<TN, BN, kWn>(tx, g);
      if (vec_out && c + kWn <= N) {
        T cv[kWn], v[kWn];
        if (C) ldg_vec<kWn>(cv, C + r * ldc + c);
#pragma unroll
        for (int w = 0; w < kWn; ++w) {
          const T prod = beta * acc[i][g + w];
          v[w] = C ? alpha * cv[w] + prod : prod;
        }
        stg_vec<kWn>(out + r * N + c, v);
      } else {
#pragma unroll
        for (int w = 0; w < kWn; ++w) {
          if (c + w < N) {
            const T prod = beta * acc[i][g + w];
            out[r * N + c + w] = C ? alpha * C[r * ldc + c + w] + prod : prod;
          }
        }
      }
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch_tile(bool vec_b, const T* A, int64_t lda, int64_t sa, const T* B,
                int64_t ldb, int64_t sb, const T* C, int64_t ldc, int64_t sc,
                T* out, int64_t M, int64_t N, int64_t K, int64_t nb, T alpha,
                T beta, cudaStream_t stream) {
  using Cfg = Tile<T, BM, BN, BK, TM, TN>;
  auto kernel = vec_b ? gemm_axpby_kernel<T, BM, BN, BK, TM, TN, true>
                      : gemm_axpby_kernel<T, BM, BN, BK, TM, TN, false>;
  // above 48 KB a kernel's dynamic shared memory needs its attribute (set
  // once a process for each instantiation)
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(gemm_axpby_kernel<T, BM, BN, BK, TM, TN, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Cfg::kSmem),
      cudaFuncSetAttribute(gemm_axpby_kernel<T, BM, BN, BK, TM, TN, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Cfg::kSmem)};
  if (attr[vec_b] != cudaSuccess) return static_cast<int>(attr[vec_b]);
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>(nb));
  kernel<<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
      A, lda, B, ldb, C, ldc, out, M, N, K, alpha, beta, sa, sb, sc);
  return static_cast<int>(cudaGetLastError());
}

int64_t tiles(int64_t M, int64_t N, int64_t nb, int64_t bm, int64_t bn) {
  return ((M + bm - 1) / bm) * ((N + bn - 1) / bn) * nb;
}

// the shape table: the largest tile that still gives the card about one
// CTA an SM (132 SMs)
constexpr int64_t kFill = 128;

template <typename T>
int launch(const void* A_, int64_t lda, int64_t sa, const void* B_,
           int64_t ldb, int64_t sb, const void* C_, int64_t ldc, int64_t sc,
           void* out_, int64_t M, int64_t N, int64_t K, int64_t nb,
           double alpha_, double beta_, void* stream_) {
  if (nb < 1 || nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const T* A = static_cast<const T*>(A_);
  const T* B = static_cast<const T*>(B_);
  const T* C = static_cast<const T*>(C_);
  T* out = static_cast<T*>(out_);
  const T alpha = static_cast<T>(alpha_), beta = static_cast<T>(beta_);
  auto stream = static_cast<cudaStream_t>(stream_);
  // B's 16-byte copies need every row (and instance) of B 16-byte aligned
  constexpr int64_t kc = 16 / sizeof(T);
  const bool vec_b = reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                     (K < 2 || ldb % kc == 0) && (nb < 2 || sb % kc == 0);
  if (tiles(M, N, nb, 128, 128) >= kFill)  // f32 16 deep, f64 8
    return launch_tile<T, 128, 128, 64 / sizeof(T), 8, 8>(
        vec_b, A, lda, sa, B, ldb, sb, C, ldc, sc, out, M, N, K, nb, alpha,
        beta, stream);
  if (tiles(M, N, nb, 64, 64) >= kFill)
    return launch_tile<T, 64, 64, 16, 4, 4>(vec_b, A, lda, sa, B, ldb, sb, C,
                                            ldc, sc, out, M, N, K, nb, alpha,
                                            beta, stream);
  // a tall product with few columns (the reseed's basis slices): 64 rows
  // a CTA, so fewer CTAs share each slab of B
  if (tiles(M, N, nb, 64, 32) >= kFill)
    return launch_tile<T, 64, 32, 32, 4, 2>(vec_b, A, lda, sa, B, ldb, sb, C,
                                            ldc, sc, out, M, N, K, nb, alpha,
                                            beta, stream);
  return launch_tile<T, 16, 32, 32, 2, 2>(vec_b, A, lda, sa, B, ldb, sb, C,
                                          ldc, sc, out, M, N, K, nb, alpha,
                                          beta, stream);
}

}  // namespace

// C may be null (then out = beta * (A @ B)); out is contiguous (M, N).
extern "C" int proxsdp_ns_gemm_f32(const void* A, int64_t lda, const void* B,
                                   int64_t ldb, const void* C, int64_t ldc,
                                   void* out, int64_t M, int64_t N, int64_t K,
                                   double alpha, double beta, void* stream) {
  return launch<float>(A, lda, 0, B, ldb, 0, C, ldc, 0, out, M, N, K, 1,
                       alpha, beta, stream);
}

extern "C" int proxsdp_ns_gemm_f64(const void* A, int64_t lda, const void* B,
                                   int64_t ldb, const void* C, int64_t ldc,
                                   void* out, int64_t M, int64_t N, int64_t K,
                                   double alpha, double beta, void* stream) {
  return launch<double>(A, lda, 0, B, ldb, 0, C, ldc, 0, out, M, N, K, 1,
                        alpha, beta, stream);
}

// K5b: nb instances, operand z at A + z * sa, B + z * sb, C + z * sc (sc
// ignored for a null C); out contiguous (nb, M, N).
extern "C" int proxsdp_ns_gemm_batch_f32(const void* A, int64_t lda,
                                         int64_t sa, const void* B,
                                         int64_t ldb, int64_t sb,
                                         const void* C, int64_t ldc,
                                         int64_t sc, void* out, int64_t M,
                                         int64_t N, int64_t K, int64_t nb,
                                         double alpha, double beta,
                                         void* stream) {
  return launch<float>(A, lda, sa, B, ldb, sb, C, ldc, sc, out, M, N, K, nb,
                       alpha, beta, stream);
}

extern "C" int proxsdp_ns_gemm_batch_f64(const void* A, int64_t lda,
                                         int64_t sa, const void* B,
                                         int64_t ldb, int64_t sb,
                                         const void* C, int64_t ldc,
                                         int64_t sc, void* out, int64_t M,
                                         int64_t N, int64_t K, int64_t nb,
                                         double alpha, double beta,
                                         void* stream) {
  return launch<double>(A, lda, sa, B, ldb, sb, C, ldc, sc, out, M, N, K, nb,
                        alpha, beta, stream);
}
