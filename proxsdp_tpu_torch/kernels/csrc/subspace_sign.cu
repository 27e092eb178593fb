// K17: the sign-based subspace step's k x k work and its acceptance test.
//
// Replaces: proxsdp_tpu/ops/cones.py:337-410 (_subspace_body_sign) from
// the Rayleigh quotient to the accept decision, and the k x k half of
// its reconstruct (398-399, 408-410).  With Q the CholeskyQR2 basis
// (side, k) and Z = X Q (both from the caller):
//   B   = sym(Q^T Z),                       sF = ||B||_F + 1e-30
//   Y   = B / sF; aggressive quintic steps Y = QA Y + Y (QB A2 + QC A2^2)
//         with A2 = Y Y, then polish cubic steps Y = 1.5 Y - 0.5 Y (Y Y)
//   S   = sym(Y),  npos = (k + tr S) / 2,    Pp = (I + S) / 2
//   R   = (Z - Q B) Pp,                      rfro = ||R||_F
//   conv_ok = rfro <= max(subspace_tol, accept_tol) * max(sF, 1)
//             & (k - npos >= 0.5) & (||S S - I||_F <= 0.05 sqrt(k))
//             & !force_full
//   stats = [rfro / max(sF, 1), npos - k, npos]
//   Bp  = sym((B + S B) / 2),   rank = clip(round(npos), 0, k)
// and info = int32 [conv_ok, rank, any entry of B non-finite] (rank 0
// where npos is not finite).  f32 only: the JAX gate (cones.py:317-321)
// sends nothing else there.  The caller reads info once and, on accept,
// reconstructs Q Bp Q^T with a library product.
//
// Bound on the H100: Q and Z read once (2 side k words) against ~2 side
// k^2 (Q^T Z) + 2 side k^2 (Q B) + 2 side k^2 (the residual's Pp product)
// + 2 k^3 x (3 aggressive + 2 polish + 2) flops -- microseconds at every
// bucket.  The work is a chain of ~30 dependent k x k products, so the
// kernel is latency-bound.  Design: one CTA.  The k x k matrices (four of
// them) live in dynamic shared memory for k <= 64 (4 x 16 KB at k = 64)
// and in a device workspace of the wrapper's above (k = 96-256, up to
// 1 MB, read through L1/L2), as K7 holds G past its shared memory.  Each
// product is a loop over the output entries spread over the block, each
// entry a sum over l in order.  The side-long work (Q^T Z, the residual)
// walks Q and Z in tiles of kRows rows staged in shared memory, in row
// order.  The reductions (||B||_F, tr S, ||SS - I||_F, ||R||_F, the
// non-finite count) sum in f64 in a fixed order (warp shuffles, then the
// warps in turn), so the result is the same from run to run.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;  // rows of Q and Z in a staged tile

constexpr float kQA = 3.4445f, kQB = -4.7750f, kQC = 2.0315f;

// the block's sum of one f64 value a thread; every thread gets it
__device__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();  // red is free: its last reader has passed
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int i = 0; i < kWarps; ++i) s += red[i];
    red[kWarps] = s;
  }
  __syncthreads();
  return red[kWarps];
}

// C = alpha * D + beta * (A B) on k x k row-major matrices (D may be C's
// input only where alpha != 0; C must not alias A, B or D).
__device__ void mm(float* C, const float* A, const float* B, const float* D,
                   float alpha, float beta, int k) {
  for (int e = threadIdx.x; e < k * k; e += kThreads) {
    const int i = e / k, j = e % k;
    const float* a = A + i * k;
    float acc = 0.0f;
    for (int l = 0; l < k; ++l) acc = __fmaf_rn(a[l], B[l * k + j], acc);
    C[e] = alpha != 0.0f ? alpha * D[e] + beta * acc : beta * acc;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
subspace_sign_kernel(const float* __restrict__ Q, const float* __restrict__ Z,
                     const float* __restrict__ accept_tol, float* ws,
                     float* __restrict__ bp_out, float* __restrict__ stats,
                     int* __restrict__ info, int64_t side, int k,
                     float subspace_tol, int aggressive, int polish,
                     int force_full) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double red[kWarps + 1];
  const int t = threadIdx.x;
  const int kk = k * k;
  float* mats = ws ? ws : smem;
  float* tiles = ws ? smem : smem + 4 * kk;
  float* Qt = tiles;              // kRows x k
  float* Zt = tiles + kRows * k;  // kRows x k
  float* P0 = mats;
  float* P1 = mats + kk;
  float* P2 = mats + 2 * kk;
  float* P3 = mats + 3 * kk;

  // ---- raw Q^T Z into P0, tile by tile, rows in order
  for (int e = t; e < kk; e += kThreads) P0[e] = 0.0f;
  for (int64_t r0 = 0; r0 < side; r0 += kRows) {
    const int nr = static_cast<int>(side - r0 < kRows ? side - r0 : kRows);
    __syncthreads();  // the previous tile's readers are done
    for (int e = t; e < nr * k; e += kThreads) {
      Qt[e] = Q[r0 * k + e];
      Zt[e] = Z[r0 * k + e];
    }
    __syncthreads();
    for (int e = t; e < kk; e += kThreads) {
      const int i = e / k, j = e % k;
      float acc = P0[e];
      for (int r = 0; r < nr; ++r) acc = __fmaf_rn(Qt[r * k + i], Zt[r * k + j], acc);
      P0[e] = acc;
    }
  }
  __syncthreads();
  // ---- B = sym(Q^T Z) in P1; ||B||_F and the non-finite count
  float* Bm = P1;
  double sq = 0.0, nonfin = 0.0;
  for (int e = t; e < kk; e += kThreads) {
    const int i = e / k, j = e % k;
    const float b = 0.5f * (P0[e] + P0[j * k + i]);
    Bm[e] = b;
    sq += static_cast<double>(b) * b;
    nonfin += isfinite(b) ? 0.0 : 1.0;
  }
  const double sumsq = block_sum(sq, red);
  const double nbad = block_sum(nonfin, red);
  const float sF = sqrtf(static_cast<float>(sumsq)) + 1e-30f;
  // ---- Newton-Schulz sign of B / sF; Y in P0, scratch P2, P3
  float* Y = P0;
  float* A2 = P2;
  float* T = P3;
  for (int e = t; e < kk; e += kThreads) Y[e] = Bm[e] / sF;
  __syncthreads();
  for (int it = 0; it < aggressive; ++it) {
    mm(A2, Y, Y, nullptr, 0.0f, 1.0f, k);
    mm(T, A2, A2, A2, kQB, kQC, k);  // QB A2 + QC A2^2
    mm(A2, Y, T, Y, kQA, 1.0f, k);   // QA Y + Y T
    float* tmp = Y;
    Y = A2;
    A2 = tmp;
  }
  for (int it = 0; it < polish; ++it) {
    mm(A2, Y, Y, nullptr, 0.0f, 1.0f, k);
    mm(T, Y, A2, Y, 1.5f, -0.5f, k);  // 1.5 Y - 0.5 Y (Y Y)
    float* tmp = Y;
    Y = T;
    T = tmp;
  }
  // ---- S = sym(Y) in A2 (Y's buffer and T become scratch)
  float* S = A2;
  double tr = 0.0;
  for (int e = t; e < kk; e += kThreads) {
    const int i = e / k, j = e % k;
    const float s = 0.5f * (Y[e] + Y[j * k + i]);
    S[e] = s;
    if (i == j) tr += s;
  }
  const double trace = block_sum(tr, red);  // syncs: S is complete
  const float npos = 0.5f * (static_cast<float>(k) + static_cast<float>(trace));
  float* F1 = Y;
  float* F2 = T;
  // ||S S - I||_F
  mm(F1, S, S, nullptr, 0.0f, 1.0f, k);
  double se = 0.0;
  for (int e = t; e < kk; e += kThreads) {
    const float d = F1[e] - ((e / k == e % k) ? 1.0f : 0.0f);
    se += static_cast<double>(d) * d;
  }
  const float sign_err = sqrtf(static_cast<float>(block_sum(se, red)));
  // Bp = sym((B + S B) / 2), written out
  mm(F2, S, Bm, Bm, 0.5f, 0.5f, k);
  for (int e = t; e < kk; e += kThreads) {
    const int i = e / k, j = e % k;
    bp_out[e] = 0.5f * (F2[e] + F2[j * k + i]);
  }
  // Pp = (I + S) / 2 in F1
  for (int e = t; e < kk; e += kThreads)
    F1[e] = 0.5f * (((e / k == e % k) ? 1.0f : 0.0f) + S[e]);
  __syncthreads();
  // ---- R = (Z - Q B) Pp, tile by tile; only ||R||_F is kept
  double rs = 0.0;
  for (int64_t r0 = 0; r0 < side; r0 += kRows) {
    const int nr = static_cast<int>(side - r0 < kRows ? side - r0 : kRows);
    __syncthreads();
    for (int e = t; e < nr * k; e += kThreads) {
      Qt[e] = Q[r0 * k + e];
      Zt[e] = Z[r0 * k + e];
    }
    __syncthreads();
    for (int e = t; e < nr * k; e += kThreads) {  // Zt := Z - Q B, in place
      const int r = e / k, j = e % k;
      float acc = 0.0f;
      for (int l = 0; l < k; ++l) acc = __fmaf_rn(Qt[r * k + l], Bm[l * k + j], acc);
      Zt[e] = Zt[e] - acc;
    }
    __syncthreads();
    for (int e = t; e < nr * k; e += kThreads) {
      const int r = e / k, j = e % k;
      float acc = 0.0f;
      for (int l = 0; l < k; ++l) acc = __fmaf_rn(Zt[r * k + l], F1[l * k + j], acc);
      rs += static_cast<double>(acc) * acc;
    }
  }
  const float rfro = sqrtf(static_cast<float>(block_sum(rs, red)));
  if (t == 0) {
    const float scale = fmaxf(sF, 1.0f);
    float thresh = subspace_tol;
    if (accept_tol) {
      const float at = *accept_tol;
      thresh = (isnan(at) || at > thresh) ? at : thresh;  // jnp.maximum
    }
    const bool ok_resid = rfro <= thresh * scale;
    const bool covers = (static_cast<float>(k) - npos) >= 0.5f;
    const bool sign_ok = sign_err <= 0.05f * sqrtf(static_cast<float>(k));
    const bool conv = ok_resid && covers && sign_ok && !force_full;
    stats[0] = rfro / scale;
    stats[1] = npos - static_cast<float>(k);
    stats[2] = npos;
    int rank = 0;
    if (isfinite(npos)) {
      const float rr = fminf(fmaxf(rintf(npos), 0.0f), static_cast<float>(k));
      rank = static_cast<int>(rr);
    }
    info[0] = conv ? 1 : 0;
    info[1] = rank;
    info[2] = nbad > 0.0 ? 1 : 0;
  }
}

}  // namespace

// Q, Z: contiguous (side, k) f32; accept_tol: a device f32 scalar or
// null; ws: null (the four k x k matrices in 16 k^2 bytes of dynamic
// shared memory) or a 4 k^2 f32 workspace in device memory; bp_out (k, k)
// f32, stats (3,) f32, info (3,) int32.
extern "C" int proxsdp_subspace_sign_f32(const void* Q, const void* Z,
                                         const void* accept_tol, void* ws,
                                         void* bp_out, void* stats, void* info,
                                         int64_t side, int64_t k,
                                         double subspace_tol,
                                         int64_t aggressive, int64_t polish,
                                         int64_t force_full, void* stream) {
  const size_t tiles = 2 * static_cast<size_t>(kRows) * k * sizeof(float);
  const size_t smem = tiles + (ws ? 0 : 4 * static_cast<size_t>(k) * k * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      subspace_sign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  subspace_sign_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Q), static_cast<const float*>(Z),
      static_cast<const float*>(accept_tol), static_cast<float*>(ws),
      static_cast<float*>(bp_out), static_cast<float*>(stats),
      static_cast<int*>(info), side, static_cast<int>(k),
      static_cast<float>(subspace_tol), static_cast<int>(aggressive),
      static_cast<int>(polish), static_cast<int>(force_full));
  return static_cast<int>(cudaGetLastError());
}
