// K9L: K9's batched dense PSD projection for sides past one block's shared
// memory, the matrix and its rotations in a workspace in device memory.
//
// Replaces: proxsdp_tpu/ops/cones.py:622-675 (psd_projection_small_batch)
// and the vmapped full_path of cones.py:204-211 that the batch driver
// (proxsdp_tpu/parallel/batch.py:141) runs for every instance, at the
// sides K9 (batched_eigh.cu) cannot hold: s > 118 in f64, s > 168 in f32.
// For each of B symmetric s x s matrices X_b, with X_b = V diag(w) V^T
// and w ascending, the outputs are K9's:
//   Xp_b   = V diag(max(w, 0)) V^T     (written symmetric: Xp_ij = Xp_ji)
//   w_b    = w
//   rank_b = #{k : w_k > tol_psd}
//   warm_b = V[:, s - 1], the eigenvector of the largest eigenvalue;
// NaN in Xp_b, w_b and warm_b and rank 0 for an instance with a
// non-finite entry.
//
// Arithmetic: jacobi.cuh's cyclic parallel-order Jacobi in f64 with its
// global stop (off-diagonal ||.||_F <= eps ||A||_F), the same rotations
// in the same order and the same fixed-order sums as K9's f64 instance,
// so in f64 the two give the same bits where both run.  An f32 input is
// worked in f64 too and its outputs rounded to f32: K9's f32 Jacobi lies
// 1.3e-4, 3.0e-4 and 9.9e-4 of the largest entry from cuSOLVER at sides
// 169, 250 and 500 (its rotations' rounding grows with the side), which
// moved side-250 batch answers by up to 3.7e-4 (1 + |obj|) from the JAX
// package's, whose f32 eigh is LAPACK's (PERF.md, ROADMAP C15).
//
// Layout: the rows and columns of A and the columns of V are stored in the
// order of the round's slots (Brent and Luk): round r pairs slot t with
// slot n - 1 - t, and slot t >= 1 holds index (r + t) mod (n - 1), slot 0
// index n - 1 -- jacobi.cuh's round-robin pairs (round_pair).  A round
// writes its result into a second copy, each index moved to its slot of
// the next round (slot t to t - 1, slot 1 to n - 1), so a warp reads 32
// consecutive slots of a row and 32 consecutive partner slots (reversed)
// and writes 32 consecutive slots: every access is coalesced.  After n - 1
// rounds, at every sweep's start, the layout is round 0's again: indices
// 0 and n - 1 swapped, the others in place.  One round's two passes of
// jacobi.cuh (A <- A J, then A <- J^T A) are fused, each entry rounded as
// the two passes round it.
//
// Bound on the H100: ~10.5 s^3 flops a matrix (an eigendecomposition ~9
// s^3, the reconstruction ~1.5 s^3) against reading X and writing Xp, w,
// rank and warm: operations bind it (at s = 250, B = 16: 2.6 GFLOP, 39 us
// at 67 TFLOP/s).  Jacobi does ~9 s^3 flops on every sweep, and each of a
// sweep's s - 1 rounds reads and writes all of A and V (4 s^2 words a
// round, ~500 MB a sweep at s = 250).  A round waits on L2 latency, and
// one SM per matrix (B = 16 uses 16 of 132) leaves most of the card idle.
// Design: G CTAs of 512 threads per matrix (G = 16, 8, ... down to the
// largest power of two whose grid stays resident, a cooperative launch;
// where even B CTAs cannot all be resident, G = 1 and the batch goes in
// cooperative launches of as many matrices as stay resident), each taking
// every G-th row pair of A and row of V, a warp along a row; the CTAs of
// a launch meet at a grid barrier after each round, reading
// what the others wrote from L2 (__ldcg), and each computes the round's
// angles itself.  The stop test's 128 partial sums (K9's order) are
// spread over the matrix's CTAs and folded by each; every CTA folds every
// matrix's test, so all agree when the launch stops meeting (a converged
// matrix idles through the later rounds).  A, V and their second copies
// in f64 (4 n^2 words, n the side padded to even: 2 MB an instance at s =
// 250, so B = 16 of them stay in the 50 MB L2); a round's slot map and
// angles, the ranked eigenvalues and two 32 x 32 tiles of the
// reconstruction (its tiles dealt over the matrix's CTAs) in shared
// memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "jacobi.cuh"

namespace {

namespace cg = cooperative_groups;
using proxsdp::JacobiLimits;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// K9's reduction width: its sums run over 128 threads' partials, and
// K9L's repeat them in the same order
constexpr int kRed = 128;
constexpr int kTile = 32;
constexpr int kMaxParts = 16;  // CTAs a matrix (a power of two)
constexpr int kMaxMats = 1024;  // matrices a launch
using W = double;              // the working type

// a value another CTA of this launch may have written (L2, not L1)
__device__ __forceinline__ W ld(const W* p) { return __ldcg(p); }

// round 0's slot of index i (indices 0 and n - 1 swapped)
__device__ __forceinline__ int slot0(int i, int n) {
  return i == 0 ? n - 1 : (i == n - 1 ? 0 : i);
}

// the next round's slot of the index at slot u (t to t - 1, 1 to n - 1)
__device__ __forceinline__ int next_slot(int u, int n) {
  return u == 0 ? 0 : (u == 1 ? n - 1 : u - 1);
}

// K9's tree over 128 partials (block_sum<128>); every thread calls it
__device__ double sum128(const double* parts, double* red) {
  const int t = threadIdx.x;
  if (t < kRed) red[t] = __ldcg(parts + t);
  __syncthreads();
  for (int st = kRed / 2; st > 0; st >>= 1) {
    if (t < st) red[t] += red[t + st];
    __syncthreads();
  }
  const double out = red[0];
  __syncthreads();
  return out;
}

// this CTA's share of K9's 128 partial sums of squares of A's entries
// (off the diagonal only with off_only): K9's thread v sums the row-major
// entries e = v, v + 128, ... in index order; A is in round 0's layout
__device__ void sq_parts(const W* A, int n, int g, int G, bool off_only,
                         double* parts) {
  const int per = kRed / G;
  if (threadIdx.x < per) {
    const int v = g * per + threadIdx.x;
    double part = 0.0;
    for (int e = v; e < n * n; e += kRed) {
      const int i = e / n, j = e % n;
      if (off_only && i == j) continue;
      const double x = ld(A + slot0(i, n) * n + slot0(j, n));
      part += x * x;
    }
    parts[v] = part;
  }
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
    batched_psd_eigh_large_kernel(const In* __restrict__ X, In* __restrict__ Xp,
                                  In* __restrict__ w_out,
                                  int32_t* __restrict__ rank_out,
                                  In* __restrict__ warm_out, W* ws,
                                  double* parts, int* bad_flags, int s, int G,
                                  double tol_psd) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red[kRed];
  __shared__ int s_all;
  const int n = s + (s & 1);  // padded to even
  const int half = n / 2, m = n - 1;
  W* cs = reinterpret_cast<W*>(smem);  // half cosines of the round
  W* sn = cs + half;                   // half sines
  W* wsort = sn + half;                // n: the eigenvalues, ascending
  W* pos = wsort + n;                  // n: the diagonal, then max(w, 0)
  W* Pt = pos + n;                     // kTile x (kTile + 1): V_ik max(w_k, 0)
  W* Qt = Pt + kTile * (kTile + 1);    // kTile x (kTile + 1): V_jk
  // the matrices whose stop tests this CTA folds: every one of the launch
  // (all must agree when to stop meeting)
  const int nmat = gridDim.x / G;
  double* thresh = Qt + kTile * (kTile + 1);  // nmat: each one's stop
  int* perm = reinterpret_cast<int*>(thresh + nmat);  // n
  int* sig = perm + n;                 // n: the round's slot -> index

  cg::grid_group grid = cg::this_grid();
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int64_t nn = static_cast<int64_t>(n) * n;
  W* A = ws + b * 4 * nn;  // n * n, rows and columns in slot order
  W* V = A + nn;           // n * n, row i, columns in slot order
  W* A2 = V + nn;          // the second copies
  W* V2 = A2 + nn;
  double* pfro = parts + static_cast<int64_t>(b) * 2 * kRed;
  double* poff = pfro + kRed;
  const In* Xb = X + static_cast<int64_t>(b) * s * s;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;

  // ---- load this CTA's rows in round 0's layout, V = I; the finiteness
  // of the whole matrix (CTA 0 of it)
  for (int i = g; i < n; i += G) {
    for (int j = t; j < n; j += kThreads) {
      W v = W(0);
      if (i < s && j < s) v = static_cast<W>(Xb[i * s + j]);
      A[slot0(i, n) * n + slot0(j, n)] = v;
      V[i * n + slot0(j, n)] = i == j ? W(1) : W(0);
    }
  }
  if (g == 0) {
    int bad = 0;
    for (int e = t; e < s * s; e += kThreads) bad |= !isfinite(Xb[e]);
    bad = __syncthreads_or(bad);
    if (t == 0) bad_flags[b] = bad;
  }
  grid.sync();
  sq_parts(A, n, g, G, false, pfro);
  grid.sync();
  const double eps = JacobiLimits<W>::eps;
  for (int k = 0; k < nmat; ++k) {
    const double fro2 = sum128(parts + k * 2 * kRed, red);
    if (t == 0) thresh[k] = eps * eps * fro2;
  }
  __syncthreads();
  const bool bad = __ldcg(bad_flags + b) != 0;
  bool done = bad;

  // ---- the Jacobi sweeps
  for (int sweep = 0; sweep < JacobiLimits<W>::max_sweeps; ++sweep) {
    sq_parts(A, n, g, G, true, poff);
    grid.sync();
    int all = 1;
    for (int k = 0; k < nmat; ++k) {
      const double off = sum128(parts + k * 2 * kRed + kRed, red);
      const bool ok = __ldcg(bad_flags + k) != 0 || off <= thresh[k];
      all &= ok;
      if (k == b) done = ok;
    }
    if (t == 0) s_all = all;
    __syncthreads();
    if (s_all) break;  // the same answer in every CTA of the launch
    for (int r = 0; r < m; ++r) {
      if (!done) {
        // the round's slot -> index map and angles (every CTA of the
        // matrix computes them all): pair k is slots k and m - k, indices
        // p < q; apq read at (row p, column q) as K9 does
        for (int u = t; u < n; u += kThreads)
          sig[u] = u == 0 ? m : (r + u) % m;
        for (int k = t; k < half; k += kThreads) {
          const int i1 = k == 0 ? m : (r + k) % m, i2 = (r + m - k) % m;
          const int sp = i1 < i2 ? k : m - k, sq = i1 < i2 ? m - k : k;
          const W apq = ld(A + sp * n + sq);
          W c = W(1), sv = W(0);
          if (apq != W(0)) {
            const W tau =
                (ld(A + sq * n + sq) - ld(A + sp * n + sp)) / (W(2) * apq);
            const W abs_tau = tau >= W(0) ? tau : -tau;
            const W tt = (tau >= W(0) ? W(1) : W(-1)) /
                         (abs_tau + sqrt(W(1) + tau * tau));
            c = W(1) / sqrt(W(1) + tt * tt);
            sv = tt * c;
          }
          cs[k] = c;
          sn[k] = sv;
        }
        __syncthreads();
        // A2 = J^T (A J), moved to the next round's slots: this CTA's row
        // pairs k (slots k and m - k), a warp each, its lanes the column
        // slots b (partner slot m - b)
        for (int k = g * kWarps + warp; k < half; k += G * kWarps) {
          const int i1 = sig[k], i2 = sig[m - k];
          const int sp = i1 < i2 ? k : m - k, sq = i1 < i2 ? m - k : k;
          const int p = i1 < i2 ? i1 : i2, q = i1 < i2 ? i2 : i1;
          const W cI = cs[k], sI = sn[k];
          const W* rp = A + sp * n;
          const W* rq = A + sq * n;
          W* wp = A2 + next_slot(sp, n) * n;
          W* wq = A2 + next_slot(sq, n) * n;
#pragma unroll 2
          for (int c = lane; c < n; c += 32) {
            const int pc = m - c, J = c < pc ? c : pc;
            const int ic = sig[c];
            const W cJ = cs[J], sJ = sn[J];
            const W apc = ld(rp + c), appc = ld(rp + pc);
            const W aqc = ld(rq + c), aqpc = ld(rq + pc);
            W tp, tq;
            if (ic < sig[pc]) {  // c holds its pair's first index
              tp = cJ * apc - sJ * appc;
              tq = cJ * aqc - sJ * aqpc;
            } else {
              tp = sJ * appc + cJ * apc;
              tq = sJ * aqpc + cJ * aqc;
            }
            const int nc = next_slot(c, n);
            wp[nc] = ic == q ? W(0) : cI * tp - sI * tq;
            wq[nc] = ic == p ? W(0) : sI * tp + cI * tq;
          }
        }
        // V2 = V J, its columns moved to the next round's slots: this
        // CTA's rows, a warp each
        for (int i = g * kWarps + warp; i < n; i += G * kWarps) {
          const W* vr = V + i * n;
          W* vw = V2 + i * n;
#pragma unroll 4
          for (int c = lane; c < n; c += 32) {
            const int pc = m - c, J = c < pc ? c : pc;
            const W cc = cs[J], sv = sn[J];
            const W vc = ld(vr + c), vpc = ld(vr + pc);
            vw[next_slot(c, n)] = sig[c] < sig[pc] ? cc * vc - sv * vpc
                                                   : sv * vpc + cc * vc;
          }
        }
      }
      grid.sync();
      if (!done) {
        W* tmp = A;
        A = A2;
        A2 = tmp;
        tmp = V;
        V = V2;
        V2 = tmp;
      }
    }
  }

  if (bad) {
    if (g == 0) {
      const In nan = static_cast<In>(NAN);
      for (int e = t; e < s * s; e += kThreads)
        Xp[static_cast<int64_t>(b) * s * s + e] = nan;
      for (int i = t; i < s; i += kThreads) {
        w_out[b * s + i] = nan;
        warm_out[b * s + i] = nan;
      }
      if (t == 0) rank_out[b] = 0;
    }
    return;
  }
  // ---- the eigenvalues ranked ascending (ties by index, as jacobi_rank
  // ranks them), in every CTA of the matrix
  W* diag = pos;
  for (int i = t; i < s; i += kThreads) {
    const int si = slot0(i, n);
    diag[i] = ld(A + si * n + si);
  }
  __syncthreads();
  for (int i = t; i < s; i += kThreads) {
    const W wi = diag[i];
    int at = 0;
    for (int j = 0; j < s; ++j) {
      const W wj = diag[j];
      at += (wj < wi || (wj == wi && j < i)) ? 1 : 0;
    }
    wsort[at] = wi;
    perm[at] = slot0(i, n);  // the column of V that holds its vector
  }
  __syncthreads();
  for (int k = t; k < s; k += kThreads) {
    if (g == 0) {
      w_out[b * s + k] = static_cast<In>(wsort[k]);
      warm_out[b * s + k] = static_cast<In>(ld(V + k * n + perm[s - 1]));
    }
    pos[k] = wsort[k] > W(0) ? wsort[k] : W(0);
  }
  if (g == 0 && t == 0) {
    int rank = 0;
    for (int k = 0; k < s; ++k) rank += wsort[k] > tol_psd;
    rank_out[b] = rank;
  }
  __syncthreads();
  // ---- Xp_ij = sum_k (V_ik max(w_k, 0)) V_jk, k ascending (K9's order),
  // on the 32 x 32 tiles of the upper triangle (this CTA's share), mirrored
  In* Xpb = Xp + static_cast<int64_t>(b) * s * s;
  const int nt = (s + kTile - 1) / kTile;
  int tile = 0;
  for (int ti = 0; ti < nt; ++ti) {
    for (int tj = ti; tj < nt; ++tj, ++tile) {
      if (tile % G != g) continue;
      const int i0 = ti * kTile, j0 = tj * kTile;
      W acc[2] = {W(0), W(0)};
      for (int k0 = 0; k0 < s; k0 += kTile) {
        for (int e = t; e < kTile * kTile; e += kThreads) {
          const int r = e / kTile, kk = e % kTile, k = k0 + kk;
          W pv = W(0), qv = W(0);
          if (k < s) {
            const int col = perm[k];
            if (i0 + r < s) pv = ld(V + (i0 + r) * n + col) * pos[k];
            if (j0 + r < s) qv = ld(V + (j0 + r) * n + col);
          }
          Pt[r * (kTile + 1) + kk] = pv;
          Qt[r * (kTile + 1) + kk] = qv;
        }
        __syncthreads();
        const int kn = s - k0 < kTile ? s - k0 : kTile;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = t + h * kThreads;
          const int r = e / kTile, c = e % kTile;
          W a = acc[h];
          for (int kk = 0; kk < kn; ++kk)
            a += Pt[r * (kTile + 1) + kk] * Qt[c * (kTile + 1) + kk];
          acc[h] = a;
        }
        __syncthreads();
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = t + h * kThreads;
        const int i = i0 + e / kTile, j = j0 + e % kTile;
        if (i < s && j < s && i <= j) {
          Xpb[i * s + j] = static_cast<In>(acc[h]);
          Xpb[j * s + i] = static_cast<In>(acc[h]);
        }
      }
    }
  }
}

size_t smem_bytes(int s, int nmat) {
  const size_t n = s + (s & 1);
  // cs, sn; wsort, pos; the tiles; the stop thresholds; perm, sig
  return (n + 2 * n + 2 * kTile * (kTile + 1) + nmat) * sizeof(W) +
         2 * n * sizeof(int);
}

template <typename In>
int launch(const void* X, void* Xp, void* w, void* rank, void* warm,
           void* ws, void* parts, void* bad_flags, int64_t B, int64_t s,
           double tol_psd, void* stream) {
  static_assert(2 * kThreads == kTile * kTile, "two outputs a thread");
  if (s < 2 || s > 16384) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every CTA folds the stop test of every matrix of its launch: up to
  // kMaxMats thresholds in shared memory
  const int64_t mats = B < kMaxMats ? B : kMaxMats;
  const size_t bytes = smem_bytes(static_cast<int>(s), static_cast<int>(mats));
  if (bytes > 232448 - kRed * sizeof(double) - sizeof(int))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(batched_psd_eigh_large_kernel<In>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, batched_psd_eigh_large_kernel<In>, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident = static_cast<int64_t>(nsm) * per_sm;
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // CTAs a matrix: the largest power of two <= kMaxParts whose grid stays
  // resident; at G = 1 the batch goes in launches of as many matrices as
  // stay resident
  int G = kMaxParts;
  while (G > 1 && B * G > resident) G /= 2;
  const int64_t per_launch = resident / G < mats ? resident / G : mats;
  const int64_t n = s + (s & 1);
  int s_i = static_cast<int>(s);
  for (int64_t b0 = 0; b0 < B; b0 += per_launch) {
    const int64_t nb = B - b0 < per_launch ? B - b0 : per_launch;
    const In* Xc = static_cast<const In*>(X) + b0 * s * s;
    In* Xpc = static_cast<In*>(Xp) + b0 * s * s;
    In* wc = static_cast<In*>(w) + b0 * s;
    int32_t* rc = static_cast<int32_t*>(rank) + b0;
    In* wmc = static_cast<In*>(warm) + b0 * s;
    W* wsc = static_cast<W*>(ws) + b0 * 4 * n * n;
    double* pc = static_cast<double*>(parts) + b0 * 2 * kRed;
    int* bc = static_cast<int*>(bad_flags) + b0;
    void* args[] = {&Xc, &Xpc, &wc, &rc, &wmc, &wsc, &pc, &bc,
                    &s_i, &G, &tol_psd};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(batched_psd_eigh_large_kernel<In>),
        dim3(static_cast<unsigned>(nb * G)), dim3(kThreads), args, bytes,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X, Xp: (B, s, s) row-major; w, warm: (B, s); rank: (B,) int32; ws: the
// workspace, B * 4 n^2 doubles (either entry) for n = s rounded up to
// even; parts: B * 256 doubles; bad_flags: B ints.
extern "C" int proxsdp_batched_psd_eigh_large_f64(
    const void* X, void* Xp, void* w, void* rank, void* warm, void* ws,
    void* parts, void* bad_flags, int64_t B, int64_t s, double tol_psd,
    void* stream) {
  return launch<double>(X, Xp, w, rank, warm, ws, parts, bad_flags, B, s,
                        tol_psd, stream);
}

extern "C" int proxsdp_batched_psd_eigh_large_f32(
    const void* X, void* Xp, void* w, void* rank, void* warm, void* ws,
    void* parts, void* bad_flags, int64_t B, int64_t s, double tol_psd,
    void* stream) {
  return launch<float>(X, Xp, w, rank, warm, ws, parts, bad_flags, B, s,
                       tol_psd, stream);
}
