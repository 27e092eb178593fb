// K7: one CholeskyQR pass on a tall-skinny Y (side, k).
//
// Replaces one call of `one` inside proxsdp_tpu/ops/cones.py:_cholqr2
// (243-263):
//   G = Y^T Y
//   L = chol(G + eps * (tr(G) / k + 1) * I)      (lower, G = L L^T)
//   Q = Y L^{-T}                                  (solve_triangular)
// with eps the jitter of the compute type (1e-6 in f32, 1e-12 in f64).
// _cholqr2 is two passes.  A non-positive (or NaN) pivot makes the whole
// factor NaN, as jnp.linalg.cholesky does, so Q comes out NaN and the
// callers' finite guards fire.
//
// Rounding (the numeric contract): each entry of G is the sum over the rows
// of Y in row order, one fused multiply-add a row from +0; the trace is
// summed in diagonal order and the jitter added to it; each entry of the
// factor is the chain of its updates G[i][c] - L[i][j] L[c][j] (fused) in
// pivot order j, then the pivot's sqrt or the division by it; each q[r, j]
// is the chain y[r, j] - L[j][p] q[r, p] (fused) over p < j in order, then
// the division by L[j][j].  Every output has the bits of the one-CTA kernel
// this file held before.
//
// Bound on the H100: 2 side k^2 + k^3 / 3 flops against Y read and Q written
// once -- at side 2000, k = 128 about 1 us (operations), at side 250, k = 24
// 0.007 us (bytes).  The work is latency-bound: each entry of G is a chain
// of `side` dependent multiply-adds, the factor k dependent pivots, each row
// of Q a chain of k divisions.
//
// What held it back: one CTA did everything (<<<1, 512>>>, one SM of 132):
// each thread walked all rows for k^2 / 512 entries of G, unstaged; each
// pivot paid three barriers of 512 threads; and each thread solved a row
// whose neighbours lay k words away, re-reading q from device memory.  An
// IEEE square root or division is a long dependent chain behind a
// slow-path branch, and a barrier round costs as much again, so the design
// keeps the sequential chains inside warps and cuts barriers:
// 1. G over many CTAs: a CTA an 8 x 8 tile of G's lower triangle, an entry
//    a thread; Y's rows staged through shared memory 32 at a time by
//    cp.async (16-byte copies where k allows), 7 stages in flight; it
//    writes the lower triangle packed by columns into the wrapper's
//    workspace.
// 2. The factor in one CTA, blocked by 32 columns: the packed triangle in
//    shared memory -- all of it to kFactorSmem bytes (f32 to k = 256, f64
//    to k = 240); past that the leading columns stay in the workspace.  Row
//    i belongs to lane i % 32 of its 32-row group; a panel is three
//    barriers: one warp factors the diagonal block in registers (the pivot
//    rows shuffled across its lanes), one warp of each later group solves
//    its rows against it, then every warp of those groups updates the
//    trailing triangle by the panel's pivots in order.
// 3. The solve over all CTAs: a warp two rows, a lane the columns j = lane
//    + 32 s of both (k <= 256) in registers; step p divides the owner's
//    accumulator, broadcasts q[r, p] by a shuffle and applies column p of L
//    (staged in shared memory in panels) to the later columns, so each
//    q[r, j] keeps its chain order; the rows are read and written
//    coalesced.
// At k <= 32 and side <= 512 (the side-250 path) the three are one CTA and
// one launch (cholqr_small_kernel): Y in shared memory, G an entry a
// thread, the factor as one diagonal block (factor_block), each row's
// solve a thread.  The C entry point is one launch count either way.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 256;          // the wrapper's limit (K8's)
constexpr int kSlots = kMaxK / 32;  // a lane's rows / columns
constexpr int kGramTile = 8;        // G: an 8 x 8 tile a CTA, an entry a thread
constexpr int kGramThreads = kGramTile * kGramTile;
constexpr int kGramRows = 32;       // Y's rows a stage
constexpr int kGramStages = 8;      // stages in flight
// the factor's packed triangle in shared memory (the design's limit; the
// wrapper's CHOLQR_SMEM_BYTES): 227 KB a block less 1 KB
constexpr int kFactorSmem = 231424;
constexpr int kSolveWarps = 8;
constexpr int kSolveRows = 2;           // rows a warp
constexpr int kSolvePanel = 48 * 1024;  // bytes of L staged at a time

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// the packed lower triangle by columns: column c (rows c..k-1) starts here
__host__ __device__ __forceinline__ int64_t col_off(int64_t c, int64_t k) {
  return c * k - c * (c - 1) / 2;
}

// The diagonal block of a panel, pw <= 32 columns, in one warp's registers:
// lane i holds row i's entries g[c], c <= i.  Left-looking: column c takes
// L[c][j] (j < c) from lane c by shuffle, its updates in pivot order, then
// the pivot's sqrt (lane c) or the division by it (lanes below).  Returns
// whether a pivot was not positive (or NaN).
template <typename T>
__device__ __forceinline__ bool factor_block(T (&g)[32], int pw, int lane) {
  bool bad = false;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    if (c < pw) {  // uniform
#pragma unroll
      for (int j = 0; j < c; ++j)  // L[c][j] from lane c
        g[c] = fma_rn(-g[j], __shfl_sync(kFull, g[j], c), g[c]);
      const T d = __shfl_sync(kFull, g[c], c);
      bad |= !(d > T(0));  // NaN too
      const T l = sqrt(d);
      if (lane == c) {
        g[c] = l;
      } else if (lane > c) {
        g[c] = g[c] / l;
      }
    }
  }
  return bad;
}

// ---- 1. G = Y^T Y, lower triangle, packed by columns into ws
template <typename T, bool kVec>
__global__ void __launch_bounds__(kGramThreads)
cholqr_gram_kernel(const T* __restrict__ y, T* __restrict__ ws, int64_t side,
                   int k) {
  // a stage: its rows' 8 columns of tile row bi, then the 8 of tile column bj
  __shared__ __align__(16) T ys[kGramStages][kGramRows][2 * kGramTile];
  // tile (bi, bj), bi >= bj, from blockIdx.x = bi (bi + 1) / 2 + bj
  const int b = static_cast<int>(blockIdx.x);
  int bi = static_cast<int>((sqrtf(8.0f * b + 1.0f) - 1.0f) * 0.5f);
  while ((bi + 1) * (bi + 2) / 2 <= b) ++bi;
  while (bi * (bi + 1) / 2 > b) --bi;
  const int bj = b - bi * (bi + 1) / 2;
  const int tid = threadIdx.x, ty = tid / kGramTile, tx = tid % kGramTile;
  const int64_t nstage = (side + kGramRows - 1) / kGramRows;

  auto stage = [&](int64_t s) {
    T(*const dst)[2 * kGramTile] = ys[s % kGramStages];
    const int64_t r0 = s * kGramRows;
    auto column = [&](int ci) {
      return ci < kGramTile ? bi * kGramTile + ci
                            : bj * kGramTile + ci - kGramTile;
    };
    if constexpr (kVec) {  // 16-byte copies: k a multiple of them
      constexpr int kc = 16 / static_cast<int>(sizeof(T));
      constexpr int per_row = 2 * kGramTile / kc;
      for (int e = tid; e < kGramRows * per_row; e += kGramThreads) {
        const int r = e / per_row, ci = (e % per_row) * kc;
        const int c = column(ci);
        const bool ok = r0 + r < side && c < k;
        cp_16(&dst[r][ci], ok ? y + (r0 + r) * k + c : y,
              ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kGramRows * 2 * kGramTile; e += kGramThreads) {
        const int r = e / (2 * kGramTile), ci = e % (2 * kGramTile);
        const int c = column(ci);
        const bool ok = r0 + r < side && c < k;
        cp_elem(&dst[r][ci], ok ? y + (r0 + r) * k + c : y, ok);
      }
    }
    cp_commit();
  };

  // entry (a, c) = (bi * 8 + ty, bj * 8 + tx): the rows in order, one
  // stage at a time with kGramStages - 1 in flight, a barrier a stage
  T acc = T(0);
#pragma unroll
  for (int st = 0; st < kGramStages - 1; ++st) {
    if (st < nstage) {
      stage(st);
    } else {
      cp_commit();
    }
  }
  for (int64_t s = 0; s < nstage; ++s) {
    cp_wait<kGramStages - 2>();
    __syncthreads();  // stage s landed; stage s - 1's buffer is free
    if (s + kGramStages - 1 < nstage) {
      stage(s + kGramStages - 1);
    } else {
      cp_commit();
    }
    const T(*const yb)[2 * kGramTile] = ys[s % kGramStages];
    const int64_t left = side - s * kGramRows;
    if (left >= kGramRows) {
#pragma unroll
      for (int r = 0; r < kGramRows; ++r)
        acc = fma_rn(yb[r][ty], yb[r][kGramTile + tx], acc);
    } else {
      for (int r = 0; r < static_cast<int>(left); ++r)
        acc = fma_rn(yb[r][ty], yb[r][kGramTile + tx], acc);
    }
  }
  const int a = bi * kGramTile + ty, c = bj * kGramTile + tx;
  if (a < k && c <= a) ws[col_off(c, k) + a - c] = acc;
}

// the first column whose trailing triangle fits kFactorSmem
template <typename T>
__host__ __device__ int factor_split(int k) {
  int cs = 0;
  while (static_cast<int64_t>(k - cs) * (k - cs + 1) / 2 *
             static_cast<int64_t>(sizeof(T)) > kFactorSmem)
    ++cs;
  return cs;
}

// the factor's warps a 32-row group: 512 threads at most, so 128
// registers a thread hold a row's 32 panel entries
constexpr int kFactorParts = 2;

// ---- 2. the factor, blocked by 32 columns, in place: columns [0, cs) in
// ws, [cs, k) in shared memory (kSplit; else all of them, cs = 0).  Row i
// belongs to lane i % 32 of row group i / 32 (kFactorParts warps a
// group).  A panel of columns p0..p0+31: (a) the group's first warp factors
// the diagonal block in registers, the pivot rows shuffled across its
// lanes; (b) the first warp of each later group solves its rows against
// the block; (c) all warps of the later groups update the trailing
// triangle by the panel's pivots in order.  L (packed by columns, its
// diagonal in place) goes back to ws, the flag (a non-positive or NaN
// pivot) after it.
template <typename T, bool kSplit>
__global__ void __launch_bounds__(32 * kFactorParts * kSlots, 1)
cholqr_factor_kernel(T* __restrict__ ws, int k, int cs, T eps) {
  constexpr int kQ = kFactorParts;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  __shared__ int s_bad;
  const int t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, warp = t >> 5;
  const int rg = warp / kQ, part = warp % kQ;
  const int ns = (k + 31) / 32;  // row groups (and panels)
  const int64_t base = col_off(cs, k), tri = col_off(k, k);
  for (int64_t e = base + t; e < tri; e += nt)
    cp_elem(sm + (e - base), ws + e, true);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  // column c of the factor, rows c..k-1
  auto col = [&](int c) -> T* {
    if constexpr (kSplit) {
      return c < cs ? ws + col_off(c, k) : sm + (col_off(c, k) - base);
    } else {
      return sm + col_off(c, k);
    }
  };
  if (warp == 0) {  // the trace in diagonal order (every lane the same sum)
    T tr = T(0);
    for (int j0 = 0; j0 < k; j0 += 32) {
      const T dj = j0 + lane < k ? col(j0 + lane)[0] : T(0);
      const int n = k - j0 < 32 ? k - j0 : 32;
      for (int l = 0; l < n; ++l) tr += __shfl_sync(kFull, dj, l);
    }
    const T jit = eps * (tr / static_cast<T>(k) + T(1));
    for (int j = lane; j < k; j += 32) col(j)[0] += jit;
    if (lane == 0) s_bad = 0;
  }
  __syncthreads();
  const int i = 32 * rg + lane;  // this lane's row
  for (int pg = 0; pg < ns; ++pg) {
    const int p0 = 32 * pg, pw = k - p0 < 32 ? k - p0 : 32;
    const bool below = rg > pg && rg < ns && i < k;
    T g[32];  // this row's entries in the panel's columns
    // (a) the diagonal block
    if (rg == pg && part == 0) {
#pragma unroll
      for (int c = 0; c < 32; ++c)
        g[c] = c < pw && c <= lane && lane < pw ? col(p0 + c)[lane - c] : T(0);
      const bool bad = factor_block(g, pw, lane);
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (c < pw && c <= lane && lane < pw) col(p0 + c)[lane - c] = g[c];
      if (lane == 0 && bad) s_bad = 1;
    }
    __syncthreads();
    // (b) the panel's rows below the block, against it
    if (below && part == 0) {
#pragma unroll
      for (int c = 0; c < 32; ++c)
        g[c] = c < pw ? col(p0 + c)[i - p0 - c] : T(0);
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        if (c < pw) {  // uniform
#pragma unroll
          for (int j = 0; j < c; ++j)
            g[c] = fma_rn(-g[j], col(p0 + j)[c - j], g[c]);
          g[c] = g[c] / col(p0 + c)[0];
        }
      }
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (c < pw) col(p0 + c)[i - p0 - c] = g[c];
    }
    __syncthreads();
    // (c) the trailing triangle, entries (i, c) with p0 + 32 <= c <= i
    if (below) {
#pragma unroll
      for (int c = 0; c < 32; ++c)
        g[c] = c < pw ? col(p0 + c)[i - p0 - c] : T(0);
      const int cend = 32 * rg + 32 < k ? 32 * rg + 32 : k;
      for (int c = p0 + 32 + part; c < cend; c += kQ) {
        if (c <= i) {
          T* const cc = col(c);
          T acc = cc[i - c];
#pragma unroll
          for (int j = 0; j < 32; ++j)
            if (j < pw) acc = fma_rn(-g[j], col(p0 + j)[c - p0 - j], acc);
          cc[i - c] = acc;
        }
      }
    }
    __syncthreads();
  }
  for (int64_t e = base + t; e < tri; e += nt) ws[e] = sm[e - base];
  if (t == 0) *reinterpret_cast<int*>(ws + tri) = s_bad;
}

// ---- 3. Q = Y L^{-T}, a warp two rows
template <typename T>
__global__ void __launch_bounds__(kSolveWarps * 32)
cholqr_solve_kernel(const T* __restrict__ y, T* __restrict__ q,
                    const T* __restrict__ ws, int64_t side, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const panel = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t tri = col_off(k, k);
  constexpr int kCtaRows = kSolveWarps * kSolveRows;
  const int64_t cta0 = static_cast<int64_t>(blockIdx.x) * kCtaRows;
  const int64_t cta1 = side < cta0 + kCtaRows ? side : cta0 + kCtaRows;
  if (*reinterpret_cast<const int*>(ws + tri) != 0) {  // uniform
    for (int64_t e = cta0 * k + tid; e < cta1 * k; e += kSolveWarps * 32)
      q[e] = static_cast<T>(NAN);
    return;
  }
  const int ns = (k + 31) / 32;
  const int64_t row0 = cta0 + warp * kSolveRows;
  T acc[kSolveRows][kSlots];
#pragma unroll
  for (int rr = 0; rr < kSolveRows; ++rr) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = lane + 32 * s;
      const int64_t r = row0 + rr;
      acc[rr][s] = r < side && j < k ? y[r * k + j] : T(0);
    }
  }
  constexpr int64_t cap = kSolvePanel / sizeof(T);
  for (int p0 = 0; p0 < k;) {
    // columns [p0, p1) of L: a contiguous run of the packed triangle
    int p1 = p0 + 1;
    while (p1 < k && col_off(p1 + 1, k) - col_off(p0, k) <= cap) ++p1;
    const int64_t o0 = col_off(p0, k), o1 = col_off(p1, k);
    __syncthreads();  // the previous panel is done with
    for (int64_t e = tid; e < o1 - o0; e += kSolveWarps * 32)
      cp_elem(panel + e, ws + o0 + e, true);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int tb = 0; tb < kSlots; ++tb) {
      const int lo = p0 > 32 * tb ? p0 : 32 * tb;
      const int hi = p1 < 32 * tb + 32 ? p1 : 32 * tb + 32;
      for (int p = lo; p < hi; ++p) {
        const int owner = p - 32 * tb;
        const T* const lp = panel + (col_off(p, k) - o0);  // L[p..k-1][p]
        const T d = lp[0];
        // this lane's entries of column p, loaded before the divisions so
        // the loads overlap them
        T lv[kSlots];
#pragma unroll
        for (int s = tb; s < kSlots; ++s) {
          const int j = lane + 32 * s;
          lv[s] = s < ns && j > p && j < k ? lp[j - p] : T(0);
        }
        T qv[kSolveRows];
#pragma unroll
        for (int rr = 0; rr < kSolveRows; ++rr) {
          // the owner's quotient; the other lanes divide d by itself, a
          // division that never leaves the fast path
          const T num = lane == owner ? acc[rr][tb] : d;
          qv[rr] = __shfl_sync(kFull, num / d, owner);
          if (lane == owner) acc[rr][tb] = qv[rr];
        }
#pragma unroll
        for (int s = tb; s < kSlots; ++s) {
          const int j = lane + 32 * s;
          if (s < ns && j > p && j < k) {  // s < ns: uniform
#pragma unroll
            for (int rr = 0; rr < kSolveRows; ++rr)
              acc[rr][s] = fma_rn(-lv[s], qv[rr], acc[rr][s]);
          }
        }
      }
    }
    p0 = p1;
  }
#pragma unroll
  for (int rr = 0; rr < kSolveRows; ++rr) {
    const int64_t r = row0 + rr;
    if (r >= side) continue;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = lane + 32 * s;
      if (j < k) q[r * k + j] = acc[rr][s];
    }
  }
}

// ---- the small pass: k <= 32 and at most 512 rows, Y in shared memory
// -- G, the factor and the solve in one CTA and one launch (the side-250
// path, where every phase is a latency chain and three launches cost more
// than the work).  The arithmetic, and so every bit, is the three kernels':
// G's entries summed over the rows in order, the diagonal block factored
// as the blocked factor's (a), each row solved as a chain per column.
constexpr int kSmallK = 32;
constexpr int kSmallRows = 512;  // threads: 128 registers each
constexpr int kSmallSmem = 96 * 1024;  // Y, G and L in shared memory

template <typename T>
int64_t small_smem(int64_t side, int k) {
  return (side * k + 2 * kSmallK * kSmallK) * static_cast<int64_t>(sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kSmallRows, 1)
cholqr_small_kernel(const T* __restrict__ y, T* __restrict__ q, int64_t side,
                    int k, T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ys = reinterpret_cast<T*>(smem_raw);  // Y, row-major; then Q
  T* const gs = ys + side * k;                   // G, gs[a * 32 + b], a >= b
  T* const ls = gs + kSmallK * kSmallK;          // L, ls[a * 32 + b]
  __shared__ int s_bad;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int64_t e = t; e < side * k; e += kSmallRows)
    cp_elem(ys + e, y + e, true);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  // G: an entry a thread, (a, b) with a >= b, the rows in order
  for (int e = t; e < k * (k + 1) / 2; e += kSmallRows) {
    int a = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
    while ((a + 1) * (a + 2) / 2 <= e) ++a;
    while (a * (a + 1) / 2 > e) --a;
    const int b = e - a * (a + 1) / 2;
    T acc = T(0);
#pragma unroll 8
    for (int64_t r = 0; r < side; ++r)
      acc = fma_rn(ys[r * k + a], ys[r * k + b], acc);
    gs[a * kSmallK + b] = acc;
  }
  __syncthreads();
  if (warp == 0) {  // the jitter and the factor, as the blocked factor's (a)
    const T dj = lane < k ? gs[lane * kSmallK + lane] : T(0);
    T tr = T(0);
    for (int l = 0; l < k; ++l) tr += __shfl_sync(kFull, dj, l);
    const T jit = eps * (tr / static_cast<T>(k) + T(1));
    T g[kSmallK];
#pragma unroll
    for (int c = 0; c < kSmallK; ++c)
      g[c] = c < lane && lane < k
                 ? gs[lane * kSmallK + c]
                 : (c == lane && lane < k ? gs[lane * kSmallK + c] + jit : T(0));
    const bool bad = factor_block(g, k, lane);
#pragma unroll
    for (int c = 0; c < kSmallK; ++c) ls[lane * kSmallK + c] = g[c];
    if (lane == 0) s_bad = bad;
  }
  __syncthreads();
  if (s_bad) {  // uniform
    for (int64_t e = t; e < side * k; e += kSmallRows)
      q[e] = static_cast<T>(NAN);
    return;
  }
  if (t < side) {  // row t: each column's chain, right-looking
    T acc[kSmallK];
#pragma unroll
    for (int c = 0; c < kSmallK; ++c) acc[c] = c < k ? ys[t * k + c] : T(0);
#pragma unroll
    for (int c = 0; c < kSmallK; ++c) {
      if (c < k) {  // uniform
        // column c of L, loaded before the division so the loads overlap it
        T lc[kSmallK];
#pragma unroll
        for (int c2 = c; c2 < kSmallK; ++c2)
          lc[c2] = c2 < k ? ls[c2 * kSmallK + c] : T(0);
        acc[c] = acc[c] / lc[c];
#pragma unroll
        for (int c2 = c + 1; c2 < kSmallK; ++c2)
          if (c2 < k) acc[c2] = fma_rn(-lc[c2], acc[c], acc[c2]);
      }
    }
#pragma unroll
    for (int c = 0; c < kSmallK; ++c)
      if (c < k) ys[t * k + c] = acc[c];
  }
  __syncthreads();
  for (int64_t e = t; e < side * k; e += kSmallRows) q[e] = ys[e];
}

// a kernel's dynamic shared memory above 48 KB, allowed once a process
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T>
int launch(const void* y_, void* q_, void* ws_, int64_t side, int64_t k64,
           double eps, void* stream_) {
  if (k64 < 1 || k64 > kMaxK || side < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k = static_cast<int>(k64);
  const T* y = static_cast<const T*>(y_);
  T* q = static_cast<T*>(q_);
  T* ws = static_cast<T*>(ws_);
  auto stream = static_cast<cudaStream_t>(stream_);
  if (k <= kSmallK && side <= kSmallRows &&
      small_smem<T>(side, k) <= kSmallSmem) {
    static const cudaError_t small_attr =
        allow_smem(cholqr_small_kernel<T>, kSmallSmem);
    if (small_attr != cudaSuccess) return static_cast<int>(small_attr);
    cholqr_small_kernel<T><<<1, kSmallRows, small_smem<T>(side, k), stream>>>(
        y, q, side, k, static_cast<T>(eps));
    return static_cast<int>(cudaGetLastError());
  }
  const int nt = (k + kGramTile - 1) / kGramTile;
  const bool vec = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   k % (16 / static_cast<int>(sizeof(T))) == 0;
  if (vec) {
    cholqr_gram_kernel<T, true><<<nt * (nt + 1) / 2, kGramThreads, 0,
                                  stream>>>(y, ws, side, k);
  } else {
    cholqr_gram_kernel<T, false><<<nt * (nt + 1) / 2, kGramThreads, 0,
                                   stream>>>(y, ws, side, k);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static const cudaError_t attr[2] = {
      allow_smem(cholqr_factor_kernel<T, false>, kFactorSmem),
      allow_smem(cholqr_factor_kernel<T, true>, kFactorSmem)};
  if (attr[0] != cudaSuccess) return static_cast<int>(attr[0]);
  if (attr[1] != cudaSuccess) return static_cast<int>(attr[1]);
  const int cs = factor_split<T>(k);
  const size_t smem = static_cast<size_t>(col_off(k, k) - col_off(cs, k)) *
                      sizeof(T);
  const int threads = 32 * kFactorParts * ((k + 31) / 32);
  if (cs > 0) {
    cholqr_factor_kernel<T, true><<<1, threads, smem, stream>>>(
        ws, k, cs, static_cast<T>(eps));
  } else {
    cholqr_factor_kernel<T, false><<<1, threads, smem, stream>>>(
        ws, k, 0, static_cast<T>(eps));
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t cta_rows = kSolveWarps * kSolveRows;
  const size_t panel = static_cast<size_t>(
      col_off(k, k) * sizeof(T) < kSolvePanel ? col_off(k, k) * sizeof(T)
                                              : kSolvePanel);
  cholqr_solve_kernel<T><<<static_cast<unsigned>((side + cta_rows - 1) /
                                                 cta_rows),
                           kSolveWarps * 32, panel, stream>>>(y, q, ws, side,
                                                              k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y and q are contiguous (side, k), 1 <= k <= 256; ws is a device workspace
// of k (k + 1) / 2 + 1 elements (the packed G, then L, and the flag).
extern "C" int proxsdp_cholqr_f32(const void* y, void* q, void* ws,
                                  int64_t side, int64_t k, double eps,
                                  void* stream) {
  return launch<float>(y, q, ws, side, k, eps, stream);
}

extern "C" int proxsdp_cholqr_f64(const void* y, void* q, void* ws,
                                  int64_t side, int64_t k, double eps,
                                  void* stream) {
  return launch<double>(y, q, ws, side, k, eps, stream);
}
