// K19: the control of one PDHG iteration -- the residual formulas, the
// ring writes and every scalar decision -- in one launch.
//
// Replaces: proxsdp_tpu/solver.py:563-637 (the scalar tail of
// _residuals_and_gap, after its reductions), 653-807 (_control's
// decisions: rank convergence over the block table and the SOC gap, the
// stop test with opt_block_until, the rank bumps b1/b2 and their reset,
// the step balance b3/b4 with fire3/fire4, the infeasibility and
// unboundedness tests with infeas_block_until, the certificate wait and
// the status-7 primal ray, iter = k), the restart's epoch and stalled
// test (809-860's scalar part, on K20a's reductions) with
// _max_abs_cyclic_diff (301-304) and _bump_ranks (640-651) as device
// functions, and parallel/batch.py:141's vmap of them.
//
// Two entry points share the code: proxsdp_control_* (one instance, one
// CTA of 256 threads, which first folds K3's and K20a's pass-1 partials
// with reduce.cuh's fold_partials -- finalize_kernel's order, so the nine
// residual values are those of K3's own second pass bit for bit) and
// proxsdp_control_batch_* (a warp an instance, eight a CTA; K3b and K20a's
// batch form give each instance's values folded).  A group (the CTA, or
// the warp) copies the seven rings with this iteration's slot replaced
// and folds the two cyclic max-differences over L = 2 * window; every
// thread of the group computes the same scalar decisions, and its first
// thread writes them.
//
// Each output is a fresh tensor (the rings (7, B, L), nine program-dtype
// and seven int32 scalars a row of (9, B) and (7, B), the target ranks
// (B, nb)); nothing is written in place.  The kernel runs in one of three
// modes: the residual formulas and ring writes (r given), the decisions
// (do_control), or both (the iteration's path).
//
// Parity with the plain twin (kernels/iteration_control.py:control_plain), bit for
// bit on the card:
// - torch.maximum, amax and clamp_min propagate NaN; tmax / nan_max /
//   clamp_lo below do too (fmax would not, and a NaN dual objective
//   drives status 6);
// - a Python float against a program-dtype tensor is cast to that dtype
//   first (torch's wrapped-number rule): every constant is cast to T
//   before it is compared or multiplied; the residual formulas are f64
//   throughout (sqrt(n_tri) a host double) and cast at the ring write;
// - built with -fmad=false: a*b + c rounds twice, as torch does;
// - (k - w - 1) % L is a floor modulo (negative early on);
// - the counters are int32; the restart's weight floor is 1e-30 in T.
//
// Bound on the H100: the rings (7 x L values read and written an
// instance) and the launch: ~0.02 MB at L = 400 for one solve, ~22 MB for
// B = 1024 (bytes).  The design buys the launch count, not bandwidth:
// ~300 torch launches an iteration become this one.
#include "reduce.cuh"

namespace {

using proxsdp::kThreads;
using proxsdp::nan_max;

constexpr int kRings = 7;  // kernels/iteration_control.py: RINGS
enum Ring { kGap = 0, kPrim, kDual, kFeas, kPres, kDres, kComb };

// the pointer table (kernels/iteration_control.py: control(), in this order)
enum Ptr {
  kRingIn = 0,  // 7 rings, (B, L) each
  kEquaIn = 7, kIneqIn, kBeta, kPs, kDs, kAl, kMinEig, kMaxSocGap, kAvgW,
  kLrg, kNormB, kNormH, kNormC, kObjScale,
  kIter = 21, kStatus, kRankUpdate, kUpdateCont, kAdaCount, kTargetRank,
  kCurrentRank, kCertKind, kCertWait, kInfeasBlock, kOptBlock, kLri, kSides,
  kR = 34, kRed, kRingOut, kTOut, kIOut, kTargetOut,
  kNumPtrs = 40
};
// rows of the outputs (kernels/iteration_control.py: T_OUT, I_OUT)
enum TOut { oEqua = 0, oIneq, oBeta, oPs, oDs, oAl, oAvgW, oLrg, oWsum };
enum IOut { oStatus = 0, oRankUpdate, oUpdateCont, oAdaCount, oIter, oLri,
            oStalled };
// ControlConfig.ints and .doubles
enum CInt { cW = 0, cP, cM, cHasSdp, cHasSoc, cLineSearch, cRatio, cAdaptive,
            cKkt, cIncZero, cIncFactor, cMinSizeKrylov, cMaxTargetKrylov,
            cMinIter, cDivMinUpdate, cAdaptWindow, cMinIterMaxObj,
            cRestartWindow, cRankSlack, kNumInts };
enum CDbl { dSqrtNtri = 0, dSqrtPm, dTolPsd, dTolSoc, dTolGap, dTolFeas,
            dRatio, dTolPrimal, dTolDual, dAdaptDecay, dMaxObj,
            dInfeasLimitGap, dInfeasFeas, dInfeasStableFeas, dOneMinusIgt,
            dInfeasStableGap, dCertObjTol, dMinTol, dRestartDecay,
            kNumDoubles };

constexpr int kSlots = 9;             // K3's values
constexpr unsigned kSlotMask = 0x3Fu; // residuals.cu: slots 0..5 are maxima
constexpr int kRedSlots = 5;          // K20a's values
constexpr unsigned kRedMask = 0x18u;  // restart_avg.cu: slots 3, 4 maxima

struct Params {
  const void* p[kNumPtrs];
  int64_t ic[kNumInts];
  double dc[kNumDoubles];
  int64_t B, nb, L, r_parts, red_parts;
  int do_control;
};

__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t L) {
  const int64_t r = a % L;
  return r < 0 ? r + L : r;
}

// torch.maximum: NaN from either side, else the larger (a on a tie)
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (isnan(a) || a >= b) ? a : b;
}

__device__ __forceinline__ float tabs(float a) { return fabsf(a); }
__device__ __forceinline__ double tabs(double a) { return fabs(a); }
__device__ __forceinline__ float tsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double tsqrt(double a) { return sqrt(a); }

// torch.clamp_min: NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_lo(T a, T lo) {
  return a < lo ? lo : a;
}

// the max over a group of G threads (a warp, or the 256-thread CTA), in
// every thread; max is exact in any order
template <int G, typename T>
__device__ T group_max(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (G == 32) return v;
  __shared__ T wmax[G / 32];
  __syncthreads();  // the previous call's readers are done
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = v;
  __syncthreads();
  T m = wmax[0];
  for (int i = 1; i < G / 32; ++i) m = nan_max(m, wmax[i]);
  return m;
}

template <typename T>
__device__ __forceinline__ const T* in(const Params& P, int k) {
  return static_cast<const T*>(P.p[k]);
}

// One instance b, by a group of G threads (tid its thread); r: the nine
// folded K3 values, red: the five folded K20a values (null without the
// adaptive restart or the decisions).
template <typename T, int G>
__device__ void control_instance(const Params& P, int64_t b, int tid,
                                 const double* r, const double* red) {
  const int64_t B = P.B, L = P.L, nb = P.nb;
  const int64_t* ic = P.ic;
  const double* dc = P.dc;
  const bool do_res = r != nullptr;
  const int64_t p = ic[cP], m = ic[cM];
  const int it = in<int>(P, kIter)[b];
  const int k = it + 1;
  const int64_t idx = floor_mod(static_cast<int64_t>(it), L);
  const T* ring[kRings];
#pragma unroll
  for (int j = 0; j < kRings; ++j) ring[j] = in<T>(P, kRingIn + j) + b * L;

  // ---- the residual formulas (f64), cast at the ring write
  T nv[kRings];
  if (do_res) {
    const double norm_b = static_cast<double>(in<T>(P, kNormB)[b]);
    const double norm_h = static_cast<double>(in<T>(P, kNormH)[b]);
    const double norm_c = static_cast<double>(in<T>(P, kNormC)[b]);
    const double pres = dc[dSqrtNtri] * r[0] /
                        clamp_lo(tmax(r[1], tmax(norm_b, norm_h)), 1.0);
    const double dres = dc[dSqrtPm] * r[2] / clamp_lo(tmax(r[3], norm_c), 1.0);
    const double comb = tmax(pres, dres);
    const double equa = p ? r[4] / (1.0 + norm_b)
                          : static_cast<double>(in<T>(P, kEquaIn)[b]);
    const double ineq = m ? r[5] / (1.0 + norm_h)
                          : static_cast<double>(in<T>(P, kIneqIn)[b]);
    const double feas = tmax(p ? equa : 0.0, m ? ineq : 0.0);
    double dual_obj = 0.0;
    if (p) dual_obj = dual_obj - r[7];
    if (m) dual_obj = dual_obj - r[8];
    const double obj_scale = static_cast<double>(in<T>(P, kObjScale)[b]);
    const double prim_obj = r[6] * obj_scale;
    dual_obj = dual_obj * obj_scale;
    const double gap =
        fabs(prim_obj - dual_obj) / (1.0 + fabs(prim_obj) + fabs(dual_obj));
    nv[kGap] = static_cast<T>(gap);
    nv[kPrim] = static_cast<T>(prim_obj);
    nv[kDual] = static_cast<T>(dual_obj);
    nv[kFeas] = static_cast<T>(feas);
    nv[kPres] = static_cast<T>(pres);
    nv[kDres] = static_cast<T>(dres);
    nv[kComb] = static_cast<T>(comb);
    T* ring_out = static_cast<T*>(const_cast<void*>(P.p[kRingOut]));
    for (int64_t i = tid; i < L; i += G) {
#pragma unroll
      for (int j = 0; j < kRings; ++j)
        ring_out[(j * B + b) * L + i] = i == idx ? nv[j] : ring[j][i];
    }
    if (tid == 0) {
      T* tout = static_cast<T*>(const_cast<void*>(P.p[kTOut]));
      tout[oEqua * B + b] = static_cast<T>(equa);
      tout[oIneq * B + b] = static_cast<T>(ineq);
    }
  }
  if (!P.do_control) return;

  // the ring values this iteration's state holds
  auto at = [&](int j, int64_t i) -> T {
    return (do_res && i == idx) ? nv[j] : ring[j][i];
  };
  // _max_abs_cyclic_diff: max_i |v[i] - v[i - 1]| over the ring
  auto cyclic_diff = [&](int j) -> T {
    T acc = static_cast<T>(-INFINITY);
    for (int64_t i = tid; i < L; i += G)
      acc = nan_max(acc, tabs(at(j, i) - at(j, i == 0 ? L - 1 : i - 1)));
    return group_max<G>(acc);
  };
  const T mdiff_feas = cyclic_diff(kFeas);
  const T mdiff_gap = cyclic_diff(kGap);

  const int64_t w = ic[cW];
  const T gap_k = at(kGap, idx), feas_k = at(kFeas, idx);
  const T pres_k = at(kPres, idx), dres_k = at(kDres, idx);
  const T comb_k = at(kComb, idx);
  const T prim_k = at(kPrim, idx), dual_k = at(kDual, idx);
  const T comb_back = at(kComb, floor_mod(static_cast<int64_t>(k) - w - 1, L));

  const int cert_kind = in<int>(P, kCertKind)[b];
  const bool active = !(cert_kind != 0 && k < in<int>(P, kCertWait)[b]);
  int rank_update = in<int>(P, kRankUpdate)[b] + (active ? 1 : 0);

  // rank convergence over the block table, and the SOC gap
  const int* sides = in<int>(P, kSides);
  const int* target = in<int>(P, kTargetRank) + b * nb;
  const int* current = in<int>(P, kCurrentRank) + b * nb;
  const T* min_eig = in<T>(P, kMinEig) + b * nb;
  const T tol_psd = static_cast<T>(dc[dTolPsd]);
  bool rank_conv = true, any_not_full = false;
  if (ic[cHasSdp]) {
    for (int64_t j = 0; j < nb; ++j) {
      rank_conv = rank_conv && (sides[j] < ic[cMinSizeKrylov] ||
                                target[j] > ic[cMaxTargetKrylov] ||
                                min_eig[j] < tol_psd);
      any_not_full = any_not_full || target[j] < sides[j];
    }
  }
  if (ic[cHasSoc])
    rank_conv = rank_conv &&
                in<T>(P, kMaxSocGap)[b] < static_cast<T>(dc[dTolSoc]);

  const bool conv = gap_k <= static_cast<T>(dc[dTolGap]) &&
                    feas_k <= static_cast<T>(dc[dTolFeas]);
  const bool opt_ok = conv && rank_conv && k > ic[cMinIter];
  const int status_in = in<int>(P, kStatus)[b];
  int status = (active && opt_ok && status_in == 0 &&
                k >= in<int>(P, kOptBlock)[b]) ? 1 : status_in;

  // b1 / b2: the rank bumps and their reset
  const bool b1 = active && conv && !opt_ok && rank_update > w;
  const bool b2 = active && !conv && k > w && comb_back < comb_k &&
                  rank_update > w;
  int update_cont = in<int>(P, kUpdateCont)[b] + ((b1 || b2) ? 1 : 0);
  const bool do_bump2 = b2 && update_cont > ic[cDivMinUpdate];
  const bool bump = b1 || do_bump2;
  const bool reset = b1 || (do_bump2 && any_not_full);
  if (reset) {
    rank_update = 0;
    update_cont = 0;
  }

  // b3 / b4: the step balance
  bool b3, b4;
  if (ic[cRatio]) {
    const T ratio = static_cast<T>(dc[dRatio]);
    b3 = active && !conv && !b2 && pres_k > ratio * dres_k && k > w;
    b4 = active && !conv && !b2 && !b3 && dres_k > ratio * pres_k && k > w;
  } else {
    const T tp = static_cast<T>(dc[dTolPrimal]), td = static_cast<T>(dc[dTolDual]);
    b3 = active && !conv && !b2 && pres_k > tp && dres_k < td && k > w;
    b4 = active && !conv && !b2 && !b3 && pres_k < tp && dres_k > td && k > w;
  }
  int ada_count = in<int>(P, kAdaCount)[b] + ((b3 || b4) ? 1 : 0);
  const bool fire3 = b3 && ada_count > ic[cAdaptWindow];
  const bool fire4 = b4 && ada_count > ic[cAdaptWindow];
  if (fire3 || fire4) ada_count = 0;
  const T al = in<T>(P, kAl)[b];
  const T oma = static_cast<T>(1.0) - al;
  const T ps_in = in<T>(P, kPs)[b];
  T beta = in<T>(P, kBeta)[b], ps = ps_in, ds = in<T>(P, kDs)[b];
  if (ic[cLineSearch]) {
    if (fire3) beta = beta * oma;
    if (fire4) beta = beta / oma;
    if (fire3) ps = ps / tsqrt(oma);
    if (fire4) ps = ps * tsqrt(oma);
  } else {
    if (fire3) ps = ps / oma;
    if (fire4) ps = ps * oma;
    if (fire3) ds = ds * oma;
    if (fire4) ds = ds / oma;
  }
  const T al_out = (fire3 || fire4) ? al * static_cast<T>(dc[dAdaptDecay]) : al;

  // in-loop infeasibility / unboundedness detection (not in cert mode)
  const bool det = active && cert_kind == 0 && status == 0;
  const bool after_min = k > ic[cMinIterMaxObj];
  const T max_obj = static_cast<T>(dc[dMaxObj]);
  const T ift = static_cast<T>(dc[dInfeasFeas]);
  const bool c_inf1 = (after_min && dual_k > max_obj) || isnan(dual_k);
  const bool c_unb1 = (after_min && prim_k < -max_obj) || isnan(prim_k);
  const bool stalled_feas = after_min &&
                            gap_k > static_cast<T>(dc[dInfeasLimitGap]) &&
                            feas_k > ift &&
                            mdiff_feas < static_cast<T>(dc[dInfeasStableFeas]);
  const bool stall100 = after_min &&
                        gap_k > static_cast<T>(dc[dOneMinusIgt]) &&
                        mdiff_gap < static_cast<T>(dc[dInfeasStableGap]);
  const bool c_inf3 = stall100 && tabs(dual_k) > tabs(prim_k) && feas_k > ift;
  const bool c_unb2 = stall100 && tabs(prim_k) > tabs(dual_k) &&
                      feas_k <= static_cast<T>(dc[dTolFeas]);
  const bool det_stall = det && k >= in<int>(P, kInfeasBlock)[b];
  if (det && c_inf1) status = 6;
  if (det && status == 0 && c_unb1) status = 5;
  if (det_stall && status == 0 && stalled_feas) status = 6;
  if (det_stall && status == 0 && c_inf3) status = 6;
  if (det_stall && status == 0 && c_unb2) status = 5;
  // the in-search primal ray (status 7), not gated by the wait
  const bool ray5 = cert_kind == 5 && status == 0 &&
                    prim_k < -static_cast<T>(dc[dCertObjTol]) &&
                    feas_k < static_cast<T>(dc[dTolFeas]) *
                                 clamp_lo(tabs(prim_k), static_cast<T>(1.0));
  if (ray5) status = 7;

  // the restart's epoch and stalled test, on K20a's reductions
  int stalled = 0, lri = in<int>(P, kLri)[b];
  T avg_w = in<T>(P, kAvgW)[b], lrg = in<T>(P, kLrg)[b], wsum = avg_w;
  if (ic[cAdaptive]) {
    avg_w = avg_w + ps_in;
    const bool epoch = active && status == 0 && cert_kind == 0 &&
                       k - lri >= ic[cRestartWindow];
    const T metric_k = ic[cKkt] ? tmax(gap_k, feas_k) : gap_k;
    bool st = epoch && metric_k > static_cast<T>(dc[dMinTol]) &&
              metric_k > static_cast<T>(dc[dRestartDecay]) * lrg &&
              isfinite(metric_k);
    wsum = clamp_lo(avg_w, static_cast<T>(1e-30));
    const T obj_scale = in<T>(P, kObjScale)[b];
    const T one = static_cast<T>(1.0);
    const T po_a = static_cast<T>(red[0]) * obj_scale;
    T do_a = static_cast<T>(0.0);
    if (p) do_a = do_a - static_cast<T>(red[1]);
    if (m) do_a = do_a - static_cast<T>(red[2]);
    do_a = do_a * obj_scale;
    const T gap_a = tabs(po_a - do_a) / (one + tabs(po_a) + tabs(do_a));
    T feas_a = static_cast<T>(0.0);
    if (p) feas_a = tmax(feas_a, static_cast<T>(red[3]) / (one + in<T>(P, kNormB)[b]));
    if (m) feas_a = tmax(feas_a, static_cast<T>(red[4]) / (one + in<T>(P, kNormH)[b]));
    const T metric_now = tmax(gap_k, feas_k);
    const T metric_avg = tmax(gap_a, feas_a);
    st = st && metric_avg < static_cast<T>(0.9) * metric_now;
    stalled = st ? 1 : 0;
    avg_w = avg_w * (st ? static_cast<T>(0.0) : one);
    if (epoch) {
      lri = k;
      lrg = metric_k;
    }
  }

  if (tid == 0) {
    T* tout = static_cast<T*>(const_cast<void*>(P.p[kTOut]));
    int* iout = static_cast<int*>(const_cast<void*>(P.p[kIOut]));
    int* tgt_out = static_cast<int*>(const_cast<void*>(P.p[kTargetOut])) + b * nb;
    tout[oBeta * B + b] = beta;
    tout[oPs * B + b] = ps;
    tout[oDs * B + b] = ds;
    tout[oAl * B + b] = al_out;
    tout[oAvgW * B + b] = avg_w;
    tout[oLrg * B + b] = lrg;
    tout[oWsum * B + b] = wsum;
    iout[oStatus * B + b] = status;
    iout[oRankUpdate * B + b] = rank_update;
    iout[oUpdateCont * B + b] = update_cont;
    iout[oAdaCount * B + b] = ada_count;
    iout[oIter * B + b] = k;
    iout[oLri * B + b] = lri;
    iout[oStalled * B + b] = stalled;
    // _bump_ranks on every block where a bump fires
    for (int64_t j = 0; j < nb; ++j) {
      int t = target[j];
      if (bump) {
        const bool eligible = current[j] + ic[cRankSlack] >= t &&
                              min_eig[j] > tol_psd;
        int nt = ic[cIncZero] ? t * static_cast<int>(ic[cIncFactor])
                              : t + static_cast<int>(ic[cIncFactor]);
        nt = nt < sides[j] ? nt : sides[j];
        if (eligible) t = nt;
      }
      tgt_out[j] = t;
    }
  }
}

// one instance: the CTA folds the partials, then runs the instance
template <typename T>
__global__ void __launch_bounds__(kThreads)
control_kernel(const Params P) {
  __shared__ double r_sh[kSlots];
  __shared__ double red_sh[kRedSlots];
  const bool do_res = P.p[kR] != nullptr;
  const bool do_red = P.do_control && P.p[kRed] != nullptr;
  if (do_res) {
    double acc[kSlots];
    proxsdp::fold_partials<double, kSlots, kSlotMask>(
        static_cast<const double*>(P.p[kR]), P.r_parts, acc);
    if (threadIdx.x == 0)
      for (int q = 0; q < kSlots; ++q) r_sh[q] = acc[q];
  }
  if (do_red) {
    double acc[kRedSlots];
    proxsdp::fold_partials<double, kRedSlots, kRedMask>(
        static_cast<const double*>(P.p[kRed]), P.red_parts, acc);
    if (threadIdx.x == 0)
      for (int q = 0; q < kRedSlots; ++q) red_sh[q] = acc[q];
  }
  __syncthreads();
  control_instance<T, kThreads>(P, 0, threadIdx.x, do_res ? r_sh : nullptr,
                                do_red ? red_sh : nullptr);
}

// a batch: a warp an instance, each instance's values folded already
template <typename T>
__global__ void __launch_bounds__(kThreads)
control_batch_kernel(const Params P) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                    (threadIdx.x >> 5);
  if (b >= P.B) return;  // a whole warp leaves
  const double* r = P.p[kR] ? static_cast<const double*>(P.p[kR]) + b * kSlots
                            : nullptr;
  const double* red = (P.do_control && P.p[kRed])
                          ? static_cast<const double*>(P.p[kRed]) + b * kRedSlots
                          : nullptr;
  control_instance<T, 32>(P, b, threadIdx.x & 31, r, red);
}

template <typename T>
int launch(const void* const* ptrs, int64_t nptrs, const int64_t* ints,
           const double* doubles, int64_t B, int64_t nb, int64_t L,
           int64_t r_parts, int64_t red_parts, int64_t do_control,
           bool batched, void* stream) {
  if (nptrs != kNumPtrs || L < 1 || nb < 1) return cudaErrorInvalidValue;
  Params P;
  for (int i = 0; i < kNumPtrs; ++i) P.p[i] = ptrs[i];
  for (int i = 0; i < kNumInts; ++i) P.ic[i] = ints[i];
  for (int i = 0; i < kNumDoubles; ++i) P.dc[i] = doubles[i];
  P.B = B;
  P.nb = nb;
  P.L = L;
  P.r_parts = r_parts;
  P.red_parts = red_parts;
  P.do_control = static_cast<int>(do_control);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batched) {
    if (B > 0) {
      const int64_t per = kThreads / 32;
      control_batch_kernel<T><<<static_cast<unsigned>((B + per - 1) / per),
                                kThreads, 0, s>>>(P);
    }
  } else {
    control_kernel<T><<<1, kThreads, 0, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: the host array of kNumPtrs device pointers (enum Ptr); ints,
// doubles: the host arrays of ControlConfig; r_parts, red_parts: the rows
// of the partials at ptrs[kR] (K3's (P, 9)) and ptrs[kRed] (K20a's (P, 5)).
extern "C" int proxsdp_control_f64(const void* const* ptrs, int64_t nptrs,
                                   const int64_t* ints, const double* doubles,
                                   int64_t B, int64_t nb, int64_t L,
                                   int64_t r_parts, int64_t red_parts,
                                   int64_t do_control, void* stream) {
  return launch<double>(ptrs, nptrs, ints, doubles, B, nb, L, r_parts,
                        red_parts, do_control, false, stream);
}

extern "C" int proxsdp_control_f32(const void* const* ptrs, int64_t nptrs,
                                   const int64_t* ints, const double* doubles,
                                   int64_t B, int64_t nb, int64_t L,
                                   int64_t r_parts, int64_t red_parts,
                                   int64_t do_control, void* stream) {
  return launch<float>(ptrs, nptrs, ints, doubles, B, nb, L, r_parts,
                       red_parts, do_control, false, stream);
}

// the batch: ptrs[kR] (B, 9) and ptrs[kRed] (B, 5), folded per instance
extern "C" int proxsdp_control_batch_f64(
    const void* const* ptrs, int64_t nptrs, const int64_t* ints,
    const double* doubles, int64_t B, int64_t nb, int64_t L, int64_t r_parts,
    int64_t red_parts, int64_t do_control, void* stream) {
  return launch<double>(ptrs, nptrs, ints, doubles, B, nb, L, r_parts,
                        red_parts, do_control, true, stream);
}

extern "C" int proxsdp_control_batch_f32(
    const void* const* ptrs, int64_t nptrs, const int64_t* ints,
    const double* doubles, int64_t B, int64_t nb, int64_t L, int64_t r_parts,
    int64_t red_parts, int64_t do_control, void* stream) {
  return launch<float>(ptrs, nptrs, ints, doubles, B, nb, L, r_parts,
                       red_parts, do_control, true, stream);
}
