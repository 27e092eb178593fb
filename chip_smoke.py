#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (proxsdp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit, torch and CUDA versions, and
   builds the port's CUDA kernels from kernels/csrc with nvcc (one process
   per source, in parallel);
2. phase A: solves maxcut_problem(random_graph_weights(0, 250)) with
   Options(hybrid_precision=False) (the f64 program, dense eigh) twice,
   times the second solve, counts its launches, and checks status,
   objective and X against the JAX package's constants;
3. phase B: checks each kernel entry point of the default path against its
   plain PyTorch version on the card at that path's side-250 shapes (f64
   and f32 K1-K4, K5-K8 at k = 24 in f32 and k = 16 in the mixed f64
   polish, K5 also on the polar reseed's column slices of the basis), and
   times it beside the plain version and, where one PyTorch call computes
   the same function, that call; the mixed-type entry points of the f64
   program's polar reseed, which the side-250 solves do not run, are
   checked alike;
   Phase B also holds the batch path's kernels to their plain versions:
   K9 (the batched Jacobi PSD projection) at sides 2-64 in f32 and f64 on
   1024 random, rank-deficient and non-finite matrices, K10 (the
   packed-triangle gathers) and the batched K1-K4 entry points at phase
   D's shapes;
4. phase C: solves the same instance with the default Options() (the
   hybrid f32 race and f64 polish) twice, times the second, counts its
   launches, checks status, objective and X, and prints its phase events
   beside the JAX package's;
5. phase D: solve_batch of 1024 side-16 max-cut instances at
   Options(tol_gap=1e-4, tol_feasibility=1e-4), a first solve then a
   timed warm one: every status 1, each X within the solver's feasibility
   bound and PSD, instances 0-15 against the JAX package's batch solve
   under the same Options() (its f64 solve reported beside it); prints
   instances/s, the iteration spread, the f32 race's length, and from a
   profiled window of each program the launches per iteration and each
   batch kernel's device time per launch.

Any failed phase exits non-zero.  The last line is a JSON object with the
device; the line before it lists the kernels.  It needs no network and
imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SIDE = 250
# the JAX package's solve of this instance with Options(hybrid_precision=
# False) (f64, CPU): status 1, 598 iterations, final rank 8
REF_OBJ = 1250.6130819530558
REF_ITERS = 598
# max|diag(X) - 1| of the reference's X.  The solver stops at feasibility
# max|A x - b| / (1 + ||b||) <= tol_feasibility in rhs-scaled units, i.e.
# |X_ii - 1| <= 1e-4 * (1 + 1) * sqrt(250) = 3.16e-3 in user units; the
# checks hold the port to that bound, the solver's own.
REF_DIAG_ERR = 0.003009914531918012
# the JAX package's default Options(chunk_iters=256) solve (the port's
# fixed chunk) on one CPU thread: status 1, 598 iterations, the race's
# subspace rank 24 (observed 14), the hand-over at 597, the polish rank 16
# (observed 8), 143 polar reseeds and 0 dense-eigh fallbacks
HYB_REF_OBJ = 1250.5958191446912
HYB_REF_ITERS = 598
HYB_REF_RACE_RANK = 24
HYB_REF_HANDOVER = 597
HYB_REF_POLISH_RANK = 16
HYB_REF_RESEEDS = 143
HYB_REF_DENSE = 0
HYB_REF_DIAG_ERR = 0.003048931860007542
# phase D: solve_batch of maxcut_problem(random_graph_weights(s, 16)) for s
# in range(1024) at Options(tol_gap=1e-4, tol_feasibility=1e-4) (bench.py's
# BENCH_MODE=batch sweep).  References, the JAX package on the CPU, one
# thread (tests/test_torch_batch.py keeps them true): its batch solve of
# these instances with the same Options() -- the hybrid race and f64
# final phase that phase D runs, the check; each instance reaches an f32
# status inside the race's one chunk and then runs alone, so instances
# 0-15 come out alike in a batch of 16 and of 1024 -- and its f64 solve
# (hybrid_precision=False) of instances 0-15, reported beside it.
# The JAX package's own two modes differ by up to 1.14e-3 (1 + |obj|) on
# this batch (19 % of the instances above 2e-4: each stops at the 1e-4
# tolerances at another point), so the f64 one is not the check.
# Objectives of instances 0-15, all status 1:
BATCH_HYB_REF_OBJ = [
    13.096346594152177, 15.824168555957952, 16.731458929630534,
    16.868796674219332, 15.09873249280418, 15.383250456368378,
    16.358025927318895, 16.652644927898177, 13.837881049053143,
    13.086015867157379, 12.931857506459826, 15.701798501871084,
    13.828233361294478, 13.686190227295912, 14.89206565235259,
    15.42635530147343,
]
BATCH_SIDE = 16
BATCH_SIZE = 1024
BATCH_REF_OBJ = [
    13.096354231526517, 15.823228353787306, 16.731964759981373,
    16.868839224452948, 15.099546908667755, 15.383237994330926,
    16.343638444673857, 16.65271693489418, 13.838146226795732,
    13.08604412776561, 12.917495023848206, 15.70180393787491,
    13.829341803692628, 13.686995447070771, 14.903252826900498,
    15.426360692707982,
]
# kernel vs plain version on the card.  f64: elementwise outputs round
# alike (-fmad=false, the plain version's operation order); reductions
# differ in summation order only, ~1e-14 in practice.  f32: the GEMM sums
# in another order than the plain version's (2e-5 of the output's scale);
# K3's f32 program and K8's Ritz sums in the mixed polish are f64 slots.
RTOL = {"f64": 1e-12, "f32": 2e-5}
REPS = 50
SLOW_MS = 20.0
# peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and the fastest
# IEEE rate per type (f32 on the CUDA cores, f64 on the FP64 tensor cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 67e12}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def median_ms(torch, fn) -> float:
    """Median of REPS CUDA-event-timed calls after 3 warm-up calls; a call
    slower than SLOW_MS (cuSOLVER's batched eigh above side 32 takes
    ~0.5 s) gets one warm-up and 3 timed calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    slow = start.elapsed_time(end) > SLOW_MS
    for _ in range(0 if slow else 2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3 if slow else REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, got, want):
    """(max abs error, max error relative to the largest finite value) of a
    kernel's outputs against the plain version's; equal entries (incl. inf
    and NaN pairs) count as 0."""
    got = torch.cat([g.reshape(-1).double() for g in got])
    want = torch.cat([w.reshape(-1).double() for w in want])
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    diff = torch.where(same, torch.zeros_like(got), (got - want).abs())
    finite = want[torch.isfinite(want)]
    scale = float(finite.abs().max()) if finite.numel() else 1.0
    err = float(diff.max())
    return err, err / max(scale, 1e-300)


def nbytes(tensors) -> int:
    """Bytes of distinct tensors (one read or write each)."""
    seen, total = set(), 0
    for t in tensors:
        if t is None or t.data_ptr() in seen:
            continue
        seen.add(t.data_ptr())
        total += t.numel() * t.element_size()
    return total


def solve_timed(torch, kernels, solve, problem, opts, capture=False):
    """Warm-up solve, then the timed one with the launch counts set to 0
    just before it and read just after; (result, wall s, counts by entry
    point, counts by kernel, captured stdout)."""
    solve(problem, opts.replace(log_verbose=False, timer_verbose=False))
    torch.cuda.synchronize()
    buf = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf) if capture else contextlib.nullcontext():
        res = solve(problem, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (res, wall, dict(kernels.launch_counts), kernels.kernel_launches(),
            buf.getvalue())


def check_solution(res, Xidx, ref_obj, diag_tol, label):
    X = res.primal[Xidx]
    diag_err = float(np.max(np.abs(np.diag(X) - 1.0)))
    lam_min = float(np.linalg.eigvalsh(X)[0])
    fro = float(np.linalg.norm(X))
    check(res.status == 1, f"{label}: status {res.status}, want 1 (OPTIMAL)")
    check(abs(res.objval - ref_obj) <= 1e-4 * (1 + abs(ref_obj)),
          f"{label}: objval {res.objval} vs {ref_obj}")
    check(np.all(np.isfinite(X)) and X.shape == (SIDE, SIDE),
          f"{label}: X not finite")
    check(diag_err <= diag_tol, f"{label}: max|diag(X)-1| = {diag_err} > {diag_tol}")
    check(lam_min >= -1e-6 * fro, f"{label}: lambda_min(X) = {lam_min}")
    return diag_err, lam_min, fro


def check_entry(torch, kernels, out, name, sfx, source, replaces, call, plain,
                inputs, outputs, flops, library=None, compare_fn=None,
                tol=None, label="", note=""):
    """Run one entry point on the card and its plain version on the same
    inputs, compare, time both (and the library call), and append the
    kernels-line row to ``out``; launches are filled in later."""
    entry = f"{name}_{sfx}"
    row_name = f"{entry} ({label})" if label else entry
    kernels.reset_launch_counts()
    got = call(getattr(kernels, name))
    torch.cuda.synchronize()
    check(kernels.launch_counts[entry] >= 1,
          f"{entry}: the wrapper launched no kernel")
    want = call(plain)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, rel = (compare_fn or (lambda g, w: compare(torch, g, w)))(got, want)
    if tol is None:
        tol = RTOL["f64" if all(w.dtype != torch.float32 for w in want)
                   else "f32"]
    ms = median_ms(torch, lambda: call(getattr(kernels, name)))
    plain_ms = median_ms(torch, lambda: call(plain))
    lib_ms = median_ms(torch, library) if library else None
    t_bytes = nbytes(list(inputs) + list(outputs)) / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS["f32" if "f32" in sfx else "f64"] * 1e3
    print(f"kernel {row_name:32s} max_abs_err {err:.3e} rel {rel:.3e} "
          f"(tol {tol:.0e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
          f"library {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms "
          f"bound {max(t_bytes, t_ops) * 1e3:.3f} us{note}")
    check(rel <= tol, f"{entry}: relative error {rel:.3e} > {tol}")
    out.append({
        "name": row_name, "route": "cuda",
        "source": f"proxsdp_tpu_torch/kernels/csrc/{source}",
        "replaces": replaces, "launches": 0, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    })


def kernel_checks(torch, kernels, setup, rng, dev):
    """Each entry point of the default path against its plain version at
    the path's shapes on ``dev``; (rows of the kernels line, launches
    filled in later; rows of entry points the side-250 solves do not run,
    checked alike but left out of that line)."""
    import torch.nn.functional as F

    from proxsdp_tpu_torch.ops.cones import POLAR_QA, POLAR_QB, POLAR_QC
    from proxsdp_tpu_torch.ops.linop import build_linop

    n, p, m = setup.layout.n, setup.layout.p, setup.layout.m
    dtypes = {"f64": torch.float64, "f32": torch.float32}
    rows, off_path = [], []

    def add(*args, on_path=True, **kw):
        check_entry(torch, kernels, rows if on_path else off_path, *args,
                    note="" if on_path else " (not on the side-250 solves)",
                    **kw)

    # ---- K1-K4 in both programs (the f32 race and the f64 polish)
    for sfx, dt in dtypes.items():
        M = build_linop(setup.A, setup.G, dt, device=dev)

        def vec(k, scale=1.0, dt=dt):
            return torch.tensor(scale * rng.standard_normal(k), dtype=dt,
                                device=dev)

        def scalar(v, dt=dt):
            return torch.tensor(v, dtype=dt, device=dev)

        b = torch.tensor(setup.b, dtype=dt, device=dev)
        h = torch.tensor(setup.h, dtype=dt, device=dev)
        c = torch.tensor(setup.c, dtype=dt, device=dev)
        x, x_old, Mty, Mty_old = vec(n), vec(n), vec(n, 1e-2), vec(n, 1e-2)
        y, y_old, Mx, Mx_old = vec(p + m), vec(p + m), vec(p + m), vec(p + m)
        tau, sigma, theta = scalar(0.37), scalar(0.21), scalar(0.93)
        csr_row = torch.sparse_coo_tensor(
            torch.stack([torch.arange(p + m, device=dev).repeat_interleave(
                M.row_cols.shape[1]), M.row_cols.reshape(-1).long()]),
            M.row_vals.reshape(-1), (p + m, n)).to_sparse_csr()
        csr_col = torch.sparse_coo_tensor(
            torch.stack([torch.arange(n, device=dev).repeat_interleave(
                M.col_rows.shape[1]), M.col_rows.reshape(-1).long()]),
            M.col_vals.reshape(-1), (n, p + m)).to_sparse_csr()
        out_pm, out_n = vec(p + m), vec(n)
        add("ell_spmv", sfx, "ell_spmv.cu", "proxsdp_tpu/ops/linop.py:123",
            lambda f: (f(M.row_cols, M.row_vals, x), f(M.col_rows, M.col_vals, y)),
            kernels.ell_spmv_plain,
            (M.row_cols, M.row_vals, x, M.col_rows, M.col_vals, y),
            (out_pm, out_n), 2 * (M.row_vals.numel() + M.col_vals.numel()),
            library=lambda: (torch.sparse.mm(csr_row, x[:, None]),
                             torch.sparse.mm(csr_col, y[:, None])))
        add("ls_dual_update", sfx, "ls_dual_update.cu",
            "proxsdp_tpu/solver.py:452",
            lambda f: f(y, Mx, Mx_old, b, h, y_old, sigma, theta, p, m),
            kernels.ls_dual_update_plain,
            (y, Mx, Mx_old, b, h, y_old, sigma, theta), (out_pm, tau),
            10 * (p + m))
        add("sq_dist", sfx, "ls_dual_update.cu", "proxsdp_tpu/solver.py:459",
            lambda f: (f(Mty, Mty_old),), kernels.sq_dist_plain,
            (Mty, Mty_old), (tau,), 3 * n,
            library=lambda: F.mse_loss(Mty, Mty_old, reduction="sum"))
        add("residuals", sfx, "residuals.cu", "proxsdp_tpu/solver.py:545",
            lambda f: (f(x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old,
                         sigma, b, h, c, p, m, SIDE),),
            kernels.residuals_plain,
            (x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma, b, h, c),
            (torch.empty(9, dtype=torch.float64, device=dev),),
            10 * n + 10 * (p + m))
        add("primal_update_sym", sfx, "primal_update_sym.cu",
            "proxsdp_tpu/solver.py:308",
            lambda f: (f(x, Mty, c, tau, SIDE),),
            kernels.primal_update_sym_plain, (x, Mty, c, tau), (out_n,), 5 * n)

    # ---- K5-K8: a side-250 matrix with the race's spectrum (a few large
    # positive eigenvalues, a negative bulk), its Newton-Schulz iterate, and
    # the subspace bases (k = 24 in the f32 race, 16 in the mixed polish)
    f32, f64 = torch.float32, torch.float64
    V, _ = np.linalg.qr(rng.standard_normal((SIDE, SIDE)))
    w = np.concatenate([np.linspace(40.0, 1.0, 14),
                        -np.linspace(0.05, 5.0, SIDE - 14)])
    X64 = torch.tensor((V * w) @ V.T, dtype=f64, device=dev)
    X = X64.float()
    # the sign of X and a warm (side, 24) basis: its top eigenvectors
    Sgn = torch.tensor((V * np.sign(w)) @ V.T, dtype=f32, device=dev)
    wb = torch.tensor(V[:, :24], dtype=f32, device=dev)
    Y, _ = kernels.fro_scale_plain(X, f32)
    A = kernels.ns_gemm_plain(Y, Y)
    S = kernels.sym_plain(Y)
    P = kernels.ns_gemm_plain(S, X, X, 0.5, 0.5)
    mat = torch.empty_like(X)
    cube = 2 * SIDE ** 3
    add("ns_gemm", "f32", "ns_gemm.cu", "proxsdp_tpu/ops/cones.py:89",
        lambda f: (f(A, A, A, POLAR_QB, POLAR_QC),), kernels.ns_gemm_plain,
        (A,), (mat,), cube + 3 * SIDE * SIDE,
        library=lambda: torch.addmm(A, A, A, beta=POLAR_QB, alpha=POLAR_QC))
    add("ns_gemm", "f32", "ns_gemm.cu", "proxsdp_tpu/ops/cones.py:90",
        lambda f: (f(Y, A, Y, POLAR_QA, 1.0),), kernels.ns_gemm_plain,
        (Y, A), (mat,), cube + 3 * SIDE * SIDE,
        library=lambda: torch.addmm(Y, Y, A, beta=POLAR_QA, alpha=1.0),
        label="Y = QA Y + Y B")
    # polar_reseed's P+ on the leading k - 1 columns and P- on the last:
    # column slices of the basis, row stride k, partial tiles
    for label, cols, sign, line in (("P+ warm", slice(None, -1), 0.5, 296),
                                    ("P- last", slice(-1, None), -0.5, 297)):
        Wc = wb[:, cols]
        kc = Wc.shape[1]
        add("ns_gemm", "f32", "ns_gemm.cu", f"proxsdp_tpu/ops/cones.py:{line}",
            lambda f, Wc=Wc, sign=sign: (f(Sgn, Wc, Wc, 0.5, sign),),
            kernels.ns_gemm_plain, (Sgn, Wc),
            (torch.empty(SIDE, kc, dtype=f32, device=dev),),
            2 * SIDE * SIDE * kc + 3 * SIDE * kc,
            library=lambda Wc=Wc, sign=sign: torch.addmm(
                Wc, Sgn, Wc, beta=0.5, alpha=sign),
            label=f"{label}, strided")
    add("fro_scale", "f32", "polar_sym.cu", "proxsdp_tpu/ops/cones.py:85",
        lambda f: f(X, f32), kernels.fro_scale_plain, (X,), (mat,),
        3 * SIDE * SIDE)
    add("sym", "f32", "polar_sym.cu", "proxsdp_tpu/ops/cones.py:94",
        lambda f: (f(Y),), kernels.sym_plain, (Y,), (mat,), 2 * SIDE * SIDE)
    add("sym_guard", "f32", "polar_sym.cu", "proxsdp_tpu/ops/cones.py:96",
        lambda f: f(P, S, X), kernels.sym_guard_plain,
        (P, torch.diagonal(S).contiguous()), (mat,), 3 * SIDE * SIDE)
    # the f64 program's f32-compute polar reseed (subspace_fallback
    # "polar"): the default path takes it in the polish above
    # polar_fallback_min_side = 384, not at side 250
    add("fro_scale", "f64_f32", "polar_sym.cu", "proxsdp_tpu/ops/cones.py:281",
        lambda f: f(X64, f32), kernels.fro_scale_plain, (X64,),
        (mat, torch.empty_like(mat)),
        3 * SIDE * SIDE, on_path=False)
    add("sym_guard", "f32_f64", "polar_sym.cu", "proxsdp_tpu/ops/cones.py:303",
        lambda f: f(P, S, X64), kernels.sym_guard_plain,
        (P, torch.diagonal(S).contiguous()), (X64,), 3 * SIDE * SIDE,
        tol=RTOL["f32"], on_path=False)
    for sfx, k, dt in (("f32", 24, f32), ("f32", 16, f32)):
        Yk = torch.matmul(X, torch.tensor(rng.standard_normal((SIDE, k)),
                                          dtype=dt, device=dev))
        add("cholqr", sfx, "cholqr.cu", "proxsdp_tpu/ops/cones.py:247",
            lambda f, Yk=Yk: (f(Yk, kernels.CHOLQR_EPS[f32]),),
            kernels.cholqr_plain, (Yk,), (Yk,),
            3 * SIDE * k * k + k ** 3 // 3, label=f"k={k}",
            library=lambda Yk=Yk: torch.linalg.qr(Yk))
    # K8: the race's f32 test (theta from the eigh) at k = 24, and the
    # mixed polish's f64 test (f64 Rayleigh quotients) at k = 16
    for sfx, k, dt in (("f32", 24, f32), ("f64", 16, f64)):
        Wk = torch.tensor(V[:, :k], dtype=dt, device=dev)
        Xk = X64.to(dt)
        XW = torch.matmul(Xk, Wk)
        th = (torch.tensor(w[:k], dtype=dt, device=dev) if sfx == "f32"
              else None)
        at = torch.tensor(1e-4, dtype=dt, device=dev)
        tol = 1e-9 if sfx == "f32" else 4e-6

        def exact_flags(g, wnt):
            check(torch.equal(g[2].cpu(), wnt[2].cpu()),
                  f"ritz_accept_{sfx}: flags {g[2].tolist()} vs {wnt[2].tolist()}")
            return compare(torch, g[:2], wnt[:2])

        add("ritz_accept", sfx, "ritz_accept.cu",
            "proxsdp_tpu/ops/cones.py:443",
            lambda f, Wk=Wk, XW=XW, th=th, at=at, tol=tol: f(
                Wk, XW, th, at, tol, 1e-7, False),
            kernels.ritz_accept_plain, (Wk, XW, th, at),
            (torch.empty(k + 3, dtype=dt, device=dev),), 8 * SIDE * k,
            compare_fn=exact_flags)
    return rows, off_path


EIGH_SIDES = (2, 10, 16, 31, 32, 33, 40, 64)
# K9 against torch.linalg.eigh: two backward-stable eigensolvers, whose
# projections and eigenvalues differ by a few s * eps * ||X||; held
# relative to the batch's largest entry
EIGH_RTOL = {"f64": 1e-11, "f32": 1e-4}
TOL_PSD = 1e-7


def eigh_inputs(torch, rng, side, dt, dev):
    """BATCH_SIZE symmetric side x side matrices: random ones, every third
    rank-deficient (half its eigenvalues exactly 0), instance 1 NaN."""
    B = BATCH_SIZE
    X = rng.standard_normal((B, side, side))
    X = 0.5 * (X + X.transpose(0, 2, 1))
    Q, _ = np.linalg.qr(rng.standard_normal((B // 3 + 1, side, side)))
    w = 3.0 * rng.standard_normal((B // 3 + 1, side))
    w[:, : side // 2] = 0.0
    X[::3] = np.einsum("bik,bk,bjk->bij", Q, w, Q)[: len(X[::3])]
    X[1, 0, side - 1] = np.nan
    return torch.tensor(X, dtype=dt, device=dev)


def eigh_compare(torch, X, tol):
    """K9's outputs (Xp, w, rank, warm) against the plain version's: the
    NaN instance alone NaN with rank 0; projection and eigenvalues to
    ``tol`` of the largest entry; ranks equal wherever every eigenvalue
    clears tol_psd by more than that; the top eigenvector up to sign where
    the top eigenvalue is simple.  Returns (max abs error, relative)."""

    def fn(got, want):
        (Xp, w, rank, warm), (pXp, pw, prank, pwarm) = got, want
        fin = torch.isfinite(X).all(dim=(1, 2))
        for t in (Xp.flatten(1), w, warm):
            check(torch.equal(torch.isnan(t).all(dim=1), ~fin),
                  "batched_psd_eigh: NaN outside the non-finite instance")
        check(bool((rank[~fin] == 0).all()), "batched_psd_eigh: NaN rank")
        scale = float(X[fin].abs().max())
        err = max(float((Xp[fin] - pXp[fin]).abs().max()),
                  float((w[fin] - pw[fin]).abs().max()))
        clear = ((pw[fin] - TOL_PSD).abs() > tol * scale).all(dim=1)
        check(torch.equal(rank[fin][clear], prank[fin][clear]),
              "batched_psd_eigh: ranks differ")
        simple = (pw[fin][:, -1] - pw[fin][:, -2]) > 1e-3 * scale
        dots = torch.sum(warm[fin] * pwarm[fin], dim=1).abs()[simple]
        check(not dots.numel() or float((1 - dots).abs().max()) <= 1e-3,
              "batched_psd_eigh: top eigenvectors differ")
        return err, err / scale

    return fn


def batch_kernel_checks(torch, kernels, setups, rng, dev):
    """Phase B rows of the batch path: K9 at every side of EIGH_SIDES (the
    phase-D side 16 on the path, the others checked but off it), K10 and
    the batched K1-K4 entry points at phase D's shapes, in f32 (the race)
    and f64; (rows of the kernels line, off-path rows)."""
    from proxsdp_tpu_torch.parallel.batch import _batch_operands

    rows, off_path = [], []
    B = len(setups)
    lay = setups[0].layout
    side, n, p, m = BATCH_SIDE, lay.n, lay.p, lay.m
    tl = side * (side + 1) // 2
    for sfx, dt in (("f64", torch.float64), ("f32", torch.float32)):
        for s in EIGH_SIDES:
            X = eigh_inputs(torch, rng, s, dt, dev)
            # the function's work, whatever the algorithm: a symmetric
            # eigendecomposition with vectors ~9 s^3 (symmetric QR), the
            # reconstruction V diag(max(w, 0)) V^T ~1.5 s^3
            flops = B * 10.5 * s ** 3
            outs = (torch.empty_like(X), torch.empty(B, s, dtype=dt, device=dev),
                    torch.empty(B, dtype=torch.int32, device=dev),
                    torch.empty(B, s, dtype=dt, device=dev))
            on = s == side
            check_entry(
                torch, kernels, rows if on else off_path, "batched_psd_eigh",
                sfx, "batched_eigh.cu", "proxsdp_tpu/ops/cones.py:622",
                lambda f, X=X: f(X, TOL_PSD), kernels.batched_psd_eigh_plain,
                (X,), outs, flops,
                library=lambda Xf=torch.nan_to_num(X): torch.linalg.eigh(Xf),
                compare_fn=eigh_compare(torch, X, EIGH_RTOL[sfx]),
                tol=EIGH_RTOL[sfx], label=f"side {s}",
                note="" if on else f" (side {s}: not phase D's)")

        o = _batch_operands(setups, dt, dev, "auto")
        M = o.M

        def rows_of(k, scale=1.0, dt=dt):
            return torch.tensor(scale * rng.standard_normal((B, k)), dtype=dt,
                                device=dev)

        def steps(dt=dt):
            return torch.tensor(rng.uniform(0.1, 1.0, B), dtype=dt, device=dev)

        x, x_old, Mty, Mty_old = rows_of(n), rows_of(n), rows_of(n, 1e-2), \
            rows_of(n, 1e-2)
        y, y_old, Mx, Mx_old = (rows_of(p + m) for _ in range(4))
        tau, sigma, theta = steps(), steps(), steps()
        out_pm, out_n = rows_of(p + m), rows_of(n)
        csr_row = torch.sparse_coo_tensor(
            torch.stack([torch.arange(p + m, device=dev).repeat_interleave(
                M.row_cols.shape[1]), M.row_cols.reshape(-1).long()]),
            M.row_vals.reshape(-1), (p + m, n)).to_sparse_csr()
        csr_col = torch.sparse_coo_tensor(
            torch.stack([torch.arange(n, device=dev).repeat_interleave(
                M.col_rows.shape[1]), M.col_rows.reshape(-1).long()]),
            M.col_vals.reshape(-1), (n, p + m)).to_sparse_csr()
        xT, yT = x.T.contiguous(), y.T.contiguous()

        def add(*args, **kw):
            check_entry(torch, kernels, rows, *args, **kw)

        add("ell_spmv_batch", sfx, "ell_spmv.cu", "proxsdp_tpu/ops/linop.py:123",
            lambda f: (f(M.row_cols, M.row_vals, x), f(M.col_rows, M.col_vals, y)),
            kernels.ell_spmv_batch_plain,
            (M.row_cols, M.row_vals, x, M.col_rows, M.col_vals, y),
            (out_pm, out_n), 2 * B * (M.row_vals.numel() + M.col_vals.numel()),
            library=lambda: (torch.sparse.mm(csr_row, xT),
                             torch.sparse.mm(csr_col, yT)))
        add("ls_dual_update_batch", sfx, "ls_dual_update.cu",
            "proxsdp_tpu/solver.py:452",
            lambda f: f(y, Mx, Mx_old, o.b, o.h, y_old, sigma, theta, p, m),
            kernels.ls_dual_update_batch_plain,
            (y, Mx, Mx_old, o.b, o.h, y_old, sigma, theta), (out_pm, tau),
            10 * B * (p + m))
        add("sq_dist_batch", sfx, "ls_dual_update.cu",
            "proxsdp_tpu/solver.py:459",
            lambda f: (f(Mty, Mty_old),), kernels.sq_dist_batch_plain,
            (Mty, Mty_old), (tau,), 3 * B * n)
        add("residuals_batch", sfx, "residuals.cu", "proxsdp_tpu/solver.py:545",
            lambda f: (f(x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old,
                         sigma, o.b, o.h, o.c, p, m),),
            kernels.residuals_batch_plain,
            (x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma, o.b,
             o.h, o.c),
            (torch.empty(B, 9, dtype=torch.float64, device=dev),),
            B * (10 * n + 10 * (p + m)))
        add("primal_update_batch", sfx, "primal_update_sym.cu",
            "proxsdp_tpu/solver.py:308",
            lambda f: (f(x, Mty, o.c, tau),), kernels.primal_update_batch_plain,
            (x, Mty, o.c, tau), (out_n,), 3 * B * n)
        S = kernels.tri_to_square_plain(x, side)
        add("tri_to_square", sfx, "tri_gather.cu", "proxsdp_tpu/ops/tri.py:39",
            lambda f: (f(x, side),), kernels.tri_to_square_plain,
            (x, *kernels._tri_maps(side, dt, dev)[:2]), (S,), B * side * side)
        add("square_to_tri", sfx, "tri_gather.cu", "proxsdp_tpu/ops/tri.py:47",
            lambda f: (f(S, side),), kernels.square_to_tri_plain,
            (S, *kernels._tri_maps(side, dt, dev)[2:]), (x[:, :tl],), B * tl)
    return rows, off_path


# the batch path's CUDA functions as the profiler names them (K10's two
# directions are one function)
BATCH_DEVICE_FNS = {
    "ell_spmv_batch": "ell_spmv_batch_kernel",
    "ls_dual_update_batch": "ls_dual_update_batch_kernel",
    "sq_dist_batch": "sq_dist_batch_kernel",
    "residuals_batch": "residuals_batch_",
    "primal_update_batch": "primal_update_batch_kernel",
    "batched_psd_eigh": "batched_psd_eigh_kernel",
    "tri_gather": "gather_scale_kernel",
}


def profile_steps(torch, kernels, setups, opts, steps=64):
    """``steps`` iterations of the batch program of ``opts`` on the setups
    (after 8 warm-up ones) under torch.profiler: (CUDA kernels per
    iteration, the port's kernel launches per iteration, device-busy
    share of the window, ms per iteration, device µs per launch of each
    function of BATCH_DEVICE_FNS).  None where the profiler shows no
    device events."""
    from torch.profiler import ProfilerActivity, profile

    from proxsdp_tpu_torch.parallel import batch as tbatch

    dev = torch.device("cuda")
    opts = tbatch._force_batch_options(opts)
    dt = torch.float32 if opts.dtype == "float32" else torch.float64
    layout = setups[0].layout
    o = tbatch._batch_operands(setups, dt, dev, opts.linop)
    st = tbatch._stack_states(layout, opts, setups, dev)
    stats = tbatch.BatchStats()
    run = tbatch.make_batch_runner(layout, opts, device=dev, stats=stats)[0]
    st = run(st, o, 8)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    steps0 = stats.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = run(st, o, 8 + steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    done = stats.steps - steps0
    ours = sum(kernels.launch_counts.values()) / max(done, 1)
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        return None, ours, None, wall * 1e3 / max(done, 1), None

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    n_kernels = sum(e.count for e in dev_events)
    busy_us = sum(dev_us(e) for e in dev_events)
    per_launch = {}
    for name, fn in BATCH_DEVICE_FNS.items():
        hits = [e for e in dev_events if fn in e.key]
        count = sum(e.count for e in hits)
        if count:
            per_launch[name] = sum(dev_us(e) for e in hits) / count
    return (n_kernels / max(done, 1), ours, busy_us * 1e-6 / wall,
            wall * 1e3 / max(done, 1), per_launch)


def phase_d(torch, kernels, smi, problems, setups, brows):
    """Two solve_batch runs of the BATCH_SIZE side-16 max-cut instances at
    Options(tol_gap=1e-4, tol_feasibility=1e-4): a first one, then the
    timed warm one with the launch counts set to 0 just before it and read
    just after.  Checks every status, the feasibility and PSD bounds per
    instance and the objectives of instances 0-15; fills the launches of
    the batch rows."""
    from proxsdp_tpu_torch import Options, solve_batch
    from proxsdp_tpu_torch.parallel import batch as tbatch

    probs = [p for p, _ in problems]
    Xidx = problems[0][1]
    opts = Options(tol_gap=1e-4, tol_feasibility=1e-4)
    t0 = time.perf_counter()
    solve_batch(probs, opts)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    kernels.reset_launch_counts()
    stats = tbatch.BatchStats()
    t0 = time.perf_counter()
    res = solve_batch(probs, opts, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    entries = dict(kernels.launch_counts)
    B = len(res)
    status = np.array([r.status for r in res])
    iters = np.array([r.iter for r in res])
    X = np.stack([r.primal[Xidx] for r in res])
    diag_err = np.abs(np.diagonal(X, axis1=1, axis2=2) - 1.0).max(axis=1)
    diag_tol = np.array([1e-4 * (1.0 + s.norm_b) * s.rhs_scale for s in setups])
    lam_min = np.linalg.eigvalsh(X)[:, 0]
    fro = np.linalg.norm(X, axis=(1, 2))
    obj = np.array([r.objval for r in res[: len(BATCH_HYB_REF_OBJ)]])
    ref = np.array(BATCH_HYB_REF_OBJ)
    obj_dev = np.abs(obj - ref) / (1.0 + np.abs(ref))
    f64_dev = np.abs(obj - BATCH_REF_OBJ) / (1.0 + np.abs(BATCH_REF_OBJ))
    print(f"phase D (solve_batch, B = {B}, side {BATCH_SIDE}, Options(tol_gap="
          f"1e-4, tol_feasibility=1e-4)) on {smi}: warm solve {wall:.3f} s, "
          f"{B / wall:.1f} instances/s (first solve {first:.3f} s); "
          f"statuses {dict(zip(*np.unique(status, return_counts=True)))}; "
          f"iterations min/median/max {iters.min()}/{int(np.median(iters))}/"
          f"{iters.max()}; f32 race {stats.race_iters} iterations "
          f"({stats.race_seconds:.3f} s), program steps {stats.steps}, final "
          f"phase {stats.final_seconds:.3f} s")
    print(f"phase D checks: max|diag(X)-1| worst {diag_err.max():.3e} "
          f"(its bound {diag_tol[diag_err.argmax()]:.3e}), min over instances "
          f"of lambda_min(X)/||X||_F {float((lam_min / fro).min()):.3e}, "
          f"objective of instances 0-{len(ref) - 1} vs the JAX batch solve "
          f"(same Options()): max |diff|/(1+|ref|) {obj_dev.max():.3e} (bound "
          f"2e-4); vs the JAX f64 solve {f64_dev.max():.3e} (instances "
          f"{np.nonzero(f64_dev > 2e-4)[0].tolist()} above 2e-4; the JAX "
          "package's own modes differ by up to 1.14e-3 there)")
    print("phase D launches: " + json.dumps(
        {e: n for e, n in entries.items() if n}))
    print(f"phase D: the port's kernel launches per program step "
          f"{sum(entries.values()) / max(stats.steps, 1):.2f}")
    for label, dtype in (("f32 race", "float32"), ("f64", "float64")):
        per_step, ours, busy, ms, per_launch = profile_steps(
            torch, kernels, setups, Options(dtype=dtype, hybrid_precision=False,
                                            tol_gap=1e-4, tol_feasibility=1e-4))
        print(f"phase D profile ({label} program, 64 iterations of all "
              f"{B} instances): {ms:.3f} ms/iteration, CUDA kernels per "
              f"iteration {'not measured' if per_step is None else f'{per_step:.1f}'}"
              f" (the port's own {ours:.1f}), device busy "
              f"{'not measured' if busy is None else f'{100 * busy:.1f} %'}; "
              "device us per launch "
              + ("not measured" if per_launch is None
                 else json.dumps(per_launch)))
    check((status == 1).all(), "D: not every instance reached status 1")
    check((diag_err <= diag_tol).all(),
          f"D: max|diag(X)-1| above the bound for "
          f"{int((diag_err > diag_tol).sum())} instances")
    check((lam_min >= -1e-6 * fro).all(),
          f"D: lambda_min(X) < -1e-6 ||X||_F for "
          f"{int((lam_min < -1e-6 * fro).sum())} instances")
    check((obj_dev <= 2e-4).all(),
          f"D: objectives of instances {np.nonzero(obj_dev > 2e-4)[0].tolist()}"
          " differ from the JAX batch solve by more than 2e-4 (1 + |obj|)")
    for row in brows:
        row["launches"] = entries[row["name"].split(" ")[0]]
        check(row["launches"] > 0, f"{row['name']} launched no kernel in D")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    from proxsdp_tpu_torch import Options, kernels, solve
    from proxsdp_tpu_torch.kernels import build
    from proxsdp_tpu_torch.models.maxcut import maxcut_problem, random_graph_weights
    from proxsdp_tpu_torch.problem import preprocess, to_square_form

    # ---- 1. build
    t0 = time.perf_counter()
    kernels.load()
    print(f"build: {time.perf_counter() - t0:.2f} s to load, nvcc "
          f"{build.BuildInfo.seconds:.2f} s -> {build.BuildInfo.path}")
    for line in build.BuildInfo.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip())

    problem, Xidx = maxcut_problem(random_graph_weights(0, SIDE))
    setup = to_square_form(preprocess(problem))
    diag_tol = 1e-4 * (1.0 + setup.norm_b) * setup.rhs_scale
    print(f"slice shapes: n={setup.layout.n} p={setup.layout.p} "
          f"m={setup.layout.m} block {SIDE}x{SIDE}")

    # ---- 2. phase A: the f64 program (hybrid_precision=False)
    res, wall, entries_a, counts, _ = solve_timed(
        torch, kernels, solve, problem, Options(hybrid_precision=False))
    diag_err, lam_min, fro = check_solution(res, Xidx, REF_OBJ, diag_tol, "A")
    print(f"phase A (hybrid_precision=False): status {res.status} objval "
          f"{res.objval!r} (reference {REF_OBJ!r}, diff {res.objval - REF_OBJ:.3e}) "
          f"iterations {res.iter} (reference {REF_ITERS}) wall {wall:.3f} s, "
          f"{res.iter / wall:.1f} iterations/s; max|diag(X)-1| {diag_err:.6e} "
          f"(reference {REF_DIAG_ERR:.6e}, bound {diag_tol:.3e}), "
          f"lambda_min(X) {lam_min:.3e}")
    print("phase A launches: " + json.dumps(
        {e: n for e, n in entries_a.items() if n}))
    check(counts["ell_spmv"] >= 2 * res.iter, "A: ell_spmv launched < 2x iterations")
    for name in ("ls_dual_update", "sq_dist", "residuals", "primal_update_sym"):
        check(counts[name] >= res.iter, f"A: {name} launched < iterations")

    # ---- 3. phase B: every entry point of the default path vs its plain
    # version, then the batch path's at phase D's shapes
    rows, off_path = kernel_checks(torch, kernels, setup,
                                   np.random.default_rng(0),
                                   torch.device("cuda"))
    bproblems = [maxcut_problem(random_graph_weights(s, BATCH_SIDE))
                 for s in range(BATCH_SIZE)]
    bsetups = [preprocess(p) for p, _ in bproblems]
    brows, boff = batch_kernel_checks(torch, kernels, bsetups,
                                      np.random.default_rng(1),
                                      torch.device("cuda"))

    # ---- 4. phase C: the default Options() -- hybrid race and polish
    opts = Options(log_verbose=True, timer_verbose=True)
    res, wall, entries, counts, log = solve_timed(torch, kernels, solve,
                                                  problem, opts, capture=True)
    for line in log.splitlines():
        if line.startswith("  [") or "total" in line or "status:" in line:
            print("  | " + line.strip())
    diag_err, lam_min, fro = check_solution(res, Xidx, HYB_REF_OBJ, diag_tol, "C")
    race = re.search(r"f32 race: subspace rank (\d+) \(observed (\d+)\)", log)
    hand = re.search(r"f32 -> f64 at iter (\d+)", log)
    pol = re.search(r"f64 polish: subspace rank (\d+) \(observed (\d+)\)", log)
    fb = re.search(r"f32 polar-reseed=(\d+), dense-eigh=(\d+)", log)
    iters = res.iter
    print(f"phase C (default Options()): status {res.status} objval "
          f"{res.objval!r} (reference {HYB_REF_OBJ!r}, diff "
          f"{res.objval - HYB_REF_OBJ:.3e}, bound "
          f"{1e-4 * (1 + abs(HYB_REF_OBJ)):.3f}) iterations {iters} (reference "
          f"{HYB_REF_ITERS}, {100.0 * (iters - HYB_REF_ITERS) / HYB_REF_ITERS:+.1f}%) "
          f"final rank {res.final_rank} gap {res.gap:.3e}")
    print(f"phase C events: race rank {race and race.group(1)} (observed "
          f"{race and race.group(2)}; reference {HYB_REF_RACE_RANK}), hand-over "
          f"at {hand and hand.group(1)} (reference {HYB_REF_HANDOVER}), polish "
          f"rank {pol and pol.group(1)} (observed {pol and pol.group(2)}; "
          f"reference {HYB_REF_POLISH_RANK}), polar reseeds "
          f"{fb and fb.group(1)} (reference {HYB_REF_RESEEDS}), dense-eigh "
          f"fallbacks {fb and fb.group(2)} (reference {HYB_REF_DENSE})")
    if abs(iters - HYB_REF_ITERS) > 0.25 * HYB_REF_ITERS:
        print(f"phase C FINDING: iterations {iters} differ from the "
              f"reference's {HYB_REF_ITERS} by more than 25 %")
    print(f"phase C wall {wall:.3f} s, {iters / wall:.1f} iterations/s; "
          f"max|diag(X)-1| {diag_err:.6e} (reference {HYB_REF_DIAG_ERR:.6e}, "
          f"bound {diag_tol:.3e}), lambda_min(X) {lam_min:.3e}, "
          f"||X||_F {fro:.3e}")
    print("phase C launches: " + json.dumps(
        {e: n for e, n in entries.items() if n}))
    for name in kernels.SOLVE_KERNELS:
        check(counts[name] > 0, f"C: {name} launched no kernel")
    for name in ("ell_spmv", "ls_dual_update", "sq_dist", "residuals",
                 "primal_update_sym"):
        check(entries.get(f"{name}_f32", 0) > 0, f"C: {name}_f32 not launched")
    # launches: the f64 K1-K4 rows count phase A's solve (the f64
    # program), every other row phase C's (the default path)
    f64_program = {f"{name}_f64" for name in ("ell_spmv", "ls_dual_update",
                                              "sq_dist", "residuals",
                                              "primal_update_sym")}
    for row in rows:
        entry = row["name"].split(" ")[0]
        row["launches"] = (entries_a if entry in f64_program else entries)[entry]
        check(row["launches"] > 0, f"{row['name']} launched no kernel")
    print("kernels line: launches of the f64 ell_spmv, ls_dual_update, "
          "sq_dist, residuals and primal_update_sym rows from phase A, the "
          "others from phase C; checked against the plain version but not "
          "on the side-250 solves (the polish's polar reseed from side 384): "
          + ", ".join(row["name"] for row in off_path))

    # ---- 5. phase D: the batched sweep (solve_batch)
    phase_d(torch, kernels, smi, bproblems, bsetups, brows)
    rows += brows
    print("kernels line: the batch rows' launches from phase D's warm solve; "
          "K9 checked against its plain version but not on phase D's path: "
          + ", ".join(row["name"] for row in boff))

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
