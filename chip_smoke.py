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
4. phase C: solves the same instance with the default Options() (the
   hybrid f32 race and f64 polish) twice, times the second, counts its
   launches, checks status, objective and X, and prints its phase events
   beside the JAX package's.

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
# kernel vs plain version on the card.  f64: elementwise outputs round
# alike (-fmad=false, the plain version's operation order); reductions
# differ in summation order only, ~1e-14 in practice.  f32: the GEMM sums
# in another order than the plain version's (2e-5 of the output's scale);
# K3's f32 program and K8's Ritz sums in the mixed polish are f64 slots.
RTOL = {"f64": 1e-12, "f32": 2e-5}
REPS = 50
# peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and the CUDA-core
# (not tensor-core) rates per type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def median_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
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

    def add(name, sfx, source, replaces, call, plain, inputs, outputs, flops,
            library=None, compare_fn=None, tol=None, on_path=True, label=""):
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
              f"bound {max(t_bytes, t_ops) * 1e3:.3f} us"
              f"{'' if on_path else ' (not on the side-250 solves)'}")
        check(rel <= tol, f"{entry}: relative error {rel:.3e} > {tol}")
        (rows if on_path else off_path).append({
            "name": row_name, "route": "cuda",
            "source": f"proxsdp_tpu_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        })

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
            3 * SIDE * k * k + k ** 3 // 3, label=f"k={k}")
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

    # ---- 3. phase B: every entry point of the default path vs its plain version
    rows, off_path = kernel_checks(torch, kernels, setup,
                                   np.random.default_rng(0),
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
    for name in kernels.KERNELS:
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

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
