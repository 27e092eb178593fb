#!/usr/bin/env python3
"""K5 (``ns_gemm``, ``ns_gemm_batch``) and K7 (``cholqr``) of this checkout
held bit for bit against another checkout's, on one CUDA card.

    python3 tools/compare_kernel_bits.py --parent DIR [--reps 20]

``DIR`` is another tree of the port (say the parent commit unpacked with
``git archive`` under ``_archive/``, which ``.gitignore`` lists).  Its
``ns_gemm.cu`` and ``cholqr.cu`` are built with this checkout's nvcc flags
into ``build/proxsdp_tpu_torch/`` and called through their C entry points
beside this checkout's wrappers on the same inputs: the square products of
sides 250 and 2000, the reseed's strided column slices, a tensor-parallel
row slab, ragged and unaligned shapes (M, N, K in 1, 31, 33, 127, 250),
products that underflow to -0, the Ritz rotation, batches of 3 and 16;
CholeskyQR at the subspace buckets (side 250, k = 16, 24; side 2000,
k = 32, 128, 192, 256), at k = 1, 33, 200, at the f64 shared-memory edge
and one past it, on a zero Y and on one with a zero column (both NaN).
Every output must have the same bits (NaN where NaN); each case's CUDA-
event median of both trees is printed beside it.  Prints the card's name
and power limit first and one JSON object last; exits non-zero on a
difference or where there is no card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build_other(parent: pathlib.Path) -> ctypes.CDLL:
    """The other tree's K5 and K7 in a library of their own."""
    from proxsdp_tpu_torch.kernels import build

    csrc = parent / "proxsdp_tpu_torch" / "kernels" / "csrc"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    objs, procs = [], []
    for name in ("ns_gemm.cu", "cholqr.cu"):
        obj = tmp / f"{name}.o"
        objs.append(str(obj))
        procs.append(subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-c", "-o",
             str(obj), str(csrc / name)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the other tree:\n{out}")
    lib = tmp / "libother.so"
    subprocess.run([build._nvcc(), *build.LINK_FLAGS, "-o", str(lib), *objs],
                   check=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("compare_kernel_bits: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)

    from proxsdp_tpu_torch import kernels

    kernels.load()
    other = build_other(pathlib.Path(args.parent).resolve())
    P, I, D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    sfx = {torch.float32: "f32", torch.float64: "f64"}
    for dt in sfx.values():
        for name, argt in (("ns_gemm", [P, I, P, I, P, I, P, I, I, I, D, D, P]),
                           ("ns_gemm_batch", [P, I, I] * 3 + [P] + [I] * 4
                            + [D, D, P]),
                           ("cholqr", [P, P, P, I, I, D, P])):
            fn = getattr(other, f"proxsdp_{name}_{dt}")
            fn.argtypes, fn.restype = argt, ctypes.c_int
    dev = torch.device("cuda")
    rng = np.random.default_rng(15)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def rs(t, axis):  # a row (instance) stride, as the wrappers pass it
        if t.dim() == 2:
            return t.stride(0) if t.shape[0] > 1 else t.shape[1]
        if axis == 0:
            return t.stride(0) if t.shape[0] > 1 else t.shape[1] * t.shape[2]
        return t.stride(1) if t.shape[1] > 1 else t.shape[2]

    def other_gemm(A, B, C, alpha, beta):
        M, K = A.shape
        out = torch.empty((M, B.shape[1]), dtype=A.dtype, device=dev)
        rc = getattr(other, f"proxsdp_ns_gemm_{sfx[A.dtype]}")(
            A.data_ptr(), rs(A, 0), B.data_ptr(), rs(B, 0),
            None if C is None else C.data_ptr(), 0 if C is None else rs(C, 0),
            out.data_ptr(), M, B.shape[1], K, alpha, beta, stream())
        assert rc == 0, rc
        return out

    def other_gemm_batch(A, B, C, alpha, beta):
        nb, M, K = A.shape
        N = B.shape[2]
        out = torch.empty((nb, M, N), dtype=A.dtype, device=dev)
        rc = getattr(other, f"proxsdp_ns_gemm_batch_{sfx[A.dtype]}")(
            A.data_ptr(), rs(A, 1), rs(A, 0), B.data_ptr(), rs(B, 1),
            rs(B, 0), None if C is None else C.data_ptr(),
            0 if C is None else rs(C, 1), 0 if C is None else rs(C, 0),
            out.data_ptr(), M, N, K, nb, alpha, beta, stream())
        assert rc == 0, rc
        return out

    def other_cholqr(Y, eps):
        side, k = Y.shape
        gws = (torch.empty((k, k), dtype=Y.dtype, device=dev)
               if k * k * Y.element_size() > 200 * 1024 else None)
        Q = torch.empty_like(Y)
        rc = getattr(other, f"proxsdp_cholqr_{sfx[Y.dtype]}")(
            Y.data_ptr(), Q.data_ptr(), None if gws is None else gws.data_ptr(),
            side, k, eps, stream())
        assert rc == 0, rc
        return Q

    def median_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def mat(*shape, dt, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(shape), dtype=dt,
                            device=dev)

    def same_bits(g, w):
        ints = {torch.float32: torch.int32, torch.float64: torch.int64}
        return g.shape == w.shape and torch.equal(
            g.contiguous().view(ints[g.dtype]), w.contiguous().view(ints[w.dtype]))

    cases = []  # (label, ours, theirs, timed)
    f32, f64 = torch.float32, torch.float64
    for dt in (f32, f64):
        for side in (250, 2000):
            Y, A = mat(side, side, dt=dt, scale=side ** -1), mat(side, side, dt=dt)
            cases += [
                (f"ns_gemm {dt} square {side}: Y A", (Y, A, None, 0.0, 1.0), True),
                (f"ns_gemm {dt} square {side}: QA Y + Y A", (Y, A, Y, 1.875, 1.0),
                 True),
                (f"ns_gemm {dt} square {side}: 1.5 A - 0.5 A Y", (A, Y, A, 1.5, -0.5),
                 False),
            ]
            for k in ((24,) if side == 250 else (32, 128, 256)):
                W = mat(side, k, dt=dt)
                cases += [
                    (f"ns_gemm {dt} side {side} P+ k={k}",
                     (Y, W[:, :-1], W[:, :-1], 0.5, 0.5), side == 2000 and k == 128),
                    (f"ns_gemm {dt} side {side} P- k={k}",
                     (Y, W[:, -1:], W[:, -1:], 0.5, -0.5), side == 2000 and k == 128),
                ]
            # a tensor-parallel rank's row slab, starting on an odd row
            cases.append((f"ns_gemm {dt} side {side} rows 125-250 slab",
                          (Y[125:250], A, Y[125:250], 0.5, 0.5), False))
        for M in (1, 31, 33, 127, 250):
            for N in (1, 31, 33, 127, 250):
                for K in ((1, 33, 250) if M in (1, 127) else (31, 127)):
                    A, B = mat(M, K, dt=dt), mat(K, N, dt=dt)
                    C = mat(M, N, dt=dt)
                    cases.append((f"ns_gemm {dt} ragged {M}x{K}x{N}",
                                  (A, B, C, -0.75, 1.25), False))
        # products that underflow: partial sums of -0 and denormals
        tiny = 1e-30 if dt == f32 else 1e-200
        A, B = mat(33, 37, dt=dt, scale=tiny), mat(37, 31, dt=dt, scale=tiny)
        cases.append((f"ns_gemm {dt} underflow 33x37x31", (A, B, None, 0.0, 1.0),
                      False))
        A = torch.zeros(40, 20, dtype=dt, device=dev)
        A[:, 3] = -1.0
        B = torch.zeros(20, 30, dtype=dt, device=dev)
        cases.append((f"ns_gemm {dt} signed zeros 40x20x30", (A, B, None, 0.0, 1.0),
                      False))
        # the Ritz rotation (ncv x ncv) by (ncv, n)
        cases.append((f"ns_gemm {dt} Ritz rotation 62x62x2000",
                      (mat(62, 62, dt=dt), mat(62, 2000, dt=dt), None, 0.0, 1.0),
                      dt == f64))

    fails, rows = [], []

    def run(label, ours, theirs, timed):
        got, want = ours(), theirs()
        torch.cuda.synchronize()
        ok = same_bits(got, want)
        ms = (median_ms(ours), median_ms(theirs)) if timed else (None, None)
        rows.append({"case": label, "same_bits": ok, "ms": ms[0],
                     "other_ms": ms[1]})
        times = (f" ms {ms[0]:.4f} (other {ms[1]:.4f})" if timed else "")
        print(f"{'ok  ' if ok else 'DIFF'} {label}{times}", flush=True)
        if not ok:
            fails.append(label)

    for label, (A, B, C, alpha, beta), timed in cases:
        run(label, lambda: kernels.ns_gemm(A, B, C, alpha, beta),
            lambda: other_gemm(A, B, C, alpha, beta), timed)

    for dt in (f32, f64):
        for nb, side in ((3, 33), (3, 250), (16, 250)):
            X = mat(nb, side, side, dt=dt, scale=side ** -1)
            Z = mat(nb, side, side, dt=dt)
            for args_ in ((X, Z, None, 0.0, 1.0), (X, Z, Z, 0.5, -1.5)):
                run(f"ns_gemm_batch {dt} B={nb} side {side}"
                    f"{'' if args_[2] is None else ' axpby'}",
                    lambda a=args_: kernels.ns_gemm_batch(*a),
                    lambda a=args_: other_gemm_batch(*a),
                    nb == 16 and args_[2] is not None)
        # a strided batch: every second instance
        X = mat(6, 100, 100, dt=dt)
        run(f"ns_gemm_batch {dt} B=3 side 100 strided",
            lambda: kernels.ns_gemm_batch(X[::2], X[1::2]),
            lambda: other_gemm_batch(X[::2], X[1::2], None, 0.0, 1.0), False)

    edge = max(k for k in range(1, 257)
               if kernels.cholqr_shared_columns(k, f64) == 0)
    chol = []
    for dt in (f32, f64):
        chol += [(dt, 250, 24, True), (dt, 250, 16, False)]
        chol += [(dt, 2000, k, True) for k in (32, 128, 192, 256)]
        chol += [(dt, 250, k, False) for k in (1, 33, 200)]
    chol += [(f64, 2000, edge, False), (f64, 2000, edge + 1, False)]
    Xs = {dt: mat(2000, 2000, dt=dt) for dt in (f32, f64)}
    for dt, side, k, timed in chol:
        Y = torch.matmul(Xs[dt][:side, :side], mat(side, k, dt=dt))
        eps = kernels.CHOLQR_EPS[dt]
        run(f"cholqr {dt} side {side} k={k}", lambda: kernels.cholqr(Y, eps),
            lambda: other_cholqr(Y, eps), timed)
    for dt in (f32, f64):
        Y = torch.zeros(250, 24, dtype=dt, device=dev)
        run(f"cholqr {dt} zero Y", lambda: kernels.cholqr(Y, -1.0),
            lambda: other_cholqr(Y, -1.0), False)
        # rank-deficient: a zero column, no jitter -- a zero pivot
        Y = mat(250, 24, dt=dt)
        Y[:, 5] = 0.0
        run(f"cholqr {dt} rank-deficient", lambda: kernels.cholqr(Y, 0.0),
            lambda: other_cholqr(Y, 0.0), False)
        if not torch.isnan(kernels.cholqr(Y, 0.0)).all():
            fails.append(f"cholqr {dt} rank-deficient: not all NaN")

    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "parent": args.parent, "cases": len(rows),
                      "differ": fails, "rows": rows}))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
