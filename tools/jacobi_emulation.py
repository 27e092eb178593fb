"""jacobi.cuh's cyclic Jacobi emulated in NumPy, f32 against f64, on the
Rayleigh-Ritz matrices of K12's mixed-mode rows (a side-500 matrix with
six large eigenvalues, a basis spanning its top k eigenvectors).

    python3 tools/jacobi_emulation.py [K ...]

For each k (default 128 192) and each of three instances it prints the
sweeps taken, how far the Jacobi eigenvalues lie from LAPACK's f64 ones
and how far its eigenvectors do (1 - |cos| over the pairs separated by
more than 1e-3 of the scale), each relative to the largest entry of the
packed block.  Runs on the CPU; ~1 minute.
"""

import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from proxsdp_tpu_torch import kernels  # noqa: E402


def round_pairs(r, n):
    """jacobi.cuh's round_pair for every pair of round r."""
    m = n - 1
    k = np.arange(n // 2)
    a = np.where(k == 0, m, (r + k) % m)
    b = np.where(k == 0, r, (r - k + m) % m)
    return np.minimum(a, b), np.maximum(a, b)


def jacobi(A, dt, max_sweeps, eps):
    """(eigenvalues, eigenvectors, sweeps) of jacobi_eigh in type dt."""
    A = A.astype(dt).copy()
    n = A.shape[0]
    V = np.eye(n, dtype=dt)
    thresh = eps * eps * float(np.sum(A.astype(np.float64) ** 2))
    sweeps = 0
    one, two = dt(1), dt(2)
    for _ in range(max_sweeps):
        off = A.astype(np.float64)
        if float(np.sum(off ** 2) - np.sum(np.diag(off) ** 2)) <= thresh:
            break
        sweeps += 1
        for r in range(n - 1):
            p, q = round_pairs(r, n)
            apq = A[p, q]
            nz = apq != 0
            den = np.where(nz, two * apq, one)
            tau = np.where(nz, (A[q, q] - A[p, p]) / den, 0).astype(dt)
            t = (np.where(tau >= 0, one, -one)
                 / (np.abs(tau) + np.sqrt(one + tau * tau))).astype(dt)
            c = np.where(nz, one / np.sqrt(one + t * t), one).astype(dt)
            s = np.where(nz, t * c, 0).astype(dt)
            Ap, Aq = A[:, p].copy(), A[:, q].copy()
            A[:, p], A[:, q] = c * Ap - s * Aq, s * Ap + c * Aq
            Vp, Vq = V[:, p].copy(), V[:, q].copy()
            V[:, p], V[:, q] = c * Vp - s * Vq, s * Vp + c * Vq
            Ap, Aq = A[p, :].copy(), A[q, :].copy()
            A[p, :] = c[:, None] * Ap - s[:, None] * Aq
            A[q, :] = s[:, None] * Ap + c[:, None] * Aq
            A[p, q] = 0
            A[q, p] = 0
    return np.diag(A).astype(np.float64), V.astype(np.float64), sweeps


def main() -> int:
    ks = [int(a) for a in sys.argv[1:]] or [128, 192]
    B, side = 3, 500
    rng = np.random.default_rng(5)
    Qx, _ = np.linalg.qr(rng.standard_normal((B, side, side)))
    w = rng.standard_normal((B, side))
    w[:, :6] = 5.0 + 3.0 * rng.random((B, 6))
    X = torch.tensor((Qx * w[:, None, :]) @ Qx.transpose(0, 2, 1))
    scale = float(kernels.square_to_tri_plain(X, side).abs().max())
    order = np.argsort(-w, axis=1)
    eps32 = kernels.CHOLQR_EPS[torch.float32]
    for k in ks:
        V = np.take_along_axis(Qx, order[:, None, :k], axis=2) \
            @ np.linalg.qr(rng.standard_normal((B, k, k)))[0]
        Xb = X.float()
        Q = kernels._cholqr_batch_plain(kernels._cholqr_batch_plain(
            Xb @ torch.tensor(V).float(), eps32), eps32)
        Bm = Q.mT @ (Xb @ Q)
        Bm = (0.5 * (Bm + Bm.mT)).numpy()
        for b in range(B):
            wl, Ul = np.linalg.eigh(Bm[b].astype(np.float64))
            g = np.diff(wl)
            simple = np.minimum(np.r_[g, np.inf], np.r_[np.inf, g]) \
                > 1e-3 * scale
            for dt, sweeps, eps in ((np.float32, 15, 1.1920928955078125e-07),
                                    (np.float64, 20, 2.220446049250313e-16)):
                d, Vj, sw = jacobi(Bm[b], dt, sweeps, eps)
                o = np.argsort(d)
                Vj = Vj[:, o] / np.linalg.norm(Vj[:, o], axis=0)
                apart = 1 - np.abs(np.sum(Vj * Ul, axis=0))
                print(f"k = {k}, instance {b}, {dt.__name__}: {sw} sweeps; "
                      f"eigenvalues {np.abs(d[o] - wl).max() / scale:.2e} of "
                      f"the scale from LAPACK's; vectors 1 - |cos| up to "
                      f"{apart[simple].max():.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
