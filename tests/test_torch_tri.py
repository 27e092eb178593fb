"""The port's packed-triangle gathers (K10), batched dense-eigh projection
(K9) and batched K1-K4 entry points on the CPU, where each wrapper runs
its plain PyTorch version.

K10 and K9 are held to the JAX package's ``ops/tri.py`` and
``psd_projection_small_batch``; the batched K1-K4 plain versions to the
single-instance plain versions applied row by row.
"""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread, full-precision products)
import jax.numpy as jnp
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu.ops import cones as jcones
from proxsdp_tpu.ops import tri as jtri
from proxsdp_tpu_torch import kernels
from proxsdp_tpu_torch.ops import cones as tcones
from proxsdp_tpu_torch.ops import tri as ttri

DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]


def _tri_rows(rng, B, side, n_extra=0):
    return rng.standard_normal((B, side * (side + 1) // 2 + n_extra))


@pytest.mark.parametrize("ndt, tdt", DTYPES)
@pytest.mark.parametrize("side", [1, 2, 5, 16])
def test_tri_gathers_match_jax(ndt, tdt, side):
    """K10's plain version against ops/tri.py, row by row: exact (one
    gather and one multiply by the same scale)."""
    rng = np.random.default_rng(side)
    V = _tri_rows(rng, 6, side, n_extra=3).astype(ndt)
    S = ttri.tri_to_square(torch.tensor(V), side)
    tl = side * (side + 1) // 2
    for b in range(V.shape[0]):
        want = np.asarray(jtri.tri_to_square(jnp.asarray(V[b, :tl]), side))
        np.testing.assert_array_equal(S[b].numpy(), want)
    X = rng.standard_normal((6, side, side)).astype(ndt)
    T = ttri.square_to_tri(torch.tensor(X), side)
    for b in range(X.shape[0]):
        want = np.asarray(jtri.square_to_tri(jnp.asarray(X[b]), side))
        np.testing.assert_array_equal(T[b].numpy(), want)
    assert S.dtype == T.dtype == tdt
    for a, b in zip(ttri._maps(side), jtri._maps(side)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ndt, tdt", DTYPES)
@pytest.mark.parametrize("side", [1, 2, 10, 16, 40])
@pytest.mark.parametrize("layout", ["tri", "square"])
def test_small_batch_projection_matches_jax(ndt, tdt, side, layout):
    """The batched projection (K9's plain version between K10's) against
    psd_projection_small_batch: blocks to 1e-12 (f64) / 1e-5 (f32) of the
    largest entry, ranks equal, the warm vector equal up to sign where the
    top eigenvalue is simple."""
    rng = np.random.default_rng(100 + side)
    B = 7
    X = rng.standard_normal((B, side, side))
    X = X + X.transpose(0, 2, 1)
    V, _ = np.linalg.qr(rng.standard_normal((side, side)))
    w = rng.standard_normal(side)
    w[: side // 2] = 0.0
    X[0] = (V * w) @ V.T  # rank-deficient
    if layout == "tri":
        i, j = np.triu_indices(side)
        order = np.lexsort((i, j))  # column-major upper triangle
        i, j = i[order], j[order]
        scale = np.where(i == j, 1.0, np.sqrt(2.0))
        blocks = np.ascontiguousarray((X[:, i, j] * scale).astype(ndt))
    else:
        blocks = X.reshape(B, -1).astype(ndt)
    opts_j = jx.Options(use_lanczos=False, subspace_rank=0)
    got = tcones.psd_projection_small_batch(torch.tensor(blocks), side,
                                            opts=tx.Options())
    want = jcones.psd_projection_small_batch(jnp.asarray(blocks), side,
                                             opt=opts_j)
    got = [g.numpy() for g in got]
    want = [np.asarray(w_) for w_ in want]
    tol = 1e-12 if ndt == np.float64 else 1e-5
    scale = np.abs(want[0]).max()
    assert got[0].dtype == want[0].dtype
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol * scale)
    np.testing.assert_array_equal(got[1], want[1])
    # ranks: equal for every instance whose eigenvalues clear tol_psd by
    # more than the rounding of the eigensolvers -- in f32 the exact zeros
    # of the rank-deficient instance come out as noise of ~1e-6 on either
    # side of tol_psd = 1e-7, and two LAPACK builds count it differently
    ev = np.linalg.eigvalsh(X)
    clear = (np.abs(ev - 1e-7) > 10 * tol * np.abs(ev).max()).all(axis=1)
    np.testing.assert_array_equal(got[2][clear], want[2][clear])
    assert clear[1:].all()
    if side == 1:
        np.testing.assert_array_equal(got[3], want[3])
        return
    simple = ev[:, -1] - ev[:, -2] > 1e-3 * np.abs(ev).max()
    dots = np.abs(np.sum(got[3] * want[3], axis=1))
    np.testing.assert_allclose(dots[simple], 1.0, rtol=0,
                               atol=1e-9 if ndt == np.float64 else 1e-4)


def test_psd_eigh_nan_instance_alone():
    """A non-finite instance gives NaN (rank 0) for itself alone, as
    jnp.linalg.eigh does; torch.linalg.eigh would raise."""
    X = torch.tensor(np.random.default_rng(0).standard_normal((3, 4, 4)))
    X = X + X.transpose(1, 2)
    X[1, 2, 3] = float("nan")
    Xp, w, rank, warm = kernels.batched_psd_eigh(X, 1e-7)
    assert torch.isnan(Xp[1]).all() and torch.isnan(w[1]).all()
    assert torch.isnan(warm[1]).all() and int(rank[1]) == 0
    for b in (0, 2):
        assert torch.isfinite(Xp[b]).all() and int(rank[b]) > 0


@pytest.mark.parametrize("tdt", [torch.float64, torch.float32])
def test_batched_entry_points_match_single_rows(tdt):
    """Each batched K1-K4 plain version against the single-instance plain
    version applied row by row: exact.  The one exception is K3's f64
    dots, a row sum against torch.dot (BLAS), which add in another order:
    they are held to 1e-15 relative."""
    rng = np.random.default_rng(5)
    B, n, p, m = 5, 55, 10, 4

    def rows(k):
        return torch.tensor(rng.standard_normal((B, k)), dtype=tdt)

    x, x_old, Mty, Mty_old, c = (rows(n) for _ in range(5))
    y, y_old, Mx, Mx_old = (rows(p + m) for _ in range(4))
    b, h = rows(p), rows(m)
    tau, sigma, theta = (torch.tensor(rng.uniform(0.1, 1.0, B), dtype=tdt)
                         for _ in range(3))
    idx = torch.tensor(rng.integers(0, n, (p + m, 3)), dtype=torch.int32)
    vals = torch.tensor(rng.standard_normal((p + m, 3)), dtype=tdt)

    out = kernels.ell_spmv_batch(idx, vals, x)
    for k in range(B):
        assert torch.equal(out[k], kernels.ell_spmv(idx, vals, x[k]))
    yt, sq = kernels.ls_dual_update_batch(y, Mx, Mx_old, b, h, y_old, sigma,
                                          theta, p, m)
    for k in range(B):
        yt1, sq1 = kernels.ls_dual_update(y[k], Mx[k], Mx_old[k], b[k], h[k],
                                          y_old[k], sigma[k], theta[k], p, m)
        assert torch.equal(yt[k], yt1) and torch.equal(sq[k], sq1)
    sq = kernels.sq_dist_batch(x, x_old)
    for k in range(B):
        assert torch.equal(sq[k], kernels.sq_dist(x[k], x_old[k]))
    u = kernels.primal_update_batch(x, Mty, c, tau)
    for k in range(B):
        # side 0: the single entry point without the square symmetrisation
        assert torch.equal(u[k], kernels.primal_update_sym(x[k], Mty[k], c[k],
                                                           tau[k], 0))
    r = kernels.residuals_batch(x, x_old, Mty, Mty_old, tau, y, y_old, Mx,
                                Mx_old, sigma, b, h, c, p, m)
    for k in range(B):
        r1 = kernels.residuals(x[k], x_old[k], Mty[k], Mty_old[k], tau[k],
                               y[k], y_old[k], Mx[k], Mx_old[k], sigma[k],
                               b[k], h[k], c[k], p, m, 0)
        assert torch.equal(r[k, :6], r1[:6])
        if tdt == torch.float32:
            assert torch.equal(r[k, 6:], r1[6:])
        else:
            torch.testing.assert_close(r[k, 6:], r1[6:], rtol=1e-15, atol=0)
