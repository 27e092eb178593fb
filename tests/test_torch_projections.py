"""The polar and subspace PSD projections of the port against the JAX
package's, at side 100.

Inputs come from numpy seeds; the JAX side runs ``proxsdp_tpu.ops.cones``
on the CPU, the port ``proxsdp_tpu_torch.ops.cones`` with ``device="cpu"``
(every kernel wrapper takes its plain PyTorch version).  The matrices are
shaped like the solver's: a few large positive eigenvalues, a negative
bulk.  Tolerances (relative to ||Xp||_F):

* polar_psd: 1e-5 in f32 and f64 (the Newton-Schulz polynomial is the
  same; the products sum in other orders), equal rank;
* _cholqr2: ||Q^T Q - I|| <= 1e-5 in f32 (1e-10 in f64, ill-conditioned
  input), projectors QQ^T equal to 1e-5;
* the f32 subspace step: 1e-5, the same accept decision and rank;
* the mixed f64 subspace step: 1e-6 (its basis is f32);
* polar_reseed: the NaN guard passes a non-finite X through with rank =
  side and the old basis; a rank-deficient P+ W still gives a finite
  basis (the jitter of _cholqr2).

Observed when written: polar 3.2e-7 (f32) and 5.8e-16 (f64); _cholqr2
||Q^T Q - I|| 7.8e-6 (f32) and 8.0e-12 (f64) on the ill-conditioned
input, projectors equal to 6.0e-8 and 1.1e-16; the subspace step accepted
1.1e-6 (f32) and 8.6e-7 (mixed f64), rejected into the polar reseed
3.1e-7 in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (one torch thread, f32 matmuls)
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu.ops import cones as jcones
from proxsdp_tpu_torch import kernels
from proxsdp_tpu_torch.ops import cones as tcones

SIDE = 100
K = 16
TORCH = {"float32": torch.float32, "float64": torch.float64}
NP = {"float32": np.float32, "float64": np.float64}


def _spectrum_matrix(seed, npos=8):
    """(X, V): X = V diag(w) V^T with npos eigenvalues in [2, 10] and a
    negative bulk in [-3, -0.1]; V's columns sorted by descending w."""
    rng = np.random.RandomState(seed)
    V, _ = np.linalg.qr(rng.randn(SIDE, SIDE))
    w = np.concatenate([np.linspace(10.0, 2.0, npos),
                        -np.linspace(0.1, 3.0, SIDE - npos)])
    return (V * w) @ V.T, V


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_polar_psd(dtype):
    X, _ = _spectrum_matrix(1)
    X = X.astype(NP[dtype])
    want, wrank = jcones.polar_psd(jnp.asarray(X), SIDE, aggressive=7, polish=4)
    got, grank = tcones.polar_psd(torch.tensor(X), aggressive=7, polish=4)
    assert got.dtype == TORCH[dtype]
    assert _rel(got.numpy(), want) <= 1e-5
    assert int(grank) == int(wrank) == 8


def _jax_cholqr2(Y, eps):
    """cones.py:247-263, transcribed (a closure there)."""
    def one(Yc):
        G = Yc.T @ Yc
        jit = jnp.asarray(eps, Yc.dtype) * (jnp.trace(G) / Yc.shape[1] + 1.0)
        R = jnp.linalg.cholesky(G + jit * jnp.eye(Yc.shape[1], dtype=Yc.dtype))
        import jax.scipy.linalg as jsl
        return jsl.solve_triangular(R, Yc.T, lower=True).T
    return one(one(Y))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cholqr2(dtype):
    Y = np.random.RandomState(3).randn(SIDE, K).astype(NP[dtype])
    Y[:, 1] += 0.999 * Y[:, 0]  # ill-conditioned columns
    got = tcones._cholqr2(torch.tensor(Y)).numpy()
    want = np.asarray(_jax_cholqr2(jnp.asarray(Y),
                                   kernels.CHOLQR_EPS[TORCH[dtype]]))
    orth = np.linalg.norm(got.T.astype(np.float64) @ got - np.eye(K))
    assert orth <= (1e-5 if dtype == "float32" else 1e-10)
    np.testing.assert_allclose(got @ got.T, want @ want.T, rtol=0, atol=1e-5)


def test_cholqr_non_positive_pivot_gives_nan():
    # jnp.linalg.cholesky gives NaN there; torch.linalg.cholesky raises
    Y = torch.zeros(SIDE, 4, dtype=torch.float32)
    Q = kernels.cholqr(Y, eps=-1.0)
    assert torch.isnan(Q).all()
    want = _jax_cholqr2(jnp.zeros((SIDE, 4), jnp.float32), -1.0)
    assert np.isnan(np.asarray(want)).all()


def _subspace_case(dtype, *, accept_tol, force_full, warm_noise=0.0,
                   fallback="polar", X=None, warm=None):
    """One subspace step of both packages: (port result, JAX result)."""
    Xm, V = _spectrum_matrix(5)
    X = Xm if X is None else X
    if warm is None:
        rng = np.random.RandomState(6)
        warm = V[:, :K] + warm_noise * rng.randn(SIDE, K)
    kw = dict(dtype=dtype, subspace_rank=K, subspace_fallback=fallback,
              projection="polar")
    jo, to = jx.Options(**kw), tx.Options(**kw)
    X, warm = X.astype(NP[dtype]), warm.astype(NP[dtype])
    at = None if accept_tol is None else np.asarray(accept_tol, NP[dtype])
    want = jcones.psd_projection_block(
        jnp.asarray(X.reshape(-1)), SIDE, jnp.asarray(2, jnp.int32),
        jnp.asarray(warm), opt=jo, allow_lanczos=True,
        accept_tol=None if at is None else jnp.asarray(at),
        force_full=jnp.asarray(force_full))
    got = tcones.psd_projection_block(
        torch.tensor(X), torch.tensor(warm), opts=to,
        accept_tol=None if at is None else torch.tensor(at),
        force_full=force_full)
    return got, want


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5), ("float64", 1e-6)])
@pytest.mark.parametrize("case", ["accept", "reject_resid", "force_full"])
def test_subspace_step(dtype, tol, case):
    """f32 step (eigh of B in f32) and mixed f64 step (f32 basis, f64
    Rayleigh quotients); accepted, rejected on the residual, and forced
    to the polar reseed."""
    kw = {"accept": dict(accept_tol=1e-3, force_full=False),
          "reject_resid": dict(accept_tol=None, force_full=False,
                               warm_noise=0.3),
          "force_full": dict(accept_tol=1e-3, force_full=True)}[case]
    got, want = _subspace_case(dtype, **kw)
    assert got.used_full == bool(want.used_full) == (case != "accept")
    assert int(got.current_rank) == int(want.current_rank)
    block = np.asarray(want.block).reshape(SIDE, SIDE)
    assert _rel(got.block.numpy(), block) <= tol
    np.testing.assert_allclose(got.sub_stats.numpy(), np.asarray(want.sub_stats),
                               rtol=1e-4, atol=1e-5)
    gw, ww = got.warm.numpy(), np.asarray(want.warm)
    assert gw.shape == ww.shape == (SIDE, K)
    if case == "accept":
        # the Ritz basis: the same subspace (columns may flip sign)
        np.testing.assert_allclose(gw @ gw.T, ww @ ww.T, rtol=0, atol=1e-4)
    else:
        # the reseed's P+ W: only its span of X's positive eigenspace is
        # determined (the other columns are jitter-rescued noise)
        _, V = _spectrum_matrix(5)
        for basis in (gw, ww):
            coef = np.linalg.lstsq(basis.astype(np.float64), V[:, :8],
                                   rcond=None)[0]
            assert np.linalg.norm(basis @ coef - V[:, :8]) <= 1e-3


def test_subspace_dense_fallback_f64():
    """The f64 polish's dense-eigh fallback (full_path_sub)."""
    got, want = _subspace_case("float64", accept_tol=None, force_full=True,
                               fallback="eigh")
    assert got.used_full and bool(want.used_full)
    assert int(got.current_rank) == int(want.current_rank) == 8
    assert _rel(got.block.numpy(), np.asarray(want.block).reshape(SIDE, SIDE)) <= 1e-12


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_polar_reseed_nan_guard(dtype):
    """A non-finite X: the step is rejected, the reseed's guard passes X
    through with rank = side, and the old basis is kept."""
    X, V = _spectrum_matrix(5)
    X[3, 7] = X[7, 3] = np.nan
    warm = V[:, :K]
    got, want = _subspace_case(dtype, accept_tol=1e-3, force_full=False,
                               X=X, warm=warm)
    assert got.used_full and bool(want.used_full)
    assert int(got.current_rank) == int(want.current_rank) == SIDE
    np.testing.assert_array_equal(np.isnan(got.block.numpy()),
                                  np.isnan(np.asarray(want.block).reshape(SIDE, SIDE)))
    np.testing.assert_array_equal(got.warm.numpy(), warm.astype(NP[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_polar_reseed_rank_deficient_basis(dtype):
    """Every column of the old basis in X's negative eigenspace: P+ W is ~0
    and Z is rank-deficient; _cholqr2's jitter keeps the new basis finite
    and the projection is the polar one."""
    X, V = _spectrum_matrix(5)
    warm = V[:, -K:]
    got, want = _subspace_case(dtype, accept_tol=1e-3, force_full=True,
                               X=X, warm=warm)
    assert np.all(np.isfinite(got.warm.numpy()))
    assert np.all(np.isfinite(np.asarray(want.warm)))
    assert int(got.current_rank) == int(want.current_rank) == 8
    assert _rel(got.block.numpy(), np.asarray(want.block).reshape(SIDE, SIDE)) <= 1e-5
