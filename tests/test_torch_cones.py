"""Cone projections of the PyTorch port against the JAX package's.

The dense projection is an eigendecomposition on both sides, from two
LAPACK builds (jaxlib's and PyTorch's), so the projected block is held to
atol 1e-10 * ||X||_F; rank and min_eig must be equal, and the warm vector
(the top eigenvector) equal up to its arbitrary sign."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from proxsdp_tpu.ops import cones as jcones
from proxsdp_tpu_torch.ops import cones as tcones

F64 = torch.float64


@pytest.mark.parametrize("p, m", [(5, 4), (6, 0), (0, 7)])
def test_box_projection(p, m):
    rng = np.random.RandomState(p * 10 + m)
    v, b, h = rng.randn(p + m), rng.randn(p), rng.randn(m)
    step = 0.37
    want = jcones.box_projection(jnp.asarray(v), jnp.asarray(b), jnp.asarray(h),
                                 step, p, m)
    got = tcones.box_projection(torch.tensor(v, dtype=F64),
                                torch.tensor(b, dtype=F64),
                                torch.tensor(h, dtype=F64), step, p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _random_symmetric(side, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(side, side)
    return 0.5 * (A + A.T)


@pytest.mark.parametrize("side", [1, 20, 50])
def test_psd_projection_block(side):
    X = _random_symmetric(side, seed=side)
    warm = np.random.RandomState(7).randn(side)
    opts = tp.jax_opts()
    want = jcones.psd_projection_block(
        jnp.asarray(X.reshape(-1)), side, jnp.asarray(2, jnp.int32),
        jnp.asarray(warm), opt=opts, allow_lanczos=True)
    got = tcones.psd_projection_block(
        torch.tensor(X, dtype=F64), torch.tensor(warm, dtype=F64), opts=opts)
    fro = np.linalg.norm(X)
    np.testing.assert_allclose(got.block.numpy().reshape(-1),
                               np.asarray(want.block), rtol=0,
                               atol=1e-10 * fro)
    assert int(got.current_rank) == int(want.current_rank)
    assert float(got.min_eig) == float(want.min_eig)
    assert got.used_full == bool(want.used_full)
    gw, ww = got.warm.numpy(), np.asarray(want.warm)
    sign = -1.0 if np.dot(gw, ww) < 0 else 1.0
    np.testing.assert_allclose(sign * gw, ww, rtol=0, atol=1e-10)


def test_projection_is_psd_and_idempotent():
    X = torch.tensor(_random_symmetric(30, seed=11), dtype=F64)
    opts = tp.torch_opts()
    P = tcones.psd_projection_block(X, torch.zeros(30, dtype=F64),
                                    opts=opts).block
    assert float(torch.linalg.eigvalsh(P)[0]) >= -1e-12
    P2 = tcones.psd_projection_block(P, torch.zeros(30, dtype=F64),
                                     opts=opts).block
    torch.testing.assert_close(P2, P, rtol=0, atol=1e-12)


def test_eigh_nonconvergence_gives_nan(monkeypatch):
    """Where LAPACK's (or cuSOLVER's) eigh does not converge, torch raises
    and jnp.linalg.eigh returns NaN; the port's ``_eigh`` returns NaN
    eigenpairs of the input's shape, so the caller's finite guard sends
    it to its fallback (MIMO n = 100's k x k Ritz matrix met this)."""
    from proxsdp_tpu_torch.ops import cones as tcones

    def fails(A):
        raise torch.linalg.LinAlgError("linalg.eigh: The algorithm failed "
                                       "to converge")

    A = torch.eye(4, dtype=torch.float64)
    w, V = tcones._eigh(A)
    assert torch.equal(w, torch.ones(4, dtype=torch.float64))
    monkeypatch.setattr(torch.linalg, "eigh", fails)
    w, V = tcones._eigh(A)
    assert w.shape == (4,) and V.shape == (4, 4)
    assert torch.isnan(w).all() and torch.isnan(V).all()
