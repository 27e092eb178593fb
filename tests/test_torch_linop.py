"""Operators of the PyTorch port against the JAX package's (ops/linop.py).

``EllOp`` products run kernel K1's wrapper, which on the CPU takes the
plain PyTorch version; ``DenseOp`` products are ``torch.matmul``.  Both
are held to the JAX operator at rtol 1e-13: only the summation order of
at most 32 terms per row (or the BLAS dot order) differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import _torch_parity as tp
from proxsdp_tpu.ops import linop as jlinop
from proxsdp_tpu_torch import convert, kernels
from proxsdp_tpu_torch.ops import linop as tlinop

F64 = torch.float64


def _pair(A, G, force=None):
    return (jlinop.build_linop(A, G, jnp.float64, force=force),
            tlinop.build_linop(A, G, F64, device="cpu", force=force))


def _check_products(jop, top, seed):
    rng = np.random.RandomState(seed)
    nrows, ncols = top.shape
    assert tuple(jop.shape) == (nrows, ncols)
    x, y = rng.randn(ncols), rng.randn(nrows)
    np.testing.assert_allclose(
        top.matvec(torch.tensor(x, dtype=F64)).numpy(),
        np.asarray(jop.matvec(jnp.asarray(x))), rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(
        top.rmatvec(torch.tensor(y, dtype=F64)).numpy(),
        np.asarray(jop.rmatvec(jnp.asarray(y))), rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("name, kind", [("maxcut50", "EllOp"),
                                        ("maxcut30", "DenseOp"),
                                        ("readme", "DenseOp")])
def test_slice_operator_matches_jax(name, kind):
    s = tp.jax_setup(name)
    jop, top = _pair(s.A, s.G)
    assert type(jop).__name__ == type(top).__name__ == kind
    _check_products(jop, top, seed=1)
    assert kernels.kernel_launches()["ell_spmv"] == 0  # CPU: plain version


def test_wide_ell_matches_jax():
    # rows and columns with several nonzeros (max-cut's tables are width 1)
    rng = np.random.RandomState(3)
    A = sp.random(40, 600, density=0.03, random_state=rng, format="csr")
    G = sp.random(20, 600, density=0.03, random_state=rng, format="csr")
    jop, top = _pair(A, G, force="ell")
    assert isinstance(top, tlinop.EllOp) and top.row_cols.shape[1] > 1
    _check_products(jop, top, seed=4)


@pytest.mark.parametrize("name", ["maxcut50", "maxcut30"])
def test_tables_equal_and_convert(name):
    s = tp.jax_setup(name)
    jop, top = _pair(s.A, s.G)
    if isinstance(jop, jlinop.EllOp):
        fields = ("row_cols", "row_vals", "col_rows", "col_vals")
        for f in fields:
            assert np.array_equal(getattr(top, f).numpy(), np.asarray(getattr(jop, f))), f
        conv = convert.linop_from_tables(
            **{f: np.asarray(getattr(jop, f)) for f in fields}, device="cpu")
        for f in fields:
            assert torch.equal(getattr(conv, f), getattr(top, f)), f
    else:
        assert np.array_equal(top.mat.numpy(), np.asarray(jop.mat))
        conv = convert.linop_from_tables(mat=np.asarray(jop.mat), device="cpu")
        assert torch.equal(conv.mat, top.mat)


def test_ell_index_validation():
    idx = torch.tensor([[0], [5]], dtype=torch.int32)
    val = torch.ones(2, 1, dtype=F64)
    with pytest.raises(ValueError, match="out of range"):
        tlinop.EllOp(idx, val, torch.zeros(3, 1, dtype=torch.int32),
                     torch.ones(3, 1, dtype=F64))
    with pytest.raises(TypeError):
        tlinop.EllOp(idx.long(), val, idx.long(), val)


def test_coo_form_raises():
    s = tp.jax_setup("maxcut30")
    with pytest.raises(NotImplementedError, match="ROADMAP B2'"):
        tlinop.build_linop(s.A, s.G, F64, device="cpu", force="coo")
