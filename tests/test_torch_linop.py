"""Operators of the PyTorch port against the JAX package's (ops/linop.py).

``EllOp`` products run kernel K1's wrapper and ``CooOp`` products kernel
K14's, which on the CPU take their plain PyTorch versions; ``DenseOp``
products are ``torch.matmul``.  All are held to the JAX operator at rtol
1e-13: only summation orders differ."""

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


def test_coo_form_matches_jax():
    """The COO operator (kernel K14's plain version), forced on max-cut."""
    s = tp.jax_setup("maxcut30")
    jop, top = _pair(s.A, s.G, force="coo")
    assert type(jop).__name__ == type(top).__name__ == "CooOp"
    _check_products(jop, top, 3)


def test_auto_picks_coo_where_jax_does():
    """A row denser than ELL's 32 on a matrix too large for the dense form
    (a trace row of side 60, beside 2500 single-entry rows) takes the COO
    form in both packages, and their products agree."""
    rng = np.random.RandomState(8)
    side, m = 60, 2500
    n = side * side
    rows = [np.zeros(side, np.int64)]
    cols = [np.arange(side) * (side + 1)]
    rows.append(1 + np.arange(m))
    cols.append(rng.choice(n, m, replace=False))
    A = sp.csr_matrix((rng.randn(side + m), (np.concatenate(rows),
                                             np.concatenate(cols))),
                      shape=(m + 1, n))
    G = sp.csr_matrix((0, n))
    jop, top = _pair(A, G)
    assert type(jop).__name__ == type(top).__name__ == "CooOp"
    _check_products(jop, top, 4)
    assert tlinop.build_linop(A, G, F64, device="cpu",
                              dense_limit=10**8).__class__.__name__ == "DenseOp"


@pytest.mark.parametrize("force, form", [("dense", kernels.LS_DENSE),
                                         ("ell", kernels.LS_ELL),
                                         ("coo", kernels.LS_COO)])
def test_rmatvec_tables_give_the_jax_rmatvec(force, form):
    """The M' tables an operator hands the linesearch kernels (K15, K15b)
    compute the JAX operator's M' y when summed as the kernels read
    them: the dense matrix's columns, ELL's column rows and values, COO's
    column segments."""
    s = tp.jax_setup("maxcut30")
    jop, top = _pair(s.A, s.G, force=force)
    got_form, ptr, idx, vals, width = top.rmatvec_tables()
    assert got_form == form
    y = np.random.RandomState(5).randn(top.shape[0])
    vals = vals.numpy()
    if form == kernels.LS_DENSE:
        assert ptr is None and idx is None and width == 0
        mty = vals.T @ y
    elif form == kernels.LS_ELL:
        assert ptr is None and width == idx.shape[1]
        mty = (vals * y[idx.numpy()]).sum(axis=1)
    else:
        assert width == 0 and ptr.shape[0] == top.shape[1] + 1
        ptr, idx = ptr.numpy(), idx.numpy()
        mty = np.array([np.dot(vals[a:b], y[idx[a:b]])
                        for a, b in zip(ptr[:-1], ptr[1:])])
    np.testing.assert_allclose(mty, np.asarray(jop.rmatvec(jnp.asarray(y))),
                               rtol=1e-13, atol=1e-14)
