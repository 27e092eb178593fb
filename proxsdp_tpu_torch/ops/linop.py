"""Linear operator M = [A; G] of the PDHG loop (``proxsdp_tpu/ops/linop.py``).

* ``DenseOp`` -- a dense (p+m, n) matrix; products are ``torch.matmul``
  (the JAX package leaves them to XLA too, linop.py:44-48).
* ``EllOp`` -- per-row and per-column ELLPACK tables; both products are
  kernel K1 (``kernels.ell_spmv``), a gather + row reduce.

Both are ``nn.Module``s holding their tables as buffers, so ``.to(device)``
moves them.  The COO form is ROADMAP B2'.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from .. import kernels


class DenseOp(nn.Module):
    def __init__(self, mat: torch.Tensor):
        super().__init__()
        self.register_buffer("mat", mat)

    @property
    def shape(self):
        return tuple(self.mat.shape)

    def matvec(self, x):
        return torch.matmul(self.mat, x)

    def rmatvec(self, y):
        return torch.matmul(self.mat.T, y)

    def matvec_batch(self, X):
        """M x for each row of the (B, n) X."""
        return torch.matmul(X, self.mat.T)

    def rmatvec_batch(self, Y):
        return torch.matmul(Y, self.mat)


class EllOp(nn.Module):
    """ELLPACK operator; padding entries point at index 0 with value 0."""

    def __init__(self, row_cols, row_vals, col_rows, col_vals):
        super().__init__()
        nrows, ncols = row_cols.shape[0], col_rows.shape[0]
        for idx, bound in ((row_cols, ncols), (col_rows, nrows)):
            if idx.dtype != torch.int32:
                raise TypeError("ELL index tables must be int32")
            if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= bound):
                raise ValueError("ELL index out of range")
        self.register_buffer("row_cols", row_cols)  # (nrows, r) int32
        self.register_buffer("row_vals", row_vals)  # (nrows, r)
        self.register_buffer("col_rows", col_rows)  # (ncols, c) int32
        self.register_buffer("col_vals", col_vals)  # (ncols, c)

    @property
    def shape(self):
        return (self.row_cols.shape[0], self.col_rows.shape[0])

    def matvec(self, x):
        return kernels.ell_spmv(self.row_cols, self.row_vals, x)

    def rmatvec(self, y):
        return kernels.ell_spmv(self.col_rows, self.col_vals, y)

    def matvec_batch(self, X):
        """M x for each row of the (B, n) X (K1's batched entry point)."""
        return kernels.ell_spmv_batch(self.row_cols, self.row_vals, X)

    def rmatvec_batch(self, Y):
        return kernels.ell_spmv_batch(self.col_rows, self.col_vals, Y)


def ell_tables(rows, cols, vals, nrows, ncols, max_width=32):
    """Host ELL tables (row_cols, row_vals, col_rows, col_vals) as numpy
    arrays, or None if a row/column is too dense (linop.py:140-170)."""

    def tables(keys, others, vals, nkeys):
        counts = np.bincount(keys, minlength=nkeys)
        width = int(counts.max()) if len(counts) else 0
        width = max(width, 1)
        if width > max_width:
            return None
        idx = np.zeros((nkeys, width), np.int32)
        val = np.zeros((nkeys, width))
        order = np.argsort(keys, kind="stable")
        ks = keys[order]
        starts = np.searchsorted(ks, np.arange(nkeys), side="left")
        slot = np.arange(len(ks)) - starts[ks]
        idx[ks, slot] = others[order]
        val[ks, slot] = vals[order]
        return idx, val

    t_row = tables(rows, cols, vals, nrows)
    t_col = tables(cols, rows, vals, ncols)
    if t_row is None or t_col is None:
        return None
    return t_row[0], t_row[1], t_col[0], t_col[1]


def _to_coo(M):
    if sp.issparse(M):
        coo = M.tocoo()
        return coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data.astype(np.float64)
    M = np.asarray(M)
    r, c = np.nonzero(M)
    return r.astype(np.int64), c.astype(np.int64), M[r, c].astype(np.float64)


def stack_vertical(A, G):
    """Host-side vertical stack of A (p,n) and G (m,n), dense or sparse."""
    if sp.issparse(A) or sp.issparse(G):
        return sp.vstack([sp.csr_matrix(A), sp.csr_matrix(G)]).tocsr()
    return np.vstack([np.asarray(A), np.asarray(G)])


def build_linop(A, G, dtype: torch.dtype, *, device, force: str | None = None,
                dense_limit: int = 1 << 23):
    """Choose and build the operator for M = [A; G] on ``device``.

    force: "dense" | "ell" | None (auto).  Auto is the JAX package's policy
    for a backend that is not a TPU (linop.py:278-281): ELL for very sparse
    matrices, dense otherwise.
    """
    M = stack_vertical(A, G)
    nrows, ncols = M.shape
    size = nrows * ncols
    nnz = M.nnz if sp.issparse(M) else int(np.count_nonzero(M))
    density = nnz / max(size, 1)

    choice = force
    if choice is None:
        if density < 0.02 and size > (1 << 16):
            choice = "ell"
        else:
            choice = "dense" if (size <= dense_limit or density > 0.25) else "ell"
    if choice not in ("dense", "ell"):
        raise NotImplementedError(
            f"operator form {choice!r}: the COO operator is ROADMAP B2'"
        )

    def dense():
        arr = M.toarray() if sp.issparse(M) else np.asarray(M)
        return DenseOp(torch.tensor(arr, dtype=dtype, device=device))

    if choice == "dense":
        return dense()
    t = ell_tables(*_to_coo(M), nrows, ncols)
    if t is not None:
        return linop_tables_to_ell(*t, dtype=dtype, device=device)
    if size <= dense_limit:
        return dense()
    raise NotImplementedError(
        "a row/column too dense for ELL on a matrix too large for the dense "
        "form needs the COO operator: ROADMAP B2'"
    )


def linop_tables_to_ell(row_cols, row_vals, col_rows, col_vals, *, dtype, device):
    def idx(a):
        return torch.tensor(np.asarray(a, np.int32), dtype=torch.int32, device=device)

    def val(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return EllOp(idx(row_cols), val(row_vals), idx(col_rows), val(col_vals))
