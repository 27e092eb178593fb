"""Linear operator M = [A; G] of the PDHG loop (``proxsdp_tpu/ops/linop.py``).

* ``DenseOp`` -- a dense (p+m, n) matrix; products are ``torch.matmul``
  (the JAX package leaves them to XLA too, linop.py:44-48).
* ``EllOp`` -- per-row and per-column ELLPACK tables; both products are
  kernel K1 (``kernels.ell_spmv``), a gather + row reduce.
* ``CooOp`` -- the triplets sorted by row and by column, for a matrix with
  a row or column too dense for ELL and too large for the dense form;
  both products are kernel K14 (``kernels.coo_spmv``), a gather and a
  segmented sum; over a batch's (B, .) rows K14b (``coo_spmv_batch``).

A batch (``parallel/batch.py``) whose instances differ in [A; G] holds
one operator per instance, as the JAX driver's vmapped ``DenseOp(0)`` and
``EllOp(None, 0, None, 0)`` operands do (batch.py:129-136): a
``DenseOp`` over a (B, p+m, n) stack, whose batched products are kernel
K16 (``kernels.batched_gemv``, ``batched_gemv_t``), or an ``EllOp`` with
shared index tables and stacked (B, rows, width) values, whose batched
products are K1's batched entry point with a value stride.  Such an
operator is ``batched``; it has no single-instance products.  A batch
whose instances share [A; G] broadcasts one operator of any form, as the
JAX driver's vmap does (batch.py:229-231).

All are ``nn.Module``s holding their tables as buffers, so ``.to(device)``
moves them.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from .. import kernels


def _single(op):
    if op.batched:
        raise ValueError("a per-instance operator has only batched products")


class DenseOp(nn.Module):
    """A dense (p+m, n) matrix, or a (B, p+m, n) stack of one per instance."""

    def __init__(self, mat: torch.Tensor):
        super().__init__()
        if mat.dim() not in (2, 3):
            raise ValueError(f"dense operator of shape {tuple(mat.shape)}")
        # the kernels read it row-major (a transposed host array arrives
        # with column-major strides)
        self.register_buffer("mat", mat.contiguous())

    @property
    def batched(self) -> bool:
        return self.mat.dim() == 3

    @property
    def shape(self):
        return tuple(self.mat.shape[-2:])

    def matvec(self, x):
        _single(self)
        return torch.matmul(self.mat, x)

    def rmatvec(self, y):
        _single(self)
        return torch.matmul(self.mat.T, y)

    def matvec_batch(self, X):
        """M x for each row of the (B, n) X (per instance: K16)."""
        if self.batched:
            return kernels.batched_gemv(self.mat, X)
        return torch.matmul(X, self.mat.T)

    def rmatvec_batch(self, Y):
        if self.batched:
            return kernels.batched_gemv_t(self.mat, Y)
        return torch.matmul(Y, self.mat)

    def rmatvec_tables(self):
        """M' for the linesearch kernels: (form, ptr, idx, vals, width)."""
        return kernels.LS_DENSE, None, None, self.mat, 0


class EllOp(nn.Module):
    """ELLPACK operator; padding entries point at index 0 with value 0.  A
    per-instance operator shares the index tables and stacks the values:
    row_vals (B, nrows, r), col_vals (B, ncols, c)."""

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
    def batched(self) -> bool:
        return self.row_vals.dim() == 3

    @property
    def shape(self):
        return (self.row_cols.shape[0], self.col_rows.shape[0])

    def matvec(self, x):
        _single(self)
        return kernels.ell_spmv(self.row_cols, self.row_vals, x)

    def rmatvec(self, y):
        _single(self)
        return kernels.ell_spmv(self.col_rows, self.col_vals, y)

    def matvec_batch(self, X):
        """M x for each row of the (B, n) X (K1's batched entry point;
        per instance, its value stride)."""
        return kernels.ell_spmv_batch(self.row_cols, self.row_vals, X)

    def rmatvec_batch(self, Y):
        return kernels.ell_spmv_batch(self.col_rows, self.col_vals, Y)

    def rmatvec_tables(self):
        """M' for the linesearch kernels: (form, ptr, idx, vals, width)."""
        return (kernels.LS_ELL, None, self.col_rows, self.col_vals,
                self.col_rows.shape[1])


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


class CooOp(nn.Module):
    """COO operator (linop.py:61-104) held as two segment tables: the
    triplets sorted by row (the matvec's segments) and by column (the
    rmatvec's).  ``*_seg`` is each term's segment, the plain version's
    scatter index."""

    def __init__(self, rows, cols, vals, nrows: int, ncols: int, *, dtype,
                 device):
        super().__init__()

        def table(keys, others, nkeys):
            order = np.argsort(keys, kind="stable")
            ptr = np.searchsorted(keys[order], np.arange(nkeys + 1))
            return (torch.tensor(ptr, dtype=torch.int64, device=device),
                    torch.tensor(others[order], dtype=torch.int32, device=device),
                    torch.tensor(vals[order], dtype=dtype, device=device),
                    torch.tensor(keys[order], dtype=torch.int64, device=device))

        for prefix, t in (("row", table(rows, cols, nrows)),
                          ("col", table(cols, rows, ncols))):
            for name, buf in zip(("ptr", "idx", "vals", "seg"), t):
                self.register_buffer(f"{prefix}_{name}", buf)

    batched = False

    @property
    def shape(self):
        return (self.row_ptr.shape[0] - 1, self.col_ptr.shape[0] - 1)

    def matvec(self, x):
        return kernels.coo_spmv(self.row_ptr, self.row_idx, self.row_vals, x,
                                self.row_seg)

    def rmatvec(self, y):
        return kernels.coo_spmv(self.col_ptr, self.col_idx, self.col_vals, y,
                                self.col_seg)

    def matvec_batch(self, X):
        """M x for each row of the (B, n) X (K14b)."""
        return kernels.coo_spmv_batch(self.row_ptr, self.row_idx,
                                      self.row_vals, X, self.row_seg)

    def rmatvec_batch(self, Y):
        return kernels.coo_spmv_batch(self.col_ptr, self.col_idx,
                                      self.col_vals, Y, self.col_seg)

    def rmatvec_tables(self):
        """M' for the linesearch kernels: (form, ptr, idx, vals, width)."""
        return kernels.LS_COO, self.col_ptr, self.col_idx, self.col_vals, 0


def build_linop(A, G, dtype: torch.dtype, *, device, force: str | None = None,
                dense_limit: int = 1 << 23):
    """Choose and build the operator for M = [A; G] on ``device``.

    force: "dense" | "ell" | "coo" | None (auto).  Auto is the JAX
    package's policy for a backend that is not a TPU (linop.py:278-330):
    ELL for very sparse matrices, dense otherwise; where a row or column is
    too dense for ELL, dense if the matrix fits ``dense_limit``, else COO.
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
    if choice not in ("dense", "ell", "coo"):
        raise ValueError(f"operator form {choice!r}")

    def dense():
        arr = M.toarray() if sp.issparse(M) else np.asarray(M)
        return DenseOp(torch.tensor(arr, dtype=dtype, device=device))

    if choice == "dense":
        return dense()
    rows, cols, vals = _to_coo(M)
    if choice == "ell":
        t = ell_tables(rows, cols, vals, nrows, ncols)
        if t is not None:
            return linop_tables_to_ell(*t, dtype=dtype, device=device)
        if size <= dense_limit:
            return dense()
    return CooOp(rows, cols, vals, nrows, ncols, dtype=dtype, device=device)


def linop_tables_to_ell(row_cols, row_vals, col_rows, col_vals, *, dtype, device):
    def idx(a):
        return torch.tensor(np.asarray(a, np.int32), dtype=torch.int32, device=device)

    def val(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return EllOp(idx(row_cols), val(row_vals), idx(col_rows), val(col_vals))
