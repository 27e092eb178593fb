"""Problem-building part of the modeling API (``proxsdp_tpu/api.py:33-183``).

``Optimizer`` builds a ``ConicProblem`` incrementally, with the same
variable convention as MOI's PSDTriangle: the declared variables are the
raw upper-triangle entries X_ij (column-major, i <= j), so a full-matrix
inner product <A, X> contributes 2*A_ij on off-diagonal variables.  Solve
the built problem with ``proxsdp_tpu_torch.solve(problem, options,
device=...)``; ``optimize`` and ``solve_sdp`` are ROADMAP A9.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .options import Options
from .problem import ConicProblem
from .utils.vech import sympackedlen, tri_ij


class Optimizer:
    """Incremental conic model builder."""

    def __init__(self, options: Options | None = None, **kwargs):
        base = options or Options()
        self.options = base.replace(**kwargs) if kwargs else base
        self._nvars = 0
        self._sdp_vars: list[np.ndarray] = []
        self._soc_vars: list[np.ndarray] = []
        self._eq_rows: list[dict] = []
        self._eq_rhs: list[float] = []
        self._ineq_rows: list[dict] = []
        self._ineq_rhs: list[float] = []
        self._obj: dict = {}
        self._sense = "min"
        self._obj_constant = 0.0

    def add_free_vars(self, k: int) -> np.ndarray:
        idx = np.arange(self._nvars, self._nvars + k)
        self._nvars += k
        return idx

    def add_psd_var(self, side: int) -> np.ndarray:
        """Add a side x side PSD block; returns a (side, side) symmetric
        index matrix ([i,j] and [j,i] map to the same variable)."""
        tl = sympackedlen(side)
        idx = np.arange(self._nvars, self._nvars + tl)
        self._nvars += tl
        self._sdp_vars.append(idx)
        i, j = tri_ij(side)
        mat = np.zeros((side, side), dtype=np.int64)
        mat[i, j] = idx
        mat[j, i] = idx
        return mat

    def add_soc_var(self, length: int) -> np.ndarray:
        """Add a second-order cone block [t; v] with ||v|| <= t."""
        idx = np.arange(self._nvars, self._nvars + length)
        self._nvars += length
        self._soc_vars.append(idx)
        return idx

    def add_rsoc_var(self, length: int) -> np.ndarray:
        """Add a rotated second-order cone block [u; v; w] with
        2*u*v >= ||w||^2, u >= 0, v >= 0 (length = 2 + len(w)), bridged
        as MOI's RSOCtoSOC bridge does (api.py:89-111): free (u, v, w)
        linked by equalities to an SOC block (t1, t2, w') with t1 = (u +
        v) / sqrt(2), t2 = (u - v) / sqrt(2), w' = w.  Returns the indices
        of (u, v, w)."""
        if length < 2:
            raise ValueError("rotated SOC needs at least (u, v)")
        uvw = self.add_free_vars(length)
        soc = self.add_soc_var(length)
        s = np.sqrt(2.0) / 2.0
        u, v = int(uvw[0]), int(uvw[1])
        self.add_eq_constraint({int(soc[0]): 1.0, u: -s, v: -s}, 0.0)
        self.add_eq_constraint({int(soc[1]): 1.0, u: -s, v: s}, 0.0)
        for wi, wsoc in zip(uvw[2:], soc[2:]):
            self.add_eq_constraint({int(wsoc): 1.0, int(wi): -1.0}, 0.0)
        return uvw

    def add_eq_constraint(self, coeffs: dict, rhs: float):
        self._eq_rows.append(dict(coeffs))
        self._eq_rhs.append(float(rhs))

    def add_ineq_constraint(self, coeffs: dict, rhs: float):
        """sum coeffs[v] * x[v] <= rhs."""
        self._ineq_rows.append(dict(coeffs))
        self._ineq_rhs.append(float(rhs))

    def set_objective(self, coeffs: dict, sense: str = "min", constant: float = 0.0):
        self._obj = dict(coeffs)
        self._sense = sense
        self._obj_constant = float(constant)

    def psd_inner_product_coeffs(self, Xidx: np.ndarray, A: np.ndarray) -> dict:
        """Coefficient dict for <A, X> over a PSD block's index matrix."""
        side = Xidx.shape[0]
        A = np.asarray(A, dtype=np.float64)
        A = 0.5 * (A + A.T)
        coeffs: dict = {}
        for jj in range(side):
            for ii in range(jj + 1):
                v = int(Xidx[ii, jj])
                coef = A[ii, jj] if ii == jj else 2.0 * A[ii, jj]
                if coef != 0.0:
                    coeffs[v] = coeffs.get(v, 0.0) + coef
        return coeffs

    def build_problem(self) -> ConicProblem:
        n = self._nvars

        def rows_to_mat(rows, nr):
            data, ri, ci = [], [], []
            for r, row in enumerate(rows):
                for v, coef in row.items():
                    ri.append(r)
                    ci.append(int(v))
                    data.append(float(coef))
            return sp.csc_matrix((data, (ri, ci)), shape=(nr, n))

        c = np.zeros(n)
        for v, coef in self._obj.items():
            c[int(v)] += coef
        if self._sense == "max":
            c = -c
        return ConicProblem(
            c=c,
            A=rows_to_mat(self._eq_rows, len(self._eq_rows)),
            b=np.asarray(self._eq_rhs),
            G=rows_to_mat(self._ineq_rows, len(self._ineq_rows)),
            h=np.asarray(self._ineq_rhs),
            sdp_vars=self._sdp_vars,
            soc_vars=self._soc_vars,
            objective_sense=self._sense,
            objective_constant=self._obj_constant,
        )
