"""The modeling API (``proxsdp_tpu/api.py``), the reference's MOI-wrapper
equivalent.

``Optimizer`` builds a ``ConicProblem`` incrementally, with the same
variable convention as MOI's PSDTriangle: the declared variables are the
raw upper-triangle entries X_ij (column-major, i <= j), so a full-matrix
inner product <A, X> contributes 2*A_ij on off-diagonal variables.
``Optimizer.optimize`` solves the built problem and keeps the result for
the MOI-style accessors; ``solve_sdp`` is the one-call standard-form SDP.
Both solve on the CUDA card unless the caller passes ``device="cpu"``
(the plain PyTorch path); ``device`` is not an ``Options`` field.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .options import Options
from .problem import ConicProblem
from .result import Result
from .solver import solve
from .utils.vech import sympackedlen, tri_ij


class Optimizer:
    """Incremental conic model builder and solver (api.py:33-306)."""

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
        self._time_limit_set = False
        self.result: Result | None = None

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

    def optimize(self, warm_start=None, *, device="cuda", **kwargs) -> Result:
        """Solve on ``device`` (api.py:184-190); ``warm_start`` accepts a
        previous Result (or (x, dual_eq, dual_in)) for the same model
        geometry; keyword arguments are ``Options`` fields for this solve."""
        opts = self.options.replace(**kwargs) if kwargs else self.options
        self.result = solve(self.build_problem(), opts, warm_start=warm_start,
                            device=device)
        return self.result

    # ---- result accessors, MOI-style (api.py:192-306; reference
    # src/MOI_wrapper.jl:356-530)

    def _solved(self) -> Result:
        if self.result is None:
            raise RuntimeError("call optimize() first")
        return self.result

    def get_psd_solution(self, Xidx: np.ndarray) -> np.ndarray:
        """The solved PSD block as a dense symmetric matrix."""
        return self._solved().primal[Xidx]

    @property
    def termination_status(self) -> str:
        return self._solved().termination_status

    @property
    def objective_value(self) -> float:
        return self._solved().objval

    @property
    def dual_objective_value(self) -> float:
        return self._solved().dual_objval

    @property
    def solve_time_sec(self) -> float:
        """MOI.SolveTimeSec (MOI_wrapper.jl:455-457)."""
        return self._solved().time

    @property
    def raw_status_string(self) -> str:
        """MOI.RawStatusString (MOI_wrapper.jl:459-461)."""
        return self._solved().status_string

    @property
    def result_count(self) -> int:
        """MOI.ResultCount (MOI_wrapper.jl:463-465)."""
        return 0 if self.result is None else max(self.result.result_count, 1)

    @property
    def pdhg_iterations(self) -> int:
        """ProxSDP.PDHGIterations (MOI_wrapper.jl:364-375)."""
        return self._solved().iter

    @property
    def silent(self) -> bool:
        """MOI.Silent: suppresses the banner and progress log."""
        return not self.options.log_verbose

    @silent.setter
    def silent(self, value: bool):
        self.options = self.options.replace(log_verbose=not value)

    @property
    def time_limit_sec(self) -> float | None:
        """MOI.TimeLimitSec (seconds); None when unset (MOI_wrapper.jl:447-453)."""
        if not self._time_limit_set:
            return None
        return self.options.time_limit

    @time_limit_sec.setter
    def time_limit_sec(self, value: float | None):
        self._time_limit_set = value is not None
        self.options = self.options.replace(
            time_limit=360000.0 if value is None else float(value))

    @property
    def primal_status(self) -> str:
        """MOI.PrimalStatus (MOI_wrapper.jl:413-425): FEASIBLE_POINT,
        INFEASIBILITY_CERTIFICATE (unbounded with a primal ray) or
        NO_SOLUTION."""
        r = self.result
        if r is None:
            return "NO_SOLUTION"
        if r.status == 5 and r.certificate_found:
            return "INFEASIBILITY_CERTIFICATE"
        if r.primal_feasible_user_tol:
            return "FEASIBLE_POINT"
        return "NO_SOLUTION" if r.status != 1 else "FEASIBLE_POINT"

    @property
    def dual_status(self) -> str:
        """MOI.DualStatus (MOI_wrapper.jl:427-441): FEASIBLE_POINT,
        INFEASIBILITY_CERTIFICATE (infeasible with a dual ray) or
        NO_SOLUTION."""
        r = self.result
        if r is None:
            return "NO_SOLUTION"
        if r.status == 6 and r.certificate_found:
            return "INFEASIBILITY_CERTIFICATE"
        if r.dual_feasible_user_tol:
            return "FEASIBLE_POINT"
        return "NO_SOLUTION" if r.status != 1 else "FEASIBLE_POINT"

    def get_eq_dual(self, row: int) -> float:
        """Dual multiplier of the row-th equality (ConstraintDual of a
        Zeros row, MOI_wrapper.jl:487-497)."""
        return float(self._solved().dual_eq[row])

    def get_ineq_dual(self, row: int) -> float:
        """Dual multiplier of the row-th inequality."""
        return float(self._solved().dual_in[row])

    def get_eq_slack(self, row: int) -> float:
        """A x - b of the row-th equality (ConstraintPrimal is b + slack)."""
        return float(self._solved().slack_eq[row])

    def get_ineq_slack(self, row: int) -> float:
        return float(self._solved().slack_in[row])


def solve_sdp(C, As=(), bs=(), Gs=(), hs=(), sense: str = "min",
              options: Options | None = None, warm_start=None, *,
              device="cuda", **kwargs) -> tuple[np.ndarray, Result]:
    """Standard-form single-block SDP (api.py:309-336):

        sense  <C, X>   s.t.  <A_i, X> = b_i,  <G_j, X> <= h_j,  X psd,

    solved on ``device``.  Returns (X, result), X the dense solution."""
    C = np.asarray(C, dtype=np.float64)
    opt = Optimizer(options, **kwargs)
    X = opt.add_psd_var(C.shape[0])
    for A, b in zip(As, bs):
        opt.add_eq_constraint(opt.psd_inner_product_coeffs(X, A), b)
    for G, h in zip(Gs, hs):
        opt.add_ineq_constraint(opt.psd_inner_product_coeffs(X, G), h)
    opt.set_objective(opt.psd_inner_product_coeffs(X, C), sense=sense)
    res = opt.optimize(warm_start=warm_start, device=device)
    return opt.get_psd_solution(X), res
