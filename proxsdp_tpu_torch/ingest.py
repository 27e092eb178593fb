"""Standard conic-form ingestion (SCS/CVXPY-style cone programs); a copy
of ``proxsdp_tpu/ingest.py`` whose ``solve_cone_program`` solves on the
CUDA card unless the caller passes ``device="cpu"``.

The reference's real front door is MathOptInterface: JuMP/Convex models are
lowered by MOI bridges into the four geometries the solver supports
(VectorAffine-in-Zeros/Nonpositives, VectorOfVariables-in-SOC/PSDTriangle;
reference src/MOI_wrapper.jl:184-201).  The Python ecosystem's lingua franca
is instead the SCS standard form

    min  c'x   s.t.  A x + s = b,   s in K,
    K = {0}^z  x  R+^l  x  SOC(q_1) x ... x  PSD(s_1) x ...

(what CVXPY emits from ``problem.get_problem_data(cvxpy.SCS)``).  This module
is the bridge layer: it lowers that form into :class:`ConicProblem`'s
variable-cone geometry exactly the way MOI bridges do — slack variables for
cone rows plus equality constraints (reference src/structs.jl:36 'extra'
variables play the same role):

* zero-cone rows        ->  A_eq x = b rows, directly
* nonnegative rows      ->  G x <= h rows, directly (s = b - Ax >= 0)
* SOC rows              ->  new SOC variable block t with  A x + t = b
* PSD rows (SCS scaled lower-triangle packing, off-diag * sqrt(2))
                        ->  new PSD triangle variable block Z (raw entries,
                            MOI upper-triangle order) with
                            A x + vec_scaled(Z) = b

Duals returned map back to the cone rows (one multiplier per row of A), so a
CVXPY user gets (x, y, s) with the usual SCS sign conventions.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import scipy.sparse as _sp

from .options import Options, make_options
from .problem import ConicProblem
from .result import Result
from .solver import solve
from .utils.vech import sympackedlen, tri_ij


@dataclasses.dataclass(frozen=True)
class ConeDims:
    """Cone dimensions for the SCS standard form (rows of A, in order).

    z: number of zero-cone rows (equalities); SCS calls this ``z`` or ``f``.
    l: number of nonnegative rows.
    q: SOC sizes (each >= 1; size-1 SOC degenerates to a nonnegative row).
    s: PSD matrix sides (rows consumed: side*(side+1)//2 each, scaled
       lower-triangle packing like SCS).
    """

    z: int = 0
    l: int = 0
    q: tuple = ()
    s: tuple = ()

    @property
    def total_rows(self) -> int:
        return (
            self.z
            + self.l
            + sum(self.q)
            + sum(side * (side + 1) // 2 for side in self.s)
        )


def _rows(M, sl):
    if _sp.issparse(M):
        return M.tocsr()[sl]
    return np.asarray(M)[sl]


def _hstack(blocks):
    if any(_sp.issparse(B) for B in blocks):
        return _sp.hstack([_sp.csr_matrix(B) for B in blocks]).tocsc()
    return np.hstack([np.asarray(B) for B in blocks])


def _vstack(blocks):
    blocks = [B for B in blocks if B.shape[0]]
    if not blocks:
        return np.zeros((0, 0))
    if any(_sp.issparse(B) for B in blocks):
        return _sp.vstack([_sp.csr_matrix(B) for B in blocks]).tocsc()
    return np.vstack([np.asarray(B) for B in blocks])


def cone_program_to_conic(c, A, b, dims: ConeDims) -> tuple:
    """Lower the SCS form to a ConicProblem.

    Returns (problem, recover) where ``recover(result)`` maps a solver
    Result back to the cone-program's (x, y, s) with objective/duals in the
    original row order.
    """
    c = np.asarray(c, dtype=np.float64).ravel()
    b = np.asarray(b, dtype=np.float64).ravel()
    n = c.shape[0]
    m_total = dims.total_rows
    if A.shape != (m_total, n):
        raise ValueError(
            f"A has shape {A.shape}, expected ({m_total}, {n}) from dims/c"
        )

    # Row partitions in SCS order: zero, nonneg, soc..., psd...
    ofs = 0
    sl_zero = slice(ofs, ofs + dims.z)
    ofs += dims.z
    sl_pos = slice(ofs, ofs + dims.l)
    ofs += dims.l
    sl_socs = []
    for qlen in dims.q:
        sl_socs.append(slice(ofs, ofs + qlen))
        ofs += qlen
    sl_psds = []
    for side in dims.s:
        tl = side * (side + 1) // 2
        sl_psds.append(slice(ofs, ofs + tl))
        ofs += tl

    # Slack variable blocks appended after x: one per SOC / PSD cone.
    soc_vars, psd_vars = [], []
    nvar = n
    for qlen in dims.q:
        soc_vars.append(np.arange(nvar, nvar + qlen))
        nvar += qlen
    for side in dims.s:
        tl = sympackedlen(side)
        psd_vars.append(np.arange(nvar, nvar + tl))
        nvar += tl
    n_slack = nvar - n

    def widen(M):
        """Extend an (r, n) block with zeros for the slack columns."""
        r = M.shape[0]
        if _sp.issparse(M):
            return _sp.hstack([M, _sp.csr_matrix((r, n_slack))]).tocsc()
        return np.hstack([np.asarray(M), np.zeros((r, n_slack))])

    eq_blocks, eq_rhs = [], []
    if dims.z:
        eq_blocks.append(widen(_rows(A, sl_zero)))
        eq_rhs.append(b[sl_zero])

    # SOC rows: A x + t = b, t in SOC.  SCS SOC packing [t; v] matches ours.
    for sl, vidx in zip(sl_socs, soc_vars):
        Ar = _rows(A, sl)
        r = Ar.shape[0]
        S = np.zeros((r, n_slack))
        S[np.arange(r), vidx - n] = 1.0
        eq_blocks.append(_hstack([Ar, S]))
        eq_rhs.append(b[sl])

    # PSD rows: SCS packs the LOWER triangle column-major with off-diagonals
    # scaled by sqrt(2); our PSD variable block holds RAW upper-triangle
    # entries column-major (MOI order).  Lower-tri colmajor (i>=j scanning
    # j ascending) == upper-tri ROW-major; build the index map explicitly.
    for side, sl, vidx in zip(dims.s, sl_psds, psd_vars):
        Ar = _rows(A, sl)
        tl = sympackedlen(side)
        iu, ju = tri_ij(side)  # our order: upper triangle column-major
        pos = {}
        for k in range(tl):
            pos[(int(iu[k]), int(ju[k]))] = k
        S = np.zeros((tl, n_slack))
        r = 0
        for j in range(side):  # SCS: lower triangle, column-major
            for i in range(j, side):
                k = pos[(j, i)]  # (row<=col) key of the same entry
                S[r, vidx[k] - n] = 1.0 if i == j else np.sqrt(2.0)
                r += 1
        eq_blocks.append(_hstack([Ar, S]))
        eq_rhs.append(b[sl])

    A_eq = _vstack(eq_blocks) if eq_blocks else np.zeros((0, nvar))
    b_eq = np.concatenate(eq_rhs) if eq_rhs else np.zeros(0)

    if dims.l:
        G = widen(_rows(A, sl_pos))
        h = b[sl_pos].copy()
    else:
        G = np.zeros((0, nvar))
        h = np.zeros(0)

    c_full = np.concatenate([c, np.zeros(n_slack)])
    problem = ConicProblem(
        c=c_full,
        A=A_eq,
        b=b_eq,
        G=G,
        h=h,
        sdp_vars=psd_vars,
        soc_vars=soc_vars,
    )

    # Dual/slack recovery bookkeeping: row order of A_eq is
    # [zero rows, soc rows..., psd rows...]; G rows are the nonneg rows.
    def recover(result: Result):
        x = result.primal[:n]
        y = np.zeros(m_total)
        s = np.zeros(m_total)
        de = np.asarray(result.dual_eq) if result.dual_eq is not None else None
        di = np.asarray(result.dual_in) if result.dual_in is not None else None
        eq_ofs = 0
        if dims.z and de is not None:
            y[sl_zero] = de[eq_ofs : eq_ofs + dims.z]
        eq_ofs += dims.z
        if dims.l:
            if di is not None:
                y[sl_pos] = di[: dims.l]
            s[sl_pos] = b[sl_pos] - _rows(A, sl_pos) @ x
        for sl, vidx in zip(sl_socs, soc_vars):
            r = sl.stop - sl.start
            if de is not None:
                y[sl] = de[eq_ofs : eq_ofs + r]
            eq_ofs += r
            s[sl] = result.primal[vidx]
        for side, sl, vidx in zip(dims.s, sl_psds, psd_vars):
            tl = sl.stop - sl.start
            if de is not None:
                y[sl] = de[eq_ofs : eq_ofs + tl]
            eq_ofs += tl
            z = result.primal[vidx]  # raw upper-tri col-major
            iu, ju = tri_ij(side)
            pos = {}
            for k in range(tl):
                pos[(int(iu[k]), int(ju[k]))] = k
            r = 0
            vals = np.zeros(tl)
            for j in range(side):
                for i in range(j, side):
                    k = pos[(j, i)]
                    vals[r] = z[k] * (1.0 if i == j else np.sqrt(2.0))
                    r += 1
            s[sl] = vals
        return x, y, s

    return problem, recover


@dataclasses.dataclass
class ConeSolution:
    """Solution of an SCS-form cone program."""

    x: np.ndarray
    y: np.ndarray  # dual per row of A (cone order)
    s: np.ndarray  # slack per row of A
    objval: float
    result: Result  # full solver result (status, iters, residuals...)

    @property
    def status(self) -> int:
        return self.result.status

    @property
    def termination_status(self) -> str:
        return self.result.termination_status


def solve_cone_program(
    c,
    A,
    b,
    dims: ConeDims | dict | None = None,
    options: Options | None = None,
    warm_start=None,
    *,
    device="cuda",
    **kwargs,
) -> ConeSolution:
    """Solve an SCS-standard-form cone program:

        min  c'x   s.t.  A x + s = b,  s in K(dims).

    ``dims`` accepts a :class:`ConeDims` or an SCS-style dict with keys
    ``z``/``f`` (zero), ``l`` (nonneg), ``q`` (SOC sizes), ``s`` (PSD sides).
    Solves on ``device``; returns a :class:`ConeSolution`.
    """
    if dims is None:
        dims = ConeDims(z=np.asarray(b).shape[0])
    if isinstance(dims, dict):
        dims = ConeDims(
            z=int(dims.get("z", dims.get("f", 0))),
            l=int(dims.get("l", 0)),
            q=tuple(int(v) for v in dims.get("q", ())),
            s=tuple(int(v) for v in dims.get("s", ())),
        )
    if options is None:
        opts = make_options(**kwargs)
    else:
        opts = options.replace(**kwargs) if kwargs else options
    problem, recover = cone_program_to_conic(c, A, b, dims)
    result = solve(problem, opts, warm_start=warm_start, device=device)
    x, y, s = recover(result)
    c = np.asarray(c, dtype=np.float64).ravel()
    return ConeSolution(x=x, y=y, s=s, objval=float(c @ x), result=result)
