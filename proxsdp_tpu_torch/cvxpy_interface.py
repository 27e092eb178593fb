"""CVXPY front end (user modeling layer); a copy of
``proxsdp_tpu/cvxpy_interface.py`` that solves on the CUDA card unless
the caller passes ``device="cpu"``.

The reference's user modeling layer is JuMP/Convex.jl via MOI
(reference src/MOI_wrapper.jl); the Python ecosystem's equivalent is
CVXPY.  CVXPY can lower any conic model to the SCS standard form
(``problem.get_problem_data(cvxpy.SCS)``), which is exactly what
:func:`proxsdp_tpu_torch.ingest.solve_cone_program` consumes — so the adapter
is a thin, schema-stable bridge rather than a reimplementation of
CVXPY's solver-plugin internals.

Usage::

    import cvxpy as cp
    from proxsdp_tpu_torch.cvxpy_interface import solve_cvxpy_problem

    X = cp.Variable((4, 4), PSD=True)
    prob = cp.Problem(cp.Maximize(cp.trace(W @ X)), [cp.diag(X) == 1])
    value = solve_cvxpy_problem(prob, tol_gap=1e-6)   # also unpacks into
    print(X.value)                                    # the cvxpy variables

``cvxpy`` is an optional dependency: importing this module without it
raises ImportError with a clear message.
"""

from __future__ import annotations

import numpy as np

from .options import Options


def _require_cvxpy():
    try:
        import cvxpy
    except ImportError as e:  # pragma: no cover - cvxpy not in test image
        raise ImportError(
            "proxsdp_tpu_torch.cvxpy_interface requires the optional dependency "
            "cvxpy (pip install cvxpy)"
        ) from e
    return cvxpy


def solve_cvxpy_problem(
    problem,
    options: Options | None = None,
    warm_start=None,
    *,
    device="cuda",
    **kwargs,
):
    """Solve a ``cvxpy.Problem`` with the cone solver on ``device``.

    Lowers via CVXPY's own SCS reduction chain, solves through
    :func:`proxsdp_tpu_torch.ingest.solve_cone_program`, and unpacks the
    solution back into the problem's variables (``var.value`` etc.)
    using CVXPY's inverse-data chain.  Returns the optimal objective
    value (CVXPY's sign/constant conventions applied).

    Keyword arguments are :class:`Options` fields.
    """
    cp = _require_cvxpy()
    from .ingest import solve_cone_program

    data, chain, inverse_data = problem.get_problem_data(cp.SCS)
    cone_dims = data["dims"]
    dims = dict(
        z=int(getattr(cone_dims, "zero", 0)),
        l=int(getattr(cone_dims, "nonneg", 0)),
        q=tuple(int(v) for v in getattr(cone_dims, "soc", ())),
        s=tuple(int(v) for v in getattr(cone_dims, "psd", ())),
    )
    exp = getattr(cone_dims, "exp", 0)
    p3d = getattr(cone_dims, "p3d", getattr(cone_dims, "pow", ()))
    if exp or (p3d is not None and len(tuple(p3d)) > 0):
        raise ValueError(
            "exponential/power cones are outside the reference's cone "
            "suite (Zeros/Nonneg/SOC/PSD) and are not supported"
        )

    sol = solve_cone_program(
        data["c"], data["A"], data["b"], dims,
        options=options, warm_start=warm_start, device=device, **kwargs,
    )

    # hand the (x, y, s) triple back through CVXPY's inversion chain so
    # variable values / duals land on the user's model objects.  CVXPY's
    # solver-level Solution keying has shifted across versions, so this is
    # best-effort: on any mismatch the ConeSolution is still returned and
    # the caller can read sol.x / sol.y directly.
    status_map = {
        1: "optimal",
        2: "user_limit",
        3: "user_limit",
        4: "infeasible_or_unbounded",
        5: "unbounded",
        6: "infeasible",
    }
    status = status_map.get(sol.result.status, "solver_error")
    try:
        from cvxpy.reductions.solution import Solution, failure_solution

        scs_cls = type(chain.solver) if hasattr(chain, "solver") else cp.SCS
        var_id = getattr(scs_cls, "VAR_ID", "x")
        dual_id = getattr(scs_cls, "DUAL_VAR_ID", "y")
        if status in ("optimal", "user_limit"):
            attr = {
                "solve_time": sol.result.time,
                "num_iters": sol.result.iter,
            }
            raw = Solution(
                "optimal" if status == "optimal" else "optimal_inaccurate",
                sol.objval,
                {var_id: np.asarray(sol.x)},
                {dual_id: np.asarray(sol.y)},
                attr,
            )
        else:
            raw = failure_solution(status)
        problem.unpack_results(raw, chain, inverse_data)
        return problem.value
    except Exception as e:
        # version mismatch in CVXPY's internal Solution schema: the solve
        # itself succeeded; expose the raw cone solution.  Warn loudly —
        # the return type changes (float -> ConeSolution) and silent
        # type-sniffing at call sites is worse than a schema note.
        import warnings

        warnings.warn(
            "solve_cvxpy_problem: cvxpy's Solution/unpack_results schema "
            f"did not match this cvxpy version ({type(e).__name__}: {e}); "
            "returning the raw ConeSolution (read .objval/.x/.y) instead "
            "of problem.value",
            RuntimeWarning,
            stacklevel=2,
        )
        return sol
