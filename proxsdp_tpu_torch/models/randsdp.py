"""Random dense feasible SDP (reference: test/base_randsdp.jl +
test/moi_randsdp.jl); a copy of ``proxsdp_tpu/models/randsdp.py``.

    min <C, X>  s.t.  <A_k, X> = b_k (k=1..m),  X psd,
    with (quirk reproduced from moi_randsdp.jl:32-45) box bounds
    -10 <= x_k <= 10 on the FIRST n triangle variables only.
"""

from __future__ import annotations

import numpy as np

from ..api import Optimizer
from ..options import Options


def randsdp_data(seed: int, m: int, n: int):
    rng = np.random.RandomState(seed)
    c_sqrt = rng.rand(n, n)
    C = c_sqrt @ c_sqrt.T
    X_ = rng.randn(n, n)
    X_ = X_ @ X_.T
    A, b = {}, {}
    for i in range(m):
        Ai = rng.rand(n, n)
        A[i] = Ai @ Ai.T
        b[i] = np.trace(A[i] @ X_)
    return A, b, C


def randsdp_problem(seed: int, n: int, m: int, options: Options | None = None,
                    varbounds: bool = True):
    A, b, C = randsdp_data(seed, m, n)
    opt = Optimizer(options)
    X = opt.add_psd_var(n)
    for k in range(m):
        opt.add_eq_constraint(opt.psd_inner_product_coeffs(X, A[k]), b[k])
    if varbounds:
        for k in range(n):  # only first n tri vars, as in the reference
            opt.add_ineq_constraint({k: -1.0}, 10.0)
            opt.add_ineq_constraint({k: 1.0}, 10.0)
    opt.set_objective(opt.psd_inner_product_coeffs(X, C), sense="min")
    return opt.build_problem(), X, (A, b, C)


def randsdp_eval(A, b, C, X):
    """Constraint violations + rank (base_randsdp.jl:25-35)."""
    eigs = np.linalg.eigvalsh(X)
    minus_rank = int(np.sum(eigs < -1e-10))
    rank = int(np.sum(eigs > 1e-10))
    viol = [abs(np.trace(A[i] @ X) - b[i]) for i in range(len(A))]
    return minus_rank, rank, float(np.trace(C @ X)), viol


def solve_randsdp(seed: int, n: int, m: int, options: Options | None = None,
                  *, device="cuda", **kwargs):
    from ..solver import solve

    problem, Xidx, data = randsdp_problem(seed, n, m, options)
    if kwargs:
        options = (options or Options()).replace(**kwargs)
    res = solve(problem, options, device=device)
    return res.primal[Xidx], data, res
