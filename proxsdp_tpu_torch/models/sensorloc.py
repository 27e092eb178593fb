"""Sensor-network localization SDP (a feasibility problem); a copy of
``proxsdp_tpu/models/sensorloc.py`` (reference: test/base_sensorloc.jl and
test/moi_sensorloc.jl).

Variables: X of side n+2 with X[:2,:2] pinned to I (anchor frame), sensor
positions in X[:2, 2:], Gram matrix in X[2:, 2:]; equality constraints from
anchor-sensor and (10%-sampled) sensor-sensor squared distances; zero
objective.
"""

from __future__ import annotations

import numpy as np

from ..api import Optimizer
from ..options import Options


def sensorloc_data(seed: int, n: int):
    rng = np.random.RandomState(seed)
    m = int(np.floor(0.1 * n))
    x_true = rng.rand(2, n)
    d = {(i, j): np.linalg.norm(x_true[:, i] - x_true[:, j]) for i in range(n) for j in range(i)}
    a = {k: rng.rand(2) for k in range(m)}
    d_bar = {(k, j): np.linalg.norm(x_true[:, j] - a[k]) for k in range(m) for j in range(n)}
    return m, x_true, a, d, d_bar


def sensorloc_problem(seed: int, n: int, options: Options | None = None):
    """Build the localization SDP; returns (problem, Xidx, x_true)."""
    rng = np.random.RandomState(seed)  # for the 10% sensor-pair sampling
    m, x_true, a, d, d_bar = sensorloc_data(seed, n)
    side = n + 2
    opt = Optimizer(options)
    X = opt.add_psd_var(side)

    # anchor-sensor distances (moi_sensorloc.jl:22-45)
    for j in range(n):
        for k in range(m):
            ak = a[k]
            coeffs = {
                int(X[0, 0]): ak[0] * ak[0],
                int(X[1, 1]): ak[1] * ak[1],
                int(X[0, j + 2]): -2.0 * ak[0],
                int(X[1, j + 2]): -2.0 * ak[1],
            }
            coeffs[int(X[j + 2, j + 2])] = coeffs.get(int(X[j + 2, j + 2]), 0.0) + 1.0
            opt.add_eq_constraint(coeffs, d_bar[k, j] ** 2)

    # sampled sensor-sensor distances (moi_sensorloc.jl:48-76)
    for i in range(n):
        for j in range(i):
            if rng.rand() > 0.9:
                opt.add_eq_constraint(
                    {
                        int(X[i + 2, i + 2]): 1.0,
                        int(X[j + 2, j + 2]): 1.0,
                        int(X[i + 2, j + 2]): -2.0,
                    },
                    d[i, j] ** 2,
                )

    # pin the anchor frame: X[0,0]=1, X[0,1]=0 (twice, matching the
    # reference's duplicated row), X[1,1]=1 (moi_sensorloc.jl:78-95)
    opt.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
    opt.add_eq_constraint({int(X[0, 1]): 1.0}, 0.0)
    opt.add_eq_constraint({int(X[0, 1]): 1.0}, 0.0)
    opt.add_eq_constraint({int(X[1, 1]): 1.0}, 1.0)

    opt.set_objective({}, sense="min")  # feasibility problem
    return opt.build_problem(), X, x_true


def solve_sensorloc(seed: int, n: int, options: Options | None = None, *,
                    device="cuda", **kwargs):
    from ..solver import solve

    problem, Xidx, x_true = sensorloc_problem(seed, n, options)
    if kwargs:
        options = (options or Options()).replace(**kwargs)
    res = solve(problem, options, device=device)
    return res.primal[Xidx], x_true, res
