"""Binary MIMO detection SDP relaxation; a copy of
``proxsdp_tpu/models/mimo.py`` (reference: test/base_mimo.jl and
test/moi_mimo.jl):

    min <L, X>  s.t. diag(X) = 1,  -1 <= X_ij <= 1,  X psd,
    L = [H'H  -H'y; -y'H  y'y],  X of side n+1.

Rank-1 solutions recover the +-1 signal s in X[:n, n].
"""

from __future__ import annotations

import numpy as np

from ..api import Optimizer
from ..options import Options
from ..utils.vech import sympackedlen


def mimo_data(seed: int, m: int, n: int, sigma: float = 1e-4):
    rng = np.random.RandomState(seed)
    H = rng.randn(m, n)
    v = rng.randn(m, 1)
    s = rng.choice([-1.0, 1.0], size=n)
    y = H @ s + sigma * v.ravel()
    yc = y.reshape(-1, 1)
    L = np.block([[H.T @ H, -H.T @ yc], [-yc.T @ H, yc.T @ yc]])
    return s, H, y, L


def mimo_problem(seed: int, n: int, options: Options | None = None):
    """Build the MIMO SDP (m = 10n as in moi_mimo.jl); returns
    (problem, Xidx, s_true)."""
    m = 10 * n
    s, H, y, L = mimo_data(seed, m, n)
    side = n + 1
    nvars = sympackedlen(side)
    opt = Optimizer(options)
    X = opt.add_psd_var(side)
    # elementwise box |X_ij| <= 1 over triangle variables (moi_mimo.jl:17-31)
    for k in range(nvars):
        opt.add_ineq_constraint({k: 1.0}, 1.0)
        opt.add_ineq_constraint({k: -1.0}, 1.0)
    for i in range(side):
        opt.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
    opt.set_objective(opt.psd_inner_product_coeffs(X, L), sense="min")
    return opt.build_problem(), X, s


def mimo_eval(s, X):
    """Decode and compare against the true signal (base_mimo.jl:20-27)."""
    x_hat = np.sign(X[:-1, -1])
    decode_error = np.sum(np.abs(x_hat - s))
    eigs = np.linalg.eigvalsh(X)
    rank = int(np.sum(eigs > 1e-7))
    return x_hat, decode_error, rank


def solve_mimo(seed: int, n: int, options: Options | None = None, *,
               device="cuda", **kwargs):
    from ..solver import solve

    problem, Xidx, s = mimo_problem(seed, n, options)
    if kwargs:
        options = (options or Options()).replace(**kwargs)
    res = solve(problem, options, device=device)
    return res.primal[Xidx], s, res
