"""Full solves of the PyTorch port against the JAX package.

Both run ``Options(hybrid_precision=False)`` (the port's slice), the port
with ``device="cpu"``.  Checks: the same status; |obj difference| <=
tol_gap * (1 + |obj|) = 1e-4 * (1 + |obj|), the solver's own gap
tolerance; |iteration difference| <= max(2, 2%).

Observed when these tests were written: identical iteration counts
everywhere (30: 345, 50: 384, README: 67, with a free variable and
inequalities: 60), objective differences of 1.5e-13 (side 30), 2.5e-13
(side 50) and ~1e-14 (README, free/inequality case); the limit,
dual-feasibility-veto and infeasibility-declaration paths give identical
statuses, iterations and status strings."""

import numpy as np
import pytest

import _torch_parity as tp
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu_torch import kernels


def _tiny_infeasible(pkg):
    # X psd with X_00 = -1: infeasible, declared by the in-loop heuristics
    opt = pkg.Optimizer()
    X = opt.add_psd_var(2)
    opt.add_eq_constraint({int(X[0, 0]): 1.0}, -1.0)
    opt.set_objective({int(X[1, 1]): 1.0}, sense="min")
    return opt.build_problem()


def _free_and_inequalities(pkg):
    # README max-cut plus a free variable t = X_01 and two inequality rows:
    # K4's update of the entries after the PSD block, K3's inequality slots
    opt = pkg.Optimizer()
    X = opt.add_psd_var(4)
    for i in range(4):
        opt.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
    t = int(opt.add_free_vars(1)[0])
    opt.add_eq_constraint({t: 1.0, int(X[0, 1]): -1.0}, 0.0)
    opt.add_ineq_constraint({int(X[0, 1]): 1.0}, -0.2)
    opt.add_ineq_constraint({t: -1.0}, 0.5)
    opt.set_objective(opt.psd_inner_product_coeffs(X, 0.25 * tp.README_W),
                      sense="max")
    return opt.build_problem()


def _problem(pkg, name):
    special = {"infeasible": _tiny_infeasible,
               "free_ineq": _free_and_inequalities}
    return special[name](pkg) if name in special else tp.build_problem(pkg, name)


CASES = [
    ("maxcut30", {}),
    ("maxcut50", {}),
    ("readme", {}),
    ("readme", {"max_iter": 50}),
    ("readme", {"time_limit": 0.0}),
    ("readme", {"check_dual_feas": True}),
    ("readme", {"restart": "none", "step_balance": "reference"}),
    ("readme", {"restart_trigger": "kkt", "restart_window": 20}),
    ("infeasible", {"certificate_search": False}),
    ("free_ineq", {}),
]


@pytest.mark.parametrize("name, kw", CASES,
                         ids=[f"{n}-{'-'.join(k) or 'default'}" for n, k in CASES])
def test_solve_matches_jax(name, kw):
    kernels.reset_launch_counts()
    want = jx.solve(_problem(jx, name), tp.jax_opts(**kw))
    got = tx.solve(_problem(tx, name), tp.torch_opts(**kw), device=tp.DEV)
    assert got.status == want.status, (got.status_string, want.status_string)
    assert abs(got.objval - want.objval) <= 1e-4 * (1 + abs(want.objval))
    assert abs(got.iter - want.iter) <= max(2, 0.02 * want.iter)
    assert got.final_rank == want.final_rank
    assert got.primal.shape == want.primal.shape
    if "time_limit" not in kw:  # the time-limit string carries a wall time
        assert got.status_string == want.status_string
    if want.status == 1:
        np.testing.assert_allclose(got.primal, want.primal, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.dual_eq, want.dual_eq, rtol=0, atol=1e-6)
    # on the CPU every kernel wrapper takes its plain version
    assert all(v == 0 for v in kernels.launch_counts.values())
